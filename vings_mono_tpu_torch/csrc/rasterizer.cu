// 2DGS tile rasterizer for Hopper (sm_90a): forward and backward kernels.
//
// Replaces the Pallas TPU kernels of vings_mono_tpu/ops/rasterizer/
// tile_kernel.py: `raster_forward` does what `_fwd_kernel` (driven by
// `rasterize_forward`) does, `raster_backward` what `_bwd_kernel` /
// `_bwd_chunk_body` (driven by `rasterize_backward`) do. The plain PyTorch
// twins and the math are in vings_mono_tpu_torch/ops/rasterizer/
// tile_kernel.py.
//
// Design. One block per 16x16 tile, one thread per pixel (256 threads).
// The TPU walks (tile, chunk) steps in order on one core and carries the
// transmittance across steps in VMEM scratch; here the block loops over its
// own tile's chunks (`tile_chunks[t] .. tile_chunks[t+1]`) and each thread
// keeps its pixel's transmittance in a register. Each chunk's (24 x G) pair
// block is staged in shared memory once and read by all 256 threads as
// broadcasts. Before each chunk the block decides early termination with
// __syncthreads_or(T > T_EPS) — the TPU's `max(carry) > T_EPS` — and the
// backward makes exactly the forward's decision because both run the same
// coverage and transmittance arithmetic (explicitly rounded intrinsics, so
// the compiler cannot contract them differently in the two kernels).
//
// What bounds it on the H100: per (pair, pixel) the forward runs about 65
// f32 operations and one exp, the backward about 140 and one exp (the
// counts are OPS_* in tile_kernel.py), against 96 bytes of pair data that
// every pixel of the tile shares. So the FP32
// pipes bound both kernels, not memory. The design keeps every per-pixel
// operand in registers and the pair data in shared memory, skips pairs
// that cover no pixel of a warp (the backward's 23 warp reductions), and
// stops opaque tiles early. The backward reduces each pair's 23 per-pixel
// contributions over the block with warp shuffles, then across the 8 warps
// through shared memory, 32 pairs at a time; each pair belongs to one tile,
// so no atomics are needed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NWARP = PIX / 32;
constexpr int PK_PAD = 24;
constexpr int CH_PAD = 16;
constexpr int NGRAD = 23;  // 21 packed-field grads + 2 scores
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float MAX_ALPHA = 0.999f;
constexpr float MIN_HIT_Z = 0.05f;
constexpr float T_EPS = 1e-4f;

// packed field rows (vings_mono_tpu_torch/ops/rasterizer/projection.py)
constexpr int PK_WU = 0, PK_WV = 3, PK_N = 6, PK_CN = 9, PK_C2X = 10,
              PK_C2Y = 11, PK_OPAC = 12, PK_RGB = 13, PK_NRM = 16,
              PK_FLOW = 19;

struct Pixel {
  float qx, qy, px, py;
};

__device__ __forceinline__ Pixel pixel_of(int tile, const float* meta) {
  const float fx = meta[0], fy = meta[1], cx = meta[2], cy = meta[3];
  const int ntx = static_cast<int>(meta[4]);
  const int p = threadIdx.x;
  Pixel r;
  r.px = static_cast<float>((tile % ntx) * TILE + p % TILE);
  r.py = static_cast<float>((tile / ntx) * TILE + p / TILE);
  r.qx = __fdiv_rn(__fsub_rn(r.px, cx), fx);
  r.qy = __fdiv_rn(__fsub_rn(r.py, cy), fy);
  return r;
}

struct Cover {
  float alpha, z, u, v, rcp, expval, dx, dy;
  bool sel3, live;
};

// ray-splat coverage of one pair (shared-memory column i of a G-wide
// block) at one pixel; identical rounding in both kernels
__device__ __forceinline__ Cover coverage(const float* s, int G, int i,
                                          const Pixel& q) {
#define F(k) s[(k) * G + i]
  Cover c;
  const float u_num = __fadd_rn(__fadd_rn(__fmul_rn(F(PK_WU), q.qx),
                                          __fmul_rn(F(PK_WU + 1), q.qy)),
                                F(PK_WU + 2));
  const float v_num = __fadd_rn(__fadd_rn(__fmul_rn(F(PK_WV), q.qx),
                                          __fmul_rn(F(PK_WV + 1), q.qy)),
                                F(PK_WV + 2));
  float den = __fadd_rn(__fadd_rn(__fmul_rn(F(PK_N), q.qx),
                                  __fmul_rn(F(PK_N + 1), q.qy)),
                        F(PK_N + 2));
  den = fabsf(den) < 1e-12f ? 1e-12f : den;
  c.rcp = __fdiv_rn(1.0f, den);
  c.u = __fmul_rn(u_num, c.rcp);
  c.v = __fmul_rn(v_num, c.rcp);
  c.z = __fmul_rn(F(PK_CN), c.rcp);
  const float rho3d = __fadd_rn(__fmul_rn(c.u, c.u), __fmul_rn(c.v, c.v));
  c.dx = __fsub_rn(q.px, F(PK_C2X));
  c.dy = __fsub_rn(q.py, F(PK_C2Y));
  const float rho2d = __fmul_rn(
      FILTER_INV_SQUARE,
      __fadd_rn(__fmul_rn(c.dx, c.dx), __fmul_rn(c.dy, c.dy)));
  c.sel3 = rho3d < rho2d;
  const float rho = c.sel3 ? rho3d : rho2d;
  c.expval = expf(__fmul_rn(-0.5f, rho));
  const float a_raw = __fmul_rn(F(PK_OPAC), c.expval);
  const bool keep = (a_raw >= ALPHA_EPS) && (c.z > MIN_HIT_Z);
  c.alpha = keep ? fminf(a_raw, MAX_ALPHA) : 0.0f;
  c.live = keep && (a_raw < MAX_ALPHA);
#undef F
  return c;
}

__device__ __forceinline__ float transmit(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// stage chunk c's (PK_PAD x G) block of the (PK_PAD, p_cap) pair data
__device__ __forceinline__ void stage(float* s, const float* pair_data,
                                      int p_cap, int G, int c) {
  const long base = static_cast<long>(c) * G;
  for (int k = threadIdx.x; k < PK_PAD * G; k += PIX) {
    const int f = k / G, i = k - f * G;
    s[k] = pair_data[static_cast<long>(f) * p_cap + base + i];
  }
}

__global__ void __launch_bounds__(PIX)
raster_forward(const float* __restrict__ pair_data,
               const int* __restrict__ tile_chunks,
               const float* __restrict__ meta, float* __restrict__ out,
               int p_cap, int G) {
  extern __shared__ float s_pairs[];
  const int t = blockIdx.x;
  const Pixel q = pixel_of(t, meta);
  const int c0 = tile_chunks[t], c1 = tile_chunks[t + 1];

  float T = 1.0f;
  float rgb0 = 0.f, rgb1 = 0.f, rgb2 = 0.f, dep = 0.f, acc = 0.f;
  float n0 = 0.f, n1 = 0.f, n2 = 0.f, fl0 = 0.f, fl1 = 0.f;
  float wm = 0.f, wm2 = 0.f;

  for (int c = c0; c < c1; ++c) {
    // also the barrier that keeps the previous chunk's readers ahead of
    // this chunk's staging writes
    if (!__syncthreads_or(T > T_EPS)) break;
    stage(s_pairs, pair_data, p_cap, G, c);
    __syncthreads();
    for (int i = 0; i < G; ++i) {
      const Cover cv = coverage(s_pairs, G, i, q);
      if (cv.alpha > 0.0f) {
        const float w = cv.alpha * T;
        const float md = cv.z / (1.0f + cv.z);
        const float wmd = w * md;
#define F(k) s_pairs[(k) * G + i]
        rgb0 += w * F(PK_RGB);
        rgb1 += w * F(PK_RGB + 1);
        rgb2 += w * F(PK_RGB + 2);
        dep += w * cv.z;
        acc += w;
        n0 += w * F(PK_NRM);
        n1 += w * F(PK_NRM + 1);
        n2 += w * F(PK_NRM + 2);
        fl0 += w * F(PK_FLOW);
        fl1 += w * F(PK_FLOW + 1);
        wm += wmd;
        wm2 += wmd * md;
#undef F
      }
      T = transmit(T, cv.alpha);
    }
  }

  float* o = out + static_cast<long>(t) * CH_PAD * PIX + threadIdx.x;
  const float rows[CH_PAD] = {rgb0, rgb1, rgb2, dep, acc, n0,  n1,  n2,
                              0.f,  fl0,  fl1,  wm,  wm2, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ch = 0; ch < CH_PAD; ++ch) o[ch * PIX] = rows[ch];
}

__device__ __forceinline__ void store(float* g, long i, float x) { g[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* g, long i, float x) {
  g[i] = __float2bfloat16(x);
}

template <typename OutT>
__global__ void __launch_bounds__(PIX)
raster_backward(const float* __restrict__ pair_data,
                const int* __restrict__ tile_chunks,
                const float* __restrict__ meta,
                const float* __restrict__ out_saved,
                const float* __restrict__ g_out, OutT* __restrict__ grads,
                int p_cap, int G) {
  extern __shared__ float s_pairs[];
  __shared__ float s_red[NWARP][NGRAD][32];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Pixel q = pixel_of(t, meta);
  const int c0 = tile_chunks[t], c1 = tile_chunks[t + 1];

  // this pixel's cotangent and S_tot = sum_c g_c out_c
  float g[CH_PAD];
  float S_tot = 0.f;
  {
    const long o = static_cast<long>(t) * CH_PAD * PIX + threadIdx.x;
#pragma unroll
    for (int ch = 0; ch < CH_PAD; ++ch) {
      g[ch] = g_out[o + ch * PIX];
      S_tot += g[ch] * out_saved[o + ch * PIX];
    }
  }
  const float g_mag = fabsf(g[0]) + fabsf(g[1]) + fabsf(g[2]);

  float T = 1.0f;
  float prefix = 0.0f;  // sum of gw * w over the pairs so far
  for (int c = c0; c < c1; ++c) {
    if (!__syncthreads_or(T > T_EPS)) break;
    stage(s_pairs, pair_data, p_cap, G, c);
    __syncthreads();
    for (int base = 0; base < G; base += 32) {
      const int n = min(32, G - base);
      for (int j = 0; j < n; ++j) {
        const int i = base + j;
        const Cover cv = coverage(s_pairs, G, i, q);
        const float w = cv.alpha * T;
        float v[NGRAD];
        if (__any_sync(0xffffffffu, cv.alpha > 0.0f)) {
#define F(k) s_pairs[(k) * G + i]
          // lanes the pair does not cover may sit at z = -1: keep their md
          // finite, their gw * w must stay 0
          const float md = cv.alpha > 0.0f ? cv.z / (1.0f + cv.z) : 0.0f;
          const float gw = F(PK_RGB) * g[0] + F(PK_RGB + 1) * g[1] +
                           F(PK_RGB + 2) * g[2] + g[4] +
                           F(PK_NRM) * g[5] + F(PK_NRM + 1) * g[6] +
                           F(PK_NRM + 2) * g[7] + F(PK_FLOW) * g[9] +
                           F(PK_FLOW + 1) * g[10] + g[3] * cv.z +
                           g[11] * md + g[12] * md * md;
          prefix += gw * w;
          const float S_after = S_tot - prefix;
          const float one_minus = fmaxf(1.0f - cv.alpha, 1.0f - MAX_ALPHA);
          const float da = T * gw - S_after / one_minus;
          const float dmd_dz = (1.0f - md) * (1.0f - md);
          const float gmd = g[11] * w + g[12] * 2.0f * md * w;
          const float gz = g[3] * w + gmd * dmd_dz;
          const float da_live = cv.live ? da : 0.0f;
          const float drho = -0.5f * F(PK_OPAC) * cv.expval * da_live;
          const float gu = cv.sel3 ? drho * 2.0f * cv.u : 0.0f;
          const float gv = cv.sel3 ? drho * 2.0f * cv.v : 0.0f;
          const float k2 = -2.0f * FILTER_INV_SQUARE;
          const float gc2x = cv.sel3 ? 0.0f : drho * k2 * cv.dx;
          const float gc2y = cv.sel3 ? 0.0f : drho * k2 * cv.dy;
          const float gz_live = cv.live ? gz : 0.0f;
          const float gun = gu * cv.rcp, gvn = gv * cv.rcp;
          const float gden = -(gu * cv.u + gv * cv.v + gz_live * cv.z) * cv.rcp;
#undef F
          v[0] = gun * q.qx;  v[1] = gun * q.qy;  v[2] = gun;
          v[3] = gvn * q.qx;  v[4] = gvn * q.qy;  v[5] = gvn;
          v[6] = gden * q.qx; v[7] = gden * q.qy; v[8] = gden;
          v[9] = gz_live * cv.rcp;
          v[10] = gc2x;
          v[11] = gc2y;
          v[12] = cv.expval * da_live;
          v[13] = w * g[0];  v[14] = w * g[1];  v[15] = w * g[2];
          v[16] = w * g[5];  v[17] = w * g[6];  v[18] = w * g[7];
          v[19] = w * g[9];  v[20] = w * g[10];
          v[21] = w;
          v[22] = w * g_mag;
#pragma unroll
          for (int k = 0; k < NGRAD; ++k) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
          }
        } else {
          // no pixel of this warp is covered: every contribution is zero
          // (w = 0 and the live masks are off)
#pragma unroll
          for (int k = 0; k < NGRAD; ++k) v[k] = 0.0f;
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < NGRAD; ++k) s_red[warp][k][j] = v[k];
        }
        T = transmit(T, cv.alpha);
      }
      __syncthreads();
      for (int k = threadIdx.x; k < NGRAD * 32; k += PIX) {
        const int row = k >> 5, j = k & 31;
        if (j < n) {
          float sum = 0.0f;
#pragma unroll
          for (int w = 0; w < NWARP; ++w) sum += s_red[w][row][j];
          store(grads, static_cast<long>(row) * p_cap +
                           static_cast<long>(c) * G + base + j, sum);
        }
      }
      __syncthreads();
    }
  }
}

size_t pair_smem_bytes(int G) { return sizeof(float) * PK_PAD * G; }

}  // namespace

extern "C" {

const char* vm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the forward kernel on `stream`; returns cudaGetLastError().
int vm_raster_forward(const float* pair_data, const int* tile_chunks,
                      const float* meta, float* out, int num_tiles,
                      int p_cap, int chunk, void* stream) {
  const size_t smem = pair_smem_bytes(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      raster_forward, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_forward<<<num_tiles, PIX, smem, static_cast<cudaStream_t>(stream)>>>(
      pair_data, tile_chunks, meta, out, p_cap, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward kernel on `stream`; grads is float32 or, with
// out_bf16, bfloat16 (PK_PAD, p_cap) and must arrive zeroed.
int vm_raster_backward(const float* pair_data, const int* tile_chunks,
                       const float* meta, const float* out_saved,
                       const float* g_out, void* grads, int out_bf16,
                       int num_tiles, int p_cap, int chunk, void* stream) {
  const size_t smem = pair_smem_bytes(chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_bf16) {
    err = cudaFuncSetAttribute(raster_backward<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    raster_backward<__nv_bfloat16><<<num_tiles, PIX, smem, s>>>(
        pair_data, tile_chunks, meta, out_saved, g_out,
        static_cast<__nv_bfloat16*>(grads), p_cap, chunk);
  } else {
    err = cudaFuncSetAttribute(raster_backward<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    raster_backward<float><<<num_tiles, PIX, smem, s>>>(
        pair_data, tile_chunks, meta, out_saved, g_out,
        static_cast<float*>(grads), p_cap, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
