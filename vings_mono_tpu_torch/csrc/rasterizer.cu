// 2DGS tile rasterizer for Hopper (sm_90a): forward and backward kernels.
//
// Replaces the Pallas TPU kernels of vings_mono_tpu/ops/rasterizer/
// tile_kernel.py: `raster_forward` does what `_fwd_kernel` (driven by
// `rasterize_forward`) does, `raster_backward` what `_bwd_kernel` /
// `_bwd_chunk_body` (driven by `rasterize_backward`) do. The plain PyTorch
// twins and the math are in vings_mono_tpu_torch/ops/rasterizer/
// tile_kernel.py.
//
// Frame. One block per 16x16 tile, one thread per pixel (256 threads). The
// TPU walks (tile, chunk) steps in order on one core and carries the
// transmittance across steps in VMEM scratch; here the block loops over its
// own tile's chunks (`tile_chunks[t] .. tile_chunks[t+1]`) and each thread
// keeps its pixel's transmittance in a register. Before each chunk the
// block decides early termination with __syncthreads_or(T > T_EPS) — the
// TPU's `max(carry) > T_EPS` — and the backward makes exactly the forward's
// decision because both inline the same `coverage()` and `transmit()`,
// written with explicitly rounded intrinsics that the compiler cannot
// contract differently in the two kernels.
//
// What bounds it on the H100. The binning gives a tile every surfel whose
// 3-sigma radius reaches it, and the binning is cached while the surfels
// move, so most (pair, pixel) evaluations of a chunk hit nothing: on the
// mapper's trained map about one in eight is covered. The work that cannot
// be avoided — the covered evaluations at 67 TFLOP/s f32, the blended
// chunks' pair data, the images and the gradient rows at 3.35 TB/s — is
// tens of microseconds, a little more in bytes than in operations, so
// everything above that is instruction slots and shared-memory reads spent
// on evaluations that hit nothing, on the backward's reduction over pixels
// and on waiting for staged data. The design goes after those (the time
// after each step is in PERF.md):
//
//  * Cull. After a chunk is staged one thread per pair computes, from the
//    pair data alone, the region outside which alpha is exactly 0:
//    alpha > 0 needs rho <= r2 = 2 ln(255 opac) with rho = min(rho3d,
//    rho2d). rho2d <= r2 is a disc round the screen center; rho3d <= r2 is
//    the conic d^T Q d <= 0 with Q = M^T diag(1, 1, -r2) M, M's rows the
//    packed w_u, w_v, n, whose axis-aligned box follows from adj(Q) (the
//    construction 2DGS uses for its bounding box). A pair whose conic is
//    not a well-conditioned ellipse, or whose numbers are not finite, is
//    not culled. A warp's pixel block, widened by CULL_MARGIN, is kept if
//    it meets the disc's rectangle, or the conic's rectangle and the
//    ellipse itself (the least of its quadratic form over the block):
//    an 8-bit mask of the warps the pair can touch.
//  * Compaction. A warp is an 8x4 block of pixels. Per 32 pairs it ballots
//    its own mask bit and walks only the set bits, in order. A culled pair
//    has alpha = 0 at every pixel of the warp and leaves T untouched, so
//    transmittance, termination and every sum are the unculled kernel's,
//    bit for bit.
//  * Transpose-reduce (backward). The 23 per-lane values of a pair are
//    summed over the warp with a transposing butterfly: each step halves
//    the rows a lane holds, 12 + 6 + 3 + 2 + 1 = 24 shuffles instead of
//    23 x 5, and 23 lanes then store one row each. The eight warps' rows
//    meet in shared memory, 32 pairs at a time in two alternating buffers
//    (one block barrier per 32 pairs), and are summed in warp order 0..7,
//    skipping the warps whose mask bit is off: the result is bitwise the
//    same on every launch. Each pair belongs to one tile, so no atomics.
//  * Staging, asynchronous and pair-major. cp.async copies bring chunk
//    c + 1 into the second shared-memory buffer while the block blends
//    chunk c, and transpose it on the way to [pair][field]: every lane of a
//    warp reads the same pair, so a visit costs 4 to 6 broadcast loads of
//    16 bytes instead of 13 to 21 of 4.
//  * The forward computes the coverage of two pairs side by side (it does
//    not depend on T) and blends them in order.
//
// Not taken: coverage with FMAs, ex2.approx and rcp.approx is faster
// still but moves a few evaluations across the alpha threshold, a step of
// 1/255 in alpha, which the tolerance against the plain twin does not
// allow.
//
// Built with -DVM_CULL=0 every warp visits every pair: the reference that
// chip_smoke.py holds the cull against, bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef VM_CULL
#define VM_CULL 1         // 0: no cull, every warp visits every pair
#endif

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NWARP = PIX / 32;
constexpr int BW = 8;                // a warp's pixel block is BW x BH
constexpr int BH = 32 / BW;
constexpr int WPR = TILE / BW;       // warp blocks per tile row
constexpr int PK_PAD = 24;
constexpr int CH_PAD = 16;
constexpr int NGRAD = 23;            // 21 packed-field grads + 2 scores
constexpr int BATCH = 32;            // pairs per ballot and per reduction
constexpr int FWD_ILP = 2;           // pairs the forward covers side by side
constexpr int RED_STRIDE = 25;       // odd row stride: no bank conflicts
constexpr int RED_FLOATS = NWARP * BATCH * RED_STRIDE;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float MAX_ALPHA = 0.999f;
constexpr float MIN_HIT_Z = 0.05f;
constexpr float T_EPS = 1e-4f;
constexpr float CULL_MARGIN = 0.5f;  // pixels a warp's block is widened by
constexpr unsigned FULL = 0xffffffffu;

// packed field rows (vings_mono_tpu_torch/ops/rasterizer/projection.py)
constexpr int PK_WU = 0, PK_WV = 3, PK_N = 6, PK_CN = 9, PK_C2X = 10,
              PK_C2Y = 11, PK_OPAC = 12, PK_RGB = 13, PK_NRM = 16,
              PK_FLOW = 19;

struct Pixel {
  float qx, qy, px, py;
  int tp;  // position in the tile, row-major: the images' pixel index
};

__device__ __forceinline__ Pixel pixel_of(int tile, const float* meta) {
  const float fx = meta[0], fy = meta[1], cx = meta[2], cy = meta[3];
  const int ntx = static_cast<int>(meta[4]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = (warp % WPR) * BW + lane % BW;
  const int y = (warp / WPR) * BH + lane / BW;
  Pixel r;
  r.tp = y * TILE + x;
  r.px = static_cast<float>((tile % ntx) * TILE + x);
  r.py = static_cast<float>((tile / ntx) * TILE + y);
  r.qx = __fdiv_rn(__fsub_rn(r.px, cx), fx);
  r.qy = __fdiv_rn(__fsub_rn(r.py, cy), fy);
  return r;
}

// 1 / x to 1 ulp, one instruction where the IEEE reciprocal is a sequence.
// Only for values that no threshold is taken on, and whose range keeps
// clear of what it treats otherwise (denormals flush to zero): 1 + z of a
// covered pixel, above 1 + MIN_HIT_Z, and 1 - alpha, clamped to
// [1 - MAX_ALPHA, 1]. With __frcp_rn here the forward took 11 % and the
// backward 10 % longer on the H100 and came no closer to the plain twin.
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Pair i of a staged block into registers, p[k] = packed field k. The
// geometry (fields 0..12, and the rgb that shares a 16-byte piece with the
// opacity) is read for every visit, the features only where a pixel is
// covered. Every lane of a warp reads the same pair of the [pair][field]
// block, so each load is one broadcast of 16 bytes, 6 in all.
__device__ __forceinline__ void load_geometry(const float* s, int i,
                                              float (&p)[PK_PAD]) {
  const float4* row = reinterpret_cast<const float4*>(s + i * PK_PAD);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 x = row[k];
    p[4 * k] = x.x; p[4 * k + 1] = x.y; p[4 * k + 2] = x.z; p[4 * k + 3] = x.w;
  }
}

__device__ __forceinline__ void load_features(const float* s, int i,
                                              float (&p)[PK_PAD]) {
  const float4 x = reinterpret_cast<const float4*>(s + i * PK_PAD)[4];
  p[16] = x.x; p[17] = x.y; p[18] = x.z; p[19] = x.w;
  p[20] = s[i * PK_PAD + 20];
}

struct Cover {
  float alpha, z, u, v, rcp, expval, dx, dy;
  bool sel3, live;
};

// Ray-splat coverage of one pair (its geometry in p) at one pixel;
// identical rounding in both kernels. It is also the
// plain twin's rounding, operation by operation (separate multiplies and
// adds, the IEEE reciprocal, expf): alpha jumps from 0 to 1/255 at its
// threshold, and the plane numerators cancel for a small far surfel, so
// any other rounding (FMAs, rcp.approx, ex2.approx) moves a
// few of 10^8 evaluations across the threshold and the result away from
// the twin's by more than the tolerance it is held to.
__device__ __forceinline__ Cover coverage(const float (&p)[PK_PAD],
                                          const Pixel& q) {
#define F(k) p[k]
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
  c.rcp = __frcp_rn(den);
  c.u = __fmul_rn(u_num, c.rcp);
  c.v = __fmul_rn(v_num, c.rcp);
  c.z = __fmul_rn(F(PK_CN), c.rcp);
  c.dx = __fsub_rn(q.px, F(PK_C2X));
  c.dy = __fsub_rn(q.py, F(PK_C2Y));
  const float rho3d = __fadd_rn(__fmul_rn(c.u, c.u), __fmul_rn(c.v, c.v));
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

// The warps of tile (tx0, ty0) that pair i of the staged block can cover
// (bit w = warp w); the same formulas as `pair_block_mask` in
// tile_kernel.py. Every comparison is written so that a NaN leaves the
// pair unculled.
__device__ __forceinline__ unsigned warp_mask(const float* s, int i,
                                              float tx0, float ty0,
                                              const float* meta) {
#if !VM_CULL
  return 0xffu;
#else
  float p[PK_PAD];
  load_geometry(s, i, p);
#define F(k) p[k]
  const float opac = F(PK_OPAC);
  // a_raw = opac * expval <= opac: below the threshold nothing is covered
  if (!(opac >= ALPHA_EPS)) return 0u;
  float r2 = 2.0f * logf(255.0f * opac);
  r2 = fmaxf(r2, 0.0f) * (1.0f + 1e-5f) + 1e-5f;  // against rounding of exp
  // the screen-space filter: rho2d = 2 |p - c2|^2 <= r2
  const float rad = sqrtf(0.5f * r2);
  float x0 = F(PK_C2X) - rad, x1 = F(PK_C2X) + rad;
  float y0 = F(PK_C2Y) - rad, y1 = F(PK_C2Y) + rad;
  // the ray-splat part: box of the conic through adj(M) = [A B C]
  const float ux = F(PK_WU), uy = F(PK_WU + 1), uz = F(PK_WU + 2);
  const float vx = F(PK_WV), vy = F(PK_WV + 1), vz = F(PK_WV + 2);
  const float nx = F(PK_N), ny = F(PK_N + 1), nz = F(PK_N + 2);
  const float Ax = vy * nz - vz * ny, Ay = vz * nx - vx * nz,
              Az = vx * ny - vy * nx;                      // w_v x n
  const float Bx = ny * uz - nz * uy, By = nz * ux - nx * uz,
              Bz = nx * uy - ny * ux;                      // n x w_u
  const float Cx = uy * vz - uz * vy, Cy = uz * vx - ux * vz,
              Cz = ux * vy - uy * vx;                      // w_u x w_v
  const float det = ux * Ax + uy * Ay + uz * Az;
  const float uu = ux * ux + uy * uy + uz * uz;
  const float vv = vx * vx + vy * vy + vz * vz;
  const float nn = nx * nx + ny * ny + nz * nz;
  const float D = Cz * Cz - r2 * (Az * Az + Bz * Bz);
  const float Q00 = ux * ux + vx * vx - r2 * nx * nx;
  const float Q01 = ux * uy + vx * vy - r2 * nx * ny;
  const float Q11 = uy * uy + vy * vy - r2 * ny * ny;
  // an ellipse that stays clear of the camera plane, from a matrix that
  // is far from singular (edge-on surfels are not)
  bool ok = (det * det > 1e-8f * uu * vv * nn) && (nn > 1e-16f) &&
            (D > 0.01f * Cz * Cz) && (Q00 > 0.0f) && (Q11 > 0.0f);
  const float inv_D = 1.0f / D;
  const float qcx = (Cx * Cz - r2 * (Ax * Az + Bx * Bz)) * inv_D;
  const float qcy = (Cy * Cz - r2 * (Ay * Az + By * Bz)) * inv_D;
  const float k = fabsf(det) * inv_D * (1.0f + 1e-3f);
  const float hx = sqrtf(r2 * Q11) * k, hy = sqrtf(r2 * Q00) * k;
  const float fx = meta[0], fy = meta[1], cx = meta[2], cy = meta[3];
  const float bx0 = fx * (qcx - hx) + cx, bx1 = fx * (qcx + hx) + cx;
  const float by0 = fy * (qcy - hy) + cy, by1 = fy * (qcy + hy) + cy;
  ok = ok && (fabsf(bx0) < 1e30f) && (fabsf(bx1) < 1e30f) &&
       (fabsf(by0) < 1e30f) && (fabsf(by1) < 1e30f) &&
       (fabsf(x0) < 1e30f) && (fabsf(x1) < 1e30f) &&
       (fabsf(y0) < 1e30f) && (fabsf(y1) < 1e30f);
  if (!ok) return 0xffu;
  // the ellipse in pixels about its center e: S(p - e) <= K
  const float ex = fx * qcx + cx, ey = fy * qcy + cy;
  const float S00 = Q00 / (fx * fx), S01 = Q01 / (fx * fy),
              S11 = Q11 / (fy * fy);
  const float K = r2 * det * det * inv_D * (1.0f + 2e-3f);
  const float ky = -S01 / S11, kx = -S01 / S00;
#undef F
  unsigned m = 0u;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    // warp w's pixel block, widened against rounding
    const float X0 = tx0 + static_cast<float>((w % WPR) * BW) - CULL_MARGIN;
    const float X1 = X0 + static_cast<float>(BW - 1) + 2.0f * CULL_MARGIN;
    const float Y0 = ty0 + static_cast<float>((w / WPR) * BH) - CULL_MARGIN;
    const float Y1 = Y0 + static_cast<float>(BH - 1) + 2.0f * CULL_MARGIN;
    const bool disc = (x0 <= X1) && (x1 >= X0) && (y0 <= Y1) && (y1 >= Y0);
    const bool box = (bx0 <= X1) && (bx1 >= X0) && (by0 <= Y1) && (by1 >= Y0);
    // the least of the convex form over the block: 0 if the block holds
    // e, else on one of its four edges
    const float dx0 = X0 - ex, dx1 = X1 - ex, dy0 = Y0 - ey, dy1 = Y1 - ey;
    float least = 0.0f;
    if (!((dx0 <= 0.0f) && (dx1 >= 0.0f) && (dy0 <= 0.0f) && (dy1 >= 0.0f))) {
      const float ya = fminf(fmaxf(ky * dx0, dy0), dy1);
      const float yb = fminf(fmaxf(ky * dx1, dy0), dy1);
      const float xa = fminf(fmaxf(kx * dy0, dx0), dx1);
      const float xb = fminf(fmaxf(kx * dy1, dx0), dx1);
      least = fminf(
          fminf(S00 * dx0 * dx0 + 2.0f * S01 * dx0 * ya + S11 * ya * ya,
                S00 * dx1 * dx1 + 2.0f * S01 * dx1 * yb + S11 * yb * yb),
          fminf(S00 * xa * xa + 2.0f * S01 * xa * dy0 + S11 * dy0 * dy0,
                S00 * xb * xb + 2.0f * S01 * xb * dy1 + S11 * dy1 * dy1));
    }
    // written so that a NaN leaves the pair in
    const bool hit = disc || (box && !(least > K));
    m |= hit ? (1u << w) : 0u;
  }
  return m;
#endif
}

// Starts the copy of chunk c's (PK_PAD x G) block of the (PK_PAD, p_cap)
// pair data into s, transposed on the way to [pair][field] with 4-byte
// cp.async copies: a warp takes 8 pairs x 4 fields, so that it reads whole
// 32-byte sectors and its shared-memory writes meet two to a bank
// (G % 8 == 0).
__device__ __forceinline__ void stage(float* s, const float* pair_data,
                                      int p_cap, int G, int c) {
  const float* src = pair_data + static_cast<long>(c) * G;
  const int il = threadIdx.x & 7, fl = (threadIdx.x >> 3) & 3;
  const int pair_blocks = G >> 3;
  for (int b = threadIdx.x >> 5; b < pair_blocks * (PK_PAD / 4); b += NWARP) {
    const int i = (b % pair_blocks) * 8 + il, f = (b / pair_blocks) * 4 + fl;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(s + i * PK_PAD + f));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src + static_cast<long>(f) * p_cap + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Chunk c of the run c0..c1 becomes readable in its buffer, and chunk
// c + 1 starts on its way into the other one. Called by the whole block
// right after the barrier that ended the blending of chunk c - 1.
__device__ __forceinline__ const float* acquire(float* s_pairs,
                                                const float* pair_data,
                                                int p_cap, int G, int c,
                                                int c0, int c1) {
  if (c + 1 < c1) {
    stage(s_pairs + ((c + 1 - c0) & 1) * PK_PAD * G, pair_data, p_cap, G,
          c + 1);
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();
  return s_pairs + ((c - c0) & 1) * PK_PAD * G;
}

// shared memory: two pair buffers, the warp masks, (backward) two
// reduction buffers
__host__ __device__ constexpr size_t pair_floats(int G) {
  return 2 * static_cast<size_t>(PK_PAD) * G;
}

__global__ void __launch_bounds__(PIX, 4)
raster_forward(const float* __restrict__ pair_data,
               const int* __restrict__ tile_chunks,
               const float* __restrict__ meta, float* __restrict__ out,
               unsigned long long* __restrict__ counters, int p_cap, int G) {
  extern __shared__ __align__(16) float smem[];
  float* s_pairs = smem;
  unsigned* s_mask = reinterpret_cast<unsigned*>(smem + pair_floats(G));
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Pixel q = pixel_of(t, meta);
  const int ntx = static_cast<int>(meta[4]);
  const float tx0 = static_cast<float>((t % ntx) * TILE);
  const float ty0 = static_cast<float>((t / ntx) * TILE);
  const int c0 = tile_chunks[t], c1 = tile_chunks[t + 1];

  float T = 1.0f;
  float rgb0 = 0.f, rgb1 = 0.f, rgb2 = 0.f, dep = 0.f, acc = 0.f;
  float n0 = 0.f, n1 = 0.f, n2 = 0.f, fl0 = 0.f, fl1 = 0.f;
  float wm = 0.f, wm2 = 0.f;
  unsigned n_hit = 0, n_visit = 0, n_cand = 0;

  if (c0 < c1) stage(s_pairs, pair_data, p_cap, G, c0);
  for (int c = c0; c < c1; ++c) {
    // also the barrier that keeps the previous chunk's readers ahead of
    // the next staging writes and mask writes
    if (!__syncthreads_or(T > T_EPS)) break;
    const float* sp = acquire(s_pairs, pair_data, p_cap, G, c, c0, c1);
    for (int i = threadIdx.x; i < G; i += PIX)
      s_mask[i] = warp_mask(sp, i, tx0, ty0, meta);
    __syncthreads();
    for (int base = 0; base < G; base += BATCH) {
      const unsigned m = base + lane < G ? s_mask[base + lane] : 0u;
      unsigned bits = __ballot_sync(FULL, (m >> warp) & 1u);
      n_visit += __popc(bits);
      n_cand += min(BATCH, G - base);
      while (bits) {
        // the coverage of the next pairs does not depend on T: compute
        // them side by side, then blend them in order
        int idx[FWD_ILP];
        bool on[FWD_ILP];
        float p[FWD_ILP][PK_PAD];
        Cover cv[FWD_ILP];
#pragma unroll
        for (int u = 0; u < FWD_ILP; ++u) {
          on[u] = bits != 0u;
          idx[u] = on[u] ? base + __ffs(bits) - 1 : idx[0];
          bits &= bits - 1;
          load_geometry(sp, idx[u], p[u]);
          cv[u] = coverage(p[u], q);
        }
#pragma unroll
        for (int u = 0; u < FWD_ILP; ++u) {
          if (on[u] && cv[u].alpha > 0.0f) {
            load_features(sp, idx[u], p[u]);
            const float w = cv[u].alpha * T;
            const float md = cv[u].z * fast_rcp(1.0f + cv[u].z);
            const float wmd = w * md;
#define F(k) p[u][k]
            rgb0 += w * F(PK_RGB);
            rgb1 += w * F(PK_RGB + 1);
            rgb2 += w * F(PK_RGB + 2);
            dep += w * cv[u].z;
            acc += w;
            n0 += w * F(PK_NRM);
            n1 += w * F(PK_NRM + 1);
            n2 += w * F(PK_NRM + 2);
            fl0 += w * F(PK_FLOW);
            fl1 += w * F(PK_FLOW + 1);
            wm += wmd;
            wm2 += wmd * md;
#undef F
            ++n_hit;
            T = transmit(T, cv[u].alpha);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  float* o = out + static_cast<long>(t) * CH_PAD * PIX + q.tp;
  const float rows[CH_PAD] = {rgb0, rgb1, rgb2, dep, acc, n0,  n1,  n2,
                              0.f,  fl0,  fl1,  wm,  wm2, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ch = 0; ch < CH_PAD; ++ch) o[ch * PIX] = rows[ch];

  if (counters != nullptr) {
    // [0] covered (pair, pixel), [1] (pair, warp) visits after the cull,
    // [2] (pair, warp) of the blended chunks
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      n_hit += __shfl_xor_sync(FULL, n_hit, off);
    if (lane == 0) {
      atomicAdd(counters + 0, static_cast<unsigned long long>(n_hit));
      atomicAdd(counters + 1, static_cast<unsigned long long>(n_visit));
      atomicAdd(counters + 2, static_cast<unsigned long long>(n_cand));
    }
  }
}

__device__ __forceinline__ void store(float* g, long i, float x) { g[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* g, long i, float x) {
  g[i] = __float2bfloat16(x);
}

__device__ __forceinline__ float xsum(float keep, float send, int off) {
  return keep + __shfl_xor_sync(FULL, send, off);
}

// Sums each of v's 24 rows over the warp. Each step halves the rows a lane
// holds and hands the other half to the lane across; lane l ends with the
// total of row 3 * (l >> 2) + (l & 3), lanes with (l & 3) == 3 with nothing.
__device__ __forceinline__ float transpose_reduce(const float (&v)[24],
                                                  int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2,
             b0 = lane & 1;
  float a[12], b[6], c[3];
#pragma unroll
  for (int r = 0; r < 12; ++r)
    a[r] = xsum(b4 ? v[r + 12] : v[r], b4 ? v[r] : v[r + 12], 16);
#pragma unroll
  for (int r = 0; r < 6; ++r)
    b[r] = xsum(b3 ? a[r + 6] : a[r], b3 ? a[r] : a[r + 6], 8);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    c[r] = xsum(b2 ? b[r + 3] : b[r], b2 ? b[r] : b[r + 3], 4);
  const float d0 = xsum(b1 ? c[2] : c[0], b1 ? c[0] : c[2], 2);
  const float d1 = xsum(b1 ? 0.0f : c[1], b1 ? c[1] : 0.0f, 2);
  return xsum(b0 ? d1 : d0, b0 ? d0 : d1, 1);
}

template <typename OutT>
__global__ void __launch_bounds__(PIX, 3)
raster_backward(const float* __restrict__ pair_data,
                const int* __restrict__ tile_chunks,
                const float* __restrict__ meta,
                const float* __restrict__ out_saved,
                const float* __restrict__ g_out, OutT* __restrict__ grads,
                int p_cap, int G) {
  extern __shared__ __align__(16) float smem[];
  float* s_pairs = smem;
  unsigned* s_mask = reinterpret_cast<unsigned*>(smem + pair_floats(G));
  float* s_red = smem + pair_floats(G) + G;  // [2][NWARP][BATCH][RED_STRIDE]
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Pixel q = pixel_of(t, meta);
  const int ntx = static_cast<int>(meta[4]);
  const float tx0 = static_cast<float>((t % ntx) * TILE);
  const float ty0 = static_cast<float>((t / ntx) * TILE);
  const int c0 = tile_chunks[t], c1 = tile_chunks[t + 1];

  // this pixel's cotangent and S_tot = sum_c g_c out_c
  float g[CH_PAD];
  float S_tot = 0.f;
  {
    const long o = static_cast<long>(t) * CH_PAD * PIX + q.tp;
#pragma unroll
    for (int ch = 0; ch < CH_PAD; ++ch) {
      g[ch] = g_out[o + ch * PIX];
      S_tot += g[ch] * out_saved[o + ch * PIX];
    }
  }
  const float g_mag = fabsf(g[0]) + fabsf(g[1]) + fabsf(g[2]);

  float T = 1.0f;
  float prefix = 0.0f;  // sum of gw * w over the pairs so far
  int parity = 0;       // which reduction buffer this batch writes
  if (c0 < c1) stage(s_pairs, pair_data, p_cap, G, c0);
  for (int c = c0; c < c1; ++c) {
    if (!__syncthreads_or(T > T_EPS)) break;
    const float* sp = acquire(s_pairs, pair_data, p_cap, G, c, c0, c1);
    for (int i = threadIdx.x; i < G; i += PIX)
      s_mask[i] = warp_mask(sp, i, tx0, ty0, meta);
    __syncthreads();
    for (int base = 0; base < G; base += BATCH, parity ^= 1) {
      const int n = min(BATCH, G - base);
      float* red = s_red + parity * RED_FLOATS + warp * BATCH * RED_STRIDE;
      const unsigned m = lane < n ? s_mask[base + lane] : 0u;
      unsigned bits = __ballot_sync(FULL, (m >> warp) & 1u);
      while (bits) {
        const int j = __ffs(bits) - 1;
        const int i = base + j;
        bits &= bits - 1;
        float p[PK_PAD];
        load_geometry(sp, i, p);
        const Cover cv = coverage(p, q);
        if (!__any_sync(FULL, cv.alpha > 0.0f)) {
          // inside the rectangle, yet no pixel of this warp is covered:
          // every contribution is zero (w = 0 and the live masks are off)
          if (lane < NGRAD) red[j * RED_STRIDE + lane] = 0.0f;
          continue;
        }
        load_features(sp, i, p);
        const float w = cv.alpha * T;
        float v[24];
#define F(k) p[k]
        // lanes the pair does not cover may sit at z = -1: keep their md
        // finite, their gw * w must stay 0
        const float md = cv.alpha > 0.0f ? cv.z * fast_rcp(1.0f + cv.z) : 0.0f;
        const float gw = F(PK_RGB) * g[0] + F(PK_RGB + 1) * g[1] +
                         F(PK_RGB + 2) * g[2] + g[4] +
                         F(PK_NRM) * g[5] + F(PK_NRM + 1) * g[6] +
                         F(PK_NRM + 2) * g[7] + F(PK_FLOW) * g[9] +
                         F(PK_FLOW + 1) * g[10] + g[3] * cv.z +
                         g[11] * md + g[12] * md * md;
        prefix += gw * w;
        const float S_after = S_tot - prefix;
        const float one_minus = fmaxf(1.0f - cv.alpha, 1.0f - MAX_ALPHA);
        const float da = T * gw - S_after * fast_rcp(one_minus);
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
        v[23] = 0.0f;
        const float total = transpose_reduce(v, lane);
        const int row = 3 * (lane >> 2) + (lane & 3);
        if ((lane & 3) != 3 && row < NGRAD) red[j * RED_STRIDE + row] = total;
        T = transmit(T, cv.alpha);
      }
      // the batch's rows are in; the other buffer is free again once every
      // thread has passed this barrier, so one barrier per batch is enough
      __syncthreads();
      const float* all = s_red + parity * RED_FLOATS;
      for (int k = threadIdx.x; k < NGRAD * BATCH; k += PIX) {
        const int row = k >> 5, j = k & 31;
        const unsigned mj = j < n ? s_mask[base + j] : 0u;
        if (mj) {  // a pair no warp visited keeps the wrapper's zero
          float sum = 0.0f;
#pragma unroll
          for (int w = 0; w < NWARP; ++w)  // fixed order: deterministic
            if ((mj >> w) & 1u)
              sum += all[(w * BATCH + j) * RED_STRIDE + row];
          store(grads, static_cast<long>(row) * p_cap +
                           static_cast<long>(c) * G + base + j, sum);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

size_t forward_smem(int G) { return sizeof(float) * (pair_floats(G) + G); }
size_t backward_smem(int G) {
  return sizeof(float) * (pair_floats(G) + G + 2 * RED_FLOATS);
}

template <typename K>
cudaError_t attributes_of(K kernel, size_t smem, int* regs, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, PIX,
                                                       smem);
}

}  // namespace

extern "C" {

const char* vm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Registers per thread, resident blocks per SM and dynamic shared memory of
// kernel `which` (0 forward, 1 backward f32, 2 backward bf16) at this chunk.
int vm_raster_attributes(int which, int chunk, int* regs, int* blocks,
                         int* smem_bytes) {
  cudaError_t err;
  if (which == 0) {
    *smem_bytes = static_cast<int>(forward_smem(chunk));
    err = attributes_of(raster_forward, forward_smem(chunk), regs, blocks);
  } else {
    *smem_bytes = static_cast<int>(backward_smem(chunk));
    err = which == 1 ? attributes_of(raster_backward<float>,
                                     backward_smem(chunk), regs, blocks)
                     : attributes_of(raster_backward<__nv_bfloat16>,
                                     backward_smem(chunk), regs, blocks);
  }
  return static_cast<int>(err);
}

// Launches the forward kernel on `stream`; returns cudaGetLastError().
// counters is null or three zeroed 64-bit counts the kernel adds to.
int vm_raster_forward(const float* pair_data, const int* tile_chunks,
                      const float* meta, float* out,
                      unsigned long long* counters, int num_tiles, int p_cap,
                      int chunk, void* stream) {
  const size_t smem = forward_smem(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      raster_forward, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  raster_forward<<<num_tiles, PIX, smem, static_cast<cudaStream_t>(stream)>>>(
      pair_data, tile_chunks, meta, out, counters, p_cap, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward kernel on `stream`; grads is float32 or, with
// out_bf16, bfloat16 (PK_PAD, p_cap) and must arrive zeroed.
int vm_raster_backward(const float* pair_data, const int* tile_chunks,
                       const float* meta, const float* out_saved,
                       const float* g_out, void* grads, int out_bf16,
                       int num_tiles, int p_cap, int chunk, void* stream) {
  const size_t smem = backward_smem(chunk);
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
