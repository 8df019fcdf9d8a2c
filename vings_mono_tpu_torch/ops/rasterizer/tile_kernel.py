"""2DGS tile rasterizer: CUDA kernels for Hopper and their plain twins.

Two kernels, both in `csrc/rasterizer.cu`, replace the Pallas TPU kernels
of the JAX package:

* `rasterize_forward` replaces `_fwd_kernel` (vings_mono_tpu/ops/rasterizer/
  tile_kernel.py, `rasterize_forward`). For every 16x16 tile and its run of
  depth-sorted pairs it computes the ray-surfel coverage, blends front to
  back with the transmittance carried across chunks, stops the tile once
  every pixel has T < T_EPS, and writes 16 channel rows per pixel.
* `rasterize_backward` replaces `_bwd_kernel` / `_bwd_chunk_body` (same
  file). A single front-to-back replay per tile uses the suffix-sum
  identity

      dL/da_i = T_i * gw_i - S_i / (1 - a_i),
      S_i = sum_{k>i} gw_k w_k = S_tot - prefix_incl(gw * w),

  with S_tot = sum_c g_c * out_c per pixel from the saved forward output
  (every emitted channel is sum_i w_i f_i; the distortion channel is built
  outside the kernel). It emits per-pair gradients of the 21 packed fields
  plus the importance (sum w) and error (sum w |g_rgb|) scores.

Each wrapper runs its plain PyTorch twin for a tensor on the CPU and the
CUDA kernel for a tensor on a GPU; there is no fallback from one to the
other. Each wrapper counts its kernel launches in its `launches` attribute.

Channel layout (rows of the (T, CH_PAD, PIX) output):
  0:3 rgb, 3 sum w z, 4 alpha, 5:8 normal, 8 dist (zero, built in
  render.py), 9:11 flow, 11 wm = sum w m, 12 wm2 = sum w m^2 with
  m = z / (1 + z), 13:16 zero.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .projection import (ALPHA_EPS, FILTER_INV_SQUARE, PK_PAD, PK_WU, PK_WV,
                         PK_N, PK_CN, PK_C2X, PK_C2Y, PK_OPAC, PK_RGB,
                         PK_NRM, PK_FLOW)

TILE = 16
PIX = TILE * TILE          # 256 pixels per tile
CH_PAD = 16                # padded channel rows (13 used)
MAX_ALPHA = 0.999
MIN_HIT_Z = 0.05

# channel rows
CH_RGB = slice(0, 3)
CH_DEPTH = 3
CH_ALPHA = 4
CH_NRM = slice(5, 8)
CH_DIST = 8
CH_FLOW = slice(9, 11)
CH_WM = 11
CH_WM2 = 12

# early termination: once every pixel of a tile has transmittance below this,
# the tile's remaining (farther) chunks are skipped
T_EPS = 1e-4

# pair-gradient rows (match PK_* so callers can slice with the same names)
GR_PAD = PK_PAD            # 24 rows: grads for the 21 used packed fields
GR_SCORE_IMP = 21          # extra: sum_pix w   (importance score)
GR_SCORE_ERR = 22          # extra: sum_pix w * |g_rgb| (error score)

# f32 operations per (pair, pixel) in csrc/rasterizer.cu (an FMA counts two,
# exp, divide, compare and select one each): the coverage runs for every
# pair of a blended chunk at every pixel of the tile, the rest only where
# the pair covers the pixel (alpha > 0). The backward's count takes the
# 23-row reduction over pixels as one add per row, not the butterfly's
# five. These set the operation bound chip_smoke.py reports.
OPS_COVERAGE = 39
OPS_FWD_HIT = 26
OPS_BWD_HIT = 99


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _pixel_rays(tiles, ntx, meta):
    """Per-pixel ray coords for 16x16 tiles flattened to 256 lanes.

    tiles (n,) int64 tile ids; meta f32 (8,) = [fx, fy, cx, cy, ntx, ...].
    Returns qx, qy, px, py, each (n, 1, PIX)."""
    fx, fy, cx, cy = meta[0], meta[1], meta[2], meta[3]
    p = torch.arange(PIX, device=tiles.device)
    ty = (tiles // ntx).to(torch.float32)[:, None]
    tx = (tiles % ntx).to(torch.float32)[:, None]
    px = tx * TILE + (p % TILE).to(torch.float32)[None, :]
    py = ty * TILE + (p // TILE).to(torch.float32)[None, :]
    qx = (px - cx) / fx
    qy = (py - cy) / fy
    return qx[:, None], qy[:, None], px[:, None], py[:, None]


def _coverage(d, qx, qy, px, py):
    """alpha and z for chunks of pairs x 256 pixels.

    d (n, G, PK_PAD) pair-major; q*/p* (n, 1, PIX). Returns alpha, z
    (n, G, PIX) and the backward intermediates."""
    def col(i):
        return d[..., i:i + 1]

    u_num = col(PK_WU.start) * qx + col(PK_WU.start + 1) * qy \
        + col(PK_WU.start + 2)
    v_num = col(PK_WV.start) * qx + col(PK_WV.start + 1) * qy \
        + col(PK_WV.start + 2)
    den = col(PK_N.start) * qx + col(PK_N.start + 1) * qy + col(PK_N.start + 2)
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12),
                      den)
    rcp = 1.0 / den
    u = u_num * rcp
    v = v_num * rcp
    z = col(PK_CN) * rcp
    rho3d = u * u + v * v
    dx = px - col(PK_C2X)
    dy = py - col(PK_C2Y)
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    sel3 = rho3d < rho2d
    rho = torch.where(sel3, rho3d, rho2d)
    expval = torch.exp(-0.5 * rho)
    a_raw = col(PK_OPAC) * expval
    keep = (a_raw >= ALPHA_EPS) & (z > MIN_HIT_Z)
    alpha = torch.where(keep, torch.clamp(a_raw, max=MAX_ALPHA),
                        torch.zeros_like(a_raw))
    live = keep & (a_raw < MAX_ALPHA)
    return alpha, z, (u, v, rcp, expval, sel3, live, dx, dy)


def _excl_cumprod(x):
    """Exclusive cumprod along axis 1 and the total product (n, 1, PIX)."""
    incl = torch.cumprod(x, dim=1)
    excl = torch.cat([torch.ones_like(x[:, :1]), incl[:, :-1]], dim=1)
    return excl, incl[:, -1:]


def _md(z, alpha):
    """Contracted depth z / (1 + z) where the pair covers the pixel, else 0:
    an uncovered pair may sit at z = -1, where 0 * inf would poison the
    sums."""
    return torch.where(alpha > 0, z, torch.zeros_like(z)) / (
        1.0 + torch.where(alpha > 0, z, torch.zeros_like(z)))


class _ChunkSteps:
    """Walks the tiles' chunk runs in lock step: step j blends chunk j of
    every tile that has one and is not yet opaque (early termination as in
    the kernels: a tile stops once every pixel has T <= T_EPS)."""

    def __init__(self, pair_data, tile_chunks, meta, chunk):
        self.cs = tile_chunks[:-1].to(torch.int64)
        self.n = tile_chunks[1:].to(torch.int64) - self.cs
        self.chunk = chunk
        T = self.cs.shape[0]
        self.data = pair_data.reshape(PK_PAD, -1, chunk)
        self.ntx = int(meta[4].item())
        self.meta = meta
        self.carry = torch.ones((T, 1, PIX), dtype=torch.float32,
                                device=pair_data.device)
        self.n_max = int(self.n.max().item()) if T else 0

    def __iter__(self):
        for j in range(self.n_max):
            act = (self.n > j) & (self.carry.amax(dim=(1, 2)) > T_EPS)
            idx = torch.nonzero(act).squeeze(1)
            if idx.numel() == 0:
                return
            c = self.cs[idx] + j
            d = self.data[:, c, :].permute(1, 2, 0)       # (n, G, PK_PAD)
            rays = _pixel_rays(idx, self.ntx, self.meta)
            yield idx, c, d, rays


def forward_plain(pair_data, tile_chunks, meta, chunk):
    """Plain twin of the forward kernel. Returns (out, evals, hits): out is
    (T, CH_PAD, PIX), evals the (pair, pixel) coverage evaluations of the
    chunks blended before early termination and hits () the covered ones
    (alpha > 0) — the data-dependent work behind the kernels' bound."""
    T = tile_chunks.shape[0] - 1
    out = torch.zeros((T, CH_PAD, PIX), dtype=torch.float32,
                      device=pair_data.device)
    steps = _ChunkSteps(pair_data, tile_chunks, meta, chunk)
    evals, hits = 0, torch.zeros((), dtype=torch.int64,
                                 device=pair_data.device)
    for idx, _, d, (qx, qy, px, py) in steps:
        alpha, z, _ = _coverage(d, qx, qy, px, py)
        evals += alpha.numel()
        hits += torch.count_nonzero(alpha)
        T_excl, T_prod = _excl_cumprod(1.0 - alpha)
        w = alpha * T_excl * steps.carry[idx]             # (n, G, PIX)
        md = _md(z, alpha)
        wmd = w * md

        def feat(sl):
            return torch.einsum("ngc,ngp->ncp", d[..., sl], w)

        zero = torch.zeros_like(qx[:, 0:1, :].expand(-1, -1, PIX))
        acc = torch.cat([
            feat(PK_RGB),
            torch.sum(w * z, dim=1, keepdim=True),
            torch.sum(w, dim=1, keepdim=True),
            feat(PK_NRM),
            zero,
            feat(PK_FLOW),
            torch.sum(wmd, dim=1, keepdim=True),
            torch.sum(wmd * md, dim=1, keepdim=True),
            zero.expand(-1, CH_PAD - 13, -1),
        ], dim=1)
        out[idx] += acc
        steps.carry[idx] = steps.carry[idx] * T_prod
    return out, evals, hits


def backward_plain(pair_data, tile_chunks, meta, chunk, out_saved, g_out,
                   out_dtype=torch.float32):
    """Plain twin of the backward kernel: (GR_PAD, P_CAP) per-pair grads."""
    dev = pair_data.device
    grads = torch.zeros((GR_PAD, pair_data.shape[1]), dtype=torch.float32,
                        device=dev)
    gview = grads.view(GR_PAD, -1, chunk)
    # every emitted channel is sum_k w_k f_k, so S_tot = sum_c g_c out_c
    S_tot_all = torch.sum(g_out * out_saved, dim=1, keepdim=True)
    prefix_all = torch.zeros_like(S_tot_all)
    steps = _ChunkSteps(pair_data, tile_chunks, meta, chunk)
    for idx, c, d, (qx, qy, px, py) in steps:
        g = g_out[idx]                                    # (n, CH_PAD, PIX)
        alpha, z, (u, v, rcp, expval, sel3, live, ddx, ddy) = _coverage(
            d, qx, qy, px, py)
        T_excl, T_prod = _excl_cumprod(1.0 - alpha)
        T_run = T_excl * steps.carry[idx]
        w = alpha * T_run

        md = _md(z, alpha)
        g_depth = g[:, CH_DEPTH:CH_DEPTH + 1]
        g_wm = g[:, CH_WM:CH_WM + 1]
        g_wm2 = g[:, CH_WM2:CH_WM2 + 1]
        gw = (torch.einsum("ngc,ncp->ngp", d[..., PK_RGB], g[:, CH_RGB])
              + g[:, CH_ALPHA:CH_ALPHA + 1]
              + torch.einsum("ngc,ncp->ngp", d[..., PK_NRM], g[:, CH_NRM])
              + torch.einsum("ngc,ncp->ngp", d[..., PK_FLOW], g[:, CH_FLOW])
              + g_depth * z + g_wm * md + g_wm2 * md * md)

        prefix = torch.cumsum(gw * w, dim=1) + prefix_all[idx]
        S_after = S_tot_all[idx] - prefix
        one_minus = torch.clamp(1.0 - alpha, min=1.0 - MAX_ALPHA)
        da = T_run * gw - S_after / one_minus

        dmd_dz = (1.0 - md) * (1.0 - md)   # d/dz [z/(1+z)]
        gmd = g_wm * w + g_wm2 * 2.0 * md * w
        gz = g_depth * w + gmd * dmd_dz

        zero = torch.zeros_like(da)
        da_live = torch.where(live, da, zero)
        opac = d[..., PK_OPAC:PK_OPAC + 1]
        drho = -0.5 * opac * expval * da_live
        gu = torch.where(sel3, drho * 2.0 * u, zero)
        gv = torch.where(sel3, drho * 2.0 * v, zero)
        gc2x = torch.where(sel3, zero, drho * (-2.0 * FILTER_INV_SQUARE) * ddx)
        gc2y = torch.where(sel3, zero, drho * (-2.0 * FILTER_INV_SQUARE) * ddy)
        gopac_pix = expval * da_live

        gz_live = torch.where(live, gz, zero)
        gun = gu * rcp
        gvn = gv * rcp
        gden = -(gu * u + gv * v + gz_live * z) * rcp
        gcn = gz_live * rcp

        wg = torch.einsum("ngp,ncp->ngc", w, g)           # (n, G, CH_PAD)
        g_rgb_mag = torch.sum(torch.abs(g[:, CH_RGB]), dim=1, keepdim=True)

        def rays3(x):
            return [torch.sum(x * qx, -1), torch.sum(x * qy, -1),
                    torch.sum(x, -1)]

        rows = (rays3(gun) + rays3(gvn) + rays3(gden)
                + [torch.sum(gcn, -1), torch.sum(gc2x, -1),
                   torch.sum(gc2y, -1), torch.sum(gopac_pix, -1)]
                + list(wg[..., CH_RGB].unbind(-1))
                + list(wg[..., CH_NRM].unbind(-1))
                + list(wg[..., CH_FLOW].unbind(-1))
                + [torch.sum(w, -1), torch.sum(w * g_rgb_mag, -1)])
        gview[:GR_SCORE_ERR + 1, c, :] = torch.stack(rows, dim=0)

        steps.carry[idx] = steps.carry[idx] * T_prod
        prefix_all[idx] = prefix[:, -1:, :]
    return grads.to(out_dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_F32, _BF16 = torch.float32, torch.bfloat16


@functools.lru_cache(maxsize=None)
def _library():
    from ...utils import cuda_build
    lib = cuda_build.load("rasterizer")
    _declare(lib)
    return lib


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(pair_data, tile_chunks, meta, chunk):
    dev = pair_data.device
    if dev.type != "cuda":
        raise ValueError(f"no rasterizer for device {dev}")
    p_cap = pair_data.shape[1]
    if chunk <= 0 or p_cap % chunk:
        raise ValueError(f"chunk {chunk} does not divide p_cap {p_cap}")
    _check(pair_data, "pair_data", _F32, (PK_PAD, p_cap), dev)
    if tile_chunks.ndim != 1:
        raise ValueError("tile_chunks must be 1-D (T+1,)")
    _check(tile_chunks, "tile_chunks", torch.int32, tile_chunks.shape, dev)
    _check(meta, "meta", _F32, (8,), dev)
    return dev, p_cap, tile_chunks.shape[0] - 1


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.vm_cuda_error_string(err).decode()}")


def rasterize_forward(pair_data, tile_chunks, meta, chunk):
    """pair_data (PK_PAD, P_CAP) f32 tile-grouped; tile_chunks (T+1,) int32
    chunk runs; meta f32 (8,) = [fx, fy, cx, cy, ntx, 0, 0, 0].
    Returns (T, CH_PAD, PIX) f32."""
    if pair_data.device.type == "cpu":
        return forward_plain(pair_data, tile_chunks, meta, chunk)[0]
    dev, p_cap, T = _check_common(pair_data, tile_chunks, meta, chunk)
    out = torch.empty((T, CH_PAD, PIX), dtype=_F32, device=dev)
    if T == 0:
        return out
    lib = _library()
    err = lib.vm_raster_forward(
        pair_data.data_ptr(), tile_chunks.data_ptr(), meta.data_ptr(),
        out.data_ptr(), T, p_cap, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "rasterize_forward launch")
    rasterize_forward.launches += 1
    return out


rasterize_forward.launches = 0


def rasterize_backward(pair_data, tile_chunks, meta, chunk, out_saved, g_out,
                       out_dtype=torch.float32):
    """Per-pair grads (GR_PAD, P_CAP) in out_dtype (float32 or bfloat16;
    bf16 halves the write and the pair->Gaussian gather, the per-pair math
    stays f32). out_saved, g_out (T, CH_PAD, PIX) f32."""
    if pair_data.device.type == "cpu":
        return backward_plain(pair_data, tile_chunks, meta, chunk,
                              out_saved, g_out, out_dtype)
    dev, p_cap, T = _check_common(pair_data, tile_chunks, meta, chunk)
    if out_dtype not in (_F32, _BF16):
        raise TypeError(f"out_dtype {out_dtype} not supported")
    _check(out_saved, "out_saved", _F32, (T, CH_PAD, PIX), dev)
    _check(g_out, "g_out", _F32, (T, CH_PAD, PIX), dev)
    # chunks the kernel does not blend (early termination, padding chunks
    # past the real chunk count) keep these zeros
    grads = torch.zeros((GR_PAD, p_cap), dtype=out_dtype, device=dev)
    if T == 0:
        return grads
    lib = _library()
    err = lib.vm_raster_backward(
        pair_data.data_ptr(), tile_chunks.data_ptr(), meta.data_ptr(),
        out_saved.data_ptr(), g_out.data_ptr(), grads.data_ptr(),
        int(out_dtype == _BF16), T, p_cap, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "rasterize_backward launch")
    rasterize_backward.launches += 1
    return grads


rasterize_backward.launches = 0


def _declare(lib):
    """ctypes signatures of csrc/rasterizer.cu's C interface."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vm_raster_forward.argtypes = [P, P, P, P, I, I, I, P]
    lib.vm_raster_forward.restype = I
    lib.vm_raster_backward.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
    lib.vm_raster_backward.restype = I
    lib.vm_cuda_error_string.argtypes = [I]
    lib.vm_cuda_error_string.restype = ctypes.c_char_p
