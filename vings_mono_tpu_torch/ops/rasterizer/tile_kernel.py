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

What bounds them on the H100, and what the kernels do about it: the work
that cannot be avoided (the covered (pair, pixel) evaluations, the blended
chunks' pair data, the images, the gradient rows) is tens of microseconds;
the rest is instruction slots. Most evaluations of a chunk hit nothing, so
each kernel first culls: one thread per pair computes the ellipse and the
disc outside which alpha is exactly 0 (`pair_pixel_bounds` and
`pair_block_mask` are the same formulas in PyTorch), each warp, an 8x4
block of pixels, keeps only the pairs that reach it (ballot, in order) and
blends those. A culled pair has alpha = 0 at every pixel of the warp, so
the result is the unculled one.
The backward sums a pair's 23 rows over a warp with a transposing
butterfly (24 shuffles instead of 115) and over the eight warps in a fixed
order through shared memory, so two launches give bitwise equal gradients.
Chunks are staged with `cp.async` copies, the next chunk in flight while
the current one is blended, and transposed on the way to [pair][field], so
that a warp reads a pair in 16-byte broadcasts. The coverage rounds as the
plain twin's does, operation by operation: alpha steps from 0 to 1/255 at
its threshold, and the twins are held to 1e-4.

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

# f32 operations per covered (pair, pixel) in csrc/rasterizer.cu (an FMA
# counts two; exp, reciprocal, compare, min and select one each): the
# coverage, then what the forward adds for a covered pixel (weights, 11
# accumulations, the transmittance), or the backward (gw, the suffix-sum
# identity, 23 contributions, one add per row for the sum over pixels).
# Evaluations that cover nothing are work a kernel can avoid, so the bound
# chip_smoke.py reports counts the covered ones only.
OPS_COVERAGE = 37
OPS_FWD_HIT = 29
OPS_BWD_HIT = 114


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


# the cull widens what it tests by this many pixels against rounding
CULL_MARGIN = 0.5


def _cull_terms(pair_data, meta):
    """What the cull of csrc/rasterizer.cu (`warp_mask`) computes per pair,
    in PyTorch. pair_data (PK_PAD, ...) f32, meta the kernels' camera block.

    alpha > 0 needs opac * exp(-rho / 2) >= 1/255, that is rho <= r2 =
    2 ln(255 opac), with rho = min(rho3d, rho2d): the union of the disc
    rho2d = 2 |p - c2|^2 <= r2 and the conic rho3d <= r2, d^T Q d <= 0 for
    d = (qx, qy, 1) and Q = M^T diag(1, 1, -r2) M, M's rows w_u, w_v, n.
    With adj(M) = [A B C] = [w_v x n, n x w_u, w_u x w_v] and D = C_z^2 -
    r2 (A_z^2 + B_z^2) the conic is the ellipse (q - e)^T Q_xy (q - e) <=
    r2 det(M)^2 / D about e = (C_x C_z - r2 (A_x A_z + B_x B_z)) / D (and
    y alike), with half width sqrt(r2 Q_yy) |det M| / D. It is used only
    where Q is a well-conditioned ellipse clear of the camera plane
    (`ok`); everywhere else the pair is not culled.

    Returns covers (opac reaches the threshold at all), ok, the disc's and
    the conic's rectangles (x0, x1, y0, y1, pixels, not widened) and the
    ellipse in pixels (ex, ey, S00, S01, S11, K): S(p - e) <= K."""
    opac = pair_data[PK_OPAC]
    r2 = 2.0 * torch.log(255.0 * opac.clamp(min=ALPHA_EPS))
    r2 = r2.clamp(min=0.0) * (1.0 + 1e-5) + 1e-5
    rad = torch.sqrt(0.5 * r2)
    c2x, c2y = pair_data[PK_C2X], pair_data[PK_C2Y]
    wu, wv, n = pair_data[PK_WU], pair_data[PK_WV], pair_data[PK_N]
    A = torch.linalg.cross(wv, n, dim=0)
    B = torch.linalg.cross(n, wu, dim=0)
    C = torch.linalg.cross(wu, wv, dim=0)
    det = (wu * A).sum(0)
    uu, vv, nn = (wu * wu).sum(0), (wv * wv).sum(0), (n * n).sum(0)
    D = C[2] * C[2] - r2 * (A[2] * A[2] + B[2] * B[2])
    Q00 = wu[0] * wu[0] + wv[0] * wv[0] - r2 * n[0] * n[0]
    Q01 = wu[0] * wu[1] + wv[0] * wv[1] - r2 * n[0] * n[1]
    Q11 = wu[1] * wu[1] + wv[1] * wv[1] - r2 * n[1] * n[1]
    ok = ((det * det > 1e-8 * uu * vv * nn) & (nn > 1e-16)
          & (D > 0.01 * C[2] * C[2]) & (Q00 > 0) & (Q11 > 0))
    inv_D = 1.0 / D
    qcx = (C[0] * C[2] - r2 * (A[0] * A[2] + B[0] * B[2])) * inv_D
    qcy = (C[1] * C[2] - r2 * (A[1] * A[2] + B[1] * B[2])) * inv_D
    k = det.abs() * inv_D * (1.0 + 1e-3)
    hx = torch.sqrt(r2 * Q11) * k
    hy = torch.sqrt(r2 * Q00) * k
    fx, fy, cx, cy = meta[0], meta[1], meta[2], meta[3]
    disc = (c2x - rad, c2x + rad, c2y - rad, c2y + rad)
    box = (fx * (qcx - hx) + cx, fx * (qcx + hx) + cx,
           fy * (qcy - hy) + cy, fy * (qcy + hy) + cy)
    for b in disc + box:
        ok = ok & (b.abs() < 1e30)      # also false for NaN
    ellipse = (fx * qcx + cx, fy * qcy + cy, Q00 / (fx * fx),
               Q01 / (fx * fy), Q11 / (fy * fy),
               r2 * det * det * inv_D * (1.0 + 2e-3))
    covers = opac >= ALPHA_EPS          # a_raw = opac * expval <= opac
    return covers, ok, disc, box, ellipse


def pair_pixel_bounds(pair_data, meta):
    """Per pair a pixel rectangle x0 <= px <= x1, y0 <= py <= y1 outside
    which `_coverage` gives alpha = 0: the disc's and the conic's
    rectangles of `_cull_terms` joined and widened by CULL_MARGIN. Returns
    (x0, x1, y0, y1), each of pair_data's trailing shape; (-inf, inf, -inf,
    inf) where the pair is not culled, (inf, -inf, inf, -inf) where it
    covers nothing."""
    covers, ok, disc, box, _ = _cull_terms(pair_data, meta)
    inf = torch.full_like(disc[0], float("inf"))
    out = []
    for i, sign in enumerate((-1.0, 1.0, -1.0, 1.0)):
        b = torch.minimum(disc[i], box[i]) if sign < 0 else torch.maximum(
            disc[i], box[i])
        b = torch.where(ok, b + sign * CULL_MARGIN, sign * inf)
        out.append(torch.where(covers, b, -sign * inf))
    return tuple(out)


def pair_block_mask(pair_data, meta, x_lo, x_hi, y_lo, y_hi):
    """Whether a pair can cover any pixel of the block x_lo <= px <= x_hi,
    y_lo <= py <= y_hi (tensors that broadcast against pair_data's trailing
    shape): the kernels' cull, `warp_mask`'s bit for a warp's 8x4 block.
    The block, widened by CULL_MARGIN, must meet the disc's rectangle, or
    the conic's rectangle and the ellipse itself: the least value of the
    convex form S(p - e) over the block is 0 if the block holds e, else it
    lies on one of the four edges. A NaN anywhere leaves the pair in."""
    covers, ok, disc, box, (ex, ey, S00, S01, S11, K) = _cull_terms(
        pair_data, meta)
    X0, X1 = x_lo - CULL_MARGIN, x_hi + CULL_MARGIN
    Y0, Y1 = y_lo - CULL_MARGIN, y_hi + CULL_MARGIN

    def meets(r):
        return (r[0] <= X1) & (r[1] >= X0) & (r[2] <= Y1) & (r[3] >= Y0)

    dx0, dx1, dy0, dy1 = X0 - ex, X1 - ex, Y0 - ey, Y1 - ey
    ky, kx = -S01 / S11, -S01 / S00

    def edge_x(dx):
        y = torch.minimum(torch.maximum(ky * dx, dy0), dy1)
        return S00 * dx * dx + 2.0 * S01 * dx * y + S11 * y * y

    def edge_y(dy):
        x = torch.minimum(torch.maximum(kx * dy, dx0), dx1)
        return S00 * x * x + 2.0 * S01 * x * dy + S11 * dy * dy

    least = torch.minimum(torch.minimum(edge_x(dx0), edge_x(dx1)),
                          torch.minimum(edge_y(dy0), edge_y(dy1)))
    holds_e = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    least = torch.where(holds_e, torch.zeros_like(least), least)
    return covers & (~ok | meets(disc) | (meets(box) & ~(least > K)))


def _coverage(d, qx, qy, px, py, meta=None):
    """alpha and z for chunks of pairs x 256 pixels.

    d (n, G, PK_PAD) pair-major; q*/p* (n, 1, PIX). Returns alpha, z
    (n, G, PIX) and the backward intermediates. With meta, alpha is also
    zeroed where `pair_block_mask` keeps the pair out of the pixel's 8x4
    block, as the kernels' cull does; that changes nothing if the cull is
    right."""
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
    if meta is not None:
        # the pixel's 8x4 block, as the kernels lay warps over a tile
        bx, by = torch.floor(px / 8.0) * 8.0, torch.floor(py / 4.0) * 4.0
        inside = pair_block_mask(d.movedim(-1, 0)[..., None], meta, bx,
                                 bx + 7.0, by, by + 3.0)
        alpha = torch.where(inside, alpha, torch.zeros_like(alpha))
        live = live & inside
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


def forward_plain(pair_data, tile_chunks, meta, chunk, cull=False,
                  near_rel=None):
    """Plain twin of the forward kernel. Returns (out, evals, hits): out is
    (T, CH_PAD, PIX), evals the (pair, pixel) coverage evaluations of the
    chunks blended before early termination and hits () the covered ones
    (alpha > 0) — the data-dependent work behind the kernels' bound. With
    cull, alpha is zeroed where `pair_block_mask` is off first. With near_rel,
    a fourth value counts the evaluations that sit within that relative
    distance of a coverage threshold (opac * expval at ALPHA_EPS, z at
    MIN_HIT_Z), where another rounding of exp or 1/x may decide otherwise."""
    T = tile_chunks.shape[0] - 1
    out = torch.zeros((T, CH_PAD, PIX), dtype=torch.float32,
                      device=pair_data.device)
    steps = _ChunkSteps(pair_data, tile_chunks, meta, chunk)
    evals, hits = 0, torch.zeros((), dtype=torch.int64,
                                 device=pair_data.device)
    near = torch.zeros_like(hits)
    for idx, _, d, (qx, qy, px, py) in steps:
        alpha, z, rest = _coverage(d, qx, qy, px, py, meta if cull else None)
        evals += alpha.numel()
        hits += torch.count_nonzero(alpha)
        if near_rel is not None:
            a_raw = d[..., PK_OPAC:PK_OPAC + 1] * rest[3]
            near += torch.count_nonzero(
                ((a_raw - ALPHA_EPS).abs() <= near_rel * ALPHA_EPS)
                | ((z - MIN_HIT_Z).abs() <= near_rel * MIN_HIT_Z))
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
    if near_rel is not None:
        return out, evals, hits, near
    return out, evals, hits


def backward_plain(pair_data, tile_chunks, meta, chunk, out_saved, g_out,
                   out_dtype=torch.float32, cull=False):
    """Plain twin of the backward kernel: (GR_PAD, P_CAP) per-pair grads.
    With cull, alpha is zeroed where `pair_block_mask` is off first."""
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
            d, qx, qy, px, py, meta if cull else None)
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


# csrc/rasterizer.cu built so that every warp visits every pair: what the
# kernels' cull is checked against
NO_CULL = ("VM_CULL=0",)


@functools.lru_cache(maxsize=None)
def _library(cull=True):
    from ...utils import cuda_build
    lib = cuda_build.load("rasterizer", () if cull else NO_CULL)
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
    # the kernels stage a chunk 8 pairs x 4 fields at a time
    if chunk % 8:
        raise ValueError(f"chunk {chunk} is not a multiple of 8")
    return dev, p_cap, tile_chunks.shape[0] - 1


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.vm_cuda_error_string(err).decode()}")


def rasterize_forward(pair_data, tile_chunks, meta, chunk, counters=None,
                      cull=True):
    """pair_data (PK_PAD, P_CAP) f32 tile-grouped; tile_chunks (T+1,) int32
    chunk runs; meta f32 (8,) = [fx, fy, cx, cy, ntx, 0, 0, 0].
    Returns (T, CH_PAD, PIX) f32.

    counters, for checks only and only on a GPU: a zeroed int64 (3,) tensor
    to which the kernel adds the covered (pair, pixel) evaluations, the
    (pair, warp) visits its cull left and the (pair, warp) visits of the
    blended chunks without a cull. cull=False, likewise, launches the
    kernel built without its cull, which must give the same bits."""
    if pair_data.device.type == "cpu":
        if counters is not None or not cull:
            raise ValueError("counters and cull are the CUDA kernel's")
        return forward_plain(pair_data, tile_chunks, meta, chunk)[0]
    dev, p_cap, T = _check_common(pair_data, tile_chunks, meta, chunk)
    if counters is not None:
        _check(counters, "counters", torch.int64, (3,), dev)
    out = torch.empty((T, CH_PAD, PIX), dtype=_F32, device=dev)
    if T == 0:
        return out
    lib = _library(cull)
    err = lib.vm_raster_forward(
        pair_data.data_ptr(), tile_chunks.data_ptr(), meta.data_ptr(),
        out.data_ptr(), None if counters is None else counters.data_ptr(),
        T, p_cap, chunk, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "rasterize_forward launch")
    rasterize_forward.launches += 1
    return out


rasterize_forward.launches = 0


def rasterize_backward(pair_data, tile_chunks, meta, chunk, out_saved, g_out,
                       out_dtype=torch.float32, cull=True):
    """Per-pair grads (GR_PAD, P_CAP) in out_dtype (float32 or bfloat16;
    bf16 halves the write and the pair->Gaussian gather, the per-pair math
    stays f32). out_saved, g_out (T, CH_PAD, PIX) f32. cull=False, for
    checks only and only on a GPU, launches the kernel built without its
    cull."""
    if pair_data.device.type == "cpu":
        if not cull:
            raise ValueError("cull is the CUDA kernel's")
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
    lib = _library(cull)
    err = lib.vm_raster_backward(
        pair_data.data_ptr(), tile_chunks.data_ptr(), meta.data_ptr(),
        out_saved.data_ptr(), g_out.data_ptr(), grads.data_ptr(),
        int(out_dtype == _BF16), T, p_cap, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "rasterize_backward launch")
    rasterize_backward.launches += 1
    return grads


rasterize_backward.launches = 0


def kernel_attributes(chunk):
    """{kernel: {"registers", "blocks_per_sm", "smem_bytes"}} of the built
    kernels at this chunk size: registers per thread, resident blocks per
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and dynamic shared
    memory per block. Needs a GPU."""
    lib = _library()
    out = {}
    for which, name in enumerate(("rasterize_forward",
                                  "rasterize_backward_f32",
                                  "rasterize_backward_bf16")):
        regs, blocks, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = lib.vm_raster_attributes(which, chunk, ctypes.byref(regs),
                                       ctypes.byref(blocks),
                                       ctypes.byref(smem))
        _raise_on(lib, err, f"{name} attributes")
        out[name] = {"registers": regs.value, "blocks_per_sm": blocks.value,
                     "smem_bytes": smem.value}
    return out


def _declare(lib):
    """ctypes signatures of csrc/rasterizer.cu's C interface."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vm_raster_attributes.argtypes = [I, I, P, P, P]
    lib.vm_raster_attributes.restype = I
    lib.vm_raster_forward.argtypes = [P, P, P, P, P, I, I, I, P]
    lib.vm_raster_forward.restype = I
    lib.vm_raster_backward.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
    lib.vm_raster_backward.restype = I
    lib.vm_cuda_error_string.argtypes = [I]
    lib.vm_cuda_error_string.restype = ctypes.c_char_p
