"""High-level differentiable 2DGS render: the equivalent of the reference's
`GaussianRasterizer(...)` call.

Pipeline:
  project_surfels (differentiable)
    -> bin_surfels (sort, non-differentiable, *cacheable per camera*)
    -> gather pair data + tile rasterization under one autograd Function
       (its backward is the tile backward kernel plus the pair->Gaussian
       reduction)
    -> unpack to image maps.

Returned dict mirrors the reference's `rets`: rgb (3,H,W), depth (1,H,W
expected depth), accum (1,H,W), normal (3,H,W, camera frame), dist
(1,H,W), flow (2,H,W), radii (N,), visible (N,), plus wm/wm2 aux rows.

Per-Gaussian (importance, error) scores flow through `score_carrier`: pass
a zeros (N, 2) tensor that requires grad; its gradient after a backward
pass holds the scores (reference `_zeros.grad`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .projection import PK_C2Y, Camera, ProjectedSurfels, project_surfels
from .binning import BinnedScene, bin_surfels, num_tiles, TILE
from .tile_kernel import (rasterize_forward, rasterize_backward, CH_PAD,
                          GR_SCORE_IMP, GR_SCORE_ERR)
from .naive import render_naive

IMPLS = ("tile", "naive")


def _unpack_tiles(out_tiles, height, width):
    """(T, CH_PAD, PIX) -> (CH_PAD, H, W)."""
    nty, ntx = num_tiles(height, width)
    x = out_tiles.reshape(nty, ntx, CH_PAD, TILE, TILE)
    x = x.permute(2, 0, 3, 1, 4).reshape(CH_PAD, nty * TILE, ntx * TILE)
    return x[:, :height, :width]


class _GatherRasterize(torch.autograd.Function):
    """Pair gather + tile rasterization; replaces `rasterize_pairs` and
    `_gather_rasterize` (custom VJPs) of the JAX package.

    Forward: gather pairs <- Gaussians in two hops through the
    depth-compacted (V_CAP + 1, 24) table (`compact = packed[sel]` plus an
    all-zeros row, then `compact[pair_idx]`); invalid pair slots index the
    zeros row. Backward: the tile backward kernel's per-pair grads reduce
    to Gaussians either exactly in f32 (`index_add_` over pair_idx, when
    grad_tbl is None) or, by default, as bf16 pair grads gathered K ways
    through the binning's inverse pair map `grad_tbl` and summed in f32
    (~2e-3 relative rounding). The result expands back through `sel`
    (unique rows, so the scatter is exact).

    score_carrier (N, 2) is all-zeros by contract: it contributes nothing
    forward, but its gradient is the per-Gaussian (importance, error)
    scores from the pair grads' rows 21/22."""

    @staticmethod
    def forward(ctx, packed, score_carrier, sel, pair_idx, grad_tbl,
                tile_chunks, meta, chunk):
        compact = torch.cat([packed[sel.long()],
                             packed.new_zeros((1, packed.shape[1]))])
        pair_data = compact[pair_idx.long()].T.contiguous()
        out = rasterize_forward(pair_data, tile_chunks, meta, chunk)
        ctx.save_for_backward(sel, pair_idx, grad_tbl, pair_data, out,
                              tile_chunks, meta)
        ctx.chunk = chunk
        ctx.n = packed.shape[0]
        return out

    @staticmethod
    def backward(ctx, g_out):
        (sel, pair_idx, grad_tbl, pair_data, out_saved, tile_chunks,
         meta) = ctx.saved_tensors
        bf16 = grad_tbl is not None
        grads = rasterize_backward(
            pair_data, tile_chunks, meta, ctx.chunk, out_saved,
            g_out.contiguous(),
            out_dtype=torch.bfloat16 if bf16 else torch.float32)
        g = grads.T                                        # (P, GR_PAD)
        V = sel.shape[0]
        if bf16:
            gp = torch.cat([g, g.new_zeros((1, g.shape[1]))])
            tbl = grad_tbl.long()
            seg = gp[tbl[:, 0]].float()
            for k in range(1, tbl.shape[1]):
                seg = seg + gp[tbl[:, k]].float()
        else:
            seg = torch.zeros((V + 1, g.shape[1]), dtype=torch.float32,
                              device=g.device)
            seg.index_add_(0, pair_idx.long(), g)
            seg = seg[:-1]
        full = torch.zeros((ctx.n, g.shape[1]), dtype=torch.float32,
                           device=g.device)
        full[sel.long()] = seg
        # the carrier's gradient is the score columns; projection's backward
        # never reads packed columns 21:23, so `full` serves both
        return (full, full[:, GR_SCORE_IMP:GR_SCORE_ERR + 1], None, None,
                None, None, None, None)


def camera_meta(camera: Camera, device):
    """The kernels' (8,) f32 camera block [fx, fy, cx, cy, ntx, 0, 0, 0]."""
    _, ntx = num_tiles(camera.height, camera.width)
    return torch.tensor([camera.fx, camera.fy, camera.cx, camera.cy,
                         float(ntx), 0.0, 0.0, 0.0], dtype=torch.float32,
                        device=device)


def rasterize_binned(packed, score_carrier, binned: BinnedScene,
                     camera: Camera):
    """Render pre-binned surfels. packed (N, PK_PAD) differentiable."""
    chunk = binned.pair_idx.shape[0] // binned.chunk_tile.shape[0]
    out_tiles = _GatherRasterize.apply(
        packed, score_carrier, binned.sel, binned.pair_idx, binned.grad_tbl,
        binned.tile_chunks, camera_meta(camera, packed.device), chunk)
    return _unpack_tiles(out_tiles, camera.height, camera.width)


def _channels_to_rets(ch, proj: ProjectedSurfels):
    alpha = ch[4:5]
    # clamp the alpha divisor: at barely-covered pixels 1/alpha explodes
    # the depth-loss gradient; pixels with alpha < 1e-3 carry no reliable
    # expected depth anyway
    depth = ch[3:4] / torch.clamp(alpha, min=1e-3)
    wm, wm2 = ch[11:12], ch[12:13]
    # 2DGS distortion sum_{i<j} w_i w_j (m_i - m_j)^2 == A*D2 - D1^2 from
    # the emitted totals (gradients flow through alpha/wm/wm2)
    dist = alpha * wm2 - wm * wm
    return {
        "rgb": ch[0:3],
        "depth": torch.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0),
        "accum": alpha,
        "normal": ch[5:8],          # camera frame
        "dist": dist,
        "flow": ch[9:11],
        "wm": wm,
        "wm2": wm2,
        "radii": torch.where(proj.visible, proj.radius,
                             torch.zeros_like(proj.radius)),
        "visible": proj.visible,
    }


def _detached(proj: ProjectedSurfels) -> ProjectedSurfels:
    return ProjectedSurfels(*(x.detach() for x in proj))


def band_camera(camera: Camera, h0, h1) -> Camera:
    """The camera of rows h0..h1-1: the principal point moves up by h0, so
    every pixel keeps its ray."""
    return camera._replace(cy=camera.cy - h0, height=h1 - h0)


def render(xyz, log_scale, quat, logit_opacity, rgb, camera: Camera, *,
           alive=None, flow=None, score_carrier=None,
           binned: Optional[BinnedScene] = None,
           p_cap: int = 1 << 21, chunk: int = 128, side: int = 5,
           v_cap: int = 0, tile_cap: int = 0, impl: str = "tile",
           grad_reduce: str = "bf16", rows=None):
    """Full differentiable render from raw Gaussian parameters.

    `binned` may be passed in to reuse a cached binning across training
    iterations on the same camera. grad_reduce selects the backward
    pair->Gaussian reduction: "bf16" (default) gathers bf16 pair grads
    through the binning's inverse pair map; "f32" keeps the exact
    index_add_ segment sum.

    impl "naive" renders every visible Gaussian at every pixel in plain
    PyTorch (naive.render_naive), as the JAX package's naive branch does:
    it ignores `binned` and the binning sizes, and, like that branch, it
    leaves `score_carrier` out of the graph, so the scores are zero.

    rows = (h0, h1), h0 a multiple of 16, renders rows h0..h1-1 of the
    image alone: the visibility, the depth order and each tile's pairs are
    the whole image's, so a row band renders what those rows of the whole
    image would be (rets' maps are (C, h1 - h0, W); band_camera(camera,
    h0, h1) is their camera).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: one of {IMPLS}")
    if grad_reduce not in ("bf16", "f32"):
        raise ValueError(f"grad_reduce {grad_reduce!r}")
    proj = project_surfels(xyz, log_scale, quat, logit_opacity, rgb, camera,
                           alive=alive, flow=flow)
    packed, out_cam, tile_rows = proj.packed, camera, None
    if rows is not None:
        h0, h1 = rows
        if h0 % TILE or not 0 <= h0 < h1 <= camera.height:
            raise ValueError(f"rows {rows}: a band starts on a tile row")
        out_cam = band_camera(camera, h0, h1)
        # the screen centres in the band's rows
        shift = torch.zeros_like(packed[0])
        shift[PK_C2Y] = h0
        packed = packed - shift
        tile_rows = (h0 // TILE, -(-h1 // TILE))
    if impl == "naive":
        # stable, as jnp.argsort: equal depths keep their index order
        order = torch.argsort(torch.where(
            proj.visible, proj.depth, torch.full_like(proj.depth, math.inf)),
            stable=True)
        ch = render_naive(packed, order, proj.visible[order], out_cam)
        return _channels_to_rets(ch, proj)
    if score_carrier is None:
        score_carrier = torch.zeros((xyz.shape[0], 2), dtype=torch.float32,
                                    device=xyz.device)
    if binned is None:
        binned = bin_surfels(_detached(proj), height=camera.height,
                             width=camera.width, p_cap=p_cap, chunk=chunk,
                             side=side, v_cap=v_cap, tile_cap=tile_cap,
                             tile_rows=tile_rows)
    if grad_reduce == "f32" and binned.grad_tbl is not None:
        binned = binned._replace(grad_tbl=None)
    ch = rasterize_binned(packed, score_carrier, binned, out_cam)
    return _channels_to_rets(ch, proj)


@torch.no_grad()
def bin_for_camera(xyz, log_scale, quat, logit_opacity, rgb, camera: Camera,
                   *, alive=None, p_cap: int = 1 << 21, chunk: int = 128,
                   side: int = 5, v_cap: int = 0, tile_cap: int = 0,
                   need_grad: bool = True) -> BinnedScene:
    """Compute a cacheable binning for `camera` at the current parameters.

    need_grad=False skips the backward inverse pair map for forward-only
    consumers."""
    proj = project_surfels(xyz, log_scale, quat, logit_opacity, rgb, camera,
                           alive=alive)
    return bin_surfels(proj, height=camera.height, width=camera.width,
                       p_cap=p_cap, chunk=chunk, side=side, v_cap=v_cap,
                       tile_cap=tile_cap, need_grad=need_grad)
