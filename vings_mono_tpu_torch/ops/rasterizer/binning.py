"""Tile binning for the 2DGS rasterizer — plain PyTorch, non-differentiable.

Replaces the CUDA rasterizer's duplicate-keys + radix-sort binning stage
with a single fixed-capacity sort:

  1. every Gaussian emits up to KT = side*side (tile, gaussian) candidates
     covering its screen bbox (huge Gaussians are clamped to `side` tiles per
     axis — the mapper prunes radii > 25 px anyway),
  2. candidates get a single integer key (tile_id << RANK_BITS | depth_rank)
     and one sort groups them by tile, front-to-back within each tile,
  3. each tile's run is padded to a multiple of the kernel chunk size G so
     the tile kernels walk whole chunks.

All shapes are static: pair capacity P_CAP bounds the total duplicated pairs;
overflow is dropped from the far end (farthest Gaussians in the largest
tiles) and reported via `overflow` / `n_padded`.

Gaussians barely move during one keyframe's train iterations, so the
binning is computed once per (keyframe-window, camera) and reused across
iterations — pruning only flips alive masks, which zero contributions
without invalidating the pair lists.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .projection import PK_OPAC, ProjectedSurfels

TILE = 16
RANK_BITS = 20          # up to 2^20 visible Gaussians
INVALID_KEY = 0xFFFFFFFF


class BinnedScene(NamedTuple):
    # pair slots index into the depth-compacted table of the v_cap nearest
    # visible Gaussians (`sel` maps compact row -> original id); invalid
    # slots index the extra all-zeros row v_cap of that table.
    pair_idx: torch.Tensor    # (P_CAP,) int32 COMPACT row index per slot
    pair_valid: torch.Tensor  # (P_CAP,) bool
    sel: torch.Tensor         # (V_CAP,) int32 compact row -> original id
    chunk_tile: torch.Tensor  # (C_CAP,) int32 flat tile id per chunk
    chunk_first: torch.Tensor  # (C_CAP,) int32 bit0 first chunk, bit1 live
    n_chunks: torch.Tensor    # () int32 — real chunk count
    n_pairs: torch.Tensor     # () int32 — real pair count before padding
    overflow: torch.Tensor    # () bool — pair capacity exceeded
    # INVERSE pair map: pair slot of compact row v's candidate k, or P_CAP
    # (an all-zeros sentinel row of the grad table) when absent. The
    # backward pair->Gaussian reduction runs as a K-way gather-sum through
    # it. None when the binning was built with need_grad=False.
    grad_tbl: Optional[torch.Tensor] = None  # (V_CAP, K) int32
    # padded pair-slot demand pad_off[T]: the capacity a bucket must cover
    n_padded: Optional[torch.Tensor] = None  # () int32
    # port-only: chunk range of each tile, tile t owns chunks
    # [tile_chunks[t], tile_chunks[t+1]) (pad_off // chunk clamped to the
    # real chunk count) — a CUDA block walks its own tile's chunks from it
    tile_chunks: Optional[torch.Tensor] = None  # (T+1,) int32


def num_tiles(height, width, tile=TILE):
    return ((height + tile - 1) // tile, (width + tile - 1) // tile)


def _vsearch_left(a, v):
    """searchsorted(a, v, side='left'): first index where a[i] >= v, for
    sorted int arrays."""
    return torch.searchsorted(a, v.to(a.dtype), right=False).to(torch.int32)


@torch.no_grad()
def bin_surfels(proj: ProjectedSurfels, *, height: int, width: int,
                p_cap: int, chunk: int = 128, side: int = 5,
                tile: int = TILE, v_cap: int = 0,
                need_grad: bool = True, tile_cap: int = 0,
                tile_rows: Optional[tuple] = None) -> BinnedScene:
    """Build the tile-grouped pair list. See module docstring.

    v_cap > 0 compacts to the nearest v_cap visible Gaussians before
    candidate enumeration — the depth sort both culls and orders.
    tile_rows = (r0, r1) keeps the tile rows r0..r1-1 of the image alone,
    numbered from r0: each keeps the pairs it has in the whole image's
    binning (the side clamp of large bboxes is the whole image's too)."""
    dev = proj.packed.device
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    N = proj.packed.shape[0]
    nty, ntx = num_tiles(height, width, tile)
    r0, r1 = (0, nty) if tile_rows is None else tile_rows
    if not 0 <= r0 < r1 <= nty:
        raise ValueError(f"tile rows {r0}..{r1 - 1} of {nty}")
    T = (r1 - r0) * ntx
    if T >= (1 << (32 - RANK_BITS)):
        raise ValueError(f"{T} tiles do not fit the sort key")
    K = side * side
    c_cap = p_cap // chunk
    if v_cap <= 0 or v_cap > N:
        v_cap = N
    if v_cap > (1 << RANK_BITS):
        raise ValueError(f"v_cap {v_cap} exceeds 2^{RANK_BITS}")

    # ---- compact to the v_cap nearest visible Gaussians, depth-ordered
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.sort(torch.where(proj.visible, proj.depth, inf),
                       stable=True).indices
    sel = order[:v_cap]                              # row i == depth rank i

    aux = torch.cat([
        proj.center2d,                               # 0:2
        proj.cov2d,                                  # 2:5
        proj.packed[:, PK_OPAC:PK_OPAC + 1],         # 5
        proj.visible[:, None].to(f32),               # 6
    ], dim=1)[sel]                                   # (V, 7)
    visible = aux[:, 6] > 0.5

    # ---- candidate tiles per Gaussian (bbox clamped to side x side) from
    # the anisotropic per-axis extents and an opacity-aware cutoff
    # (alpha = opac*exp(-q/2) >= 1/255 bounds the footprint at
    # q_cut = 2 ln(255 opac)); the exact ellipse/rect test below drops the
    # bbox tiles the ellipse doesn't touch
    px, py = aux[:, 0], aux[:, 1]
    s00 = torch.clamp(aux[:, 2], min=1e-8)
    s01 = aux[:, 3]
    s11 = torch.clamp(aux[:, 4], min=1e-8)
    opac = aux[:, 5]
    q_cut = torch.clamp(2.0 * torch.log(torch.clamp(opac, min=1e-6) * 255.0),
                        min=0.05)
    sig = torch.sqrt(q_cut)
    # coverage is min(rho3d, 2 d^2): the low-pass filter alone reaches
    # d = sqrt(q_cut/2) <= 2.36 px and the ellipse linearizes rho3d at the
    # center — 2.5 px of slack covers both
    MARGIN = 2.5
    rx = sig * torch.sqrt(s00) + MARGIN
    ry = sig * torch.sqrt(s11) + MARGIN
    tx0 = torch.clamp(torch.floor((px - rx) / tile), 0, ntx - 1).to(i32)
    ty0 = torch.clamp(torch.floor((py - ry) / tile), 0, nty - 1).to(i32)
    tx1 = torch.clamp(torch.floor((px + rx) / tile), 0, ntx - 1).to(i32)
    ty1 = torch.clamp(torch.floor((py + ry) / tile), 0, nty - 1).to(i32)
    # clamp the span, keeping the center tile inside (float->int truncates
    # toward zero like jnp's astype)
    ctx = torch.minimum(torch.maximum((px / tile).to(i32), tx0), tx1)
    cty = torch.minimum(torch.maximum((py / tile).to(i32), ty0), ty1)
    tx0 = torch.maximum(tx0, ctx - (side - 1))
    ty0 = torch.maximum(ty0, cty - (side - 1))
    tx1 = torch.minimum(tx1, tx0 + side - 1)
    ty1 = torch.minimum(ty1, ty0 + side - 1)

    dk = torch.arange(K, dtype=i32, device=dev)
    dxk = (dk % side)[None, :]
    dyk = (dk // side)[None, :]
    tx = tx0[:, None] + dxk                      # (V, K)
    ty = ty0[:, None] + dyk
    cand_valid = (visible[:, None] & (tx <= tx1[:, None])
                  & (ty <= ty1[:, None]) & (ty >= r0) & (ty < r1))

    # exact ellipse/tile-rect intersection: minimum of the conic quadratic
    # q(p) = (p-c)^T Sigma^{-1} (p-c) over the (margin-expanded) tile rect —
    # interior, else the min over each of the 4 edges with clamped argmin.
    # Keep the candidate iff q_min <= q_cut.
    detS = torch.clamp(s00 * s11 - s01 * s01, min=1e-12)
    A = (s11 / detS)[:, None]                    # conic xx
    B = (-s01 / detS)[:, None]                   # conic xy
    D = (s00 / detS)[:, None]                    # conic yy
    rA = 1.0 / A
    rD = 1.0 / D
    txf = tx.to(f32) * tile
    tyf = ty.to(f32) * tile
    x0 = txf - MARGIN - px[:, None]
    x1 = txf + (tile - 1) + MARGIN - px[:, None]
    y0 = tyf - MARGIN - py[:, None]
    y1 = tyf + (tile - 1) + MARGIN - py[:, None]
    inside = (x0 <= 0) & (0 <= x1) & (y0 <= 0) & (0 <= y1)

    def q_edge_x(xe):
        ys = torch.minimum(torch.maximum(-B * xe * rD, y0), y1)
        return (A * xe + 2.0 * B * ys) * xe + D * ys * ys

    def q_edge_y(ye):
        xs = torch.minimum(torch.maximum(-B * ye * rA, x0), x1)
        return (D * ye + 2.0 * B * xs) * ye + A * xs * xs

    q_min = torch.minimum(torch.minimum(q_edge_x(x0), q_edge_x(x1)),
                          torch.minimum(q_edge_y(y0), q_edge_y(y1)))
    q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
    cand_valid &= q_min <= q_cut[:, None]
    tile_id = ((ty - r0) * ntx + tx).to(i64)

    # ---- single sort groups by (tile, depth): row index IS the depth rank.
    # int64 keys carry the same (tile << RANK_BITS | rank) order as the
    # uint32 keys of the JAX package; invalid candidates sort last.
    rank = torch.arange(v_cap, dtype=i64, device=dev)[:, None]
    key = torch.where(cand_valid, (tile_id << RANK_BITS) | rank,
                      torch.full_like(tile_id, INVALID_KEY)).reshape(-1)
    skey, perm = torch.sort(key, stable=True)
    perm = perm.to(i32)
    s_rank = perm // K                            # compact (depth-rank) row
    s_valid = skey != INVALID_KEY
    s_tile = (skey >> RANK_BITS).to(i32)

    n_total = torch.sum(s_valid.to(i32))
    overflow = n_total > p_cap

    def fit(x, fill):
        if x.shape[0] >= p_cap:
            return x[:p_cap]
        pad = torch.full((p_cap - x.shape[0],), fill, dtype=x.dtype,
                         device=dev)
        return torch.cat([x, pad])

    s_rank = fit(s_rank, 0)
    s_k = fit(perm % K, 0)                        # candidate tile ordinal
    s_valid = fit(s_valid, False)
    # invalid candidates carry tile id 0xFFF (> T), keeping the array sorted
    s_tile = fit(s_tile, (1 << (32 - RANK_BITS)) - 1)

    # ---- per-tile counts from the sorted tile ids
    bounds = _vsearch_left(s_tile, torch.arange(T + 1, dtype=i32,
                                                device=dev))
    counts = bounds[1:] - bounds[:-1]                          # (T,)
    # per-tile depth cap: keep only the tile_cap NEAREST pairs of each tile
    # (a run prefix); transmittance saturates long before. 0 = uncapped.
    if tile_cap > 0:
        counts = torch.clamp(counts, max=tile_cap)
    padded = ((counts + chunk - 1) // chunk) * chunk
    # every tile gets >= 1 chunk, so every tile's output is written
    padded = torch.clamp(padded, min=chunk)
    pad_off = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                         torch.cumsum(padded, 0).to(i32)])   # (T+1,)
    raw_off = bounds

    # destination slot: dest = (pos - raw_off[t]) + pad_off[t]. Each table's
    # value is scattered at its tile's run start and propagated with a
    # running max — both tables are nondecreasing in t, and empty tiles
    # share a boundary position where the max picks the latest value.
    pos = torch.arange(p_cap, dtype=i32, device=dev)
    starts = raw_off[:T].to(i64)
    in_cap = starts < p_cap                      # positions past p_cap drop
    raw_at = torch.zeros(p_cap, dtype=i32, device=dev).scatter_reduce_(
        0, starts[in_cap], raw_off[:T][in_cap], "amax")
    raw_at = torch.cummax(raw_at, 0).values
    pad_at = torch.zeros(p_cap, dtype=i32, device=dev).scatter_reduce_(
        0, starts[in_cap], pad_off[:T][in_cap], "amax")
    pad_at = torch.cummax(pad_at, 0).values
    rank_in_tile = pos - raw_at
    keep = s_valid if tile_cap <= 0 else s_valid & (rank_in_tile < tile_cap)
    dest = torch.where(keep, rank_in_tile + pad_at,
                       torch.full_like(pos, p_cap))
    # clamp: padded layout may not fit in p_cap when overflowing
    dest = torch.clamp(dest, max=p_cap)
    s_valid = keep

    # Invalid slots resolve to compact row v_cap — the render-side gather
    # table carries one extra all-zeros row there, so padding pairs read a
    # dead payload with no per-pair validity multiply.
    w = dest < p_cap                                    # drop sentinel
    slot_row = torch.full((p_cap,), v_cap, dtype=i32, device=dev)
    slot_row[dest[w].to(i64)] = s_rank[w]
    pair_valid = torch.zeros(p_cap, dtype=torch.bool, device=dev)
    pair_valid[dest[w].to(i64)] = True
    pair_idx = slot_row

    # ---- chunk metadata: tile of each chunk among the padded boundaries
    chunk_bounds = pad_off // chunk               # (T+1,) monotone
    total_chunks = torch.clamp(chunk_bounds[-1], max=c_cap)
    cidx = torch.arange(c_cap, dtype=i32, device=dev)
    chunk_tile = torch.searchsorted(chunk_bounds, cidx, right=True).to(i32) - 1
    chunk_tile = torch.clamp(chunk_tile, 0, T - 1)
    chunk_first = (cidx == chunk_bounds[chunk_tile.to(i64)]).to(i32)
    # out-of-range chunks: retarget at the last real tile, never "first",
    # flagged not-in-range so the kernels skip them
    last_tile = chunk_tile[torch.clamp(total_chunks - 1, min=0).to(i64)]
    in_range = cidx < total_chunks
    chunk_tile = torch.where(in_range, chunk_tile, last_tile)
    # packed flags: bit0 = first chunk of tile, bit1 = in range
    chunk_first = torch.where(in_range, chunk_first,
                              torch.zeros_like(chunk_first)) \
        + 2 * in_range.to(i32)
    tile_chunks = torch.minimum(chunk_bounds, total_chunks).to(i32)

    # ---- inverse pair map for the backward gather-reduce. Values are
    # `dest`: candidates dropped by the p_cap clamp carry dest == p_cap,
    # exactly the grad table's all-zeros sentinel row.
    grad_tbl = None
    if need_grad:
        tgt = (s_rank * K + s_k)[s_valid].to(i64)
        grad_tbl = torch.full((v_cap * K,), p_cap, dtype=i32, device=dev)
        grad_tbl[tgt] = dest[s_valid]
        grad_tbl = grad_tbl.reshape(v_cap, K)
    n_kept = torch.sum(counts) if tile_cap > 0 else torch.clamp(n_total,
                                                                max=p_cap)
    # pair slots are laid out PADDED, so capacity demand is pad_off[T]; when
    # it exceeds p_cap the dest clamp drops the trailing tiles' pairs
    n_padded = pad_off[T]
    overflow = overflow | (n_padded > p_cap)
    return BinnedScene(pair_idx=pair_idx, pair_valid=pair_valid,
                       sel=sel.to(i32), chunk_tile=chunk_tile,
                       chunk_first=chunk_first,
                       n_chunks=total_chunks.to(i32),
                       n_pairs=n_kept.to(i32), overflow=overflow,
                       grad_tbl=grad_tbl, n_padded=n_padded,
                       tile_chunks=tile_chunks)
