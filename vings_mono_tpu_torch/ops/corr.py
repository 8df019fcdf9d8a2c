"""All-pairs correlation pyramid + windowed lookup.

  * the all-pairs volume is one batched matmul accumulated in f32,
  * the (2r+1)^2-window lookup with bilinear interpolation is a direct
    gather: per (pixel, level) the (2r+2)^2 integer taps around the floor
    of the coordinate are gathered once and blended in f32.

Layouts are edge-major: fmaps (N, h, w, C); volumes (N, h1*w1, h2, w2).
The volumes may be stored in bfloat16 (half the memory and traffic); the
interpolation always runs in f32 on the stored values.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

NUM_LEVELS = 4
RADIUS = 3


class CorrPyramid(NamedTuple):
    levels: List[torch.Tensor]   # [(N, h1w1, h2/2^l, w2/2^l)]


def build_pyramid(fmap1, fmap2, num_levels=NUM_LEVELS,
                  dtype=torch.float32) -> CorrPyramid:
    """fmap1/2 (N, h, w, C) -> pyramid of all-pairs correlations, stored in
    `dtype`. Pooling floors odd sizes like avg_pool2d with stride 2."""
    N, h, w, C = fmap1.shape
    f1 = fmap1.reshape(N, h * w, C).float() / 4.0
    f2 = fmap2.reshape(N, h * w, C).float() / 4.0
    corr = torch.matmul(f1, f2.transpose(1, 2))
    corr = corr.reshape(N, h * w, h, w).to(dtype)
    levels = [corr]
    for _ in range(num_levels - 1):
        c = levels[-1]
        n, p, hh, ww = c.shape
        h2, w2 = hh // 2, ww // 2
        c = c[:, :, :2 * h2, :2 * w2].float()
        c = c.reshape(n, p, h2, 2, w2, 2).mean(dim=(3, 5)).to(dtype)
        levels.append(c)
    return CorrPyramid(levels=levels)


def _lookup_level(vol, coords, radius):
    """vol (N, P, h2, w2); coords (N, h1, w1, 2) in level-l pixel units.
    Returns (N, h1, w1, (2r+1)^2) bilinear samples around coords, y-offset
    major. Taps outside [0, size) read as zero, for any coordinate (negative
    and far out of range included): the index is clamped and the value
    masked."""
    N, P, h2, w2 = vol.shape
    _, h1, w1, _ = coords.shape
    assert P == h1 * w1
    k = 2 * radius + 1
    if h2 == 0 or w2 == 0:      # a level pooled away: every tap is outside
        return torch.zeros((N, h1, w1, k * k), device=vol.device)

    x = coords[..., 0].reshape(N, P).float()
    y = coords[..., 1].reshape(N, P).float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None, None]
    fy = (y - y0)[..., None, None]
    # a coordinate beyond the int range would wrap in the cast; anything
    # that far out has no tap inside, so park it just outside the volume
    lim = float(max(h2, w2) + 2 * k)
    off = torch.arange(-radius, radius + 2, device=vol.device)
    ix = x0.clamp(-lim, lim).long()[..., None] + off        # (N, P, k+1)
    iy = y0.clamp(-lim, lim).long()[..., None] + off
    okx = (ix >= 0) & (ix < w2)
    oky = (iy >= 0) & (iy < h2)
    flat = iy.clamp(0, h2 - 1)[..., :, None] * w2 \
        + ix.clamp(0, w2 - 1)[..., None, :]                 # (N, P, k+1, k+1)
    taps = torch.gather(vol.reshape(N, P, h2 * w2), 2,
                        flat.reshape(N, P, (k + 1) * (k + 1)))
    taps = taps.reshape(N, P, k + 1, k + 1).float()
    taps = taps * (oky[..., :, None] & okx[..., None, :])
    t = (1.0 - fx) * taps[..., :, :k] + fx * taps[..., :, 1:]
    out = (1.0 - fy) * t[..., :k, :] + fy * t[..., 1:, :]
    return out.reshape(N, h1, w1, k * k)


def lookup(pyramid: CorrPyramid, coords, radius=RADIUS):
    """coords (N, h1, w1, 2) at level-0 resolution -> (N, h1, w1,
    num_levels*(2r+1)^2) in f32, level-major."""
    outs = []
    for lvl, vol in enumerate(pyramid.levels):
        outs.append(_lookup_level(vol, coords / (2 ** lvl), radius))
    return torch.cat(outs, dim=-1)


def stack_pyramids(pyrs: List[CorrPyramid]) -> CorrPyramid:
    return CorrPyramid(levels=[torch.cat([p.levels[i] for p in pyrs])
                               for i in range(len(pyrs[0].levels))])
