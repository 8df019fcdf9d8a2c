"""Naive (per-pixel x all-Gaussians) 2DGS renderer in plain PyTorch.

The numeric specification for the tile rasterizer: differentiable through
autograd, used by the tests to check the tile path's channels and
gradients, and the render of `impl="naive"` (render.py). O(H*W*N) — only
for small N.

Channel layout shared with the tile kernels:
  0:3  rgb               (front-to-back alpha blend, black background)
  3    depth_sum         (sum w_i * z_i; expected depth = depth_sum / alpha)
  4    alpha             (sum w_i)
  5:8  normal            (sum w_i * n_i, camera frame)
  8    dist              (placeholder; render.py builds it from the totals)
  9:11 flow              (sum w_i * flow_i)
  11   wm                (sum w_i * m_i,  m = contracted depth)
  12   wm2               (sum w_i * m_i^2)
"""

from __future__ import annotations

import torch

from .projection import (ALPHA_EPS, FILTER_INV_SQUARE, Camera, PK_WU, PK_WV,
                         PK_N, PK_CN, PK_C2X, PK_C2Y, PK_OPAC, PK_RGB,
                         PK_NRM, PK_FLOW)

NUM_CHANNELS = 13
MAX_ALPHA = 0.999


def contract_depth(z):
    """Map depth to [0, 1) for the distortion accumulator."""
    return z / (1.0 + z)


def render_naive(packed, order, n_valid_mask, camera: Camera):
    """Render with a plain cumprod over depth-sorted Gaussians.

    packed (N, PK_PAD) from project_surfels; order (N,) depth-sort
    permutation; n_valid_mask (N,) bool marks (post-permutation) entries
    that contribute. Returns (NUM_CHANNELS, H, W)."""
    H, W = camera.height, camera.width
    dev = packed.device
    p = packed[order]                       # (N, C) sorted front-to-back
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    qx = ((xs - camera.cx) / camera.fx).reshape(1, -1)   # (1, P)
    qy = ((ys - camera.cy) / camera.fy).reshape(1, -1)

    def col(i):
        return p[:, i:i + 1]

    u_num = col(PK_WU.start) * qx + col(PK_WU.start + 1) * qy \
        + col(PK_WU.start + 2)
    v_num = col(PK_WV.start) * qx + col(PK_WV.start + 1) * qy \
        + col(PK_WV.start + 2)
    den = col(PK_N.start) * qx + col(PK_N.start + 1) * qy + col(PK_N.start + 2)
    rcp = 1.0 / torch.where(torch.abs(den) < 1e-12,
                            torch.full_like(den, 1e-12), den)
    u = u_num * rcp
    v = v_num * rcp
    z = col(PK_CN) * rcp
    rho3d = u * u + v * v
    dx = xs.reshape(1, -1) - col(PK_C2X)
    dy = ys.reshape(1, -1) - col(PK_C2Y)
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    a_raw = col(PK_OPAC) * torch.exp(-0.5 * rho)
    keep = n_valid_mask[:, None] & (a_raw >= ALPHA_EPS) & (z > 0.05)
    alpha = torch.where(keep, torch.clamp(a_raw, max=MAX_ALPHA),
                        torch.zeros_like(a_raw))

    # front-to-back weights: w_i = a_i * prod_{j<i} (1 - a_j)
    T_excl = torch.cat([torch.ones_like(alpha[:1]),
                        torch.cumprod(1.0 - alpha, dim=0)[:-1]], dim=0)
    w = alpha * T_excl                       # (N, P)
    # entries that are not kept have w = 0, but their z is anything: at
    # z = -1 exactly contract_depth is infinite and 0 * inf is NaN
    md = contract_depth(torch.where(keep, z, torch.zeros_like(z)))
    out = torch.cat([
        torch.einsum("np,nc->cp", w, p[:, PK_RGB]),
        torch.sum(w * z, dim=0)[None],
        torch.sum(w, dim=0)[None],
        torch.einsum("np,nc->cp", w, p[:, PK_NRM]),
        torch.zeros_like(z[:1]),
        torch.einsum("np,nc->cp", w, p[:, PK_FLOW]),
        torch.sum(w * md, dim=0)[None],
        torch.sum(w * md * md, dim=0)[None],
    ], dim=0)
    return out.reshape(NUM_CHANNELS, H, W)
