"""Convex upsampling (RAFT-style 8x)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cvx_upsample(data, mask):
    """data (B, h, w, D); mask (B, h, w, 8*8*9) -> (B, 8h, 8w, D).

    Each output pixel is a softmax-weighted combination of the 3x3
    neighborhood of its parent coarse pixel."""
    B, h, w, D = data.shape
    m = mask.reshape(B, h, w, 9, 8, 8)
    m = torch.softmax(m, dim=3)

    # unfold 3x3 neighborhoods (zero padding), neighbor-major
    pads = F.pad(data, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([pads[:, dy:dy + h, dx:dx + w, :]
                         for dy in range(3) for dx in range(3)],
                        dim=3)                      # (B, h, w, 9, D)
    up = torch.einsum("bhwnuv,bhwnd->bhwuvd", m, neigh)  # (B,h,w,8,8,D)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, 8 * h, 8 * w, D)


def upsample_disp(disp, mask):
    """disp (B, h, w) + mask (B, h, w, 576) -> (B, 8h, 8w)."""
    return cvx_upsample(disp[..., None], mask)[..., 0]
