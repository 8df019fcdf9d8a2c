"""3DGS-convention quaternion helpers (wxyz layout).

The mapper stores Gaussian rotations as **wxyz** quaternions like the
reference; the tracker uses xyzw (lietorch layout). Keep the two worlds
separate and convert explicitly at boundaries.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def to_matrix(q):
    """Unit wxyz quaternion -> rotation matrix (..., 3, 3) whose COLUMNS are
    the rotated basis axes (t_u, t_v, t_w for a 2D surfel)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def mul(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def from_xyzw(q):
    return torch.cat([q[..., 3:4], q[..., :3]], dim=-1)


def to_xyzw(q):
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def normal_to_quat(normals):
    """Unit normal -> wxyz quaternion whose third rotation column (t_w, the
    surfel normal axis) aligns with it: the exact shortest-arc rotation
    taking e_z to the normal."""
    a, b, c = normals.unbind(-1)
    w = 1.0 + c
    z = torch.zeros_like(a)
    q = torch.stack([w, -b, a, z], dim=-1)
    # n ~ -e_z is degenerate; fall back to a 180-degree flip about x
    flip = torch.stack([z, torch.ones_like(a), z, z], dim=-1)
    q = torch.where((w < 1e-6)[..., None], flip, q)
    return normalize(q)
