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
