"""Camera construction and dense back-projection for the mapper.

The reference's intrinsic dict uses row-major names: fu/cu act on image rows
(v ~ y) and fv/cv on columns (u ~ x). Internally we use standard fx, fy, cx,
cy; this module is the boundary where the convention is converted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rasterizer import Camera


def _f32(x):
    """Host float rounded to f32, so the intrinsics match f32 arithmetic."""
    return float(np.float32(x))


def make_camera(w2c, intr4, height: int, width: int) -> Camera:
    """intr4 = (fx, fy, cx, cy) host floats."""
    fx, fy, cx, cy = (_f32(v) for v in intr4)
    return Camera(w2c=w2c, fx=fx, fy=fy, cx=cx, cy=cy,
                  height=int(height), width=int(width))


def camera_from_intrinsic(w2c, intr: dict) -> Camera:
    """intr: reference-style {'fu','fv','cu','cv','H','W'} (fu/cu = rows);
    w2c a (4, 4) f32 tensor."""
    return make_camera(w2c, (intr["fv"], intr["fu"], intr["cv"], intr["cu"]),
                       intr["H"], intr["W"])


def _pixel_grid(H, W, device):
    return torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")


def backproject(depth, camera: Camera, c2w):
    """depth (H, W) -> world points (H*W, 3) (zero-depth rows stay at the
    camera center; mask with depth>0)."""
    ys, xs = _pixel_grid(*depth.shape, depth.device)
    x = (xs - camera.cx) / camera.fx * depth
    y = (ys - camera.cy) / camera.fy * depth
    pts_cam = torch.stack([x, y, depth], dim=-1).reshape(-1, 3)
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]


def project_points(xyz, camera: Camera):
    """World points (N, 3) -> (px, py, z_cam) each (N,)."""
    pc = xyz @ camera.w2c[:3, :3].T + camera.w2c[:3, 3]
    z = pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    px = camera.fx * pc[:, 0] / zs + camera.cx
    py = camera.fy * pc[:, 1] / zs + camera.cy
    return px, py, z


def depth_to_normal(depth, camera: Camera):
    """Central-difference normals from a depth map, camera frame (H, W, 3):
    cross(left->right, bottom->top), zero border."""
    ys, xs = _pixel_grid(*depth.shape, depth.device)
    x = (xs - camera.cx) / camera.fx * depth
    y = (ys - camera.cy) / camera.fy * depth
    p = torch.stack([x, y, depth], dim=-1)   # (H, W, 3)
    l2r = p[1:-1, 2:, :] - p[1:-1, :-2, :]
    b2t = p[:-2, 1:-1, :] - p[2:, 1:-1, :]
    n = torch.linalg.cross(l2r, b2t)
    # smooth normalization — a plain norm has NaN gradients at exact zeros
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
