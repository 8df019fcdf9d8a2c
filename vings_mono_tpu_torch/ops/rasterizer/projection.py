"""2D Gaussian surfel projection — the differentiable, per-Gaussian half of
the rasterizer.

The math is refactored so that *everything per-pixel becomes a ratio of
functions linear in the pixel ray*. A surfel has center c (camera frame),
tangent axes a_u = s_u * R @ e_u and a_v = s_v * R @ e_v. A pixel with ray
direction d = ((px-cx)/fx, (py-cy)/fy, 1) intersects the surfel plane at
local coordinates

    u = (w_u . d) / (n . d),   v = (w_v . d) / (n . d),   z = (c . n) / (n . d)

with  n = a_u x a_v,  w_u = -(c x a_v),  w_v = c x a_u  (Cramer's rule on
[a_u a_v -d] [u v t]^T = -c). So each Gaussian packs 10 plane coefficients +
its screen center + features, and the per-pixel work in the tile kernel is a
handful of FMAs + one reciprocal + one exp.

Everything here is plain differentiable PyTorch; gradients to the raw
Gaussian parameters flow through this projection (the tile kernel's
autograd Function stops at the packed representation).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import quat_wxyz

# Screen-space low-pass filter: a Gaussian is never smaller than ~0.7px on
# screen (2DGS uses FilterInvSquare = 2.0 on squared pixel distance).
FILTER_INV_SQUARE = 2.0
# Gaussians are evaluated out to this many sigmas for binning radii.
CUTOFF_SIGMA = 3.0
MIN_Z = 0.2
ALPHA_EPS = 1.0 / 255.0


class Camera(NamedTuple):
    """Pinhole camera. w2c is a (4, 4) world-to-camera tensor; intrinsics
    are standard fx, fy, cx, cy Python floats (the reference's fu/cu are
    row-focal/center — convert at the mapper boundary)."""
    w2c: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    height: int
    width: int


# Packed per-Gaussian layout (feature channel indices in the packed array);
# the tile kernels index this layout, keep it in step with csrc/.
PK_WU = slice(0, 3)     # w_u plane coefficients
PK_WV = slice(3, 6)     # w_v plane coefficients
PK_N = slice(6, 9)      # n = a_u x a_v (camera frame, scaled normal)
PK_CN = 9               # c . n  (z numerator)
PK_C2X = 10             # screen center x
PK_C2Y = 11             # screen center y
PK_OPAC = 12            # opacity (activated)
PK_RGB = slice(13, 16)
PK_NRM = slice(16, 19)  # unit normal for the normal channel (camera frame,
                        # sign-flipped toward camera)
PK_FLOW = slice(19, 21)  # per-gaussian optical flow (u2 - u1), pixels
PK_DIM = 21
PK_PAD = 24             # padded channel count used by the tile kernels


class ProjectedSurfels(NamedTuple):
    packed: torch.Tensor    # (N, PK_PAD) float32 — differentiable payload
    depth: torch.Tensor     # (N,) camera-frame center depth (for sorting)
    radius: torch.Tensor    # (N,) conservative screen radius in pixels
    center2d: torch.Tensor  # (N, 2) screen center (px, py)
    visible: torch.Tensor   # (N,) bool — in frustum, alive, non-degenerate
    cov2d: torch.Tensor     # (N, 3) linearized screen covariance
                            # (S00, S01, S11) — binning only


def project_surfels(xyz, log_scale, quat, logit_opacity, rgb, camera: Camera,
                    alive=None, flow=None, scale_modifier=1.0):
    """Project world-space surfels into the packed per-Gaussian representation.

    xyz (N,3), log_scale (N,2), quat (N,4 wxyz, unnormalized),
    logit_opacity (N,1), rgb (N,3); flow (N,2) optional screen-flow feature.
    """
    N = xyz.shape[0]
    R_w2c = camera.w2c[:3, :3]
    t_w2c = camera.w2c[:3, 3]

    q = quat_wxyz.normalize(quat)
    R_g = quat_wxyz.to_matrix(q)             # (N, 3, 3) columns t_u,t_v,t_w
    scales = torch.exp(log_scale) * scale_modifier  # (N, 2)

    # camera-frame center and tangent axes
    c = xyz @ R_w2c.T + t_w2c                # (N, 3)
    Rg_cam = torch.einsum("ij,njk->nik", R_w2c, R_g)  # (N, 3, 3)
    a_u = Rg_cam[..., :, 0] * scales[:, 0:1]
    a_v = Rg_cam[..., :, 1] * scales[:, 1:2]

    n = torch.linalg.cross(a_u, a_v)         # (N, 3) scaled normal
    w_u = -torch.linalg.cross(c, a_v)
    w_v = torch.linalg.cross(c, a_u)
    cn = torch.sum(c * n, dim=-1)            # (N,)

    # screen center
    z = c[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    px = camera.fx * c[:, 0] / z_safe + camera.cx
    py = camera.fy * c[:, 1] / z_safe + camera.cy
    center2d = torch.stack([px, py], dim=-1)

    # conservative screen radius: 3-sigma extent via the projection Jacobian
    # at the center, J = d(px,py)/d(u,v). Columns:
    inv_z = 1.0 / z_safe
    Ju = torch.stack(
        [camera.fx * (a_u[:, 0] - c[:, 0] * a_u[:, 2] * inv_z) * inv_z,
         camera.fy * (a_u[:, 1] - c[:, 1] * a_u[:, 2] * inv_z) * inv_z],
        dim=-1)
    Jv = torch.stack(
        [camera.fx * (a_v[:, 0] - c[:, 0] * a_v[:, 2] * inv_z) * inv_z,
         camera.fy * (a_v[:, 1] - c[:, 1] * a_v[:, 2] * inv_z) * inv_z],
        dim=-1)
    # max singular value of [Ju Jv] from the trace+det closed form on the
    # 2x2 Gram matrix
    g11 = torch.sum(Ju * Ju, dim=-1)
    g22 = torch.sum(Jv * Jv, dim=-1)
    g12 = torch.sum(Ju * Jv, dim=-1)
    tr = g11 + g22
    det = g11 * g22 - g12 * g12
    lam_max = 0.5 * tr + torch.sqrt(torch.clamp(0.25 * tr * tr - det,
                                                min=0.0))
    radius = CUTOFF_SIGMA * torch.sqrt(torch.clamp(lam_max, min=0.0)) + 1.0
    # screen covariance Sigma = [Ju Jv][Ju Jv]^T; its per-axis sigmas and
    # conic drive tile binning
    s00 = Ju[:, 0] * Ju[:, 0] + Jv[:, 0] * Jv[:, 0]
    s11 = Ju[:, 1] * Ju[:, 1] + Jv[:, 1] * Jv[:, 1]
    s01 = Ju[:, 0] * Ju[:, 1] + Jv[:, 0] * Jv[:, 1]
    cov2d = torch.stack([s00, s01, s11], dim=-1)

    opacity = torch.sigmoid(logit_opacity[:, 0])
    if alive is not None:
        # gate the payload too (not just `visible`): pair lists may be
        # CACHED across prune events, and the tile kernel renders whatever
        # packed rows the cached pair_idx references
        opacity = opacity * alive.to(opacity.dtype)

    # unit normal for the normal render channel; flip toward the camera the
    # way 2DGS does (normal faces the ray origin)
    t_w = Rg_cam[..., :, 2]
    facing = torch.sign(torch.sum(t_w * c, dim=-1, keepdim=True))
    nrm_unit = -t_w * facing

    if flow is None:
        flow = torch.zeros((N, 2), dtype=torch.float32, device=xyz.device)

    packed = torch.cat([
        w_u, w_v, n, cn[:, None], px[:, None], py[:, None],
        opacity[:, None], rgb, nrm_unit, flow,
        torch.zeros((N, PK_PAD - PK_DIM), dtype=torch.float32,
                    device=xyz.device),
    ], dim=1).to(torch.float32)

    W, H = camera.width, camera.height
    visible = (z > MIN_Z) & (opacity > ALPHA_EPS) & (radius > 0.3)
    visible &= (px + radius > 0) & (px - radius < W)
    visible &= (py + radius > 0) & (py - radius < H)
    # degenerate surfels (normal ~ 0) can't be intersected
    visible &= torch.sum(n * n, dim=-1) > 1e-18
    if alive is not None:
        visible &= alive

    return ProjectedSurfels(packed=packed, depth=z, radius=radius,
                            center2d=center2d, visible=visible, cov2d=cov2d)
