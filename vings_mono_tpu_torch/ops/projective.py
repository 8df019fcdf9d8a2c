"""Pinhole projective geometry with analytic Jacobians on torch tensors.

Dense per-pixel maps are kept in (..., H, W) layout; intrinsics are
``[fx, fy, cx, cy]``.

Used by:
  * the dense bundle-adjustment engine (ops/ba.py) — Jacobian construction,
  * the covisible graph (tracker/graph.py) — reprojection + induced flow,
  * frame-distance edge proposal.
"""

from __future__ import annotations

import torch

from . import lie

MIN_DEPTH = 0.2


def coords_grid(ht, wd, dtype=torch.float32, device=None):
    """Pixel coordinate grid, (ht, wd, 2) with [x, y] order."""
    y, x = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                          torch.arange(wd, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def iproj(disps, intrinsics):
    """Inverse projection to homogeneous points [X, Y, 1, d].

    disps: (..., H, W) inverse depth; intrinsics (..., 4) broadcastable.
    Returns pts (..., H, W, 4).
    """
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=disps.dtype, device=disps.device),
        torch.arange(wd, dtype=disps.dtype, device=disps.device),
        indexing="ij")
    X = ((x - cx) / fx).expand(disps.shape)
    Y = ((y - cy) / fy).expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def proj(Xs, intrinsics, jacobian=False, return_depth=False):
    """Project homogeneous points [X, Y, Z, D] to pixels.

    The 4th coordinate carries inverse depth through the transform;
    Z < 0.5*MIN_DEPTH is clamped to 1 to keep the math finite (validity is
    handled by the caller's mask).
    """
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z
    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    if return_depth:
        coords = torch.stack([x, y, D * d], dim=-1)
    else:
        coords = torch.stack([x, y], dim=-1)
    if jacobian:
        o = torch.zeros_like(d)
        # d(pix)/d(X,Y,Z,D): rows [x, y], cols [X Y Z D]
        Jp = torch.stack([
            fx * d, o, -fx * X * d * d, o,
            o, fy * d, -fy * Y * d * d, o,
        ], dim=-1).reshape(d.shape + (2, 4))
        return coords, Jp
    return coords, None


def actp(Gij, X0, jacobian=False):
    """Apply relative pose to homogeneous points.

    Gij: (..., 7) SE3 broadcast against X0 (..., H, W, 4).
    Returns X1 and (optionally) the right-jacobian d(X1)/d(xi_j),
    (..., H, W, 4, 6).
    """
    G = Gij[..., None, None, :]
    # homogeneous [X Y 1 d] transforms projectively:
    # [X' Y' Z' d'] = [R (X,Y,Z) + t*d, d]
    xyz = X0[..., :3]
    d = X0[..., 3:4]
    xyz1 = lie.quat_rotate(G[..., 3:7], xyz) + G[..., :3] * d
    X1 = torch.cat([xyz1, d], dim=-1)
    if jacobian:
        Xc, Yc, Zc = xyz1.unbind(-1)
        dd = d[..., 0]
        o = torch.zeros_like(dd)
        Ja = torch.stack([
            dd, o, o, o, Zc, -Yc,
            o, dd, o, -Zc, o, Xc,
            o, o, dd, Yc, -Xc, o,
            o, o, o, o, o, o,
        ], dim=-1).reshape(dd.shape + (4, 6))
        return X1, Ja
    return X1, None


def projective_transform(poses, disps, intrinsics, ii, jj, jacobian=False,
                         return_depth=False, self_motion=None):
    """Map dense points from frames ii into frames jj.

    poses: (P, 7) world-to-camera SE3 (lietorch layout), disps (P, H, W),
    intrinsics (4,) or (P, 4), ii/jj (N,) integer edge lists.

    Returns coords (N, H, W, 2[+1]), valid (N, H, W, 1) and, with
    ``jacobian=True``, (Ji, Jj, Jz): Ji/Jj (N, H, W, 2, 6), Jz (N, H, W, 2, 1).

    `self_motion` replaces Gij on ii==jj edges: a fixed small sideways
    motion is planted there, as DROID does.
    """
    ii = ii.long()
    jj = jj.long()
    if intrinsics.ndim == 1:
        intr_ii = intrinsics[None].expand(ii.shape[0], 4)
        intr_jj = intr_ii
    else:
        intr_ii = intrinsics[ii]
        intr_jj = intrinsics[jj]

    X0 = iproj(disps[ii], intr_ii)
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    if self_motion is None:
        self_motion = Gij.new_tensor([-0.1, 0, 0, 0, 0, 0, 1.0])
    Gij = torch.where((ii == jj)[:, None], self_motion[None], Gij)

    X1, Ja = actp(Gij, X0, jacobian=jacobian)
    x1, Jp = proj(X1, intr_jj, jacobian=jacobian, return_depth=return_depth)

    valid = ((X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH))
    valid = valid.to(disps.dtype)[..., None]

    if jacobian:
        Jj = Jp @ Ja  # (N, H, W, 2, 6)
        Ji = -lie.se3_adjT_apply(Gij[:, None, None], Jj)
        # Jz: d(coords)/d(disp) — disp enters X0[...,3]; through Gij the
        # derivative of X1 wrt d is [t, 1] (translation column).
        tcol = torch.cat(
            [Gij[:, None, None, :3].expand(X1[..., :3].shape),
             torch.ones_like(X1[..., :1])], dim=-1)
        Jz = (Jp @ tcol[..., None])  # (N, H, W, 2, 1)
        return x1, valid, (Ji, Jj, Jz)
    return x1, valid


def induced_flow(poses, disps, intrinsics, ii, jj):
    """Optical flow induced by camera motion between frames ii -> jj."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, disps.dtype, disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1[..., :2] - coords0, valid


def frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3):
    """Mean induced-flow distance between frame pairs: the masked mean
    magnitude of the flow induced by full motion, blended with the
    rotation-only flow by beta the way DROID does."""
    ii = ii.long()
    jj = jj.long()
    flow_full, val_full = induced_flow(poses, disps, intrinsics, ii, jj)
    # rotation-only flow: evaluate with the translation of Gij zeroed
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    Gij_rot = torch.cat([torch.zeros_like(Gij[..., :3]), Gij[..., 3:]],
                        dim=-1)
    ht, wd = disps.shape[-2:]
    intr = (intrinsics if intrinsics.ndim > 1 else intrinsics[None]).expand(
        poses.shape[0], 4)
    X0 = iproj(disps[ii], intr[ii])
    X1r, _ = actp(Gij_rot, X0)
    x1r, _ = proj(X1r, intr[jj])
    coords0 = coords_grid(ht, wd, disps.dtype, disps.device)
    flow_rot = x1r - coords0

    def masked_mean(flow, valid):
        mag = torch.linalg.norm(flow, dim=-1)
        v = valid[..., 0]
        return torch.sum(mag * v, dim=(-2, -1)) / torch.sum(
            v, dim=(-2, -1)).clamp(min=1.0)

    d_full = masked_mean(flow_full, val_full)
    d_rot = masked_mean(flow_rot, val_full)
    return beta * d_full + (1.0 - beta) * d_rot
