"""NVS pose refinement: optimize a small SE3 correction per keyframe by
photometric loss against the frozen map, return the refined c2w poses, and
rigidly move each keyframe's attributed Gaussians by its correction."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie, quat_wxyz
from ..ops.rasterizer import render
from .cameras import make_camera
from .losses import masked_l1
from .state import GaussianState
from .train import KeyframeBatch, _select_kf


def refine_poses(state: GaussianState, batch: KeyframeBatch, binned_stack,
                 intr4, *, iters: int = 20, lr: float = 1e-3, height: int,
                 width: int, render_kwargs=()):
    """Returns refined c2w poses (K, 4, 4): c2w' = c2w @ exp(xi_k), with
    the (K, 6) table xi optimized by Adam on the masked photometric L1 of
    keyframe `it % n_valid` at iteration `it`. The gradient with respect
    to xi flows through the tile backward kernel and the projection.
    Non-finite gradients are zeroed. The binning stays the one given (the
    training loop's cache: its margin holds the small pose deltas)."""
    rkw = dict(render_kwargs)
    K = batch.w2cs.shape[0]
    with torch.no_grad():
        c2ws = torch.linalg.inv(batch.w2cs)
    xi = torch.zeros((K, 6), dtype=torch.float32, device=c2ws.device)
    m = torch.zeros_like(xi)
    v = torch.zeros_like(xi)
    params = state.params()
    for it in range(iters):
        kf = it % max(int(batch.n_valid), 1)
        xi_g = xi.detach().requires_grad_()
        c2w = c2ws[kf] @ lie.se3_matrix(lie.se3_exp(xi_g[kf]))
        camera = make_camera(torch.linalg.inv(c2w), intr4, height, width)
        rets = render(params["xyz"], params["log_scale"], params["quat"],
                      params["logit_opacity"], params["rgb"], camera,
                      alive=state.alive,
                      binned=_select_kf(binned_stack, kf), **rkw)
        gt = batch.images[kf]
        valid = (torch.sum(gt, dim=0) > 0) & (batch.depths[kf][0] > 0)
        g, = torch.autograd.grad(masked_l1(rets["rgb"], gt, valid), xi_g)
        with torch.no_grad():
            # a single NaN here would poison the pose, then every Gaussian
            # attributed to it
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
            # Adam on the whole table (only row kf has a gradient); the
            # bias corrections in f32, as the JAX package computes them
            t = np.float32(it + 1)
            c1 = float(np.float32(1.0) - np.float32(0.9) ** t)
            c2 = float(np.float32(1.0) - np.float32(0.999) ** t)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            xi = xi - lr * ((m / c1) / (torch.sqrt(v / c2) + 1e-8))
    with torch.no_grad():
        new_c2ws = torch.einsum("kij,kjl->kil", c2ws,
                                lie.se3_matrix(lie.se3_exp(xi)))
    return new_c2ws, xi


@torch.no_grad()
def apply_pose_bias_to_gaussians(state: GaussianState, global_kf_id_window,
                                 old_c2ws, new_c2ws):
    """Move each Gaussian attributed to a refined keyframe by that
    keyframe's correction, in place. Gaussians attributed to frames outside
    the window are untouched. `lie.matrix_to_quat` gives xyzw; the map's
    quaternions are wxyz."""
    T = new_c2ws @ torch.linalg.inv(old_c2ws)      # (K, 4, 4)
    K = T.shape[0]
    # globalkf_id -> window slot (K = identity); a later slot wins
    T_ext = torch.cat([T, torch.eye(4, dtype=T.dtype, device=T.device)[None]])
    slot = torch.full((state.capacity,), K, dtype=torch.int64,
                      device=T.device)
    for k in range(K):
        slot = torch.where(state.globalkf_id == global_kf_id_window[k],
                           torch.full_like(slot, k), slot)
    Tg = T_ext[slot]
    xyz = torch.einsum("nij,nj->ni", Tg[:, :3, :3], state.xyz) \
        + Tg[:, :3, 3]
    q_rot = quat_wxyz.from_xyzw(lie.matrix_to_quat(Tg[:, :3, :3]))
    quat = quat_wxyz.mul(q_rot, quat_wxyz.normalize(state.quat))
    state.xyz.copy_(xyz)
    state.quat.copy_(quat)
    return state
