"""Keyframe-driven prune + densify — rebuild of the reference's
GaussianModel.init_first_frame / add_new_frame over the capacity-capped
state.

Every densification samples exactly n_points candidate pixels (gumbel
top-k over the eligible mask) and marks the tail invalid so the *count*
matches the reference's fraction-scaled budget. Insertion targets the first
dead slots.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.knn import knn_mean_sq_dist
from ..ops.rasterizer import Camera, bin_for_camera, render
from .cameras import backproject, make_camera, project_points
from .state import GaussianState, SparseAdamState, kill_rows, write_rows


def inverse_sigmoid(x):
    """Logit of a host float, taken in f32."""
    return float(np.log(np.float32(x / (1.0 - x))))


def draw_densify(generator, height, width, n_points, device):
    """Default random draws of one densification: gumbel noise per pixel
    (H*W,) and raw quaternions (n_points, 4)."""
    u = torch.rand((height * width,), generator=generator,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    quat = torch.randn((n_points, 4), generator=generator,
                       dtype=torch.float32)
    return gumbel.to(device), quat.to(device)


@torch.no_grad()
def sample_pointcloud(camera: Camera, c2w, gt_rgb, gt_depth, pred_accum,
                      n_points: int, gumbel, quat_noise,
                      accum_thresh: float = 0.5):
    """Reference get_pointcloud_v1: sample uniformly over valid-depth
    pixels; the *count* is scaled by the fraction of pixels not yet covered
    (accum < thresh).

    gt_rgb (3,H,W), gt_depth (1,H,W), pred_accum (1,H,W) or None; gumbel
    (H*W,) and quat_noise (n_points, 4) are the draws (draw_densify).
    Returns world points, rgb, quats (n_points, ...) and the valid mask."""
    depth = gt_depth[0]
    valid = depth > 0
    if pred_accum is None:
        uncovered = valid
    else:
        uncovered = valid & (pred_accum[0] <= accum_thresh)
    n_valid = torch.sum(valid)
    n_eff = torch.floor(torch.sum(uncovered).to(torch.float32)
                        / torch.clamp(n_valid, min=1).to(torch.float32)
                        * n_points).to(torch.int32)

    # gumbel top-k = uniform sample without replacement over valid pixels;
    # rows past the valid pixels come from the -inf entries in any order
    # and are masked by valid_new
    scores = torch.where(valid.reshape(-1), gumbel,
                         torch.full_like(gumbel, -float("inf")))
    flat_idx = torch.topk(scores, n_points).indices
    valid_new = (torch.arange(n_points, device=depth.device) < n_eff) & \
        valid.reshape(-1)[flat_idx]

    pts_world = backproject(depth, camera, c2w)[flat_idx]
    rgb = torch.movedim(gt_rgb, 0, -1).reshape(-1, 3)[flat_idx]
    return pts_world, rgb, quat_noise, valid_new


def make_new_params(camera, c2w, gt_rgb, gt_depth, pred_accum, n_points,
                    opacity, gumbel, quat_noise, accum_thresh=0.5):
    xyz, rgb, quat, valid_new = sample_pointcloud(
        camera, c2w, gt_rgb, gt_depth, pred_accum, n_points, gumbel,
        quat_noise, accum_thresh)
    d2 = torch.clamp(knn_mean_sq_dist(xyz, valid_new), min=1e-7)
    log_scale = torch.log(torch.sqrt(d2))[:, None].repeat(1, 2)
    params = {
        "xyz": xyz,
        "rgb": rgb,
        "quat": quat,
        "log_scale": log_scale,
        "logit_opacity": torch.full((n_points, 1), inverse_sigmoid(opacity),
                                    dtype=torch.float32, device=xyz.device),
    }
    return params, valid_new


def dead_slots(state: GaussianState, n: int):
    """First n dead slots (a stable sort puts alive=False first)."""
    order = torch.sort(state.alive.to(torch.uint8), stable=True).indices
    slots = order[:n]
    ok = ~state.alive[slots]
    return slots.to(torch.int32), ok


def _median(x):
    """Median that averages the two middle values of an even count, as
    jnp.median does (torch.median returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@torch.no_grad()
def add_frame(state: GaussianState, opt: SparseAdamState, w2c, intr4,
              gt_rgb, gt_depth, global_kf_id, *, height: int, width: int,
              gumbel, quat_noise, n_points=40000, first=False, opacity=0.8,
              accum_thresh=0.5, rgb_err_thresh=0.15, max_radii=25.0,
              render_kwargs=()):
    """Prune floaters + densify uncovered regions for one new keyframe, in
    place. first=True skips pruning and uses opacity 0.1
    (init_first_frame). Returns (state, opt, n_inserted, n_killed)."""
    camera = make_camera(w2c, intr4, height, width)
    c2w = torch.linalg.inv(w2c)
    rkw = dict(render_kwargs)
    n_killed = torch.zeros((), dtype=torch.int32, device=w2c.device)
    if not first:
        # ONE binning serves both renders: the prune between them only
        # flips `alive`, and killed rows re-project to zero opacity
        if rkw.get("impl", "tile") == "tile":
            rkw["binned"] = bin_for_camera(
                state.xyz, state.log_scale, state.quat, state.logit_opacity,
                state.rgb, camera, alive=state.alive, need_grad=False,
                **{k: rkw[k] for k in ("p_cap", "chunk", "side", "v_cap",
                                       "tile_cap") if k in rkw})
        rets = render(state.xyz, state.log_scale, state.quat,
                      state.logit_opacity, state.rgb, camera,
                      alive=state.alive, **rkw)
        res_rgb = torch.sum(torch.abs(rets["rgb"] - gt_rgb), dim=0)
        delete_pix = (rets["depth"][0] < 1.5 * gt_depth[0]) & \
            (res_rgb > rgb_err_thresh)
        px, py, z = project_points(state.xyz, camera)
        ix = torch.clamp(px.to(torch.int64), 0, camera.width - 1)
        iy = torch.clamp(py.to(torch.int64), 0, camera.height - 1)
        in_img = (px > 0) & (px < camera.width - 1) & (py > 0) & \
            (py < camera.height - 1) & (z > 0.01)
        hit = delete_pix[iy, ix]
        kill = state.alive & ((in_img & hit) | (rets["radii"] > max_radii))
        n_killed = torch.sum(kill.to(torch.int32))
        kill_rows(state, kill)

        rets2 = render(state.xyz, state.log_scale, state.quat,
                       state.logit_opacity, state.rgb, camera,
                       alive=state.alive, **rkw)
        accum = rets2["accum"]
        depth_err = torch.abs(rets2["depth"] - gt_depth)
        rgb_err = torch.sum(torch.abs(rets2["rgb"] - gt_rgb), dim=0,
                            keepdim=True)
        med = _median(depth_err)
        accum = torch.where(depth_err > 10.0 * med,
                            torch.zeros_like(accum), accum)
        accum = torch.where(rgb_err > 0.1, torch.zeros_like(accum), accum)
    else:
        accum = None

    new_params, valid_new = make_new_params(
        camera, c2w, gt_rgb, gt_depth, accum, n_points,
        0.1 if first else opacity, gumbel, quat_noise, accum_thresh)
    slots, ok = dead_slots(state, n_points)
    valid_new = valid_new & ok
    write_rows(state, opt, slots, valid_new, new_params, global_kf_id)
    return state, opt, torch.sum(valid_new.to(torch.int32)), n_killed
