"""Sky model — a separate Gaussian sphere for sky pixels: points live on a
radius-10 direction sphere around the camera (parameters store raw
directions; rendering normalizes and scales), trained jointly with the main
map and alpha-composited behind it."""

from __future__ import annotations

import math

import torch

from ..ops.knn import knn_mean_sq_dist
from ..ops.rasterizer import Camera, render
from .cameras import backproject, make_camera
from .densify import dead_slots, inverse_sigmoid
from .state import (GaussianState, SparseAdamState, adam_init, empty_state,
                    write_rows)

SPHERE_RADIUS = 10.0


def sky_render_params(state: GaussianState):
    """Activated sky geometry: directions -> radius-10 sphere; scales get
    the same radius multiplier. The smooth normalization keeps the
    gradients of dead all-zero rows finite."""
    nrm = torch.sqrt(torch.sum(state.xyz ** 2, dim=-1, keepdim=True)
                     + 1e-12)
    xyz = state.xyz / nrm * SPHERE_RADIUS
    log_scale = state.log_scale + math.log(SPHERE_RADIUS)
    return xyz, log_scale


def render_sky(state: GaussianState, camera: Camera, score_carrier=None,
               **rkw):
    xyz, log_scale = sky_render_params(state)
    return render(xyz, log_scale, state.quat, state.logit_opacity,
                  state.rgb, camera, alive=state.alive,
                  score_carrier=score_carrier, **rkw)


def fuse_rgb(pred_main, pred_sky):
    """Composite the sky sphere behind the map."""
    return pred_main["rgb"] + (1.0 - pred_main["accum"]) * pred_sky["rgb"]


@torch.no_grad()
def sky_add_frame(state: GaussianState, opt: SparseAdamState, w2c, intr4,
                  gt_rgb, *, height: int, width: int, gumbel, quat_noise,
                  n_points=1000):
    """Sample sky pixels (gt rgb summing to 0 after the middleware's
    zero-out) as unit directions from the camera center, in place.
    gumbel (H*W,) and quat_noise (n_points, 4) are the draws
    (densify.draw_densify). Returns the number of rows written (device
    scalar)."""
    camera = make_camera(w2c, intr4, height, width)
    c2w = torch.linalg.inv(w2c)
    sky_mask = torch.sum(gt_rgb, dim=0) == 0.0     # (H, W)
    flat = sky_mask.reshape(-1)
    scores = torch.where(flat, gumbel, torch.full_like(gumbel, -math.inf))
    flat_idx = torch.topk(scores, n_points).indices
    n_eff = torch.clamp(torch.sum(sky_mask), max=n_points)
    valid_new = (torch.arange(n_points, device=w2c.device) < n_eff) & \
        flat[flat_idx]

    depth = torch.ones((height, width), dtype=torch.float32,
                       device=w2c.device)
    pts = backproject(depth, camera, c2w)[flat_idx]
    dirs = pts - c2w[:3, 3]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-6)
    rgb = torch.movedim(gt_rgb, 0, -1).reshape(-1, 3)[flat_idx]
    d2 = torch.clamp(knn_mean_sq_dist(dirs, valid_new), min=1e-7)
    params = {
        "xyz": dirs,
        "rgb": rgb,
        "quat": quat_noise,
        "log_scale": torch.log(torch.sqrt(d2))[:, None].repeat(1, 2),
        "logit_opacity": torch.full((n_points, 1), inverse_sigmoid(0.1),
                                    dtype=torch.float32, device=w2c.device),
    }
    slots, ok = dead_slots(state, n_points)
    valid_new = valid_new & ok
    write_rows(state, opt, slots, valid_new, params, 0)
    return torch.sum(valid_new.to(torch.int32))


class SkyModel:
    """The sky state + its sparse Adam."""

    def __init__(self, cfg, capacity=1 << 15, device="cpu"):
        self.cfg = cfg
        self.state = empty_state(capacity, device)
        self.opt = adam_init(self.state)

    def add_frame(self, w2c, intr4, gt_rgb, height, width, gumbel,
                  quat_noise):
        return sky_add_frame(self.state, self.opt, w2c, intr4, gt_rgb,
                             height=height, width=width, gumbel=gumbel,
                             quat_noise=quat_noise,
                             n_points=quat_noise.shape[0])
