"""Mapper training loops — rebuild of the reference's train_once_gaussian.

Each iteration: pick a keyframe from the window, render it through a
*cached binning* (see ops/rasterizer/binning.py), compute the mapper loss,
pull per-Gaussian (importance, error) scores out of the score-carrier
gradient, apply the anti-forgetting gradient weighting, and take a masked
sparse-Adam step on Gaussians that are visible, alive and not stable.

The JAX package runs the iterations as one compiled `lax.fori_loop`; here
they are a Python loop of eager ops, and the state updates in place.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.rasterizer import BinnedScene, bin_for_camera, render
from .cameras import make_camera
from .losses import mapper_loss, psnr
from .sky import SPHERE_RADIUS
from .state import (GaussianState, SparseAdamState, kill_rows,
                    sparse_adam_step)


class KeyframeBatch(NamedTuple):
    """Fixed-capacity stack of the tracker's viz_out window (K_CAP slots)."""
    images: torch.Tensor      # (K, 3, H, W) float32 [0,1]
    depths: torch.Tensor      # (K, 1, H, W)
    depths_cov: torch.Tensor  # (K, 1, H, W)
    w2cs: torch.Tensor        # (K, 4, 4)
    global_kf_id: torch.Tensor  # (K,) int32
    n_valid: int              # real keyframes in the stack
    pixel_mask: Optional[torch.Tensor] = None  # (K, H, W) bool


def _select_kf(binned: BinnedScene, kf) -> BinnedScene:
    return BinnedScene(*(None if x is None else x[kf] for x in binned))


def _stack(scenes) -> BinnedScene:
    return BinnedScene(*(None if xs[0] is None else torch.stack(xs)
                         for xs in zip(*scenes)))


def bin_rows(state: GaussianState, w2cs_rows, intr4, height, width,
             p_cap=1 << 21, chunk=128, side=5, v_cap=0, tile_cap=0):
    """Bin a subset of window cameras (stacked BinnedScene) — the
    incremental half of the round-robin binning cache."""
    return _stack([bin_for_camera(
        state.xyz, state.log_scale, state.quat, state.logit_opacity,
        state.rgb, make_camera(w2c, intr4, height, width), alive=state.alive,
        p_cap=p_cap, chunk=chunk, side=side, v_cap=v_cap, tile_cap=tile_cap)
        for w2c in w2cs_rows])


def bin_stack(state: GaussianState, batch: KeyframeBatch, intr4, height,
              width, **bin_kwargs):
    """Bin every keyframe camera in the window."""
    return bin_rows(state, batch.w2cs, intr4, height, width, **bin_kwargs)


def permute_scatter_binned(full: BinnedScene, perm, part: BinnedScene,
                           rows) -> BinnedScene:
    """Shift cached binning rows to their new window positions (window
    slides), then write freshly-binned rows in."""
    def one(f, p):
        if f is None:
            return None
        moved = f[perm]
        moved[rows] = p
        return moved
    return BinnedScene(*(one(f, p) for f, p in zip(full, part)))


def pool2x2(x):
    """2x2 average pool over the trailing two axes."""
    return 0.25 * (x[..., 0::2, 0::2] + x[..., 1::2, 0::2] +
                   x[..., 0::2, 1::2] + x[..., 1::2, 1::2])


def half_batch(batch: KeyframeBatch) -> KeyframeBatch:
    """2x2 average-pooled copy of the window for the coarse phase of the
    coarse-to-fine schedule. Poses/ids unchanged; the caller halves the
    intrinsics with `half_intr4`."""
    pm = batch.pixel_mask
    if pm is not None:
        pm = (pm[..., 0::2, 0::2] & pm[..., 1::2, 0::2] &
              pm[..., 0::2, 1::2] & pm[..., 1::2, 1::2])
    return batch._replace(images=pool2x2(batch.images),
                          depths=pool2x2(batch.depths),
                          depths_cov=pool2x2(batch.depths_cov),
                          pixel_mask=pm)


def half_intr4(intr4):
    """(fx, fy, cx, cy) for the 2x2-pooled image: pooled pixel centers sit
    at full-res coords 2u+0.5, so u_half = (u_full - 0.5) / 2. In f32, as
    the cameras take them."""
    f = np.asarray(intr4, np.float32) * np.float32(0.5)
    f[2:] += np.float32(-0.25)
    return tuple(float(x) for x in f)


def local_n_valid(n_valid, rank, k_local):
    """Real keyframes in dp rank `rank`'s slots [rank k_local, (rank+1)
    k_local) of the window."""
    return min(max(n_valid - rank * k_local, 0), k_local)


def draw_kf_schedule(generator, iters, n_valid, dp=1, k_local=None):
    """Default keyframe draw: one window slot per iteration; with dp > 1
    an (iters, dp) list, rank r's slot drawn within its own k_local slots
    (slot 0 where it holds no real keyframe)."""
    if dp == 1:
        return torch.randint(0, max(n_valid, 1), (iters,),
                             generator=generator).tolist()
    cols = [torch.randint(0, max(local_n_valid(n_valid, r, k_local), 1),
                          (iters,), generator=generator).tolist()
            for r in range(dp)]
    return [list(row) for row in zip(*cols)]


def train_loop(state: GaussianState, opt: SparseAdamState,
               batch: KeyframeBatch, binned_stack: BinnedScene, intr4, *,
               iters: int, height: int, width: int, kf_schedule,
               weights=None, lrs=None, render_kwargs=(), sky=None,
               group=None):
    """Run `iters` training iterations on the window, updating state and
    opt in place. kf_schedule lists the window slot each iteration renders
    (draw_kf_schedule). Returns (state, opt, metrics) with the last
    iteration's metrics plus `loss_per_iter` and `psnr_per_iter` (iters,).

    group (a `parallel.mesh.DPGroup`) runs the loop as one rank of a dp
    group, as the JAX loop runs with `axis_name`: batch and binned_stack
    hold this rank's K/dp slots (n_valid still counts the whole window),
    kf_schedule is this rank's column, and every iteration the ranks
    combine their results (`_combine_ranks`) so that each applies the
    same update.

    sky = (sky_state, sky_opt, sky_images (K,3,H,W), sky_binned) trains the
    sky sphere jointly: each iteration also renders the sphere through its
    cached binning (None with impl naive), composites it behind the map,
    takes the photometric loss over the whole image against sky_images,
    and steps the sphere's visible rows with their own sparse Adam (in
    place).
    """
    rkw = dict(render_kwargs)
    metrics, losses, psnrs = {}, [], []
    if group is not None:
        # ranks whose slots are all padding contribute weight 0
        valid = local_n_valid(batch.n_valid, group.rank,
                              batch.images.shape[0]) > 0
    for it in range(iters):
        kf = int(kf_schedule[it])
        camera = make_camera(batch.w2cs[kf], intr4, height, width)
        params = {k: p.detach().requires_grad_()
                  for k, p in state.params().items()}
        carrier = torch.zeros((state.capacity, 2), dtype=torch.float32,
                              device=state.xyz.device, requires_grad=True)
        rets = render(params["xyz"], params["log_scale"], params["quat"],
                      params["logit_opacity"], params["rgb"], camera,
                      alive=state.alive, score_carrier=carrier,
                      binned=_select_kf(binned_stack, kf), **rkw)
        sky_rgb_gt, sky_params, srets = None, {}, None
        if sky is not None:
            sky_state, sky_opt, sky_images, sky_binned = sky
            sky_params = {k: p.detach().requires_grad_()
                          for k, p in sky_state.params().items()}
            srets = _render_sky_params(
                sky_params, sky_state.alive, camera,
                None if sky_binned is None else _select_kf(sky_binned, kf),
                rkw)
            rets = dict(rets)
            rets["rgb"] = rets["rgb"] + (1.0 - rets["accum"]) * srets["rgb"]
            sky_rgb_gt = sky_images[kf]
        pm = None if batch.pixel_mask is None else batch.pixel_mask[kf]
        total, metrics = mapper_loss(rets, batch.images[kf],
                                     batch.depths[kf], batch.depths_cov[kf],
                                     camera, weights, sky_rgb=sky_rgb_gt,
                                     pixel_mask=pm)
        # impl naive leaves the carrier out of the graph: zero scores
        grads = torch.autograd.grad(
            total, list(params.values()) + [carrier]
            + list(sky_params.values()), allow_unused=True,
            materialize_grads=True)
        n_main = len(params)
        sky_grads = dict(zip(sky_params, grads[n_main + 1:]))
        grads = grads[:n_main + 1]
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["psnr"] = psnr(rets["rgb"], batch.images[kf],
                                   batch.depths[kf][0] > 0)
            gp = dict(zip(params, grads[:-1]))
            cur0, cur1 = grads[-1][:, 0], grads[-1][:, 1]
            visible = rets["visible"]
            sky_vis = None if sky is None else srets["visible"]
            gid_kf = batch.global_kf_id[kf]
            if group is None:
                best0 = cur0
            else:
                (gp, sky_grads, metrics, cur0, cur1, best0, gid_kf, visible,
                 sky_vis) = _combine_ranks(group, valid, gp, sky_grads,
                                           metrics, cur0, cur1, gid_kf,
                                           visible, sky_vis)
            losses.append(metrics["total"])
            psnrs.append(metrics["psnr"])
            _score_step(state, cur0, cur1, best0, gid_kf)
            # anti-forgetting gradient weighting; 1 where no scores flow
            glob0 = state.global_scores[:, 0]
            wgt = torch.where(cur0 + glob0 > 0.0,
                              cur0 / (glob0 + 1e-6 + cur0),
                              torch.ones_like(cur0))[:, None]
            gp = {k: g * wgt for k, g in gp.items()}
            step_mask = visible & state.alive & (~state.stable)
            sparse_adam_step(state, gp, opt, step_mask, lrs)
            if sky is not None:
                sparse_adam_step(sky_state, sky_grads, sky_opt,
                                 sky_vis & sky_state.alive, lrs)
    if losses:
        metrics["loss_per_iter"] = torch.stack(losses)
        metrics["psnr_per_iter"] = torch.stack(psnrs)
    return state, opt, metrics


def _render_sky_params(sky_params, alive, camera, binned, rkw):
    """Render the sky sphere from its raw parameters (directions scaled to
    the radius-10 sphere, smooth normalization: a plain norm has NaN
    gradients at the all-zero rows of dead slots)."""
    xyz = sky_params["xyz"]
    nrm = torch.sqrt(torch.sum(xyz ** 2, dim=-1, keepdim=True) + 1e-12)
    return render(xyz / nrm * SPHERE_RADIUS,
                  sky_params["log_scale"] + math.log(SPHERE_RADIUS),
                  sky_params["quat"], sky_params["logit_opacity"],
                  sky_params["rgb"], camera, alive=alive, binned=binned,
                  **rkw)


def _combine_ranks(group, valid, gp, sky_grads, metrics, cur0, cur1,
                   gid_kf, visible, sky_vis):
    """The JAX loop's `axis_name` combination (mapper/train.py there),
    with w = 1 on a rank holding a real keyframe and 0 elsewhere:
    gradients (main and sky), metrics and cur0 become sum(x w) / sum(w);
    cur1 = max(cur1 w); best0 = max(cur0 w); the keyframe attribution is,
    per Gaussian, the largest id among the valid ranks whose cur0 w reaches
    best0; visibility is the OR over valid ranks. Three all-reduces: one
    SUM, one MAX of floats, one MAX of the attribution."""
    w = 1.0 if valid else 0.0
    names = list(metrics)
    sums = [g * w for g in gp.values()] + \
        [g * w for g in sky_grads.values()] + \
        [cur0 * w, (visible & valid).to(torch.float32)]
    if sky_vis is not None:
        sums.append((sky_vis & valid).to(torch.float32))
    sums.append(torch.stack([metrics[k] for k in names]) * w)
    sums.append(torch.full((1,), w, dtype=torch.float32,
                           device=cur0.device))
    flat = group.all_reduce(torch.cat([x.reshape(-1) for x in sums]), "sum")
    denom = flat[-1]
    parts, off = [], 0
    for x in sums[:-1]:
        parts.append(flat[off:off + x.numel()].view(x.shape))
        off += x.numel()
    n_gp, n_sky = len(gp), len(sky_grads)
    gp = {k: s / denom for k, s in zip(gp, parts[:n_gp])}
    sky_grads = {k: s / denom for k, s in zip(sky_grads,
                                              parts[n_gp:n_gp + n_sky])}
    rest = parts[n_gp + n_sky:]
    cur0_w = cur0 * w
    cur0 = rest[0] / denom
    visible = rest[1] > 0
    if sky_vis is not None:
        sky_vis = rest[2] > 0
    metrics = dict(zip(names, rest[-1] / denom))
    mx = group.all_reduce(torch.cat([cur1 * w, cur0_w]), "max")
    n = cur1.shape[0]
    cur1, best0 = mx[:n], mx[n:]
    gid = torch.where((cur0_w >= best0) & valid, gid_kf.to(torch.int32),
                      torch.tensor(-(1 << 30), dtype=torch.int32,
                                   device=cur0.device))
    gid = group.all_reduce(gid, "max")
    return (gp, sky_grads, metrics, cur0, cur1, best0, gid, visible,
            sky_vis)


def _score_step(state: GaussianState, cur0, cur1, best0, gid_kf):
    """Score bookkeeping (add_records + keyframe attribution), in place.
    The attribution and the stored maximum take best0, the largest score
    of one keyframe (cur0 itself at dp = 1); gid_kf is that keyframe's id,
    one for all rows or one per row."""
    state.local_scores.copy_(torch.stack(
        [state.local_scores[:, 0] + cur0,
         torch.maximum(state.local_scores[:, 1], cur1)], dim=-1))
    state.global_scores.copy_(torch.clamp(torch.stack(
        [state.global_scores[:, 0] + cur0, state.global_scores[:, 1]],
        dim=-1), 0.0, 1e4))
    replace = state.globalkf_max_scores < best0
    state.globalkf_max_scores.copy_(
        torch.where(replace, best0, state.globalkf_max_scores))
    state.globalkf_id.copy_(torch.where(replace, gid_kf.to(torch.int32),
                                        state.globalkf_id))


@torch.no_grad()
def stablemask_control(state: GaussianState) -> GaussianState:
    """Unstable->stable when untouched this round; stable->unstable when the
    error score spikes; reset local scores. In place."""
    to_stable = (~state.stable) & (state.local_scores[:, 0] < 1e-4) \
        & state.alive
    to_unstable = state.stable & (state.local_scores[:, 1] > 0.3) & \
        (state.local_scores[:, 0] > 0.05)
    state.stable.copy_((state.stable | to_stable) & ~to_unstable)
    state.local_scores.zero_()
    return state


def storage_control(state: GaussianState, batch: KeyframeBatch,
                    binned_stack: BinnedScene, intr4, *, height: int,
                    width: int, render_kwargs=()):
    """Every few keyframes: re-render the window, accumulate plain-L1
    importance scores, prune mid-importance unstable Gaussians. In place;
    returns (state, n_pruned)."""
    rkw = dict(render_kwargs)
    imp = torch.zeros((state.capacity,), dtype=torch.float32,
                      device=state.xyz.device)
    for kf in range(batch.n_valid):
        camera = make_camera(batch.w2cs[kf], intr4, height, width)
        carrier = torch.zeros((state.capacity, 2), dtype=torch.float32,
                              device=state.xyz.device, requires_grad=True)
        rets = render(state.xyz, state.log_scale, state.quat,
                      state.logit_opacity, state.rgb, camera,
                      alive=state.alive, score_carrier=carrier,
                      binned=_select_kf(binned_stack, kf), **rkw)
        gt = batch.images[kf]
        m = (torch.sum(gt, dim=0) > 0).to(torch.float32)
        loss = torch.sum(torch.abs(rets["rgb"] - gt) * m[None]) / \
            torch.clamp(torch.sum(m) * 3.0, min=1.0)
        imp += torch.autograd.grad(loss, carrier, allow_unused=True,
                                   materialize_grads=True)[0][:, 0]
    prune = (imp > 0.05) & (imp < 0.8) & (~state.stable) & state.alive
    kill_rows(state, prune)
    return state, torch.sum(prune.to(torch.int32))
