"""DROID training forward and losses (reference droid_net.py:178-228, the
unrolled GRU + BA iterations; geom/losses.py, the geodesic, residual and
flow losses). The whole unrolled optimization is one autograd graph:
gradients flow through the Schur-complement BA by autograd of the
Cholesky factor and solve (the reference needed a handwritten
CholeskySolver backward, chol.py:5-33).

Nothing here runs under `torch.no_grad()`, and nothing calls the tracker,
whose entry points do. A step runs its forward and backward in true f32
(`utils.device.true_f32`), as the reference computes them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import ba as ba_ops
from ..ops import corr as corr_ops
from ..ops import lie, projective as pops
from ..utils.device import true_f32
from .droid_net import normalize_image


class TrainBatch(NamedTuple):
    images: torch.Tensor      # (P, H, W, 3) in [0,1]
    poses_gt: torch.Tensor    # (P, 7) w2c
    disps_gt: torch.Tensor    # (P, h, w) 1/8-res inverse depth
    intrinsics: torch.Tensor  # (4,) at 1/8 res
    ii: torch.Tensor          # (N,) edges
    jj: torch.Tensor


def droid_forward(model, batch: TrainBatch, num_steps=12, fixedp=2):
    """Unrolled inference: per step (poses, disps, target, weight)."""
    fmap, net0, inp = model.extract_features(normalize_image(batch.images))
    ii, jj = batch.ii.long(), batch.jj.long()
    pyr = corr_ops.build_pyramid(fmap[ii], fmap[jj])
    net = net0[ii]
    inp_e = inp[ii]

    h, w = batch.disps_gt.shape[-2:]
    coords0 = pops.coords_grid(h, w, device=batch.disps_gt.device)
    P = batch.poses_gt.shape[0]

    # Gauge + scale anchor: the `fixedp` pinned poses start AT ground
    # truth and the remaining frames at the last pinned pose (constant-
    # motion init). DROID training fixes the first two poses to GT to pin
    # the monocular gauge AND scale; initializing everything to identity
    # while pinning two frames with real GT motion between them makes the
    # pose loss irreducible.
    k = torch.arange(P, device=batch.poses_gt.device)[:, None]
    anchor = batch.poses_gt[max(fixedp - 1, 0)]
    poses = torch.where(k < fixedp, batch.poses_gt,
                        anchor.expand_as(batch.poses_gt))
    disps = torch.ones_like(batch.disps_gt)
    edge_valid = torch.ones(ii.shape[0], dtype=torch.bool, device=ii.device)
    eta = torch.full((P, h, w), 1e-2, device=batch.disps_gt.device)

    traj = []
    target = None
    for _ in range(num_steps):
        coords1, _ = pops.projective_transform(poses, disps,
                                               batch.intrinsics, ii, jj)
        corr = corr_ops.lookup(pyr, coords1)
        if target is None:
            target = coords1
        motn = torch.cat([coords1 - coords0, target - coords1],
                         dim=-1).clamp(-64.0, 64.0)
        net, delta, weight, _, _ = model.run_update(net, inp_e, corr, motn)
        target = coords1 + delta
        poses, disps = ba_ops.ba(target.movedim(-1, 1),
                                 weight.movedim(-1, 1), eta, poses, disps,
                                 batch.intrinsics, ii, jj, edge_valid,
                                 fixedp=fixedp, iters=2)
        traj.append((poses, disps, target, weight))
    return traj


def geodesic_loss(poses, poses_gt, ii, jj):
    """Relative-pose geodesic loss over graph edges (losses.py:30)."""
    dG = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    dG_gt = lie.se3_mul(poses_gt[jj], lie.se3_inv(poses_gt[ii]))
    d = lie.se3_log(lie.se3_mul(dG_gt, lie.se3_inv(dG)))
    tr = torch.linalg.norm(d[..., :3], dim=-1)
    ro = torch.linalg.norm(d[..., 3:], dim=-1)
    return torch.mean(tr + ro)


def residual_loss(target, weight, poses_gt, disps_gt, intrinsics, ii, jj):
    """Weighted flow residual against ground-truth reprojection
    (losses.py:77)."""
    coords_gt, valid = pops.projective_transform(poses_gt, disps_gt,
                                                 intrinsics, ii, jj)
    r = (target - coords_gt) * valid
    return torch.mean(torch.abs(r) * weight)


def flow_loss(target, poses_gt, disps_gt, intrinsics, ii, jj):
    """Direct flow endpoint error (losses.py:89)."""
    coords_gt, valid = pops.projective_transform(poses_gt, disps_gt,
                                                 intrinsics, ii, jj)
    return torch.sum(torch.abs(target - coords_gt) * valid) / torch.clamp(
        torch.sum(valid), min=1.0)


def droid_training_loss(model, batch: TrainBatch, num_steps=6, gamma=0.9,
                        w_pose=10.0, w_resid=0.01, w_flow=0.1):
    traj = droid_forward(model, batch, num_steps)
    ii, jj = batch.ii.long(), batch.jj.long()
    total = 0.0
    n = len(traj)
    for s, (poses, disps, target, weight) in enumerate(traj):
        g = gamma ** (n - s - 1)
        total = total + g * (
            w_pose * geodesic_loss(poses, batch.poses_gt, ii, jj)
            + w_resid * residual_loss(target, weight, batch.poses_gt,
                                      batch.disps_gt, batch.intrinsics,
                                      ii, jj)
            + w_flow * flow_loss(target, batch.poses_gt, batch.disps_gt,
                                 batch.intrinsics, ii, jj))
    return total


# ---------------------------------------------------------------------------
# the optimizer step: optax's clip_by_global_norm + adamw + a schedule

def warmup_cosine_decay(init_value, peak_value, warmup_steps, decay_steps,
                        end_value=0.0):
    """optax.warmup_cosine_decay_schedule as a function of the step count:
    linear from init_value to peak_value over warmup_steps, then a cosine
    to end_value at decay_steps (held after)."""
    def lr(count):
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count \
                / warmup_steps
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t
                                       / (decay_steps - warmup_steps)))
        alpha = end_value / peak_value
        return peak_value * ((1.0 - alpha) * cosine + alpha)
    return lr


def clip_by_global_norm_(grads, max_norm):
    """optax.clip_by_global_norm in place: every gradient times
    max_norm / norm when the global norm exceeds max_norm (divided by the
    norm itself, as optax does; torch's clip_grad_norm_ adds 1e-6)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


CLIP_NORM = 1.0        # global-norm clipping (FastSAM's recipe: 5.0)
WEIGHT_DECAY = 1e-5


def make_optimizer(model, lr, steps):
    """AdamW (optax's defaults: betas 0.9/0.999, eps 1e-8) at optax's
    warmup-cosine schedule from 0 to `lr` over min(100, steps / 10)
    warmup steps, decaying to lr / 20 at `steps`. Returns (optimizer,
    scheduler); the scheduler is stepped once per optimizer step."""
    warmup = min(100, max(steps // 10, 1))
    sched = warmup_cosine_decay(0.0, lr, warmup, max(steps, warmup + 1),
                                end_value=lr * 0.05)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=WEIGHT_DECAY)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: sched(count) / lr)


def apply_gradients(optimizer, scheduler, loss=None, clip_norm=CLIP_NORM):
    """One optimizer step on the gradients in the parameters' `.grad`
    (a parameter without one is left out): clipping to a global norm of
    `clip_norm`, the optimizer, the scheduler. Skip-on-nonfinite: when
    `loss` or any gradient is not finite nothing changes, and neither the
    optimizer's nor the schedule's count advances. Returns whether the
    step was applied (a host sync)."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    finite = [torch.isfinite(g).all() for g in grads]
    if loss is not None:
        finite.append(torch.isfinite(loss).all())
    if not bool(torch.stack(finite).all()):
        return False
    clip_by_global_norm_(grads, clip_norm)
    optimizer.step()
    scheduler.step()
    return True


def make_loss_step(loss_fn, optimizer, scheduler, clip_norm=CLIP_NORM):
    """A train step of any loss: loss_fn(batch) -> (loss, diagnostics),
    its gradients in true f32, then `apply_gradients`. A step with a
    non-finite loss or gradient changes nothing. step(batch) returns
    (loss, diagnostics, whether the step was applied)."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        with true_f32():
            loss, aux = loss_fn(batch)
            loss.backward()
        good = apply_gradients(optimizer, scheduler, loss.detach(),
                               clip_norm)
        optimizer.zero_grad(set_to_none=True)
        return loss.detach(), aux, good

    return step


def make_train_step(model, optimizer, scheduler, num_steps=6):
    """A train step over the unrolled forward (`make_loss_step`). A single
    blown-up clip (ill-conditioned BA on a large-baseline sample) must not
    poison the parameters or the Adam moments. step(batch) returns (loss,
    whether the step was applied)."""
    step = make_loss_step(
        lambda b: (droid_training_loss(model, b, num_steps=num_steps), ()),
        optimizer, scheduler)

    def droid_step(batch):
        loss, _, good = step(batch)
        return loss, good

    return droid_step
