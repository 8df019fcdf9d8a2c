"""Self-train the compact DPT metric-depth net on the geometric synthetic
stream (the recipe of the JAX package's scripts/train_metric_depth.py,
which made vings_mono_tpu/weights/metric_depth_selftrained.npz):
supervised rgb -> metric depth on ray-cast rooms with analytic depth,
with a scale-aware log-L1 loss (the net must recover metric scale, rooms
vary 3-5 m, from perspective cues at fixed synthetic intrinsics).

Usage: python -m vings_mono_tpu_torch.runners.train_metric_depth
           [--steps 3000] [--out output/metric_depth_selftrained.npz]
           [--lr 3e-4] [--batch 4] [--ckpt-every 250]
           [--resume WEIGHTS.npz] [--device cuda|cpu]

Checkpoints are the object-pickled `.npz` (params tree and `arch`) that
both packages' `load_dpt` read. Runs on CUDA unless `--device` says
otherwise, inside `utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .self_training import room_c2w

H, W = 128, 160          # multiples of 16 (the ViT's patch grid)
# hw is the net's canonical input size: the learned position embedding
# fixes the patch grid, so inference resizes to it and back
ARCH = {"dim": 192, "depth": 6, "taps": (1, 3, 5), "hw": (128, 160)}
POOL_CAP = 256


def sample(rng):
    """One room view: (rgb (H, W, 3), depth (H, W)), as numpy."""
    from ..datasets.synthetic3d import render_room, texture_params
    room = rng.uniform(3.0, 5.0)
    tex = texture_params(rng.integers(1 << 31),
                         sharpness=float(rng.uniform(0.0, 1.0)))
    f = rng.uniform(0.8, 1.1) * W
    intr = np.asarray([f, f, W / 2, H / 2], np.float32)
    pos = rng.uniform(-0.45, 0.45, 3) * room
    yaw, pitch = rng.uniform(-np.pi, np.pi), rng.uniform(-0.35, 0.35)
    rgb, dep = render_room(room_c2w(pos, yaw, pitch), intr, H, W, room,
                           tex=tex)
    return rgb.astype(np.float32), dep.astype(np.float32)


def to_batch(picks, device):
    return tuple(torch.as_tensor(np.stack([p[k] for p in picks]),
                                 device=device) for k in range(2))


def depth_loss(model, rgb, dep):
    """The script's loss_fn: (mean |log pred - log depth|, (absrel,)),
    both clamped at 1e-3."""
    pred = model(rgb)
    err = torch.abs(torch.log(pred.clamp(min=1e-3))
                    - torch.log(dep.clamp(min=1e-3)))
    # absolute relative error diagnostic
    absrel = torch.mean(torch.abs(pred - dep) / dep.clamp(min=1e-3))
    return err.mean(), (absrel.detach(),)


def build_model(resume, device):
    """DPTDepth(**ARCH) from a weights file, or at random from seed 0."""
    from ..models.dpt_depth import DPTDepth, load_dpt
    if resume:
        model, _ = load_dpt(resume, device=device)
    else:
        hw = ARCH["hw"]
        model = DPTDepth(ARCH["dim"], ARCH["depth"], ARCH["taps"],
                         grid=(hw[0] // 16, hw[1] // 16),
                         generator=torch.Generator().manual_seed(0))
    return model.to(device).train().requires_grad_(True)


def save_weights(path, model):
    from ..models.dpt_depth import dpt_flax_tree
    from ..models.flax_weights import save_pickled_params
    save_pickled_params(path, dpt_flax_tree(model), ARCH)


def train(steps, out, lr=3e-4, batch=4, ckpt_every=250, resume=None,
          device=None, seed=5, batch_seed=11, pool=None, log_every=25,
          on_step=None):
    """The recipe's loop: clip 1.0 + AdamW at a warmup-cosine rate over
    `steps` steps of `batch` views drawn from a pool (a SamplePool of
    `sample` from `seed` unless `pool` is given). Returns (model,
    history)."""
    from ..models.droid_trainer import make_loss_step, make_optimizer
    from ..utils.device import reproducible, resolve_device
    from .self_training import SamplePool, train_loop
    device = resolve_device(device)
    with reproducible():
        model = build_model(resume, device)
        opt, sched = make_optimizer(model, lr, steps)
        step = make_loss_step(lambda b: depth_loss(model, *b), opt, sched)
        own = pool is None
        if own:
            pool = SamplePool(sample, seed, POOL_CAP, batch)
        brng = np.random.default_rng(batch_seed)
        try:
            hist = train_loop(
                step, lambda: to_batch(pool.draw(brng, batch), device),
                steps, lambda path: save_weights(path, model), out,
                ckpt_every, ("logL1", "absrel"), log_every, on_step)
        finally:
            if own:
                pool.close()
    return model, hist


def main(argv=None):
    from .self_training import add_common_flags
    ap = argparse.ArgumentParser()
    add_common_flags(ap, 3000, "output/metric_depth_selftrained.npz", 3e-4,
                     batch=4)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    train(args.steps, args.out, args.lr, args.batch, args.ckpt_every,
          args.resume, args.device)


if __name__ == "__main__":
    main()
