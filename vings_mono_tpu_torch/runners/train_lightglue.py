"""Self-train a compact LightGlue matcher on synthetic room pairs (the recipe
of the JAX package's scripts/train_lightglue.py, which made
vings_mono_tpu/weights/lightglue_selftrained.npz).

A frozen self-trained SuperPoint extracts N_KP keypoints and descriptors
on two ray-cast views; the analytic depth and poses give the exact
partial assignment (each A keypoint reprojected into B, the nearest B
keypoint within 3 px, occlusion-checked); the loss is the assignment
NLL: -scores[i, gt_i] over matched points, -log(1 - z) over unmatchable
valid ones on either side.

Usage: python -m vings_mono_tpu_torch.runners.train_lightglue
           [--steps 2000] [--out output/lightglue_selftrained.npz]
           [--lr 1e-4] [--ckpt-every 250] [--resume WEIGHTS.npz]
           [--superpoint WEIGHTS.npz (default: the repository's
           vings_mono_tpu/weights/superpoint_selftrained.npz)]
           [--device cuda|cpu]

Checkpoints are the object-pickled `.npz` (params tree and `arch`) that
both packages' LightGlue loaders read. Runs on CUDA unless `--device`
says otherwise, inside `utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .self_training import room_c2w

H, W = 240, 320
N_KP = 256
ARCH = {"layers": 2}
POOL_CAP = 256
POOL_MIN = 4
SUPERPOINT = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                          "vings_mono_tpu", "weights",
                          "superpoint_selftrained.npz")
GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)


def sample_views(rng):
    """Two views of a random room: (rgb_a, depth_a, c2w_a, rgb_b, depth_b,
    c2w_b, intr), as numpy."""
    from ..datasets.synthetic3d import render_room, texture_params
    room = rng.uniform(3.0, 5.0)
    tex = texture_params(rng.integers(1 << 31), sharpness=1.0)
    f = rng.uniform(0.9, 1.1) * W * 0.75
    intr = np.asarray([f, f, W / 2, H / 2], np.float32)
    pos = rng.uniform(-0.4, 0.4, 3) * room
    yaw, pitch = rng.uniform(-np.pi, np.pi), rng.uniform(-0.3, 0.3)
    a = room_c2w(pos, yaw, pitch)
    b = room_c2w(pos + rng.normal(size=3) * 0.25, yaw + rng.normal() * 0.2,
             np.clip(pitch + rng.normal() * 0.1, -0.4, 0.4))
    rgb_a, dep_a = render_room(a, intr, H, W, room, tex=tex)
    rgb_b, dep_b = render_room(b, intr, H, W, room, tex=tex)
    return (rgb_a.astype(np.float32), dep_a, a,
            rgb_b.astype(np.float32), dep_b, b, intr)


def gt_assignment(xy_a, va, dep_a, c2w_a, xy_b, vb, dep_b, c2w_b, intr,
                  tol=3.0):
    """Reproject the A keypoints into B: the index of the nearest valid B
    keypoint within `tol` px (occlusion-checked), else -1."""
    fx, fy, cx, cy = intr
    gt = np.full(N_KP, -1, np.int64)
    u = np.clip(xy_a[:, 0].astype(int), 0, W - 1)
    v = np.clip(xy_a[:, 1].astype(int), 0, H - 1)
    z = dep_a[v, u]
    pc = np.stack([(xy_a[:, 0] - cx) / fx * z,
                   (xy_a[:, 1] - cy) / fy * z, z], -1)
    pw = pc @ c2w_a[:3, :3].T + c2w_a[:3, 3]
    w2c = np.linalg.inv(c2w_b)
    pb = pw @ w2c[:3, :3].T + w2c[:3, 3]
    zb = pb[:, 2]
    ok = va & (z > 0.05) & (zb > 0.05)
    zs = np.where(zb > 0.05, zb, 1.0)
    ub = fx * pb[:, 0] / zs + cx
    vb_pix = fy * pb[:, 1] / zs + cy
    ok &= (ub >= 0) & (ub < W) & (vb_pix >= 0) & (vb_pix < H)
    ui = np.clip(ub, 0, W - 1).astype(int)
    vi = np.clip(vb_pix, 0, H - 1).astype(int)
    ok &= np.abs(dep_b[vi, ui] - zb) < np.maximum(0.03 * zb, 0.05)
    proj = np.stack([ub, vb_pix], -1)
    d = np.linalg.norm(proj[:, None, :] - xy_b[None, :, :], axis=-1)
    d[:, ~vb] = 1e9
    j = np.argmin(d, axis=1)
    dmin = d[np.arange(N_KP), j]
    hit = ok & (dmin < tol)
    gt[hit] = j[hit]
    return gt


def scatter_last(n, idx, vals, fill):
    """out = full(n, fill); out[idx] = vals where, at a repeated index,
    the last write wins, as a sequential scatter (the script's
    `.at[idx].set(vals)` on the CPU) does."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n,), -1, dtype=pos.dtype, device=idx.device)
    last = last.scatter_reduce(0, idx, pos, "amax")
    return torch.where(last >= 0, vals[last.clamp(min=0)], fill)


def lightglue_loss(lg, da, db, ka, kb, va, vb, gt):
    """The script's loss_fn: (loss, (acc,)) for one pair of keypoint
    sets; gt (N_KP,) from gt_assignment."""
    scores, z0, z1 = lg(da, db, ka, kb, va, vb)
    matched = gt >= 0
    gt_c = gt.clamp(min=0)
    nll_m = -torch.gather(scores, 1, gt_c[:, None])[:, 0]
    # unmatchable valid points should have low matchability
    nll_u0 = -torch.log((1.0 - z0).clamp(min=1e-9))
    # the B points some A point matches; gt_c holds 0 for every unmatched
    # A point, and the script's scatter lets the last of them win
    matched_b = scatter_last(z1.shape[0], gt_c, matched, False)
    nll_u1 = -torch.log((1.0 - z1).clamp(min=1e-9))
    n_m = matched.sum().clamp(min=1)
    un0 = va & ~matched
    un1 = vb & ~matched_b
    loss = (torch.where(matched, nll_m, 0.0).sum() / n_m
            + 0.5 * torch.where(un0, nll_u0, 0.0).sum()
            / un0.sum().clamp(min=1)
            + 0.5 * torch.where(un1, nll_u1, 0.0).sum()
            / un1.sum().clamp(min=1))
    # diagnostic: argmax accuracy on matched rows
    acc = ((torch.argmax(scores, 1) == gt_c) & matched).sum() / n_m
    return loss, acc.detach()


def extract_keypoints(sp, rgb):
    """The frozen SuperPoint's (xy, score, valid, desc) at N_KP keypoints
    of an rgb view, on its device."""
    from ..models.superpoint import extract
    dev = next(sp.parameters()).device
    return extract(sp, torch.as_tensor(rgb @ GRAY, device=dev), N_KP)


def pair_inputs(sp, views, device):
    """SuperPoint's keypoints and descriptors on both views and the ground
    truth assignment: (da, db, ka, kb, va, vb, gt) on `device`, where sp
    runs."""
    from ..models.lightglue import normalize_keypoints
    rgb_a, dep_a, c2w_a, rgb_b, dep_b, c2w_b, intr = views
    xa, _, va, da = extract_keypoints(sp, rgb_a)
    xb, _, vb, db = extract_keypoints(sp, rgb_b)
    gt = gt_assignment(xa.cpu().numpy(), va.cpu().numpy(), dep_a, c2w_a,
                       xb.cpu().numpy(), vb.cpu().numpy(), dep_b, c2w_b,
                       intr)
    return (da, db, normalize_keypoints(xa, (H, W)),
            normalize_keypoints(xb, (H, W)), va, vb,
            torch.as_tensor(gt, device=device))


def build_model(resume, device):
    """LightGlue(**ARCH) from a weights file, or at random from seed 0."""
    from ..models.lightglue import LightGlue, load_lightglue
    if resume:
        model = load_lightglue(resume)
    else:
        model = LightGlue(**ARCH, generator=torch.Generator().manual_seed(0))
    return model.to(device).train().requires_grad_(True)


def save_weights(path, model):
    from ..models.flax_weights import (flax_tree_from_state_dict,
                                       save_pickled_params)
    save_pickled_params(path, flax_tree_from_state_dict(model.state_dict()),
                        {"layers": model.layers})


def train(steps, out, lr=1e-4, ckpt_every=250, resume=None, device=None,
          superpoint=SUPERPOINT, seed=9, batch_seed=13, pool=None,
          log_every=25, on_step=None):
    """The recipe's loop: clip 1.0 + AdamW at a warmup-cosine rate over
    `steps` steps, one pair of views each, drawn from a pool (a
    SamplePool of sample_views from `seed` unless `pool` is given).
    Returns (model, history)."""
    from ..models.droid_trainer import make_loss_step, make_optimizer
    from ..models.superpoint import load_superpoint
    from ..utils.device import reproducible, resolve_device
    from .self_training import SamplePool, train_loop
    device = resolve_device(device)
    with reproducible():
        sp = load_superpoint(superpoint, device=device)
        model = build_model(resume, device)
        opt, sched = make_optimizer(model, lr, steps)
        loss_step = make_loss_step(
            lambda b: lightglue_loss(model, *b), opt, sched)

        def step(batch):
            loss, acc, applied = loss_step(batch)
            return loss, (acc, (batch[-1] >= 0).sum()), applied
        own = pool is None
        if own:
            pool = SamplePool(sample_views, seed, POOL_CAP, POOL_MIN)
        brng = np.random.default_rng(batch_seed)
        try:
            hist = train_loop(
                step, lambda: pair_inputs(sp, pool.draw(brng), device),
                steps, lambda path: save_weights(path, model), out,
                ckpt_every, ("loss", "acc", "gt_matches"), log_every,
                on_step)
        finally:
            if own:
                pool.close()
    return model, hist


def main(argv=None):
    from .self_training import add_common_flags
    ap = argparse.ArgumentParser()
    add_common_flags(ap, 2000, "output/lightglue_selftrained.npz", 1e-4)
    ap.add_argument("--superpoint", default=SUPERPOINT)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    train(args.steps, args.out, args.lr, args.ckpt_every, args.resume,
          args.device, args.superpoint)


if __name__ == "__main__":
    main()
