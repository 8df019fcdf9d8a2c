"""Self-train SuperPoint on the geometric synthetic3d stream (the recipe of
the JAX package's scripts/train_superpoint.py, which made
vings_mono_tpu/weights/superpoint_selftrained.npz):

- detector head: the 65-way per-cell cross-entropy against Shi-Tomasi
  corner self-labels (cv2.goodFeaturesToTrack) on ray-cast room renders,
  the target smoothed over the 8x8 sub-pixel grid (sigma 1 px);
- descriptor head: InfoNCE at temperature 0.07 over up to K exact
  correspondences per pair (room pairs come with analytic depth and
  poses: corner pixels of view A unproject and reproject into view B
  with an occlusion check), invalid columns masked at -1e9.

Usage: python -m vings_mono_tpu_torch.runners.train_superpoint
           [--steps 3000] [--out output/superpoint_selftrained.npz]
           [--lr 3e-4] [--ckpt-every 250] [--resume WEIGHTS.npz]
           [--device cuda|cpu]

Checkpoints are the flat flax `.npz` (f32) that both packages'
`load_superpoint` read. Runs on CUDA unless `--device` says otherwise,
inside `utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np
import torch

from .self_training import room_c2w

H, W = 120, 160
K = 128          # correspondence budget per pair
POOL_CAP = 512
POOL_MIN = 8     # samples in the pool before the first step
BS_PAIRS = 3     # pairs per step (6 views, interleaved a0 b0 a1 b1 ...)
TAU = 0.07


def _gray(rgb):
    return (rgb @ np.asarray([0.299, 0.587, 0.114])).astype(np.float32)


def _corner_labels(gray):
    """Shi-Tomasi corners -> (65-way cell labels (h8*w8,), corner xy)."""
    h8, w8 = H // 8, W // 8
    g8 = (np.clip(gray, 0, 1) * 255).astype(np.uint8)
    pts = cv2.goodFeaturesToTrack(g8, maxCorners=150, qualityLevel=0.03,
                                  minDistance=5)
    lab = np.full(h8 * w8, 64, np.int32)
    xy = np.zeros((0, 2), np.float32)
    if pts is not None:
        xy = pts.reshape(-1, 2).astype(np.float32)
        # strongest first (goodFeaturesToTrack sorts by quality): the
        # first corner to claim a cell wins
        for x, y in xy:
            xi, yi = int(x), int(y)
            cell = (yi // 8) * w8 + xi // 8
            if lab[cell] == 64:
                lab[cell] = (yi % 8) * 8 + xi % 8
    return lab, xy


def _pose(room, rng):
    pos = rng.uniform(-0.45, 0.45, 3) * room
    yaw, pitch = rng.uniform(-np.pi, np.pi), rng.uniform(-0.35, 0.35)
    return pos, yaw, pitch



def _correspond(xy_a, depth_a, c2w_a, c2w_b, depth_b, intr):
    """Project view-A corner pixels into view B through the analytic
    geometry. Returns (ptsA (K, 2), ptsB (K, 2), valid (K,)),
    zero-padded."""
    fx, fy, cx, cy = intr
    out_a = np.zeros((K, 2), np.float32)
    out_b = np.zeros((K, 2), np.float32)
    val = np.zeros(K, bool)
    if len(xy_a) == 0:
        return out_a, out_b, val
    u, v = xy_a[:, 0], xy_a[:, 1]
    z = depth_a[v.astype(int), u.astype(int)]
    pc = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    pw = pc @ c2w_a[:3, :3].T + c2w_a[:3, 3]
    w2c_b = np.linalg.inv(c2w_b)
    pb = pw @ w2c_b[:3, :3].T + w2c_b[:3, 3]
    zb = pb[:, 2]
    ok = zb > 0.05
    zb_safe = np.where(ok, zb, 1.0)
    ub = fx * pb[:, 0] / zb_safe + cx
    vb = fy * pb[:, 1] / zb_safe + cy
    ok &= (ub >= 1) & (ub < W - 1) & (vb >= 1) & (vb < H - 1)
    ui = np.clip(ub, 0, W - 1).astype(int)
    vi = np.clip(vb, 0, H - 1).astype(int)
    # occlusion: the reprojected depth must match B's depth buffer
    ok &= np.abs(depth_b[vi, ui] - zb) < np.maximum(0.03 * zb, 0.05)
    idx = np.where(ok)[0][:K]
    n = len(idx)
    out_a[:n] = xy_a[idx]
    out_b[:n] = np.stack([ub[idx], vb[idx]], -1)
    val[:n] = True
    return out_a, out_b, val


def random_pair(rng):
    """One training sample: two overlapping views of a random room with
    corner self-labels and exact correspondences, as numpy."""
    from ..datasets.synthetic3d import render_room, texture_params
    room = rng.uniform(3.0, 5.0)
    # sharp (square-wave-shaped) textures: smooth sinusoids have no
    # localizable corners
    tex = texture_params(rng.integers(1 << 31), sharpness=1.0)
    f = rng.uniform(0.8, 1.1) * W
    intr = np.asarray([f, f, W / 2, H / 2], np.float32)
    for _ in range(8):                       # resample until enough overlap
        pos, yaw, pitch = _pose(room, rng)
        c2w_a = room_c2w(pos, yaw, pitch)
        c2w_b = room_c2w(pos + rng.normal(size=3) * 0.25 * room * 0.3,
                     yaw + rng.normal() * 0.25,
                     np.clip(pitch + rng.normal() * 0.1, -0.5, 0.5))
        rgb_a, dep_a = render_room(c2w_a, intr, H, W, room, tex=tex)
        rgb_b, dep_b = render_room(c2w_b, intr, H, W, room, tex=tex)
        ga, gb = _gray(rgb_a), _gray(rgb_b)
        lab_a, xy_a = _corner_labels(ga)
        lab_b, _ = _corner_labels(gb)
        pa, pb, val = _correspond(xy_a, dep_a, c2w_a, c2w_b, dep_b, intr)
        if val.sum() >= 16:
            break
    return dict(gray=np.stack([ga, gb])[..., None],
                labels=np.stack([lab_a, lab_b]),
                pts_a=pa, pts_b=pb, valid=val)


def stack_pairs(picks):
    """The script's batch of pairs: per-view arrays (a leading axis of 2)
    concatenated, so the views interleave [a0, b0, a1, b1, ...]; the
    per-pair arrays stacked."""
    return {k: np.concatenate([p[k] for p in picks])
            if picks[0][k].ndim and picks[0][k].shape[0] == 2
            else np.stack([p[k] for p in picks]) for k in picks[0]}


def to_batch(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def target_table():
    """(65, 65) detector targets: a label's row is a sigma = 1 px Gaussian
    over the 8x8 sub-pixel grid around it (exact 64-way targets are too
    sparse to generalize from); the dustbin's row is one-hot."""
    dyx = np.stack(np.meshgrid(np.arange(8), np.arange(8),
                               indexing="ij"), -1).reshape(64, 2)
    d2 = ((dyx[None, :, :] - dyx[:, None, :]) ** 2).sum(-1)
    smooth64 = np.exp(-d2 / 2.0)
    smooth64 /= smooth64.sum(1, keepdims=True)
    table = np.zeros((65, 65), np.float32)
    table[:64, :64] = smooth64
    table[64, 64] = 1.0
    return table


def superpoint_loss(model, batch, table):
    """The script's loss_fn: detector cross-entropy + descriptor InfoNCE.
    batch: gray (2P, H, W, 1) interleaved views, labels (2P, h8 w8),
    pts_a / pts_b (P, K, 2), valid (P, K); table = target_table() on the
    device. Returns (loss, (det_ce, nce, det_acc, det_acc2px,
    match_acc))."""
    from ..models.superpoint import sample_descriptors
    _, desc_map, logits = model(batch["gray"], with_logits=True)
    B = logits.shape[0]
    logp = torch.log_softmax(logits.reshape(B, -1, 65), -1)
    lab = batch["labels"].long()
    ce = -torch.sum(table[lab] * logp, -1).mean()

    nces, accs = [], []
    tgt = torch.arange(K, device=logp.device)
    for p in range(B // 2):
        val = batch["valid"][p]
        da = sample_descriptors(batch["pts_a"][p], desc_map[2 * p], (H, W))
        db = sample_descriptors(batch["pts_b"][p], desc_map[2 * p + 1],
                                (H, W))
        sim = (da @ db.T) / TAU
        big = torch.where(val[None, :], 0.0, -1e9)
        ce_ab = -torch.diagonal(torch.log_softmax(sim + big, -1))
        ce_ba = -torch.diagonal(torch.log_softmax(sim.T + big, -1))
        n_val = val.sum().clamp(min=1)
        nces.append(torch.sum(torch.where(val, ce_ab + ce_ba, 0.0))
                    / n_val * 0.5)
        accs.append(torch.sum((torch.argmax(sim + big, -1) == tgt) & val)
                    / n_val)
    nce = torch.stack(nces).mean()
    # diagnostics: detector cell accuracy (exact and within 2 px) and
    # the descriptor's nearest-neighbour match accuracy
    pred = torch.argmax(logp, -1)
    corner = lab != 64
    share = corner.float().mean().clamp(min=1e-6)
    acc_det = ((pred == lab) & corner).float().mean() / share
    dpix2 = (pred // 8 - lab // 8) ** 2 + (pred % 8 - lab % 8) ** 2
    acc_det2 = ((pred != 64) & (dpix2 <= 4) & corner).float().mean() / share
    aux = (ce, nce, acc_det, acc_det2, torch.stack(accs).mean())
    return ce + nce, tuple(a.detach() for a in aux)


def build_model(resume, device):
    """SuperPoint from a weights file, or at random from seed 0."""
    from ..models.superpoint import SuperPoint, load_superpoint
    if resume:
        model = load_superpoint(resume)
    else:
        model = SuperPoint(generator=torch.Generator().manual_seed(0))
    return model.to(device).train().requires_grad_(True)


def save_weights(path, model):
    """The flat flax `.npz` of `save_flax_weights`, in f32."""
    from ..models.flax_weights import flax_from_state_dict
    np.savez_compressed(path, **flax_from_state_dict(model.state_dict()))


def train(steps, out, lr=3e-4, ckpt_every=250, resume=None, device=None,
          seed=77, batch_seed=123, pool=None, log_every=25, on_step=None):
    """The recipe's loop: clip 1.0 + AdamW at a warmup-cosine rate over
    `steps` steps on BS_PAIRS pairs drawn from a pool (a SamplePool of
    random_pair from `seed` unless `pool` is given). Returns (model,
    history)."""
    from ..models.droid_trainer import make_loss_step, make_optimizer
    from ..utils.device import reproducible, resolve_device
    from .self_training import SamplePool, train_loop
    device = resolve_device(device)
    with reproducible():
        model = build_model(resume, device)
        opt, sched = make_optimizer(model, lr, steps)
        table = torch.as_tensor(target_table(), device=device)
        step = make_loss_step(lambda b: superpoint_loss(model, b, table),
                              opt, sched)
        own = pool is None
        if own:
            pool = SamplePool(random_pair, seed, POOL_CAP, POOL_MIN)
        brng = np.random.default_rng(batch_seed)
        try:
            hist = train_loop(
                step, lambda: to_batch(stack_pairs(
                    pool.draw(brng, BS_PAIRS)), device), steps,
                lambda path: save_weights(path, model), out, ckpt_every,
                ("loss", "det_ce", "nce", "det_acc", "det_acc2px",
                 "match_acc"), log_every, on_step)
        finally:
            if own:
                pool.close()
    return model, hist


def main(argv=None):
    from .self_training import add_common_flags
    ap = argparse.ArgumentParser()
    add_common_flags(ap, 3000, "output/superpoint_selftrained.npz", 3e-4)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    train(args.steps, args.out, args.lr, args.ckpt_every, args.resume,
          args.device)


if __name__ == "__main__":
    main()
