"""Self-train the FastSAM-class YOLOv8-seg net on synthetic composites (the
recipe of the JAX package's scripts/train_fastsam.py, which made
vings_mono_tpu/weights/fastsam_selftrained.npz).

Data: ray-cast room backgrounds and 1-3 textured superellipse sprites
with exact instance masks. Loss, a single-positive YOLOv8-seg:
- objectness BCE per stride, positive at each object's centre cell on
  the stride its size matches, positives weighted up;
- the DFL cross-entropy of the 4 box-side distances at those cells;
- the instance-mask BCE of sigmoid(proto @ mask coefficients) against the
  mask at 1/4 resolution, weighted up inside the box.

Usage: python -m vings_mono_tpu_torch.runners.train_fastsam
           [--steps 2500] [--out output/fastsam_selftrained.npz]
           [--lr 8e-4] [--batch 4] [--ckpt-every 250]
           [--resume WEIGHTS.npz] [--device cuda|cpu]

Every parameter trains, the FrozenBN statistics (`mean`, `var`) too, as
the script's AdamW moves and decays every leaf of the flax tree; the
gradients are clipped to a global norm of 5. Checkpoints are the
object-pickled `.npz` (params tree) that both packages' FastSAM loaders
read. Runs on CUDA unless `--device` says otherwise, inside
`utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from .self_training import room_c2w

H, W = 160, 224          # multiples of 32
MAXOBJ = 3
STRIDES = (8, 16, 32)
CLIP_NORM = 5.0
POOL_CAP = 256


def _sprite_texture(rng, h, w):
    """Cheap distinct sprite texture: 2D sinusoid mixture."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rgb = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        acc = 0.5
        for _ in range(3):
            fx, fy = rng.uniform(-0.3, 0.3, 2)
            acc = acc + rng.uniform(0.1, 0.25) * np.sin(
                fx * xs + fy * ys + rng.uniform(0, 6.28))
        rgb[..., c] = acc
    return np.clip(rgb, 0, 1)


def sample(rng):
    """One composite: (rgb (H, W, 3), boxes (MAXOBJ, 4) x0 y0 x1 y1,
    masks (MAXOBJ, H, W), valid (MAXOBJ,)), as numpy."""
    from ..datasets.synthetic3d import render_room, texture_params
    room = rng.uniform(3.0, 5.0)
    tex = texture_params(rng.integers(1 << 31),
                         sharpness=float(rng.uniform(0, 1)))
    f = rng.uniform(0.8, 1.1) * W * 0.7
    intr = np.asarray([f, f, W / 2, H / 2], np.float32)
    pos = rng.uniform(-0.45, 0.45, 3) * room
    yaw, pitch = rng.uniform(-np.pi, np.pi), rng.uniform(-0.3, 0.3)
    rgb, _ = render_room(room_c2w(pos, yaw, pitch), intr, H, W, room,
                         tex=tex)
    rgb = rgb.astype(np.float32)

    n_obj = int(rng.integers(1, MAXOBJ + 1))
    boxes = np.zeros((MAXOBJ, 4), np.float32)
    masks = np.zeros((MAXOBJ, H, W), np.float32)
    valid = np.zeros(MAXOBJ, bool)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for k in range(n_obj):
        a = rng.uniform(10, 55)                      # half-extent x
        b = rng.uniform(10, 55)
        cx = rng.uniform(a + 2, W - a - 2)
        cyp = rng.uniform(b + 2, H - b - 2)
        th = rng.uniform(0, np.pi)
        p = rng.uniform(1.5, 4.0)                    # superellipse power
        xr = (xs - cx) * np.cos(th) + (ys - cyp) * np.sin(th)
        yr = -(xs - cx) * np.sin(th) + (ys - cyp) * np.cos(th)
        m = (np.abs(xr / a) ** p + np.abs(yr / b) ** p) <= 1.0
        if m.sum() < 40:
            continue
        spr = _sprite_texture(rng, H, W)
        rgb = np.where(m[..., None], spr, rgb)
        # composited over earlier sprites: occlude their masks
        masks[:k][:, m] = 0.0
        us, vs = xs[m], ys[m]
        boxes[k] = [us.min(), vs.min(), us.max() + 1, vs.max() + 1]
        masks[k] = m.astype(np.float32)
        valid[k] = True
    # drop fully occluded earlier objects
    for k in range(n_obj):
        if valid[k] and masks[k].sum() < 40:
            valid[k] = False
    return rgb, boxes, masks, valid


def to_batch(picks, device):
    """(rgb, boxes, masks, valid) stacked over the picked samples."""
    return tuple(torch.as_tensor(np.stack([p[k] for p in picks]),
                                 device=device) for k in range(4))


def sigmoid_bce(x, y):
    """optax.sigmoid_binary_cross_entropy."""
    return -y * F.logsigmoid(x) - (1.0 - y) * F.logsigmoid(-x)


def assign_scale(boxes):
    """The stride whose REG_MAX range covers the box comfortably: 0, 1, 2
    by the box's larger side below 56, 112, or above."""
    size = torch.maximum(boxes[..., 2] - boxes[..., 0],
                         boxes[..., 3] - boxes[..., 1])
    return torch.where(size < 56.0, 0, torch.where(size < 112.0, 1, 2))


def fastsam_loss(model, rgb, boxes, masks, valid):
    """The script's loss_fn over a batch: rgb (B, H, W, 3), boxes (B,
    MAXOBJ, 4), masks (B, MAXOBJ, H, W), valid (B, MAXOBJ). Returns
    (cls + 0.5 dfl + mask, (cls, dfl, mask))."""
    from ..models.fastsam import REG_MAX
    preds, proto = model(rgb)
    B, M = valid.shape
    dev = rgb.device
    scale_of = assign_scale(boxes)
    # the mask target at 1/4 and its weight map: 1.1 inside the box
    # (its edges rounded outward at 1/4), 0.1 outside
    gt4 = masks[:, :, ::4, ::4]
    gy = torch.arange(gt4.shape[2], device=dev)[:, None]
    gx = torch.arange(gt4.shape[3], device=dev)[None, :]
    x0, y0 = ((boxes[..., k] / 4).to(torch.int32)[..., None, None]
              for k in (0, 1))
    x1, y1 = (torch.ceil(boxes[..., k] / 4).to(torch.int32)[..., None, None]
              for k in (2, 3))
    wmap = ((gx >= x0) & (gx < x1) & (gy >= y0) & (gy < y1)).float() + 0.1
    total_cls = total_dfl = total_msk = 0.0
    for i, stride in enumerate(STRIDES):
        p = preds[i]
        ph, pw = p.shape[1:3]
        cxy = (boxes[..., :2] + boxes[..., 2:]) / 2.0 / stride
        ci = cxy[..., 0].to(torch.int32).clamp(0, pw - 1).long()
        cj = cxy[..., 1].to(torch.int32).clamp(0, ph - 1).long()
        on = valid & (scale_of == i)
        cell = cj * pw + ci                                   # (B, M)
        # the target: .at[cj, ci].max(on), a max over repeated cells
        tgt = torch.zeros((B, ph * pw), device=dev).scatter_reduce(
            1, cell, on.float(), "amax").reshape(B, ph, pw)
        cls = sigmoid_bce(p[..., 4 * REG_MAX], tgt)
        # balance: positives are ~1/(h w) of the cells
        wpos = torch.where(tgt > 0, float(ph * pw) / MAXOBJ / 4, 1.0)
        cls = (cls * wpos).mean((1, 2))

        flat = p.reshape(B, ph * pw, p.shape[-1])
        rows = torch.gather(flat, 1, cell[..., None].expand(
            B, M, flat.shape[-1]))                            # (B, M, C)
        # distances from the cell centre to the box edges in strides
        cpx = (ci + 0.5) * stride
        cpy = (cj + 0.5) * stride
        dists = torch.stack([cpx - boxes[..., 0], cpy - boxes[..., 1],
                             boxes[..., 2] - cpx, boxes[..., 3] - cpy],
                            -1) / stride
        dists = dists.clamp(0.0, REG_MAX - 1.01)
        lo = torch.floor(dists)
        whi = dists - lo
        logp = torch.log_softmax(
            rows[..., :4 * REG_MAX].reshape(B, M, 4, REG_MAX), -1)
        il = lo.long()
        dfl = -((1 - whi) * torch.gather(logp, -1, il[..., None])[..., 0]
                + whi * torch.gather(logp, -1, (il + 1).clamp(
                    0, REG_MAX - 1)[..., None])[..., 0]).mean(-1)
        # the proto mask of each object
        mpred = torch.einsum("bhwc,bmc->bmhw", proto,
                             rows[..., 4 * REG_MAX + 1:])
        msk = (sigmoid_bce(mpred, gt4) * wmap).sum((2, 3)) \
            / wmap.sum((2, 3)).clamp(min=1.0)
        ok = on.float()
        n = ok.sum(1).clamp(min=1.0)
        total_cls = total_cls + cls.mean()
        total_dfl = total_dfl + ((ok * dfl).sum(1) / n).mean()
        total_msk = total_msk + ((ok * msk).sum(1) / n).mean()
    loss = total_cls + 0.5 * total_dfl + total_msk
    return loss, tuple(t.detach() for t in (total_cls, total_dfl,
                                             total_msk))


def build_model(resume, device):
    """FastSAM from a weights file, or at random from seed 0."""
    from ..models.fastsam import FastSAM, load_fastsam
    if resume:
        model = load_fastsam(resume)
    else:
        model = FastSAM(generator=torch.Generator().manual_seed(0))
    return model.to(device).train().requires_grad_(True)


def save_weights(path, model):
    from ..models.flax_weights import (flax_tree_from_state_dict,
                                       save_pickled_params)
    save_pickled_params(path, flax_tree_from_state_dict(model.state_dict()))


def train(steps, out, lr=8e-4, batch=4, ckpt_every=250, resume=None,
          device=None, seed=21, batch_seed=31, pool=None, log_every=25,
          on_step=None):
    """The recipe's loop: clip 5.0 + AdamW at a warmup-cosine rate over
    `steps` steps of `batch` composites drawn from a pool (a SamplePool
    of `sample` from `seed` unless `pool` is given). Returns (model,
    history)."""
    from ..models.droid_trainer import make_loss_step, make_optimizer
    from ..utils.device import reproducible, resolve_device
    from .self_training import SamplePool, train_loop
    device = resolve_device(device)
    with reproducible():
        model = build_model(resume, device)
        opt, sched = make_optimizer(model, lr, steps)
        step = make_loss_step(lambda b: fastsam_loss(model, *b), opt, sched,
                              clip_norm=CLIP_NORM)
        own = pool is None
        if own:
            pool = SamplePool(sample, seed, POOL_CAP, batch)
        brng = np.random.default_rng(batch_seed)
        try:
            hist = train_loop(
                step, lambda: to_batch(pool.draw(brng, batch), device),
                steps, lambda path: save_weights(path, model), out,
                ckpt_every, ("loss", "cls", "dfl", "mask"), log_every,
                on_step)
        finally:
            if own:
                pool.close()
    return model, hist


def main(argv=None):
    from .self_training import add_common_flags
    ap = argparse.ArgumentParser()
    add_common_flags(ap, 2500, "output/fastsam_selftrained.npz", 8e-4,
                     batch=4)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    train(args.steps, args.out, args.lr, args.batch, args.ckpt_every,
          args.resume, args.device)


if __name__ == "__main__":
    main()
