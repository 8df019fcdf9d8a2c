"""Self-train DroidNet on the geometric synthetic3d stream: ray-cast
cube-room clips with exact pose and depth supervision through the
unrolled GRU + BA harness (models/droid_trainer.py; reference training
spec: frontend/droid_net.py:178-228 + geom/losses.py).

Each clip is scale-normalized so mean inverse depth ~= 0.8 (the reference
training pipeline rescales scenes the same way, data_readers/base.py):
monocular BA is gauge-free, so training near the disp init (1.0) helps the
unrolled optimization converge.

Usage: python -m vings_mono_tpu_torch.runners.train_droid [--steps N]
           [--out output/droid_selftrained.npz] [--lr 2e-4]
           [--num-steps 8] [--ckpt-every 250] [--resume WEIGHTS.npz]
           [--device cuda|cpu]

Checkpoints are the JAX package's flat flax `.npz` layout in f32
(`save_droid_weights`), so either package loads them. Runs on CUDA unless
`--device` says otherwise.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time

import numpy as np
import torch

P, H, W = 5, 96, 128     # frames per clip, frame size
# per-clip motion scale: the motion filter makes the tracker see larger
# inter-keyframe baselines than consecutive frames have, so the clips
# cover those too
MOTION_SCALE = (0.5, 2.0)


def random_clip(rng, p=P, h=H, w=W):
    """One training sample: random room/texture/trajectory, p frames with
    full-res rgb + exact 1/8-res inverse depth + w2c poses, as numpy."""
    from ..datasets.synthetic3d import render_room, texture_params
    from ..ops import lie
    room = rng.uniform(3.0, 5.0)
    tex = texture_params(rng.integers(1 << 31))
    f = rng.uniform(0.8, 1.1) * w
    intr = np.asarray([f, f, w / 2, h / 2], np.float32)

    ms = rng.uniform(*MOTION_SCALE)
    # smooth random walk that stays inside the room
    pos = rng.uniform(-0.35, 0.35, 3) * room
    vel = rng.normal(size=3) * 0.06 * ms
    yaw, pitch = rng.uniform(-np.pi, np.pi), rng.uniform(-0.3, 0.3)
    dyaw = rng.normal() * 0.03 * ms
    dpitch = rng.normal() * 0.015 * ms
    c2ws = []
    for _ in range(p):
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        c2w = np.eye(4)
        c2w[:3, :3] = Ry @ Rx
        c2w[:3, 3] = pos
        c2ws.append(c2w)
        vel = 0.9 * vel + rng.normal(size=3) * 0.03 * ms
        pos = np.clip(pos + vel, -0.7 * room, 0.7 * room)
        yaw += dyaw + rng.normal() * 0.01
        pitch = np.clip(pitch + dpitch + rng.normal() * 0.006, -0.5, 0.5)

    h8, w8 = h // 8, w // 8
    imgs = np.empty((p, h, w, 3), np.float32)
    depth8 = np.empty((p, h8, w8), np.float32)
    for k, c2w in enumerate(c2ws):
        imgs[k], _ = render_room(c2w, intr, h, w, room, tex=tex)
        _, depth8[k] = render_room(c2w, intr / 8.0, h8, w8, room, tex=tex)

    # scale-normalize the clip: mean inverse depth -> 0.8
    alpha = np.mean(1.0 / depth8) / 0.8
    depth8 = depth8 / alpha
    w2cs = []
    for c2w in c2ws:
        w2c = np.linalg.inv(c2w)
        w2c[:3, 3] /= alpha
        w2cs.append(w2c)
    poses = lie.se3_from_matrix(torch.as_tensor(np.stack(w2cs),
                                                dtype=torch.float32)).numpy()
    ii, jj = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
    m = (np.abs(ii - jj) >= 1) & (np.abs(ii - jj) <= 2)
    return dict(images=imgs, poses_gt=poses.astype(np.float32),
                disps_gt=(1.0 / depth8).astype(np.float32),
                intrinsics=(intr / 8.0).astype(np.float32),
                ii=ii.reshape(-1)[m.reshape(-1)].astype(np.int64),
                jj=jj.reshape(-1)[m.reshape(-1)].astype(np.int64))


def to_batch(sample, device):
    from ..models.droid_trainer import TrainBatch
    return TrainBatch(**{k: torch.as_tensor(sample[k], device=device)
                         for k in TrainBatch._fields})


class ClipProducer:
    """A host thread that renders clips from `seed` into a bounded queue
    while the trainer runs; `close()` stops it."""

    def __init__(self, seed):
        self.q = queue.Queue(maxsize=12)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(seed,),
                                        daemon=True)
        self._thread.start()

    def _run(self, seed):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            s = random_clip(rng)
            while not self._stop.is_set():
                try:
                    self.q.put(s, timeout=1.0)
                    break
                except queue.Full:
                    pass

    def get(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join()


def build_model(resume, device):
    """DroidNet from a weights file, or at random from seed 0."""
    from ..models.droid_net import DroidNet, load_droid_weights
    if resume:
        model = DroidNet()
        model.load_state_dict(load_droid_weights(resume))
    else:
        model = DroidNet(generator=torch.Generator().manual_seed(0))
    return model.to(device).train()


def train(steps, out, lr=2e-4, num_steps=8, ckpt_every=250, resume=None,
          device=None, seed=1234, log_every=25, on_step=None):
    """The training loop: `steps` optimizer steps on producer clips,
    checkpoints every `ckpt_every` steps and at the end. on_step(it, loss,
    applied) is called after every step. Returns (model, losses). The
    run is reproducible (`utils.device.reproducible`) but for the order
    in which the producer's clips arrive, which is fixed by its seed."""
    from ..utils.device import reproducible
    with reproducible():
        return _train(steps, out, lr, num_steps, ckpt_every, resume,
                      device, seed, log_every, on_step)


def _train(steps, out, lr, num_steps, ckpt_every, resume, device, seed,
           log_every, on_step):
    from ..models.droid_net import save_droid_weights
    from ..models.droid_trainer import make_optimizer, make_train_step
    from ..utils.device import resolve_device
    device = resolve_device(device)
    model = build_model(resume, device)
    opt, sched = make_optimizer(model, lr, steps)
    step_fn = make_train_step(model, opt, sched, num_steps=num_steps)
    producer = ClipProducer(seed)
    losses = []
    t0 = time.time()
    try:
        for it in range(steps):
            loss, applied = step_fn(to_batch(producer.get(), device))
            losses.append(float(loss))
            if on_step is not None:
                on_step(it, losses[-1], applied)
            if (it + 1) % log_every == 0:
                print(f"step {it + 1}/{steps} "
                      f"loss {np.mean(losses[-log_every:]):.4f} "
                      f"({(time.time() - t0) / (it + 1):.2f}s/it)",
                      flush=True)
            if (it + 1) % ckpt_every == 0 or it + 1 == steps:
                save_droid_weights(out, model)
                print(f"saved {out} @ step {it + 1}", flush=True)
    finally:
        producer.close()
    return model, losses


def main(argv=None):
    import os
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--out", default="output/droid_selftrained.npz")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--num-steps", type=int, default=8,
                    help="unrolled GRU+BA iterations")
    ap.add_argument("--ckpt-every", type=int, default=250)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    _, losses = train(args.steps, args.out, args.lr, args.num_steps,
                      args.ckpt_every, args.resume, args.device)
    print(f"done: final loss(avg50) {np.mean(losses[-50:]):.4f}")


if __name__ == "__main__":
    main()
