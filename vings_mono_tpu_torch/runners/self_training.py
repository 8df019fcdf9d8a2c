"""What the self-training recipes of SuperPoint, LightGlue, FastSAM and the
DPT metric-depth net share (`runners/train_superpoint.py`,
`train_lightglue.py`, `train_fastsam.py`, `train_metric_depth.py`; the
JAX package's scripts/train_*.py): the room camera, the sample pool a
producer thread keeps filling, and the loop of steps with its log lines
and checkpoints. The optimizer is `models/droid_trainer.py`'s."""

from __future__ import annotations

import threading
import time

import numpy as np

POLL_S = 0.05   # how often the start waits for the pool to fill


def room_c2w(pos, yaw, pitch):
    """The scripts' camera-to-world (4, 4): yaw about y, then pitch about
    x, at `pos`."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    c2w = np.eye(4)
    c2w[:3, :3] = Ry @ Rx
    c2w[:3, 3] = pos
    return c2w


class SamplePool:
    """The scripts' sample pool: a producer thread makes samples with
    sample_fn(rng), its rng seeded by `seed`, into a list of at most
    `cap`; once full, each new sample replaces the one at a slot that rng
    draws. Steps draw from whatever the pool holds at the time, so the
    batch size does not wait on the host's render rate, and which samples
    a run draws depends on that rate. The constructor returns once the
    pool holds `min_fill` samples. `SamplePool.fixed(items)` is a pool of
    given samples without a producer, for runs that must repeat."""

    def __init__(self, sample_fn=None, seed=0, cap=256, min_fill=1,
                 items=()):
        self.items = list(items)
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._error = None
        self._thread = None
        if sample_fn is None:
            return
        self._thread = threading.Thread(
            target=self._produce, args=(sample_fn, seed, cap), daemon=True)
        self._thread.start()
        while True:
            with self.lock:
                if len(self.items) >= min_fill:
                    break
            self._raise_error()
            time.sleep(POLL_S)

    @classmethod
    def fixed(cls, items):
        return cls(items=items)

    def _produce(self, sample_fn, seed, cap):
        rng = np.random.default_rng(seed)
        try:
            while not self._stop.is_set():
                s = sample_fn(rng)
                with self.lock:
                    if len(self.items) < cap:
                        self.items.append(s)
                    else:
                        self.items[rng.integers(cap)] = s
        except Exception as e:   # raised again by the next draw
            self._error = e

    def _raise_error(self):
        if self._error is not None:
            raise RuntimeError("the sample producer failed") from self._error

    def draw(self, brng, size=None):
        """One sample (size None) or a list of `size`, at slots drawn
        from `brng` as the scripts draw them."""
        self._raise_error()
        with self.lock:
            if size is None:
                return self.items[brng.integers(len(self.items))]
            return [self.items[i]
                    for i in brng.integers(len(self.items), size=size)]

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()


def train_loop(step, next_batch, steps, save, out, ckpt_every, names,
               log_every=25, on_step=None):
    """`steps` calls of step(next_batch()) -> (loss, diagnostics,
    applied). Every `log_every` steps it prints the mean of the last
    ones' loss and diagnostics under `names`, and s/it; save(out) runs
    every `ckpt_every` steps and after the last. on_step(it, loss,
    applied) is called after every step. Returns one row [loss,
    *diagnostics] per step."""
    hist = []
    t0 = time.time()
    for it in range(steps):
        loss, aux, applied = step(next_batch())
        hist.append([float(loss)] + [float(a) for a in aux])
        if on_step is not None:
            on_step(it, hist[-1][0], applied)
        if (it + 1) % log_every == 0:
            m = np.mean(hist[-log_every:], axis=0)
            print(f"step {it + 1}/{steps} "
                  + " ".join(f"{n} {v:.4f}" for n, v in zip(names, m))
                  + f" ({(time.time() - t0) / (it + 1):.2f}s/it)",
                  flush=True)
        if (it + 1) % ckpt_every == 0 or it + 1 == steps:
            save(out)
            print(f"saved {out} @ step {it + 1}", flush=True)
    return hist


def add_common_flags(ap, steps, out, lr, batch=None):
    """The scripts' flags: --steps, --out (under output/), --lr,
    --ckpt-every, --resume, --batch where the script has one, and
    --device (CUDA unless it says otherwise)."""
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--out", default=out)
    ap.add_argument("--lr", type=float, default=lr)
    ap.add_argument("--ckpt-every", type=int, default=250)
    ap.add_argument("--resume", default=None,
                    help="weights to start from (the recipe's .npz)")
    if batch is not None:
        ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
