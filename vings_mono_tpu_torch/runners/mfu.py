"""MFU table of the three main programs, the counterpart of the JAX
package's `scripts/mfu.py`: the mapper's train loop, the tracker's fused
GRU + BA update, and a global-BA round.

Usage: python -m vings_mono_tpu_torch.runners.mfu [--device cuda|cpu]

FLOPs: `utils/mfu.py` (`torch.utils.flop_counter.FlopCounterMode`:
matmuls and convolutions; it counts no elementwise op, where XLA's cost
analysis counts them too, so the two packages' counts differ), plus the
JAX script's analytic term for the tile kernels in the "incl. raster
estimate" row (`utils.mfu.raster_flops`). Device ms: the device events
inside each program's range in a `torch.profiler` trace
(`bench_common.program_ms`), after one untraced call. MFU is over the
H100's dense bf16 peak (`utils/profiling.H100_PEAK_FLOPS`). Rows, at the
script's shapes:
- `train_loop` at 240x432, 50 iterations, on `bench_common.
  synthetic_window` (2^18 surfels, 2^18 pair slots, chunk 128);
- the fused update over tracked frames 10-12 (the profiling scripts'
  frontend, mfu.py's frames without the third sine term);
- `ba_global` at T = 64, E = 256, 2 Gauss-Newton iterations.
The last line is one JSON record of the rows. Inside
`utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..utils.profiling import load_trace, trace
from .bench_common import (FOCAL, H, PROFILE_FRONTEND, W, WINDOW_MAPPER,
                           device_name, load, make_frame, program_ms, sync,
                           synthetic_window, window_train)
from .eval_all import card_line
from .eval_common import add_device_flag

ITERS = 50
BA_T, BA_E, BA_D, BA_ITERS = 64, 256, 12, 2
TRACE = os.path.join("output", "mfu")


def traced_ms(fn, program, device, path=TRACE):
    """fn() once untraced, then traced: (device ms, calls) of `program`."""
    fn()
    sync(device)
    with trace(path):
        fn()
        sync(device)
    return program_ms(load_trace(path), (program,))[program]


def train_row(device, extra=None, height=H, width=W, iters=ITERS):
    """The rows of the train loop: counted only, and with the raster
    term."""
    from ..utils.mfu import raster_flops, shape_sig, train_loop_flops
    cfg = load({"training_args": {"iters": iters, "num_keyframe": 5},
                "mapper": dict(WINDOW_MAPPER)}, extra, device)
    mapper, batch, binned, intr4 = synthetic_window(cfg, device, height,
                                                    width)
    run, args, kw = window_train(mapper, batch, binned, intr4, iters,
                                 height, width)
    sig_kw = {k: kw[k] for k in ("height", "width", "render_kwargs")}
    f_train = train_loop_flops((shape_sig(args), shape_sig(sig_kw), iters))
    p_cap = int(mapper.bin_kwargs["p_cap"])
    f_raster = raster_flops(p_cap, iters)
    ms, _ = traced_ms(run, "train_loop", device)
    return [("train_loop counted only", f_train, ms, 1),
            ("train_loop incl. raster estimate", f_train + f_raster, ms,
             1)]


def update_row(device, extra=None, height=H, width=W):
    from ..tracker.tracker import Tracker
    from ..utils.mfu import fused_update_flops
    cfg = load({"mode": "vo", "frontend": dict(PROFILE_FRONTEND)}, extra,
               device)
    tracker = Tracker(cfg, height, width, device=device)
    frame = make_frame(height, width, third=False, f32=False)
    for k in range(10):
        tracker.track(frame(k))

    def run():
        for k in range(10, 13):
            tracker.track(frame(k))
    ms, n = traced_ms(run, "_fused_update", device)
    f_upd = fused_update_flops(tracker.graph._mfu_sig)
    return [(f"fused GRU+BA update (x{n})", f_upd * n, ms, n)]


def ba_inputs(device, height=H, width=W, T=BA_T, E=BA_E, D=BA_D):
    """mfu.py's global-BA problem from numpy's generator 1."""
    h8, w8 = height // 8, width // 8
    rng = np.random.default_rng(1)
    ii = rng.integers(0, T - 1, E).astype(np.int32)
    jj = ((ii + 1 + rng.integers(0, 3, E)) % T).astype(np.int32)
    gi = np.zeros((T, D), np.int32)
    gv = np.zeros((T, D), bool)
    cnt = {}
    for e, i in enumerate(ii):
        c = cnt.get(int(i), 0)
        if c < D:
            gi[int(i), c] = e
            gv[int(i), c] = True
            cnt[int(i)] = c + 1
    poses = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1.0], np.float32), (T, 1))
    poses[:, 0] = np.arange(T) * 0.05
    intr = np.tile(np.asarray([FOCAL, FOCAL, width / 2, height / 2],
                              np.float32)[None] / 8.0, (T, 1))
    free = np.ones(T, bool)
    free[0] = False
    arrays = (np.zeros((E, 2, h8, w8), np.float32),
              np.ones((E, 2, h8, w8), np.float32),
              np.full((T, h8, w8), 1e-3, np.float32), poses,
              np.full((T, h8, w8), 0.5, np.float32), intr, ii, jj,
              np.ones(E, bool), gi, gv, free)
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def ba_row(device, height=H, width=W):
    from ..ops import ba as ba_ops
    from ..utils.profiling import count_flops
    args = ba_inputs(device, height, width)
    f_ba = count_flops(ba_ops.ba_global, *args, iters=BA_ITERS)
    ms, _ = traced_ms(lambda: ba_ops.ba_global(*args, iters=BA_ITERS),
                      "ba_global", device)
    return [(f"ba_global (T={BA_T}, E={BA_E}, {BA_ITERS} GN it)", f_ba, ms,
             1)]


def table(rows):
    from ..utils.profiling import H100_PEAK_FLOPS
    out = []
    for name, fl, ms, n in rows:
        tf = fl / max(ms / 1e3, 1e-9) / 1e12
        out.append({"program": name, "gflop": fl / 1e9, "device_ms": ms,
                    "calls": n, "tflops": tf,
                    "mfu": tf * 1e12 / H100_PEAK_FLOPS})
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    with reproducible():
        rows = train_row(device) + update_row(device) + ba_row(device)
    out = table(rows)
    print(f"\non {device_name(device)} [{card_line()}]; peak 989 TFLOP/s "
          f"(H100 dense bf16)")
    print(f"{'program':36s} {'GFLOP':>9s} {'dev ms':>8s} {'TFLOP/s':>8s} "
          f"{'MFU':>7s}")
    for r in out:
        print(f"{r['program']:36s} {r['gflop']:9.2f} {r['device_ms']:8.2f} "
              f"{r['tflops']:8.2f} {100 * r['mfu']:6.3f}%")
    print(json.dumps({"device": device_name(device), "rows": out}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
