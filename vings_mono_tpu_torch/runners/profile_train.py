"""Device time by kernel of one mapper train loop at bench scale, the
counterpart of the JAX package's `scripts/profile_train.py`.

Usage: python -m vings_mono_tpu_torch.runners.profile_train [ITERS]
           [--height 240] [--width 432] [--p-cap 262144] [--chunk 128]
           [--device cuda|cpu]

`bench_common.synthetic_window` (2^18 surfels, 8 noise keyframes, the
first two densified with min(30000, H*W - 100) points each) and one train
loop of ITERS (50) iterations on a copy of the map: the wall ms of one
warm run (device synchronized), then the same run under `torch.profiler`
with the device total and the top 40 kernels by summed ms, per iteration
too. The last line is one JSON record. Inside
`utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import json
import os

from ..utils.profiling import device_ms_by_name, load_trace, trace
from .bench_common import (WINDOW_MAPPER, device_name, load, sync,
                           synthetic_window, timed_ms, window_train)
from .eval_all import card_line
from .eval_common import add_device_flag

TRACE = os.path.join("output", "profile_train")


def main(argv=None, extra=None):
    p = argparse.ArgumentParser()
    p.add_argument("iters", nargs="?", type=int, default=50)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=432)
    p.add_argument("--p-cap", type=int, default=1 << 18)
    p.add_argument("--chunk", type=int, default=128)
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    H, W, iters = args.height, args.width, args.iters
    with reproducible():
        cfg = load({"training_args": {"iters": iters, "num_keyframe": 5},
                    "mapper": dict(WINDOW_MAPPER, pair_capacity=args.p_cap,
                                   chunk=args.chunk)}, extra, device)
        mapper, batch, binned, intr4 = synthetic_window(
            cfg, device, H, W,
            n_points=min(int(cfg["mapper"]["points_first_frame"]),
                         H * W - 100))
        print(f"alive {mapper.n_alive}", flush=True)
        run, _, _ = window_train(mapper, batch, binned, intr4, iters, H, W)
        wall = timed_ms(run, device, n=1)
        print(f"train_loop iters={iters}: {wall:.1f} ms wall "
              f"({wall / iters:.2f} ms/iter) on {device_name(device)} "
              f"[{card_line()}]", flush=True)
        with trace(TRACE):
            run()
            sync(device)
    agg = device_ms_by_name(load_trace(TRACE))
    total = sum(ms for ms, _ in agg.values())
    print(f"\ndevice total: {total:.1f} ms  ({total / iters:.3f} ms/iter), "
          f"{sum(n for _, n in agg.values())} device events")
    print(f"{'ms':>9} {'ms/iter':>8} {'count':>7}  name")
    top = sorted(agg.items(), key=lambda kv: -kv[1][0])[:40]
    for name, (ms, n) in top:
        print(f"{ms:9.2f} {ms / iters:8.3f} {n:7d}  {name[:110]}")
    out = {"device": device_name(device), "iters": iters, "wall_ms": wall,
           "device_ms": total, "device_events": sum(n for _, n in
                                                    agg.values())}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
