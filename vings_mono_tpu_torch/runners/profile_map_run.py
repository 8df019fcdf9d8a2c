"""Device time per program of the mapper's steady-state keyframes, the
counterpart of the JAX package's `scripts/profile_map_run.py`.

Usage: python -m vings_mono_tpu_torch.runners.profile_map_run
           [--device cuda|cpu]

The profiling scripts' frontend and the bench's mapper at chunk 128 on
the bench's 8-bit frames at 240x432: frames 0-11 are tracked and
mapped, the next 6 frames tracked and their windows kept (as host
copies: the tracker goes on writing its buffers), the pair buckets
frozen, and the kept windows mapped under `torch.profiler`. Prints the
wall ms per keyframe, device ms per keyframe of each program
(`train_loop`, `add_frame`, `bin_stack`, `storage_control`) and of the
top 40 device kernels; the last line is one JSON record. Inside
`utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..utils.profiling import device_ms_by_name, load_trace, trace
from .bench_common import (BENCH_MAPPER, BENCH_TRAINING, PROFILE_FRONTEND,
                           bench_overrides, device_name, load, make_frame,
                           program_ms, sync)
from .eval_all import card_line
from .eval_common import add_device_flag

MAPPER = dict(BENCH_MAPPER, chunk=128)
PROGRAMS = ("train_loop", "add_frame", "bin_stack", "storage_control")
TRACE = os.path.join("output", "profile_map_run")
N_WARM, N_MEAS, H, W = 12, 6, 240, 432


def profile(device):
    from ..mapper.mapper import GaussianMapper
    from ..middleware import judge_and_package, to_host
    from ..tracker.tracker import Tracker
    cfg = load(bench_overrides(PROFILE_FRONTEND, MAPPER, BENCH_TRAINING),
               None, device)
    tracker = Tracker(cfg, H, W, device=device)
    mapper = GaussianMapper(cfg, device=device)
    frame = make_frame(H, W)
    vizzes = []
    for k in range(N_WARM + N_MEAS):
        tracker.track(frame(k))
        viz = judge_and_package(tracker, cfg)
        if viz is None:
            continue
        if k < N_WARM:
            mapper.run(viz)
        else:
            vizzes.append(to_host(viz))
    sync(device)
    mapper.freeze_buckets()
    t0 = time.perf_counter()
    with trace(TRACE):
        for v in vizzes:
            mapper.run(v)
        sync(device)
    wall = time.perf_counter() - t0
    events = load_trace(TRACE)
    n = max(len(vizzes), 1)
    progs = program_ms(events, PROGRAMS)
    top = sorted(device_ms_by_name(events).items(),
                 key=lambda kv: -kv[1][0])[:40]
    return {"device": device_name(device), "card": card_line(),
            "keyframes": len(vizzes), "wall_ms_per_kf": wall * 1e3 / n,
            "program_ms_per_kf": {k: v[0] / n for k, v in progs.items()},
            "program_calls": {k: v[1] for k, v in progs.items()},
            "top_ms_per_kf": [(name, ms / n, c) for name, (ms, c) in top]}


def main(argv=None):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    with reproducible():
        r = profile(device)
    print(f"on {r['device']} [{r['card']}]: wall {r['wall_ms_per_kf']:.1f} "
          f"ms/keyframe ({r['keyframes']} kf)")
    print(f"{'ms/kf':>9}  program (calls)")
    for name, ms in sorted(r["program_ms_per_kf"].items(),
                           key=lambda kv: -kv[1]):
        print(f"{ms:9.2f}  {name} ({r['program_calls'][name]})")
    print(f"{'ms/kf':>9}  {'count':>7}  kernel")
    for name, ms, c in r["top_ms_per_kf"]:
        print(f"{ms:9.2f}  {c:7d}  {name[:100]}")
    print(json.dumps({k: v for k, v in r.items() if k != "top_ms_per_kf"}),
          flush=True)
    return r


if __name__ == "__main__":
    main()
