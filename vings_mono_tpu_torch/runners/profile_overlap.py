"""Device-side profile of the bench's overlapped tracker || mapper
section, the counterpart of the JAX package's
`scripts/profile_overlap.py`.

Usage: python -m vings_mono_tpu_torch.runners.profile_overlap
           [--n-meas 12] [--device cuda|cpu]

Runs `runners/bench.py`'s all-keyframe lane up to its measured section
(the same config, warm-up and halved-iterations keyframe), a throwaway
overlapped pass over n_meas frames, then the next n_meas frames under
`torch.profiler` (every thread's ranges, written under
`output/profile_overlap/`), and reports from the trace:
- the wall time of the section;
- the device's busy time as the UNION of the device events' intervals
  over both streams (`utils.profiling.busy_union_ms`: two kernels that
  overlap on the tracker's and the mapper's streams count once), its
  span and the idle share of the wall;
- busy and idle ms per frame;
- device ms per program (`train_loop`, `add_frame`, `bin_stack`,
  `storage_control`, `_fused_update`; `bench_common.program_ms`);
- the top device kernels by summed ms.
The last line is one JSON record of those numbers. This separates the
two regimes: device-bound (cut kernel time) from launch-bound (cut host
work and syncs). Inside `utils.device.reproducible`, as the bench.
"""

from __future__ import annotations

import argparse
import json
import os

from ..utils.profiling import (busy_union_ms, device_ms_by_name,
                               load_trace, trace)
from .bench_common import (bench_overrides, device_name, device_span_ms,
                           load, make_frame, overlapped, program_ms,
                           warm_pipeline)
from .eval_all import card_line
from .eval_common import add_device_flag

TRACE = os.path.join("output", "profile_overlap")
PROGRAMS = ("train_loop", "add_frame", "bin_stack", "storage_control",
            "_fused_update")


def profile(device=None, n_meas=12):
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(device)
    frames = make_frame()
    with reproducible():
        cfg = load(bench_overrides(), None, device)
        w = warm_pipeline(cfg, frames, device)
        lo = w.next_frame
        # generated before the passes, as the script does (dataset I/O)
        pre = {k: frames(k) for k in range(lo, lo + 2 * n_meas)}
        overlapped(w.tracker, w.mapper, cfg, pre.__getitem__,
                   range(lo, lo + n_meas), device)
        lo += n_meas
        with trace(TRACE):
            dt, n_kf = overlapped(w.tracker, w.mapper, cfg, pre.__getitem__,
                                  range(lo, lo + n_meas), device)
    events = load_trace(TRACE)
    busy = busy_union_ms(events)
    wall = dt * 1e3
    progs = program_ms(events, PROGRAMS)
    return {"device": device_name(device), "card": card_line(),
            "frames": n_meas, "windows": n_kf, "wall_ms": wall,
            "fps": n_meas / dt, "busy_ms": busy,
            "span_ms": device_span_ms(events),
            "idle_share": 1.0 - busy / wall,
            "busy_ms_per_frame": busy / n_meas,
            "idle_ms_per_frame": (wall - busy) / n_meas,
            "program_ms": {k: v[0] for k, v in progs.items()},
            "program_calls": {k: v[1] for k, v in progs.items()},
            "top_kernels": sorted(device_ms_by_name(events).items(),
                                  key=lambda kv: -kv[1][0])[:25]}


def report(r):
    print(f"measured on {r['device']} [{r['card']}]: {r['fps']:.3f} fps "
          f"({r['wall_ms'] / r['frames']:.1f} ms/frame), {r['windows']} "
          f"windows mapped")
    print(f"device busy (union over streams): {r['busy_ms']:.1f} ms over "
          f"span {r['span_ms']:.1f} ms; idle share of the wall "
          f"{r['idle_share']:.4f}")
    print(f"per frame: busy {r['busy_ms_per_frame']:.1f} ms, wall "
          f"{r['wall_ms'] / r['frames']:.1f} ms, idle "
          f"{r['idle_ms_per_frame']:.1f} ms")
    print("programs (device ms, ms/frame, calls):")
    for name, ms in sorted(r["program_ms"].items(), key=lambda kv: -kv[1]):
        print(f"{ms:10.2f} {ms / r['frames']:8.2f}  "
              f"{r['program_calls'][name]:5d}  {name}")
    print("top kernels (device ms, count):")
    for name, (ms, n) in r["top_kernels"]:
        print(f"{ms:10.2f} {n:7d}  {name[:100]}")
    print(json.dumps({k: v for k, v in r.items() if k != "top_kernels"}),
          flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-meas", type=int, default=12)
    add_device_flag(p)
    args = p.parse_args(argv)
    r = profile(args.device, args.n_meas)
    report(r)
    return r


if __name__ == "__main__":
    main()
