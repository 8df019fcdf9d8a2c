"""Host-side cProfile of the bench's two threads' work (the tracker loop
and the mapper worker), the counterpart of the JAX package's
`scripts/profile_host.py`.

Usage: python -m vings_mono_tpu_torch.runners.profile_host
           [--device cuda|cpu]

The bench's all-keyframe lane (`bench_common`'s config and 8-bit frames
at 240x432): 14 frames mapped serially, `freeze_buckets`, 2 more, then a
throwaway overlapped pass of 16 frames and a measured one (the
wall split: frames/s and ms per frame of the two threads together, no
profiler). Since Python 3.12 cProfile watches every thread through
`sys.monitoring` and keeps one call stack, so a profile taken while both
threads run mixes their calls; the script's per-thread profiles are
therefore taken apart: the tracker loop alone over the next 16
frames (its windows kept as host copies), then the mapper alone over
those windows, each under its own cProfile, each with its wall ms. Both
profiles print their top 28 entries by cumulative time. Inside
`utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import time

from .bench_common import (bench_overrides, device_name, load, make_frame,
                           overlapped, sync, warm_pipeline)
from .eval_all import card_line
from .eval_common import add_device_flag

N_WARM, N_MEAS = 14, 16


def profile(device, n_warm=N_WARM, n_meas=N_MEAS, extra=None, height=240,
            width=432):
    from ..middleware import judge_and_package, to_host
    frames = make_frame(height, width)
    cfg = load(bench_overrides(), extra, device)
    w = warm_pipeline(cfg, frames, device, n_warm=n_warm, halved=False,
                      height=height, width=width)
    lo = w.next_frame
    pre = {k: frames(k) for k in range(lo, lo + 3 * n_meas)}
    overlapped(w.tracker, w.mapper, cfg, pre.__getitem__,
               range(lo, lo + n_meas), device)
    dt, n_kf = overlapped(w.tracker, w.mapper, cfg, pre.__getitem__,
                          range(lo + n_meas, lo + 2 * n_meas), device)
    out = {"device": device_name(device), "card": card_line(),
           "overlapped_fps": n_meas / dt,
           "overlapped_ms_per_frame": dt * 1e3 / n_meas,
           "overlapped_windows": n_kf}

    prof_t, windows = cProfile.Profile(), []
    t0 = time.perf_counter()
    prof_t.enable()
    for k in range(lo + 2 * n_meas, lo + 3 * n_meas):
        w.tracker.track(pre[k])
        viz = judge_and_package(w.tracker, cfg)
        if viz is not None:
            windows.append(to_host(viz))
    prof_t.disable()
    sync(device)
    out["tracker_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n_meas

    prof_m = cProfile.Profile()
    t0 = time.perf_counter()
    prof_m.enable()
    for v in windows:
        w.mapper.run(v)
    prof_m.disable()
    sync(device)
    out["mapper_ms_per_window"] = \
        (time.perf_counter() - t0) * 1e3 / max(len(windows), 1)
    out["windows"] = len(windows)
    return out, {"tracker": prof_t, "mapper": prof_m}


def main(argv=None):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    with reproducible():
        out, profs = profile(device)
    print(f"on {out['device']} [{out['card']}]: overlapped "
          f"{out['overlapped_fps']:.3f} fps "
          f"({out['overlapped_ms_per_frame']:.0f} ms/frame); tracker alone "
          f"{out['tracker_ms_per_frame']:.1f} ms/frame; mapper alone "
          f"{out['mapper_ms_per_window']:.1f} ms/window "
          f"({out['windows']} windows)")
    for name, prof in profs.items():
        s = io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(
            28)
        print(f"\n===== {name} (per {N_MEAS} frames) =====")
        print("\n".join(s.getvalue().splitlines()[:46]))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
