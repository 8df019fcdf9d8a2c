"""End-to-end synthetic tracking + mapping frames per second on one card,
the counterpart of the JAX package's root `bench.py`, with its workload,
frame indices and printed keys.

Usage: python -m vings_mono_tpu_torch.runners.bench [--device cuda|cpu]

The real pipeline (DroidNet motion filter and covisible-graph GRU + BA
tracker -> middleware -> Gaussian mapper with the CUDA tile kernels) runs
on a synthetic photometric sequence at 240x432 (`bench_common.make_frame`)
in two lanes:
- all keyframes: random DroidNet weights (seed 0), every frame a keyframe;
  12 warm-up frames, `freeze_buckets`, 2 more, one keyframe at halved
  iterations, a throwaway overlapped pass over frames 14-73, then the
  measured overlapped pass over frames 74-133, then `bench_mfu`;
- gated (the headline): the self-trained weights
  (`vings_mono_tpu/weights/droid_selftrained.npz`) drive the motion
  filter (`filter_thresh` 1.75) and the keyframe test (2.0); 28 + 6
  warm-up frames, measured frames 34-93.
In an overlapped pass this thread tracks while a mapper thread maps from
a queue of 4, each on its own CUDA stream (`bench_common.overlapped`).

It prints one JSON line with bench.py's eight keys: `metric`, `value`
(gated frames/s), `unit`, `vs_baseline` (against 20 frames/s),
`allkf_fps`, `gated_keyframe_frac`, `mfu` (over the H100's dense bf16
peak, `utils/profiling.H100_PEAK_FLOPS`) and `achieved_tflops`; the card,
the lanes' walls and keyframe counts go to stderr. Unlike bench.py, a
failing gated lane, or missing weights, raises: the run then exits
non-zero. The run is inside `utils.device.reproducible`, as every runner
of the port: the bench measures what users run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .bench_common import (H, W, bench_overrides, device_name, gated_overrides,
                           load, make_frame, overlapped, warm_pipeline)
from .eval_all import card_line
from .eval_common import DROID_WEIGHTS, add_device_flag

BASELINE_FPS = 20.0
METRIC = "gated_tracking+mapping_fps_synthetic_240x432"
KEYS = ("metric", "value", "unit", "vs_baseline", "allkf_fps",
        "gated_keyframe_frac", "mfu", "achieved_tflops")
N_POST, G_POST = 2, 6   # frames mapped after freeze_buckets, each lane


def frame_plan(n_warm=12, n_meas=60, g_warm=28):
    """Half-open frame ranges of each part of the run, as bench.py
    indexes them: the warm-up, the throwaway and measured passes of the
    all-keyframe lane, the gated lane's warm-up and measured pass."""
    w = n_warm + N_POST
    g = g_warm + G_POST
    return {"warm": (0, w), "throwaway": (w, w + n_meas),
            "measured": (w + n_meas, w + 2 * n_meas),
            "gated_warm": (0, g), "gated_measured": (g, g + n_meas)}


def run(device=None, weights=DROID_WEIGHTS, n_warm=12, n_meas=60,
        g_warm=28, height=H, width=W, extra=None):
    """Both lanes. Returns (the JSON record, {lane: (tracker, mapper)}).
    extra: config overrides merged over the bench's (a smaller run)."""
    from ..utils.device import reproducible, resolve_device
    from ..utils.mfu import bench_mfu
    if not os.path.isfile(weights):
        raise FileNotFoundError(f"gated lane: no weights at {weights}")
    device = resolve_device(device)
    plan = frame_plan(n_warm=n_warm, n_meas=n_meas, g_warm=g_warm)
    frames = make_frame(height, width)
    with reproducible():
        cfg = load(bench_overrides(), extra, device)
        w = warm_pipeline(cfg, frames, device, n_warm=n_warm,
                          n_post=N_POST, height=height, width=width)
        pre = {k: frames(k) for k in range(*plan["throwaway"])}
        pre.update({k: frames(k) for k in range(*plan["measured"])})
        overlapped(w.tracker, w.mapper, cfg, pre.__getitem__,
                   range(*plan["throwaway"]), device)
        dt, n_kf = overlapped(w.tracker, w.mapper, cfg, pre.__getitem__,
                              range(*plan["measured"]), device)
        mfu = bench_mfu(w.tracker, w.mapper, n_meas, n_kf, dt)

        gcfg = load(gated_overrides(cfg, weights), None, device)
        g = warm_pipeline(gcfg, frames, device, n_warm=g_warm,
                          n_post=G_POST, weights=weights, halved=False,
                          height=height, width=width)
        gpre = {k: frames(k) for k in range(*plan["gated_measured"])}
        gdt, g_kf = overlapped(g.tracker, g.mapper, gcfg, gpre.__getitem__,
                               range(*plan["gated_measured"]), device)
    gated_fps = round(n_meas / gdt, 3)
    out = {"metric": METRIC, "value": gated_fps, "unit": "frames/s",
           "vs_baseline": round(gated_fps / BASELINE_FPS, 3),
           "allkf_fps": round(n_meas / dt, 3),
           "gated_keyframe_frac": round(g_kf / n_meas, 3),
           "mfu": round(mfu["mfu"], 5),
           "achieved_tflops": round(mfu["achieved_flops_per_s"] / 1e12, 4)}
    print(f"bench on {device_name(device)} [{card_line()}] at "
          f"{height}x{width}: all-keyframe {n_meas} frames "
          f"{plan['measured']} in {dt:.3f} s, {n_kf} windows mapped "
          f"({w.windows} in the warm-up); gated {n_meas} frames "
          f"{plan['gated_measured']} in {gdt:.3f} s, {g_kf} windows "
          f"({g.windows} in the warm-up); MFU counted "
          f"{mfu['total_flops']:.4e} FLOP (train loop "
          f"{mfu['flops_train_loop']:.4e}, fused update "
          f"{mfu['flops_fused_update']:.4e})", file=sys.stderr, flush=True)
    return out, {"allkf": (w.tracker, w.mapper),
                 "gated": (g.tracker, g.mapper)}


def main(argv=None, **sizes):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)
    out, _ = run(args.device, **sizes)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
