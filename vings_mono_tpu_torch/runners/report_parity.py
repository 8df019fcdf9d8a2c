"""Parity report of one whole run, the counterpart of the JAX package's
`scripts/report_parity.py`: runs the pipeline on a dataset and writes
{ate, psnr, fps, stage_times} as JSON into the run directory.

Usage: python -m vings_mono_tpu_torch.runners.report_parity
           [config.yaml] [--out output/parity] [--max-frames N]
           [--device cuda|cpu]

Without a config it runs the droid evaluation's default configuration
(`eval_common.default_cfg`: the synthetic3d room at 120x160, 40 frames,
every frame a keyframe; the script's `default_cfg` word for word), whose
ground truth is analytic, so the report means something with no dataset
on disk. `runners.run.run` drives it (inside
`utils.device.reproducible`); the keys are the script's: dataset,
n_frames, ate_rmse_m, psnr_db (eval_psnr over 8 keyframes), fps (frames
over the run's wall), wall_s, stage_times_s, n_keyframes, n_gaussians.
It prints the record as one JSON line and writes
`<out>/parity_report.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .eval_common import add_device_flag, default_cfg


def report(cfg, save_dir, max_frames=None, device=None):
    from ..datasets.base import get_dataset
    from .evaluate import eval_psnr, eval_trajectory
    from .run import run as run_pipeline

    os.makedirs(os.path.join(save_dir, "ply"), exist_ok=True)
    t0 = time.perf_counter()
    tracker, mapper, timer = run_pipeline(cfg, save_dir,
                                          max_frames=max_frames,
                                          device=device)
    wall = time.perf_counter() - t0

    dataset = get_dataset(cfg)
    n_frames = len(dataset) if max_frames is None else min(
        len(dataset), max_frames)
    ate = eval_trajectory(save_dir, dataset)
    psnr = eval_psnr(mapper, tracker, n_eval=8)
    out = {
        "dataset": cfg["dataset"]["module"],
        "n_frames": n_frames,
        "ate_rmse_m": None if ate is None else round(float(ate), 5),
        "psnr_db": None if psnr is None else round(float(psnr), 3),
        "fps": round(n_frames / wall, 4),
        "wall_s": round(wall, 2),
        "stage_times_s": {k: round(v, 2)
                          for k, v in sorted(timer.totals.items())},
        "n_keyframes": int(tracker.video.counter) +
        int(tracker.video.count_save),
        "n_gaussians": int(mapper.n_alive),
    }
    path = os.path.join(save_dir, "parity_report.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    return out, path


def main(argv=None, overrides=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--out", default="output/parity")
    p.add_argument("--max-frames", type=int, default=None)
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import resolve_device
    device = resolve_device(args.device)
    if args.config:
        from ..utils.config import load_config
        cfg = load_config(args.config)
    else:
        cfg = default_cfg(overrides)
    out, path = report(cfg, args.out, args.max_frames, device)
    print(json.dumps(out), flush=True)
    print(f"wrote {path}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
