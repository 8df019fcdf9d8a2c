"""Evaluate the self-trained DroidNet weights against random init on the
synthetic3d room stream, tracking only: ATE and keyframe counts of three
lanes. `random` and `trained` keyframe every frame (the ATE isolates the
flow's quality); `trained_gated` lets the motion filter decide keyframes
from the learned flow at `--filter-thresh`. `trained_beats_random`
compares the first two ATEs; `gating_selective` holds when the gate kept
some but not all keyframes.

Usage: python -m vings_mono_tpu_torch.runners.eval_droid
           [--weights vings_mono_tpu/weights/droid_selftrained.npz]
           [--frames 40] [--filter-thresh 1.75] [--out FILE]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from .eval_common import DROID_WEIGHTS, add_device_flag, default_cfg, emit


def tracking_ate(cfg_overrides, save_dir, max_frames, device=None):
    """(ATE rmse or None, keyframe count) of `runners.run_tracking.run` on
    `default_cfg(cfg_overrides)`."""
    from ..datasets.base import get_dataset
    from .evaluate import eval_trajectory
    from .run_tracking import run as run_tracking

    cfg = default_cfg(cfg_overrides)
    tracker = run_tracking(cfg, save_dir, max_frames=max_frames,
                           device=device)
    ate = eval_trajectory(save_dir, get_dataset(cfg))
    n_kf = int(tracker.video.counter) + int(tracker.video.count_save)
    return (None if ate is None else float(ate)), n_kf


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default=DROID_WEIGHTS)
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--filter-thresh", type=float, default=1.75)
    p.add_argument("--out", default=None)
    add_device_flag(p)
    args = p.parse_args(argv)

    from ..utils.device import resolve_device
    device = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix="eval_droid_")
    try:
        results = {}
        runs = [
            # every frame a keyframe in both: the ATE isolates the flow
            ("random", {"frontend": {"filter_thresh": -1.0}}),
            ("trained", {"frontend": {"filter_thresh": -1.0,
                                      "weight": args.weights}}),
            # the motion filter decides keyframes from the learned flow
            ("trained_gated", {"frontend": {
                "filter_thresh": args.filter_thresh,
                "weight": args.weights}}),
        ]
        for name, ov in runs:
            d = os.path.join(work, name)
            os.makedirs(os.path.join(d, "ply"), exist_ok=True)
            ate, n_kf = tracking_ate(ov, d, args.frames, device)
            results[name] = {"ate_rmse_m": ate, "n_keyframes": n_kf}
            print(f"{name}: ATE {ate} n_kf {n_kf}", file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    results["frames"] = args.frames
    results["trained_beats_random"] = (
        results["trained"]["ate_rmse_m"] is not None
        and results["random"]["ate_rmse_m"] is not None
        and results["trained"]["ate_rmse_m"]
        < results["random"]["ate_rmse_m"])
    results["gating_selective"] = (
        0 < results["trained_gated"]["n_keyframes"]
        < results["trained"]["n_keyframes"])
    return emit(results, args.out)


if __name__ == "__main__":
    main()
