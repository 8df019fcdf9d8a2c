"""Tracking-only ATE on the long multi-revolution room trajectory, over a
grid of BA iteration budgets (`iters1`x`iters2`): whether the tracker
survives a long sequence. `--cv` sets the constant-velocity seeding
(`frontend.motion_model_alpha`); `--metric-weights` adds the metric-depth
prior (`use_metric`, the DPT's flax-layout weights), whose `disps_sens`
pins the depth gauge.

Usage: python -m vings_mono_tpu_torch.runners.eval_track_long
           [--weights vings_mono_tpu/weights/droid_selftrained.npz]
           [--frames 160] [--revs 1.6] [--grid 2x1,4x2] [--cv 1.0]
           [--metric-weights FILE] [--out FILE] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from .eval_common import (DROID_WEIGHTS, ROOM_INTRINSIC, add_device_flag,
                          emit, metric_block, room_dataset, room_frontend)


def config(args, it1, it2):
    """The configuration of one grid combo."""
    from ..utils.config import load_config
    return load_config(overrides={
        "mode": "vo",
        **metric_block(args.metric_weights),
        "dataset": room_dataset(args.frames, args.revs),
        "intrinsic": dict(ROOM_INTRINSIC),
        "frontend": {**room_frontend(it1, it2, 256),
                     "weight": args.weights,
                     "motion_model_alpha": args.cv},
    })


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default=DROID_WEIGHTS)
    p.add_argument("--frames", type=int, default=160)
    p.add_argument("--revs", type=float, default=1.6)
    p.add_argument("--grid", default="2x1,4x2",
                   help="comma list of iters1xiters2 combos")
    p.add_argument("--cv", type=float, default=1.0,
                   help="constant-velocity seeding strength "
                        "(frontend.motion_model_alpha; 0 = identity seed)")
    p.add_argument("--metric-weights", default=None,
                   help="DPT metric-depth weights -> use_metric lane "
                        "(disps_sens pins the depth gauge)")
    p.add_argument("--out", default=None)
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..datasets.base import get_dataset
    from ..utils.device import resolve_device
    from .evaluate import eval_trajectory
    from .run_tracking import run as run_tracking
    device = resolve_device(args.device)

    results = {}
    for combo in args.grid.split(","):
        it1, it2 = (int(x) for x in combo.split("x"))
        cfg = config(args, it1, it2)
        d = tempfile.mkdtemp(prefix=f"track_long_{combo}_")
        try:
            os.makedirs(os.path.join(d, "ply"), exist_ok=True)
            run_tracking(cfg, d, max_frames=args.frames, device=device)
            ate = eval_trajectory(d, get_dataset(cfg))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        results[combo] = {"ate_rmse_m": None if ate is None
                          else float(ate)}
        print(f"{combo}: ATE {ate}", file=sys.stderr, flush=True)

    results["frames"] = args.frames
    results["revs"] = args.revs
    return emit(results, args.out)


if __name__ == "__main__":
    main()
