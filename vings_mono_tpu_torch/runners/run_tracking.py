"""Tracking-only runner (reference scripts/run_tracking.py): saves the
keyframe poses under droid_c2w/ and, with `debug_mode`, one viz_out replay
dump per packaged window under vizout_dict/, which `runners.run_mapping`
of either package maps.

Usage: python -m vings_mono_tpu_torch.runners.run_tracking <config.yaml>
           [--prefix NAME] [--max-frames N] [--device cuda|cpu]

Runs on CUDA unless `--device` (or the config's `device` block) says
otherwise. Takes `mode: vo`, `vo_nerfslam` and `vio`, `use_metric` (the
metric-depth prior of each frame becomes its `depth`) and `use_global_ba`
(the terminate pass before the poses are saved).
"""

from __future__ import annotations

import argparse
import os


def run(cfg, save_dir, max_frames=None, device=None):
    """Track the dataset's frames, reproducibly
    (`utils.device.reproducible`); returns the tracker."""
    from ..utils.device import reproducible
    with reproducible():
        return _run(cfg, save_dir, max_frames, device)


def _run(cfg, save_dir, max_frames, device):
    from ..datasets.base import get_dataset
    from ..datasets.replay import save_viz_out
    from ..middleware import judge_and_package, to_host
    from ..utils.trajectory import save_trajectory
    from .run import build_tracker, check_ported

    check_ported(cfg)
    dataset = get_dataset(cfg)
    tracker = build_tracker(cfg, dataset, device)
    metric = None
    if cfg.get("use_metric"):
        from ..models.metric_depth import MetricDepth
        metric = MetricDepth(cfg, device=tracker.device)

    dump_dir = os.path.join(save_dir, "vizout_dict")
    if cfg.get("debug_mode"):
        os.makedirs(dump_dir, exist_ok=True)

    n = len(dataset) if max_frames is None else min(len(dataset),
                                                    max_frames)
    kf = 0
    for idx in range(n):
        pkt = dataset[idx]
        if metric is not None:
            pkt["depth"] = metric.predict(pkt["rgb"], pkt["intrinsic"])
        tracker.track(pkt)
        viz_out = judge_and_package(tracker, cfg)
        if viz_out is not None and cfg.get("debug_mode"):
            save_viz_out(os.path.join(dump_dir, f"vizout_{kf:06d}.npz"),
                         to_host(viz_out))
            kf += 1
    if cfg.get("use_global_ba"):
        from ..tracker.backend import GlobalBA
        stats = GlobalBA(tracker, cfg).run()
        print(f"global BA: {stats}")
    n_kf = save_trajectory(tracker, save_dir)
    print(f"saved {n_kf} keyframe poses -> {save_dir}/droid_c2w")
    return tracker


def main(argv=None):
    from ..utils.config import load_config, make_run_dir
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--prefix", default="")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the config's, cuda)")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    save_dir = make_run_dir(cfg, args.prefix)
    run(cfg, save_dir, args.max_frames, device=args.device)


if __name__ == "__main__":
    main()
