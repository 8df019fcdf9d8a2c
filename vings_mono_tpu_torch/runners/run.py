"""Flagship single-process pipeline:
dataset -> tracker [-> inertial fusion] -> middleware -> mapper
[-> storage paging] -> trajectory + .ply.

Usage: python -m vings_mono_tpu_torch.runners.run <config.yaml>
           [--prefix NAME] [--max-frames N] [--device cuda|cpu]

Runs on CUDA unless `--device` (or the config's `device` block) says
otherwise; without CUDA it raises and does not carry on on the CPU.

Ported: `mode: vo`, `vo_nerfslam` and `vio` (the inertial layer reads the
dataset's `preload_imu()`, and `preload_gnss()` / `preload_odo()` where the
dataset has them, with `frontend.c2i` from the dataset's `c2i`),
`use_storage_manager` (paging every `storage_manager.every` frames, timed as
stage `storage`), and `middleware.variant` v3, nerfslam and v0_kitti360.
Every option that is not ported yet raises NotImplementedError naming it:
`use_loop`, `use_metric`, `use_dynamic`, `use_global_ba`, `use_vis`,
`--resume`, `--checkpoint-every` (the mapper names its own: `use_sky`,
`use_refine`, `parallel.dp`, `training_args.coarse_frac`; the dataset
loader names the image-folder datasets).
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np

UNPORTED_FLAGS = ("use_loop", "use_metric", "use_dynamic", "use_global_ba",
                  "use_vis")
MODES = ("vo", "vo_nerfslam", "vio")


def check_ported(cfg, resume=None, checkpoint_every=None):
    """Raise NotImplementedError for the first option the port lacks."""
    if cfg.get("mode", "vo") not in MODES:
        raise NotImplementedError(
            f"mode: {cfg.get('mode')} is not ported yet (ported: "
            f"{', '.join(MODES)})")
    for flag in UNPORTED_FLAGS:
        if cfg.get(flag):
            raise NotImplementedError(f"{flag} is not ported yet")
    if resume:
        raise NotImplementedError("--resume is not ported yet")
    if checkpoint_every:
        raise NotImplementedError("--checkpoint-every is not ported yet")


def build(cfg, device=None):
    """(dataset, tracker, mapper, storage) for a config; `device` overrides
    the config's `device` block for tracker and mapper. With `mode: vio`
    the tracker has its inertial layer attached; storage is None unless
    `use_storage_manager` is set."""
    from ..datasets.base import get_dataset
    from ..mapper.mapper import GaussianMapper
    from ..tracker.tracker import Tracker

    check_ported(cfg)
    dataset = get_dataset(cfg)
    H, W = (int(cfg["frontend"]["image_size"][0]),
            int(cfg["frontend"]["image_size"][1]))
    cfg["frontend"]["c2i"] = getattr(dataset, "c2i", np.eye(4))
    weights = cfg["frontend"].get("weight")
    tracker = Tracker(cfg, H, W, weights_path=weights, device=device)
    mapper = GaussianMapper(cfg, device=device)
    if cfg.get("mode") == "vio":
        from ..tracker.vio import InertialFusion
        # optional GNSS / wheel-odometry streams [(M,4) t,xyz] when the
        # dataset provides them
        gnss = getattr(dataset, "preload_gnss", lambda: None)()
        odo = getattr(dataset, "preload_odo", lambda: None)()
        tracker.frontend.attach_inertial(InertialFusion(
            tracker.video, cfg, dataset.preload_imu(),
            np.asarray(cfg["frontend"]["c2i"]), all_gnss=gnss,
            all_odo=odo))
    storage = None
    if cfg.get("use_storage_manager"):
        from ..storage.manager import StorageManager
        storage = StorageManager(cfg)
    return dataset, tracker, mapper, storage


def run(cfg, save_dir, max_frames=None, on_frame=None, resume=None,
        checkpoint_every=None, start_frame=0, device=None,
        sync_timer=False):
    """Track and map the dataset's frames; writes the trajectory and the
    final .ply under save_dir. Returns (tracker, mapper, timer).

    on_frame(idx, tracker, mapper, viz_out) is called after every frame.
    sync_timer: end each timed stage with a device synchronize, so the
    stage times hold the device work (slower: it stops the host from
    running ahead)."""
    from ..middleware import judge_and_package
    from ..utils.profiling import StageTimer
    from ..utils.trajectory import save_trajectory

    check_ported(cfg, resume, checkpoint_every)
    dataset, tracker, mapper, storage = build(cfg, device=device)
    every = int(cfg["storage_manager"]["every"]) if storage else 0

    timer = StageTimer(sync_device=tracker.device if sync_timer else None)
    n = len(dataset) if max_frames is None else min(len(dataset),
                                                    max_frames)
    for idx in range(start_frame, n):
        pkt = dataset[idx]
        with timer("track"):
            tracker.track(pkt)
        with timer("package"):
            viz_out = judge_and_package(tracker, cfg)
        if viz_out is not None:
            with timer("map"):
                mapper.run(viz_out)
        if storage is not None and idx % every == every - 1:
            with timer("storage"):
                storage.run(tracker, mapper, viz_out)
        if on_frame is not None:
            on_frame(idx, tracker, mapper, viz_out)

    save_trajectory(tracker, save_dir)
    os.makedirs(os.path.join(save_dir, "ply"), exist_ok=True)
    mapper.save_ply(os.path.join(save_dir, "ply", "final_2dgs.ply"))
    return tracker, mapper, timer


def main(argv=None):
    from ..utils.config import load_config, make_run_dir
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--prefix", default="")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the config's, cuda)")
    p.add_argument("--resume", default=None,
                   help="session checkpoint dir to resume from")
    p.add_argument("--checkpoint-every", type=int, default=None)
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    check_ported(cfg, args.resume, args.checkpoint_every)
    save_dir = make_run_dir(cfg, args.prefix)
    shutil.copy(args.config, os.path.join(save_dir, "config.yaml"))
    t0 = time.time()
    tracker, mapper, timer = run(cfg, save_dir, args.max_frames,
                                 device=args.device)
    print(f"done in {time.time() - t0:.1f}s -> {save_dir}")
    print(timer.report())


if __name__ == "__main__":
    main()
