"""Flagship single-process pipeline:
dataset -> tracker [-> inertial fusion] -> middleware -> mapper
[-> pose refinement back into the tracker] [-> storage paging] [-> vis]
-> global BA -> trajectory + .ply.

Usage: python -m vings_mono_tpu_torch.runners.run <config.yaml>
           [--prefix NAME] [--max-frames N] [--device cuda|cpu]

Runs on CUDA unless `--device` (or the config's `device` block) says
otherwise; without CUDA it raises and does not carry on on the CPU.

Ported: `mode: vo`, `vo_nerfslam` and `vio` (the inertial layer reads the
dataset's `preload_imu()`, and `preload_gnss()` / `preload_odo()` where the
dataset has them, with `frontend.c2i` from the dataset's `c2i`),
`use_storage_manager` (paging every `storage_manager.every` frames, timed as
stage `storage`), `middleware.variant` v3, nerfslam and v0_kitti360,
`use_dynamic` (the newest keyframe's dynamic pixels masked out of the
mapper loss before mapping, stage `dynamic`), `use_loop` (loop detection
every `looper.every` keyframes after `looper.start_after`, with pose and
map rectification on a closure, stage `loop`; the accepted pairs become
global-BA edges), `use_global_ba` (the terminate pass, stage `global_ba`),
`use_vis` (the rgbdnua panel every keyframe, the map and the follow-cam BEV
every tenth, stage `vis`), and in the mapper `use_sky`, `use_refine` (the
refined poses go back into the tracker's window) and
`training_args.coarse_frac`. `check_ported` raises NotImplementedError
naming the first option that is not ported yet: `use_metric`,
`parallel.dp`, `--resume`, `--checkpoint-every` (the dataset loader names
the image-folder datasets).
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np

UNPORTED_FLAGS = ("use_metric",)
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
    if int((cfg.get("parallel") or {}).get("dp", 1)) > 1:
        raise NotImplementedError("parallel.dp is not ported yet")
    if resume:
        raise NotImplementedError("--resume is not ported yet")
    if checkpoint_every:
        raise NotImplementedError("--checkpoint-every is not ported yet")


def build(cfg, device=None):
    """(dataset, tracker, mapper, storage, looper, dynamic) for a config;
    `device` overrides the config's `device` block for tracker and mapper.
    With `mode: vio` the tracker has its inertial layer attached; storage,
    looper and dynamic are None unless `use_storage_manager`, `use_loop`
    and `use_dynamic` are set."""
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
    looper = dynamic = None
    if cfg.get("use_loop"):
        from ..loop.loop_model import LoopModel
        looper = LoopModel(cfg, device=tracker.device)
    if cfg.get("use_dynamic"):
        from ..dynamic.dynamic_model import DynamicModel
        dynamic = DynamicModel(cfg, device=mapper.device)
    return dataset, tracker, mapper, storage, looper, dynamic


def run(cfg, save_dir, max_frames=None, on_frame=None, resume=None,
        checkpoint_every=None, start_frame=0, device=None,
        sync_timer=False):
    """Track and map the dataset's frames; writes the trajectory and the
    final .ply under save_dir. Returns (tracker, mapper, timer).

    on_frame(idx, tracker, mapper, viz_out) is called after every frame.
    sync_timer: end each timed stage with a device synchronize, so the
    stage times hold the device work (slower: it stops the host from
    running ahead)."""
    from ..middleware import judge_and_package, retrieve_to_tracker
    from ..utils.profiling import StageTimer
    from ..utils.trajectory import save_trajectory

    check_ported(cfg, resume, checkpoint_every)
    dataset, tracker, mapper, storage, looper, dynamic = build(cfg,
                                                               device=device)
    every = int(cfg["storage_manager"]["every"]) if storage else 0
    lcfg = cfg.get("looper") or {}

    timer = StageTimer(sync_device=tracker.device if sync_timer else None)
    n = len(dataset) if max_frames is None else min(len(dataset),
                                                    max_frames)
    kf_count = 0
    for idx in range(start_frame, n):
        pkt = dataset[idx]
        with timer("track"):
            tracker.track(pkt)
        with timer("package"):
            viz_out = judge_and_package(tracker, cfg)
        if viz_out is not None:
            if dynamic is not None:
                with timer("dynamic"):
                    viz_out = dynamic.apply_to_viz_out(viz_out, mapper)
            with timer("map"):
                mapper.run(viz_out)
            if cfg.get("use_refine") and mapper.refined_poses is not None:
                retrieve_to_tracker(viz_out, mapper.refined_poses, tracker)
            kf_count += 1
            if looper is not None and kf_count > lcfg["start_after"] and \
                    kf_count % lcfg["every"] == 0:
                with timer("loop"):
                    looper.run(mapper, tracker, viz_out, idx)
        if storage is not None and idx % every == every - 1:
            with timer("storage"):
                storage.run(tracker, mapper, viz_out)
        if cfg.get("use_vis") and viz_out is not None:
            with timer("vis"):
                _save_vis(cfg, save_dir, tracker, mapper, storage, viz_out,
                          kf_count)
        if on_frame is not None:
            on_frame(idx, tracker, mapper, viz_out)

    if cfg.get("use_global_ba"):
        # terminate pass: full-trajectory BA removes the online drift the
        # sliding window could not; accepted closures anchor it
        from ..tracker.backend import GlobalBA
        loop_pairs = [(t["cand_gid"], t["cur_gid"])
                      for t in looper.loop_traces
                      if "rejected" not in t] if looper is not None else []
        with timer("global_ba"):
            stats = GlobalBA(tracker, cfg, extra_edges=loop_pairs).run()
        print(f"global BA: {stats}")
    save_trajectory(tracker, save_dir)
    os.makedirs(os.path.join(save_dir, "ply"), exist_ok=True)
    mapper.save_ply(os.path.join(save_dir, "ply", "final_2dgs.ply"))
    return tracker, mapper, timer


def _save_vis(cfg, save_dir, tracker, mapper, storage, viz_out, kf_count):
    """The rgbdnua panel of the newest keyframe; every tenth keyframe also
    the whole map (host pages composited) and the follow-cam BEV. Returns
    the uint8 images by name."""
    from ..utils.trajectory import tracker_c2ws
    from ..utils.vis import host_array, save_rgbdnua, vis_bev, vis_map
    kf = -1
    pose = host_array(viz_out["poses"][kf])
    rets = mapper.render_at(np.linalg.inv(pose), viz_out["intrinsic"])
    gt = {k: np.moveaxis(host_array(viz_out[k][kf]), -1, 0)
          for k in ("images", "depths", "depths_cov")}
    ts = float(np.asarray(viz_out["viz_out_idx_to_f_idx"])[kf])
    out = {"rgbdnua": save_rgbdnua(save_dir, ts, rets, gt["images"],
                                   gt["depths"], gt["depths_cov"])}
    if (kf_count - 1) % 10 == 0:
        vcfg = cfg.get("vis", {}) or {}
        map_size = tuple(vcfg.get("map_size", (480, 640)))
        bev_size = tuple(vcfg.get("bev_size", (320, 320)))
        _, c2ws = tracker_c2ws(tracker)
        out["map"] = vis_map(mapper, np.asarray(c2ws), os.path.join(
            save_dir, "map", f"map_{kf_count:05d}.png"), size=map_size,
            storage=storage)
        out["bev"] = vis_bev(mapper, pose, os.path.join(
            save_dir, "bev", f"bev_{kf_count:05d}.png"), size=bev_size)
    return out


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
