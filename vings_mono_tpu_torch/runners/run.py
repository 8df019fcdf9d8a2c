"""Flagship single-process pipeline:
dataset -> tracker [-> inertial fusion] -> middleware -> mapper
[-> pose refinement back into the tracker] [-> storage paging] [-> vis]
-> global BA -> trajectory + .ply.

Usage: python -m vings_mono_tpu_torch.runners.run <config.yaml>
           [--prefix NAME] [--max-frames N] [--device cuda|cpu]
           [--checkpoint-every N] [--resume SESSION_DIR]

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
every tenth, stage `vis`), `use_metric` (the metric-depth prior of each
frame becomes its `depth`, stage `metric`), and in the mapper `use_sky`,
`use_refine` (the refined poses go back into the tracker's window) and
`training_args.coarse_frac`. `--checkpoint-every N` saves the session to
`<save_dir>/session` before every N-th frame (stage `checkpoint`);
`--resume DIR` loads a session of either package and carries on at the
frame its keyframe count names. `parallel: {dp: N}` trains the map on N
ranks, one process each (`parallel/mesh.py`); the mapper stops them when
the run ends, however it ends; as in the JAX package, `parallel.sp` is
read by no runner (`parallel.mesh.sharded_train_step` takes a (dp, sp)
group). `check_ported` raises NotImplementedError for an unknown `mode`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np

MODES = ("vo", "vo_nerfslam", "vio")


def check_ported(cfg):
    """Raise NotImplementedError for an option the port lacks."""
    if cfg.get("mode", "vo") not in MODES:
        raise NotImplementedError(
            f"mode: {cfg.get('mode')} is not ported yet (ported: "
            f"{', '.join(MODES)})")


def build_tracker(cfg, dataset, device=None):
    """The tracker for a config and its dataset, with `frontend.c2i` from
    the dataset's `c2i`; with `mode: vio` its inertial layer is attached
    and reads the dataset's `preload_imu()` (and `preload_gnss()` /
    `preload_odo()` where the dataset has them)."""
    from ..tracker.tracker import Tracker
    H, W = (int(cfg["frontend"]["image_size"][0]),
            int(cfg["frontend"]["image_size"][1]))
    cfg["frontend"]["c2i"] = getattr(dataset, "c2i", np.eye(4))
    tracker = Tracker(cfg, H, W, weights_path=cfg["frontend"].get("weight"),
                      device=device)
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
    return tracker


def build(cfg, device=None):
    """(dataset, tracker, mapper, storage, looper, dynamic, metric) for a
    config; `device` overrides the config's `device` block for tracker,
    mapper and the metric-depth net. Storage, looper, dynamic and metric
    are None unless `use_storage_manager`, `use_loop`, `use_dynamic` and
    `use_metric` are set."""
    from ..datasets.base import get_dataset
    from ..mapper.mapper import GaussianMapper

    check_ported(cfg)
    dataset = get_dataset(cfg)
    tracker = build_tracker(cfg, dataset, device)
    mapper = GaussianMapper(cfg, device=device)
    try:
        return (dataset, tracker, mapper) + _build_options(cfg, tracker,
                                                           mapper)
    except BaseException:
        mapper.close()
        raise


def _build_options(cfg, tracker, mapper):
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
    metric = None
    if cfg.get("use_metric"):
        from ..models.metric_depth import MetricDepth
        metric = MetricDepth(cfg, device=tracker.device)
    return storage, looper, dynamic, metric


def run(cfg, save_dir, max_frames=None, on_frame=None, resume=None,
        checkpoint_every=None, start_frame=0, device=None,
        sync_timer=False):
    """Track and map the dataset's frames; writes the trajectory and the
    final .ply under save_dir. Returns (tracker, mapper, timer).

    on_frame(idx, tracker, mapper, viz_out) is called after every frame.
    resume: a session directory (utils/checkpoint.py) to load first; the
    run then starts at frame `len(tstamps_host) + count_save`, the
    session's keyframe count (the JAX package's rule: the frame after the
    session's last where every frame became a keyframe).
    checkpoint_every: save the session to save_dir/session before every
    N-th frame (stage `checkpoint`). sync_timer: end each timed stage with
    a device synchronize, so the stage times hold the device work (slower:
    it stops the host from running ahead). The run is reproducible
    (`utils.device.reproducible`)."""
    from ..utils.device import reproducible
    with reproducible():
        return _run(cfg, save_dir, max_frames, on_frame, resume,
                    checkpoint_every, start_frame, device, sync_timer)


def _run(cfg, save_dir, max_frames, on_frame, resume, checkpoint_every,
         start_frame, device, sync_timer):
    from ..middleware import judge_and_package, retrieve_to_tracker
    from ..utils.checkpoint import load_session, save_session
    from ..utils.profiling import StageTimer
    from ..utils.trajectory import save_trajectory

    check_ported(cfg)
    dataset, tracker, mapper, storage, looper, dynamic, metric = build(
        cfg, device=device)
    try:
        every = int(cfg["storage_manager"]["every"]) if storage else 0
        lcfg = cfg.get("looper") or {}
        inertial = tracker.frontend.inertial
        if resume:
            load_session(resume, tracker, mapper, inertial)
            start_frame = max(start_frame, len(tracker.video.tstamps_host)
                              + tracker.video.count_save)

        timer = StageTimer(sync_device=tracker.device if sync_timer else None)
        n = len(dataset) if max_frames is None else min(len(dataset),
                                                        max_frames)
        kf_count = 0
        for idx in range(start_frame, n):
            if checkpoint_every and idx and idx % checkpoint_every == 0:
                with timer("checkpoint"):
                    save_session(os.path.join(save_dir, "session"), tracker,
                                 mapper, inertial)
            pkt = dataset[idx]
            if metric is not None:
                with timer("metric"):
                    pkt["depth"] = metric.predict(pkt["rgb"], pkt["intrinsic"])
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
    finally:
        mapper.close()


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
    check_ported(cfg)
    save_dir = make_run_dir(cfg, args.prefix)
    shutil.copy(args.config, os.path.join(save_dir, "config.yaml"))
    t0 = time.time()
    tracker, mapper, timer = run(cfg, save_dir, args.max_frames,
                                 resume=args.resume,
                                 checkpoint_every=args.checkpoint_every,
                                 device=args.device)
    print(f"done in {time.time() - t0:.1f}s -> {save_dir}")
    print(timer.report())


if __name__ == "__main__":
    main()
