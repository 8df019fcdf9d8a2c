"""End-to-end loop closure with learned detection: the whole pipeline on
the closed multi-revolution room trajectory, the self-trained SuperPoint
driving `LoopModel` (extract -> match -> PnP -> render verification on
the rendered frames), with no given candidates and no detection bypass.

Reports the loops closed, the ATE after the run and, on a fresh build of
the same trajectory without loop closure, the no-loop ATE; per accepted
closure the ATE just before and after it; per closure trace the
measured (`gt_*`) and tracked (`track_*`) candidate->current relative
pose against the ground truth (rotation error, translation direction and
length ratio); the detector's stage histogram and traces.

Usage: python -m vings_mono_tpu_torch.runners.eval_loop_e2e
           [--weights vings_mono_tpu/weights/superpoint_selftrained.npz]
           [--lightglue FILE] [--droid-weights FILE] [--frames 160]
           [--revs 1.6] [--min-history 35] [--every 3]
           [--points-per-frame 4000] [--iters1 2] [--iters2 1] [--cv 0.0]
           [--metric-weights FILE] [--out FILE] [--skip-baseline]
           [--depth-writeback 0|1] [--gt-target] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .eval_common import (DROID_WEIGHTS, ROOM_INTRINSIC, SUPERPOINT_WEIGHTS,
                          add_device_flag, ate_now, build_parts, emit,
                          metric_block, room_dataset, room_frontend,
                          room_mapper)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default=SUPERPOINT_WEIGHTS)
    p.add_argument("--lightglue", default=None)
    p.add_argument("--droid-weights", default=DROID_WEIGHTS,
                   help="tracker flow net ('' = random init)")
    p.add_argument("--frames", type=int, default=160)
    p.add_argument("--revs", type=float, default=1.6,
                   help="trajectory revolutions: > 1 revisits the room "
                        "after drift has built up, the regime loop "
                        "closure exists for")
    p.add_argument("--min-history", type=int, default=35)
    p.add_argument("--every", type=int, default=3)
    p.add_argument("--points-per-frame", type=int, default=4000)
    p.add_argument("--iters1", type=int, default=2)
    p.add_argument("--iters2", type=int, default=1)
    p.add_argument("--cv", type=float, default=0.0,
                   help="frontend.motion_model_alpha (0: identity seeding, "
                        "the reference's VO behavior)")
    p.add_argument("--metric-weights", default=None,
                   help="DPT metric-depth weights: enables use_metric, so "
                        "disps_sens pins the depth gauge")
    p.add_argument("--out", default=None)
    p.add_argument("--skip-baseline", action="store_true",
                   help="skip the no-loop ATE baseline lane")
    p.add_argument("--depth-writeback", type=int, default=0,
                   help="1: rewrite rectified-span disparities from the "
                        "re-anchored map")
    p.add_argument("--gt-target", action="store_true",
                   help="diagnostic ceiling: bypass PnP and take the "
                        "closure target from the dataset's ground truth "
                        "(still gauge-rescaled)")
    add_device_flag(p)
    return p.parse_args(argv)


def config(args):
    from ..utils.config import load_config
    return load_config(overrides={
        "mode": "vo",
        "use_loop": True,
        "dataset": room_dataset(args.frames, args.revs),
        "intrinsic": dict(ROOM_INTRINSIC),
        "frontend": {
            **room_frontend(args.iters1, args.iters2, 256),
            "motion_model_alpha": args.cv,
            **({"weight": args.droid_weights} if args.droid_weights
               else {}),
        },
        "training_args": {"iters": 16, "num_keyframe": 5},
        "mapper": room_mapper(args.points_per_frame),
        "looper": {"every": args.every, "start_after": 12,
                   "min_history": args.min_history,
                   "min_gap_from_last": 8, "search_radius": 10.0,
                   "superpoint_weights": args.weights,
                   "lightglue_weights": args.lightglue,
                   "depth_writeback": bool(args.depth_writeback),
                   "retrain": False},
        **metric_block(args.metric_weights),
    })


def room_build(cfg, device):
    """The pipeline's parts, the stream on sharp textures (what the
    detector was trained on: smooth sinusoids have no localizable
    corners)."""
    from ..datasets import synthetic3d
    parts = build_parts(cfg, device)
    parts.dataset.tex = synthetic3d.texture_params(5, sharpness=1.0)
    return parts


def saved_tstamps(video):
    return list(np.asarray(video._tstamp_save[:video.count_save])) + \
        list(video.tstamps_host)


def rel_pose_errors(rel_m, rel_gt):
    """Rotation error, translation direction error (degrees) and length
    ratio of a relative pose against the truth."""
    rot_err = np.degrees(np.arccos(np.clip(
        (np.trace(rel_gt[:3, :3].T @ rel_m[:3, :3]) - 1) / 2, -1, 1)))
    tm, tg = rel_m[:3, 3], rel_gt[:3, 3]
    cosang = float(tm @ tg / (np.linalg.norm(tm) * np.linalg.norm(tg)
                              + 1e-12))
    return (float(rot_err),
            float(np.degrees(np.arccos(np.clip(cosang, -1, 1)))),
            float(np.linalg.norm(tm) / (np.linalg.norm(tg) + 1e-12)))


def grade_traces(loop_traces, tss, dataset):
    """Replace each closure trace's `rel_meas` / `rel_track` by their
    errors against the ground truth (`gt_*` / `track_*`)."""
    for tr in loop_traces:
        if "rel_meas" not in tr:
            continue
        try:
            t_cur = float(tss[tr["cur_gid"]])
            t_cand = float(tss[tr["cand_gid"]])
        except (IndexError, TypeError):
            continue
        rel_gt = np.linalg.inv(dataset.gt_c2w(int(t_cand))) @ \
            dataset.gt_c2w(int(t_cur))
        for key, pre in (("rel_meas", "gt"), ("rel_track", "track")):
            if key not in tr:
                continue
            (tr[f"{pre}_rot_err_deg"], tr[f"{pre}_t_dir_deg"],
             tr[f"{pre}_t_ratio"]) = rel_pose_errors(np.asarray(tr[key]),
                                                     rel_gt)
            del tr[key]


def no_loop_ate(cfg, frames, device):
    """ATE of the same trajectory on a fresh build, without loop
    closure."""
    from ..middleware import judge_and_package
    parts = room_build(cfg, device)
    try:
        for idx in range(frames):
            pkt = parts.dataset[idx]
            if parts.metric is not None:
                pkt["depth"] = parts.metric.predict(pkt["rgb"],
                                                    pkt["intrinsic"])
            parts.tracker.track(pkt)
            viz_out = judge_and_package(parts.tracker, cfg)
            if viz_out is not None:
                parts.mapper.run(viz_out)
        return ate_now(parts.tracker, parts.dataset, "loop_e2e_nl_")
    finally:
        parts.mapper.close()


def evaluate(args, device):
    from ..middleware import judge_and_package
    cfg = config(args)
    parts = room_build(cfg, device)
    dataset, tracker, mapper, looper, metric = (
        parts.dataset, parts.tracker, parts.mapper, parts.looper,
        parts.metric)
    try:
        kf_count = 0
        detect_attempts = 0
        orig_detect = looper.detector.detect

        def counted_detect(*a, **kw):
            nonlocal detect_attempts
            detect_attempts += 1
            return orig_detect(*a, **kw)

        looper.detector.detect = counted_detect

        if args.gt_target:
            # the measurement replaced by the ground-truth relative pose:
            # the looper sees new_hist_c2w = cur @ inv(rel_gt), so
            # rel_meas == rel_gt (the gauge rescale still applies)
            def gt_detect(mapper_, cur_img, cur_depth, cur_c2w, hist_img,
                          hist_c2w_guess, intr_, **kw):
                nonlocal detect_attempts
                detect_attempts += 1
                ts_all = saved_tstamps(tracker.video)
                cur_t = int(round(float(ts_all[-1])))
                c2ws_h = looper._history(tracker)
                d = np.linalg.norm(c2ws_h[:, :3, 3]
                                   - np.asarray(hist_c2w_guess)[:3, 3],
                                   axis=-1)
                cand_t = int(round(float(ts_all[int(np.argmin(d))])))
                rel_gt = np.linalg.inv(dataset.gt_c2w(cand_t)) @ \
                    dataset.gt_c2w(cur_t)
                return np.asarray(cur_c2w) @ np.linalg.inv(rel_gt)

            looper.detector.detect = gt_detect

        closure_deltas = []   # per accepted closure: ATE before / after
        lcfg = cfg["looper"]
        for idx in range(args.frames):
            pkt = dataset[idx]
            if metric is not None:
                pkt["depth"] = metric.predict(pkt["rgb"], pkt["intrinsic"])
            tracker.track(pkt)
            viz_out = judge_and_package(tracker, cfg)
            if viz_out is not None:
                mapper.run(viz_out)
                kf_count += 1
                if kf_count > lcfg["start_after"] and \
                        kf_count % lcfg["every"] == 0:
                    n_before = len(looper.closed_at)
                    ate_before = ate_now(tracker, dataset, "loop_e2e_snap_")
                    looper.run(mapper, tracker, viz_out, idx)
                    if len(looper.closed_at) > n_before:
                        closure_deltas.append(
                            {"at_gid": int(looper.closed_at[-1]),
                             "ate_before": ate_before,
                             "ate_after": ate_now(tracker, dataset,
                                                  "loop_e2e_snap_")})
        ate = ate_now(tracker, dataset, "loop_e2e_")
        grade_traces(looper.loop_traces, saved_tstamps(tracker.video),
                     dataset)
    finally:
        mapper.close()

    ate_nl = None if args.skip_baseline else no_loop_ate(cfg, args.frames,
                                                         device)
    traces = looper.detector.traces
    stages = {}
    for t in traces:
        stages[t["stage"]] = stages.get(t["stage"], 0) + 1
    return {"frames": args.frames,
            "keyframes": kf_count,
            "detect_attempts": detect_attempts,
            "loops_closed": len(looper.closed_at),
            "closed_at": [int(g) for g in looper.closed_at],
            "ate_rmse_m": ate,
            "ate_no_loop_m": ate_nl,
            "closure_deltas": closure_deltas,
            "stage_histogram": stages,
            "loop_traces": looper.loop_traces,
            "traces": traces}


def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    with reproducible():
        out = evaluate(args, device)
    return emit(out, args.out)


if __name__ == "__main__":
    main()
