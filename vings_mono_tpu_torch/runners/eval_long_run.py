"""The long-trajectory integration evaluation: 300+ frames of the room at
the reference's workload shape, with real drift over several
revolutions, loop closure every 3 keyframes after 12, storage paging
every 10 frames and the global BA terminate pass, the ATE measured at
each stage. The `full` lane runs all of it; the `no_loop` lane (unless
`--skip-baseline`) the same stream with paging alone.

Per lane: keyframes, the online ATE, the peak Gaussian count (on the
device plus paged out to the host, read every frame), the ATE before and
after each accepted closure, the closures, storage's pages and events,
the global BA's stats and the ATE after it, and the map's PSNR
(`eval_psnr`).

Usage: python -m vings_mono_tpu_torch.runners.eval_long_run
           [--frames 320] [--revs 2.2] [--filter-thresh 1.75]
           [--page-dist 1.2]
           [--weights vings_mono_tpu/weights/superpoint_selftrained.npz]
           [--lightglue FILE] [--droid-weights FILE] [--out FILE]
           [--skip-baseline] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .eval_common import (DROID_WEIGHTS, ROOM_INTRINSIC, SUPERPOINT_WEIGHTS,
                          add_device_flag, ate_now, build_parts, emit,
                          room_dataset, room_frontend, room_mapper)


def _cfg(args, use_loop, use_storage, use_gba):
    from ..utils.config import load_config
    return load_config(overrides={
        "mode": "vo",
        "use_loop": use_loop,
        "use_storage_manager": use_storage,
        "use_global_ba": use_gba,
        "dataset": room_dataset(args.frames, args.revs),
        "intrinsic": dict(ROOM_INTRINSIC),
        # the motion filter decides keyframes (the trained gate's
        # operating point)
        "frontend": {**room_frontend(2, 1, 512),
                     "filter_thresh": args.filter_thresh,
                     "weight": args.droid_weights},
        "training_args": {"iters": 16, "num_keyframe": 5},
        "mapper": room_mapper(8000),
        "looper": {"every": 3, "start_after": 12, "min_history": 12,
                   "min_gap_from_last": 8, "search_radius": 10.0,
                   "superpoint_weights": args.weights,
                   "lightglue_weights": args.lightglue,
                   "depth_writeback": True,
                   "retrain": False},
        # page out keyframes more than about half a room away: the far
        # side of the orbit crosses it every revolution
        "storage_manager": {"every": 10,
                            "distance_threshold": args.page_dist},
    })


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=320)
    p.add_argument("--revs", type=float, default=2.2)
    p.add_argument("--filter-thresh", type=float, default=1.75)
    p.add_argument("--page-dist", type=float, default=1.2)
    p.add_argument("--weights", default=SUPERPOINT_WEIGHTS)
    p.add_argument("--lightglue", default=None)
    p.add_argument("--droid-weights", default=DROID_WEIGHTS)
    p.add_argument("--out", default=None)
    p.add_argument("--skip-baseline", action="store_true")
    add_device_flag(p)
    return p.parse_args(argv)


def lane(args, use_loop, use_storage, use_gba, device):
    from ..datasets import synthetic3d
    from ..middleware import judge_and_package
    from ..tracker.backend import GlobalBA
    from .evaluate import eval_psnr

    cfg = _cfg(args, use_loop, use_storage, use_gba)
    parts = build_parts(cfg, device)
    dataset, tracker, mapper, looper, storage = (
        parts.dataset, parts.tracker, parts.mapper, parts.looper,
        parts.storage)
    dataset.tex = synthetic3d.texture_params(5, sharpness=1.0)
    try:
        kf_count = 0
        peak_gauss = 0
        closure_deltas = []
        lcfg = cfg["looper"]
        for idx in range(args.frames):
            tracker.track(dataset[idx])
            viz_out = judge_and_package(tracker, cfg)
            if viz_out is not None:
                mapper.run(viz_out)
                kf_count += 1
                if looper is not None and \
                        kf_count > lcfg["start_after"] and \
                        kf_count % lcfg["every"] == 0:
                    n_before = len(looper.closed_at)
                    ate_b = ate_now(tracker, dataset, "long_run_ate_")
                    looper.run(mapper, tracker, viz_out, idx)
                    if len(looper.closed_at) > n_before:
                        closure_deltas.append(
                            {"at_gid": int(looper.closed_at[-1]),
                             "ate_before": ate_b,
                             "ate_after": ate_now(tracker, dataset,
                                                  "long_run_ate_")})
            if storage is not None and idx % 10 == 9 and viz_out is not None:
                storage.run(tracker, mapper, viz_out)
            # one read of the device's count per frame, the measure itself
            peak_gauss = max(peak_gauss, int(mapper.n_alive)
                             + (storage.n_host if storage else 0))
        out = {"keyframes": kf_count,
               "ate_online_m": ate_now(tracker, dataset, "long_run_ate_"),
               "peak_gaussians": peak_gauss,
               "closure_deltas": closure_deltas}
        if looper is not None:
            out["loops_closed"] = len(looper.closed_at)
            out["closed_at"] = [int(g) for g in looper.closed_at]
            out["loop_traces"] = looper.loop_traces
        if storage is not None:
            out["pages_out"] = storage.pages_out
            out["pages_in"] = storage.pages_in
            out["evict_events"] = storage.evict_events
            out["pagein_events"] = storage.pagein_events
            out["host_rows_end"] = storage.n_host
        if use_gba:
            loop_pairs = [(t["cand_gid"], t["cur_gid"])
                          for t in looper.loop_traces
                          if "rejected" not in t] if looper else []
            stats = GlobalBA(tracker, cfg, extra_edges=loop_pairs).run()
            out["global_ba_loop_edges"] = len(loop_pairs)
            out["global_ba"] = {k: int(v) if isinstance(v, (int, np.integer))
                                else bool(v) for k, v in stats.items()}
            out["ate_after_global_ba_m"] = ate_now(tracker, dataset,
                                                   "long_run_ate_")
        psnr = eval_psnr(mapper, tracker)
        out["psnr"] = None if psnr is None else float(psnr)
        return out
    finally:
        mapper.close()


def evaluate(args, device):
    full = lane(args, True, True, True, device)
    res = {"frames": args.frames, "revs": args.revs, "full": full}
    if not args.skip_baseline:
        res["no_loop"] = lane(args, False, True, False, device)
    return res


def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    with reproducible():
        out = evaluate(args, device)
    return emit(out, args.out)


if __name__ == "__main__":
    main()
