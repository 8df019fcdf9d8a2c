"""What the five evaluation entry points (`eval_superpoint`, `eval_droid`,
`eval_track_long`, `eval_loop_e2e`, `eval_long_run`) share: the default
tracking configuration, the pipeline's parts by name, the ATE of a
tracker's trajectory so far, and the writer of the result.

Each entry point keeps the arguments, defaults and printed JSON keys of
the JAX package's script of the same name, adds `--device` (CUDA unless
it says otherwise; without CUDA it raises), and runs inside
`utils.device.reproducible`.
"""

from __future__ import annotations

import json
import shutil
import tempfile
import types

WEIGHTS = "vings_mono_tpu/weights/"
DROID_WEIGHTS = WEIGHTS + "droid_selftrained.npz"
SUPERPOINT_WEIGHTS = WEIGHTS + "superpoint_selftrained.npz"

# the closed room stream of the long evaluations: sharp textures (what
# the detector was trained on) on a multi-revolution orbit at 240x160
ROOM_INTRINSIC = {"fu": 200.0, "fv": 200.0, "cu": 120.0, "cv": 80.0,
                  "H": 240, "W": 160}


def room_dataset(frames, revs):
    return {"module": "synthetic3d", "n_frames": frames, "room": 4.0,
            "revs": revs, "tex_seed": 5, "sharpness": 1.0}


def room_frontend(iters1, iters2, save_buffer):
    """The room stream's frontend: 240x160, every frame a keyframe unless
    the caller sets `filter_thresh`, a 12-keyframe window."""
    return {
        "image_size": [240, 160], "buffer": 64, "warm_up": 8,
        "filter_thresh": -1.0, "keyframe_thresh": 0.0,
        "frontend_thresh": 1e9, "frontend_window": 12,
        "frontend_radius": 2, "frontend_nms": 1, "max_factors": 48,
        "edge_capacity": 64, "inactive_capacity": 128, "ba_window": 16,
        "iters1": iters1, "iters2": iters2, "active_window": 12,
        "max_age": 12, "rollup_at": 48, "rollup_n": 16,
        "save_buffer": save_buffer,
    }


def room_mapper(points_per_frame):
    """The room stream's mapper: 2^18 surfels, 2^17 pair slots, an
    8-keyframe window."""
    return {"capacity": 1 << 18, "pair_capacity": 1 << 17, "chunk": 128,
            "side": 3, "visible_capacity": 1 << 15, "kf_capacity": 8,
            "points_per_frame": points_per_frame,
            "points_first_frame": 16000}


def metric_block(weights):
    """The `use_metric` overrides for DPT weights (none without)."""
    if not weights:
        return {}
    return {"use_metric": True,
            "metric": {"backend": "flax", "weights": weights,
                       "d_max": 80.0}}


def default_cfg(overrides=None):
    """The tracking configuration of the droid evaluation: 120x160, every
    frame a keyframe, a 48-keyframe buffer; `overrides` is merged one
    level deep."""
    from ..utils.config import load_config
    base = {
        "mode": "vo",
        "dataset": {"module": "synthetic3d", "n_frames": 40},
        "frontend": {
            "image_size": [120, 160], "buffer": 48, "warm_up": 8,
            "filter_thresh": -1.0, "keyframe_thresh": 0.0,
            "frontend_thresh": 1e9, "frontend_window": 12,
            "frontend_radius": 2, "frontend_nms": 1, "max_factors": 48,
            "edge_capacity": 64, "inactive_capacity": 128,
            "ba_window": 16, "iters1": 2, "iters2": 1,
            "active_window": 12, "max_age": 12, "rollup_at": 44,
            "rollup_n": 16, "save_buffer": 256,
        },
        "training_args": {"iters": 30, "num_keyframe": 5},
        "mapper": {"capacity": 1 << 16, "pair_capacity": 1 << 17,
                   "chunk": 128, "side": 3, "visible_capacity": 1 << 15,
                   "kf_capacity": 8, "points_per_frame": 4000,
                   "points_first_frame": 8000},
        "middleware": {"max_depth": 100.0, "cov_times": 1e9},
    }
    if overrides:
        for k, v in overrides.items():
            if isinstance(v, dict):
                base.setdefault(k, {}).update(v)
            else:
                base[k] = v
    return load_config(overrides=base)


def build_parts(cfg, device):
    """`runners.run.build`'s parts by name: dataset, tracker, mapper,
    storage, looper, dynamic, metric (its tuple order is the port's own,
    not the JAX package's)."""
    from .run import build
    names = ("dataset", "tracker", "mapper", "storage", "looper", "dynamic",
             "metric")
    return types.SimpleNamespace(**dict(zip(names, build(cfg,
                                                         device=device))))


def ate_now(tracker, dataset, prefix="eval_ate_"):
    """ATE rmse of the tracker's trajectory so far (written to a temporary
    directory, evaluated, removed); None where `eval_trajectory` has
    none."""
    from ..utils.trajectory import save_trajectory
    from .evaluate import eval_trajectory
    d = tempfile.mkdtemp(prefix=prefix)
    try:
        save_trajectory(tracker, d)
        a = eval_trajectory(d, dataset)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return None if a is None else float(a)


def add_device_flag(p):
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; without CUDA it "
                        "raises unless this says cpu)")


def emit(out, path=None):
    """Print the result as one JSON line; write it to `path` too."""
    print(json.dumps(out), flush=True)
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    return out
