"""YAML config loading with defaults — same schema as the reference's
per-sequence configs (the rtg/hotel.yaml layout) and loader
(general_utils.py)."""

from __future__ import annotations

import copy
import os
import time

import yaml

DEFAULTS = {
    "mode": "vo",
    "use_wandb": False,
    "use_sky": False,
    "use_dynamic": False,
    "use_loop": False,
    "use_metric": False,
    "use_refine": False,
    "use_storage_manager": False,
    "use_vis": False,
    "debug_mode": False,
    "device": {"tracker": "cuda", "mapper": "cuda"},
    "middleware": {"max_depth": 30.0, "cov_times": 5.0},
    "frontend": {
        "buffer": 256,
        "warmup": 8,
        "filter_thresh": 2.4,
        "keyframe_thresh": 3.5,
        "frontend_thresh": 17.5,
        "frontend_window": 25,
        "frontend_radius": 2,
        "frontend_nms": 1,
        "max_factors": 48,
        "iters1": 4,
        "iters2": 2,
        "max_age": 25,
        "upsample": True,
        "beta": 0.3,
    },
    # terminate-pass global BA (reference visual_frontend.py:1460-1542)
    "backend": {
        "steps": 6,
        "iters": 2,
        "thresh": 25.0,
        "nms": 2,
        "radius": 2,
        "degree_cap": 8,
        "chunk": 32,
        "encode_batch": 8,
    },
    "use_global_ba": False,
    "training_args": {
        "iters": 50,
        "num_keyframe": 5,
        "lr": {
            "_xyz_lr": 1e-4,
            "_rgb_lr": 2.5e-3,
            "_scaling_lr": 5e-3,
            "_rotation_lr": 1e-3,
            "_opacity_lr": 5e-2,
        },
        "loss_weights": {
            "rgb_loss": 1.0,
            "depth_loss": 0.1,
            "normal_loss": 0.05,
            "alpha_loss": 0.1,
            "dist_loss": 100.0,
        },
    },
    "adc_args": {"accum_thresh": 0.5},
    "mapper": {
        "capacity": 1 << 19,
        # rasterizer knobs: visible_capacity bounds the binning sort, and
        # side=3 (48 px tile span) covers everything under the 25 px radii
        # prune
        "pair_capacity": 1 << 19,
        "chunk": 128,
        "side": 3,
        "visible_capacity": 1 << 17,
        "rebin_rows": 3,
        # PSNR bar above which the per-KF training iteration budget halves
        # (None = always full budget, reference parity)
        "adaptive_iters": None,
        "kf_capacity": 20,
        "points_per_frame": 40000,
        "points_first_frame": 50000,
    },
    "storage_manager": {"distance_threshold": 60.0, "every": 10},
    "looper": {"every": 3, "start_after": 10},
    "output": {"save_dir": "output/run"},
}


def _deep_merge(base, upd):
    out = copy.deepcopy(base)
    for k, v in (upd or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path=None, overrides=None):
    cfg = copy.deepcopy(DEFAULTS)
    if path is not None:
        with open(path) as f:
            cfg = _deep_merge(cfg, yaml.safe_load(f))
    if overrides:
        cfg = _deep_merge(cfg, overrides)
    return cfg


def make_run_dir(cfg, prefix=""):
    """Timestamped run dir like the reference's get_name
    (general_utils.py:9-20)."""
    stamp = time.strftime("%Y%m%d_%H%M%S")
    name = f"{prefix}{stamp}"
    save_dir = os.path.join(cfg["output"]["save_dir"], name)
    os.makedirs(save_dir, exist_ok=True)
    for sub in ("droid_c2w", "rgbdnua", "ply", "map", "bev"):
        os.makedirs(os.path.join(save_dir, sub), exist_ok=True)
    return save_dir
