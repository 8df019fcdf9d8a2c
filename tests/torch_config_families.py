"""What tests/test_torch_config_families_*.py share: one of
profile_configs.py's shipped configuration families run through both
packages' `runners.run.run` on the same folder, written by
`profile_configs.write_folder` in the family's dataset layout, under
JAX_PLATFORMS=cpu with the Pallas kernels in interpret mode and the port's
kernels as their plain twins.

Each configuration is the committed file with profile_configs.py's
OVERRIDES (dataset.root, the weights, the save dir, the device) and these
test-only overrides, the same in both packages (`SMALL_REASONS`):"""

import copy
import os

import numpy as np
import pytest

import profile_configs as pc
from vings_mono_tpu.runners import evaluate as j_evaluate
from vings_mono_tpu.runners import run as j_run_mod
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu.utils.trajectory import tracker_c2ws as j_tracker_c2ws
from vings_mono_tpu_torch.runners import evaluate as t_evaluate
from vings_mono_tpu_torch.runners import run as t_run_mod
from vings_mono_tpu_torch.utils.config import load_config
from vings_mono_tpu_torch.utils.trajectory import tracker_c2ws

H, W = 40, 72            # 2.5 x 4.5 tiles: partial in both axes
SOURCE = (80, 144)       # the written frames, resized by the loader
ITERS = 2
SMALL_REASONS = [
    ("frontend.image_size", f"-> [{H}, {W}]", "a CPU run at a size that "
     "is a multiple of 8 and tile-partial in both axes"),
    ("the written frames", f"{SOURCE[0]}x{SOURCE[1]}, the config's "
     "intrinsics scaled", "the loader's resize still runs; full-size "
     "frames take seconds each to ray-cast"),
    ("frontend.filter_thresh, keyframe_thresh", f"x {W} / the committed "
     "width", "both gates read flow in feature pixels, and at 1/8 of "
     f"{W} px the same motion moves that much less"),
    ("frontend.bf16_gru", "-> false", "the packages' bf16 GRUs round "
     "apart (tests/test_torch_vo_slice.py's reason)"),
    ("mapper capacity, pair/visible capacity, points per frame, "
     "kf_capacity", "-> 8192, 8192, 4096, 400 / 600, 8", "CPU time"),
    ("training_args.iters", f"-> {ITERS}", "CPU time (JAX interprets the "
     "tile kernels)"),
    ("mapper.interpret (JAX only)", "-> true", "the Pallas kernels run "
     "interpreted on the CPU; the port reads no such key"),
    ("vis.map_size, vis.bev_size (the families with use_vis)",
     f"480x640, 320x320 -> [{H}, {W}]", "the map and BEV renders at the "
     "tracked size, which JAX has compiled for the keyframe panel and "
     "eval_psnr already: at their own sizes each is one more compile of the "
     "interpreted kernels (~5 s each of a family's ~100 s alone)"),
]
# poses: test_torch_runners.py test_run_tracking_as_jax's tolerance
POSE_FRAC = 0.1
# the first packaged window: what the loader and the bookkeeping make of
# the frames (the images where both depth gates kept the pixel, the
# timestamps, the global ids, the pixel mask, the intrinsics) to 1e-5.
# Its depths, covariances and poses are the trackers' after the warm-up's
# updates, and the trackers part: JAX scatters padded rows into edge slot
# 0 (ROADMAP §C) and the port does not, so through the runner the
# poses agree to POSE_FRAC of the path only, and the middleware's gates
# (depth > max_depth, covariance > cov_times x its median) may decide a
# pixel at its threshold apart: the zeroed pixels agree on GATE_SHARE of
# the window (F3, cov_times 5: 0.9983 measured)
GATE_SHARE = 0.99
VIZ_TOL = 1e-5
VIZ_KEYS = ("images", "depths", "viz_out_idx_to_f_idx", "global_kf_id",
            "pixel_mask")
# the map's PSNR (runners/evaluate.py eval_psnr: the keyframes rendered at
# their tracked poses) in test_torch_vo_slice.py's 3 dB band. A window's
# train PSNR is that of one randomly drawn slot after ITERS iterations,
# drawn from different generators in the two packages
PSNR_DB = 3.0


def small_overrides(family, extra=None):
    c = load_config(str(family.config))
    scale = W / float(c["frontend"]["image_size"][1])
    over = {
        "frontend": {"image_size": [H, W], "bf16_gru": False,
                     "filter_thresh": c["frontend"]["filter_thresh"] * scale,
                     "keyframe_thresh":
                         c["frontend"]["keyframe_thresh"] * scale},
        "mapper": {"capacity": 8192, "pair_capacity": 8192,
                   "visible_capacity": 4096, "points_per_frame": 400,
                   "points_first_frame": 600, "kf_capacity": 8},
        "training_args": {"iters": ITERS},
    }
    if c.get("use_vis"):
        over["vis"] = {"map_size": [H, W], "bev_size": [H, W]}
    if extra:
        for k, v in extra.items():
            over.setdefault(k, {}).update(v)
    return over


def run_both(key, tmp, n, extra=None, pace=None):
    """Both packages' run on one folder of n frames. Returns
    {"jax": ..., "torch": ...} of the keyframe timestamps and c2ws, the
    first mapped window's arrays, the train PSNR of every mapped window,
    the windows mapped, eval_psnr, the loop detector's attempt stages
    (None without a looper) and, with use_refine, the first refined
    window's poses before and after refinement (else None)."""
    fam = pc.FAMILIES[key]
    folder = tmp / "folder"
    over = pc.family_overrides(fam, folder, tmp / "torch", "cpu",
                               small_overrides(fam, extra))
    tcfg = load_config(str(fam.config), overrides=over)
    jover = copy.deepcopy(over)
    jover["mapper"]["interpret"] = True
    jover["output"]["save_dir"] = str(tmp / "jax")
    jcfg = j_load_config(str(fam.config), overrides=jover)
    pc.write_folder(fam, folder, n, tcfg, size=SOURCE, workers=2, pace=pace)
    out = {}
    for lib, mod, ev, cfg, at in (
            ("jax", j_run_mod, j_evaluate, jcfg, 3),
            ("torch", t_run_mod, t_evaluate, tcfg, 4)):
        got = {"viz": None, "psnr": [], "refined": None}
        build = mod.build

        def rec_build(*a, **k):
            built = build(*a, **k)
            got["looper"] = built[at]
            return built

        def on_frame(idx, tracker, mapper, viz_out, got=got):
            refined = getattr(mapper, "refined_poses", None)
            if viz_out is not None and refined is not None \
                    and got["refined"] is None:
                k = int(pc.host(viz_out["n_valid"]))
                got["refined"] = {"before": pc.host(viz_out["poses"])[:k],
                                  "after": pc.host(refined)[:k]}
            if viz_out is not None and mapper.time_idx > len(got["psnr"]):
                got["psnr"].append(float(mapper.last_metrics["psnr"]))
                if got["viz"] is None:
                    got["viz"] = {k: pc.host(viz_out[k]) for k in VIZ_KEYS}
                    got["viz"]["n_valid"] = int(pc.host(viz_out["n_valid"]))
                    got["viz"]["intrinsic"] = {
                        k: float(v) for k, v in viz_out["intrinsic"].items()}
        run_dir = tmp / lib / "run"
        os.makedirs(run_dir / "ply", exist_ok=True)
        mod.build = rec_build
        try:
            kw = {"device": "cpu"} if lib == "torch" else {}
            tracker, mapper, _ = mod.run(cfg, str(run_dir),
                                         on_frame=on_frame, **kw)
        finally:
            mod.build = build
        c2w_of = j_tracker_c2ws if lib == "jax" else tracker_c2ws
        ts, c2ws = c2w_of(tracker)
        looper = got.get("looper")
        out[lib] = {"ts": list(ts), "c2ws": np.asarray(c2ws),
                    "viz": got["viz"], "psnr": got["psnr"],
                    "windows": mapper.time_idx,
                    "eval_psnr": float(ev.eval_psnr(mapper, tracker)),
                    "loop": None if looper is None else
                    [t["stage"] for t in looper.detector.traces],
                    "refined": got["refined"]}
    return out


def assert_first_window_equal(runs):
    a, b = runs["jax"]["viz"], runs["torch"]["viz"]
    assert a is not None and b is not None
    assert a["n_valid"] == b["n_valid"]
    assert a["intrinsic"] == pytest.approx(b["intrinsic"], rel=VIZ_TOL)
    zero_a, zero_b = a["depths"] == 0, b["depths"] == 0
    assert np.mean(zero_a == zero_b) >= GATE_SHARE, np.mean(zero_a == zero_b)
    kept = ~(zero_a | zero_b)
    for k in VIZ_KEYS:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, (k, x.shape, y.shape)
        if k == "depths":
            continue
        if k == "images":
            x, y = x * kept, y * kept
        np.testing.assert_allclose(y.astype(np.float64),
                                   x.astype(np.float64), rtol=VIZ_TOL,
                                   atol=VIZ_TOL, err_msg=k)


def assert_poses_close(runs):
    from vings_mono_tpu_torch.utils.trajectory import ate_rmse
    j, t = runs["jax"], runs["torch"]
    extent = np.ptp(j["c2ws"][:, :3, 3], axis=0).max()
    rmse = ate_rmse(t["ts"], t["c2ws"], j["ts"], j["c2ws"],
                    scale_align=False)
    assert rmse <= POSE_FRAC * extent, (rmse, extent)


def assert_psnr_close(runs):
    j, t = runs["jax"]["eval_psnr"], runs["torch"]["eval_psnr"]
    assert np.isfinite(t) and abs(t - j) <= PSNR_DB, (t, j)
    assert len(runs["jax"]["psnr"]) == len(runs["torch"]["psnr"]) >= 2
