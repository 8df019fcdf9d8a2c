"""eval_loop_e2e and eval_long_run whole, in both packages, at a tiny
size: the room configuration shrunk by a wrapper around each package's
`load_config` (48x64 frames, a 2^14-surfel map, 4 training iterations per
keyframe, JAX's rasterizer interpreted): eval_loop_e2e over 24 frames
with `--skip-baseline`, eval_long_run over 40 frames with its no-loop
lane. The output keys equal, the keyframe counts equal, each ATE within
ATE_FRAC of the ground-truth path's extent (the tolerance
tests/test_torch_runners.py holds `run_tracking`'s poses to) and each
PSNR within PSNR_DB. Slow; run with -s for the long run's numbers."""

import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("cv2")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.slow

HW = [48, 64]
N_FRAMES = 24
LONG_FRAMES = 40
ATE_FRAC = 0.1
# the map's PSNR: the packages draw their densification from different
# random streams, so the maps differ pixel by pixel
PSNR_DB = 1.0
LANE_SUMMARY = ("keyframes", "ate_online_m", "ate_after_global_ba_m",
                "psnr", "loops_closed", "evict_events", "pagein_events")
SMALL = {"frontend": {"image_size": HW},
         "training_args": {"iters": 4},
         "mapper": {"capacity": 1 << 14, "pair_capacity": 1 << 13,
                    "visible_capacity": 1 << 12, "points_per_frame": 300,
                    "points_first_frame": 1000,
                    # JAX's Pallas kernels run interpreted on the CPU (the
                    # port reads no such key)
                    "interpret": True}}


def shrunk(monkeypatch, module):
    load = module.load_config

    def small(path=None, overrides=None):
        cfg = load(path, overrides)
        for k, v in SMALL.items():
            cfg[k].update(v)
        return cfg
    monkeypatch.setattr(module, "load_config", small)


@pytest.fixture
def small_room(monkeypatch):
    import vings_mono_tpu.utils.config as jconfig
    import vings_mono_tpu.utils.profiling as prof
    import vings_mono_tpu_torch.utils.config as tconfig
    monkeypatch.setattr(prof, "enable_compile_cache", lambda *a: None)
    shrunk(monkeypatch, jconfig)
    shrunk(monkeypatch, tconfig)


def tolerance(revs, frames=N_FRAMES):
    from vings_mono_tpu_torch.datasets.synthetic3d import trajectory_c2w
    gt = np.stack([trajectory_c2w(k, frames, 4.0, revs)[:3, 3]
                   for k in range(frames)])
    return ATE_FRAC * float(np.ptp(gt, axis=0).max())


def assert_ate_close(t, j, tol):
    assert t is not None and j is not None
    assert np.isfinite(t) and abs(t - j) <= tol, (t, j, tol)


def test_eval_loop_e2e_as_jax(small_room):
    import scripts.eval_loop_e2e as jscript
    from vings_mono_tpu_torch.runners import eval_loop_e2e
    argv = ["--frames", str(N_FRAMES), "--skip-baseline", "--min-history",
            "4"]
    jout = jscript.main(argv)
    tout = eval_loop_e2e.main(argv + ["--device", "cpu"])
    assert sorted(tout) == sorted(jout)
    assert tout["keyframes"] == jout["keyframes"]
    assert tout["detect_attempts"] > 0 and jout["detect_attempts"] > 0
    assert tout["ate_no_loop_m"] is None
    assert_ate_close(tout["ate_rmse_m"], jout["ate_rmse_m"], tolerance(1.6))


def test_eval_long_run_as_jax(small_room):
    """Both lanes, the baseline included, over 40 frames: the bars of
    tests/test_eval_artifacts.py that the long run is held to come out
    alike in both packages."""
    import scripts.eval_long_run as jscript
    from vings_mono_tpu_torch.runners import eval_long_run
    argv = ["--frames", str(LONG_FRAMES)]
    jout = jscript.main(argv)
    tout = eval_long_run.main(argv + ["--device", "cpu"])
    assert sorted(tout) == sorted(jout) == ["frames", "full", "no_loop",
                                            "revs"]
    tol = tolerance(2.2, LONG_FRAMES)
    for lane in ("full", "no_loop"):
        t, j = tout[lane], jout[lane]
        print(lane, {k: (t.get(k), j.get(k)) for k in LANE_SUMMARY})
        assert sorted(t) == sorted(j)
        assert t["keyframes"] == j["keyframes"]
        assert_ate_close(t["ate_online_m"], j["ate_online_m"], tol)
        assert np.isfinite(t["psnr"])
        assert abs(t["psnr"] - j["psnr"]) <= PSNR_DB, (t["psnr"], j["psnr"])
    t, j = tout["full"], jout["full"]
    assert t["global_ba"]["frames"] == j["global_ba"]["frames"]
    assert_ate_close(t["ate_after_global_ba_m"], j["ate_after_global_ba_m"],
                     tol)
