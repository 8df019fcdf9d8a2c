"""The tracking-only evaluations in both packages at 32x48 over 12 frames
of the synthetic3d room with the self-trained DroidNet: eval_droid's
`tracking_ate` on the same overrides, and eval_track_long's main with one
grid combo (its configuration shrunk to 32x48 by a wrapper around each
package's `load_config`). Keyframe counts equal; the ATEs within
ATE_FRAC of the ground-truth path's extent (the tolerance
tests/test_torch_runners.py holds `run_tracking`'s poses to). Slow: the
trained lane at eval_droid's own inputs, with both GRU precisions."""

import copy
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WEIGHTS = str(ROOT / "vings_mono_tpu/weights/droid_selftrained.npz")
HW = [32, 48]
N_FRAMES = 12
ATE_FRAC = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test worker: the lane runs several workers,
    and the JAX runs beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_compile_cache(monkeypatch):
    import vings_mono_tpu.utils.profiling as prof
    monkeypatch.setattr(prof, "enable_compile_cache", lambda *a: None)


def extent(cfg):
    from vings_mono_tpu_torch.datasets.synthetic3d import get_dataset
    gt = np.asarray(get_dataset(cfg).load_gt_dict()["c2ws"])[:, :3, 3]
    return float(np.ptp(gt, axis=0).max())


def test_tracking_ate_as_jax(tmp_path, no_compile_cache):
    import scripts.eval_droid as jscript
    from vings_mono_tpu_torch.runners import eval_common, eval_droid
    ov = {"frontend": {"filter_thresh": -1.0, "weight": WEIGHTS,
                       "image_size": HW},
          "dataset": {"n_frames": N_FRAMES}}
    for d in ("jax", "port"):
        (tmp_path / d / "ply").mkdir(parents=True)
    jate, jkf = jscript.tracking_ate(copy.deepcopy(ov),
                                     str(tmp_path / "jax"), N_FRAMES)
    tate, tkf = eval_droid.tracking_ate(copy.deepcopy(ov),
                                        str(tmp_path / "port"), N_FRAMES,
                                        device="cpu")
    assert tkf == jkf == N_FRAMES
    tol = ATE_FRAC * extent(eval_common.default_cfg(copy.deepcopy(ov)))
    assert np.isfinite(tate) and abs(tate - jate) <= tol, (tate, jate, tol)


def shrunk(monkeypatch, module):
    load = module.load_config

    def small(path=None, overrides=None):
        cfg = load(path, overrides)
        cfg["frontend"]["image_size"] = list(HW)
        return cfg
    monkeypatch.setattr(module, "load_config", small)


def test_eval_track_long_one_combo_as_jax(monkeypatch, no_compile_cache):
    import scripts.eval_track_long as jscript
    import vings_mono_tpu.utils.config as jconfig
    import vings_mono_tpu_torch.utils.config as tconfig
    from vings_mono_tpu_torch.runners import eval_track_long
    shrunk(monkeypatch, jconfig)
    shrunk(monkeypatch, tconfig)
    argv = ["--frames", str(N_FRAMES), "--grid", "2x1",
            "--weights", WEIGHTS]
    jout = jscript.main(argv)
    tout = eval_track_long.main(argv + ["--device", "cpu"])
    assert sorted(tout) == sorted(jout) == ["2x1", "frames", "revs"]
    assert (tout["frames"], tout["revs"]) == (jout["frames"], jout["revs"])
    tol = ATE_FRAC * extent(eval_track_long.config(
        eval_track_long.parse_args(argv), 2, 1))
    t, j = tout["2x1"]["ate_rmse_m"], jout["2x1"]["ate_rmse_m"]
    assert np.isfinite(t) and abs(t - j) <= tol, (t, j, tol)


@pytest.fixture
def slot0_reserved(monkeypatch):
    """Edge slot 0 out of both trackers' free lists, as
    tests/test_torch_tracker.py's `both_trackers` takes it: JAX's graph
    update scatters its padding rows into slot 0, the port's does not."""
    import vings_mono_tpu.tracker.tracker as jtracker
    import vings_mono_tpu_torch.tracker.tracker as ttracker
    for mod in (jtracker, ttracker):
        init = mod.Tracker.__init__

        def reserved(self, *a, _init=init, **kw):
            _init(self, *a, **kw)
            self.graph.free_slots.remove(0)
        monkeypatch.setattr(mod.Tracker, "__init__", reserved)


@pytest.mark.slow
@pytest.mark.parametrize("bf16_gru, reserve_slot0", [
    (True, False), (False, False), (True, True), (False, True)])
def test_tracking_ate_at_the_scripts_inputs(tmp_path, no_compile_cache,
                                            request, bf16_gru,
                                            reserve_slot0):
    """eval_droid's trained lane at the script's own inputs (120x160, 40
    frames, every frame a keyframe): keyframe counts equal, the ATEs
    within ATE_FRAC of the path's extent. Run with -s for both ATEs: as
    the scripts run them they part by more than at 32x48; with slot 0
    reserved in both and the f32 GRU they come close (ROADMAP §C)."""
    import scripts.eval_droid as jscript
    from vings_mono_tpu_torch.runners import eval_common, eval_droid
    if reserve_slot0:
        request.getfixturevalue("slot0_reserved")
    ov = {"frontend": {"filter_thresh": -1.0, "weight": WEIGHTS,
                       "bf16_gru": bf16_gru}}
    for d in ("jax", "port"):
        (tmp_path / d / "ply").mkdir(parents=True)
    jate, jkf = jscript.tracking_ate(copy.deepcopy(ov),
                                     str(tmp_path / "jax"), 40)
    tate, tkf = eval_droid.tracking_ate(copy.deepcopy(ov),
                                        str(tmp_path / "port"), 40,
                                        device="cpu")
    tol = ATE_FRAC * extent(eval_common.default_cfg(copy.deepcopy(ov)))
    print(f"bf16_gru {bf16_gru}, slot 0 reserved {reserve_slot0}: ATE "
          f"port {tate} jax {jate}, keyframes {tkf} / {jkf}, tolerance "
          f"{tol}")
    assert tkf == jkf == 40
    assert np.isfinite(tate) and abs(tate - jate) <= tol, (tate, jate, tol)
