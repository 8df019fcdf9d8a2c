"""eval_superpoint's main in both packages at 2 pairs of 96x128: the port's
(vings_mono_tpu_torch/runners/eval_superpoint.py) against the JAX
package's scripts/eval_superpoint.py. The random control's weights are
JAX's (its PRNGKey(0) init, written to an .npz in the flat flax layout
`load_superpoint` reads), so both packages hold the same random net.
Per pair and net: the match count within MATCH_REL, the recovered
position within POS_ATOL room units; the summary's PnP successes and
verdict equal."""

import pathlib
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

ARGV = ["--pairs", "2", "--hw", "96", "128"]
# mutual-NN matches over ~250 keypoints: descriptors that differ in the
# last bits can flip a few borderline mutual pairs; the RANSAC pose is
# refined by LM on the inliers, so a few changed matches move it by
# millimetres of the ~0.5-unit baseline
MATCH_REL = 0.05
POS_ATOL = 0.02


def jax_random_npz(path):
    from flax.traverse_util import flatten_dict
    from vings_mono_tpu.models.superpoint import load_superpoint
    _, params = load_superpoint(None)
    np.savez(path, **{"/".join(k): np.asarray(v, np.float32)
                      for k, v in flatten_dict(params).items()})
    return str(path)


def recording(monkeypatch, cls, log):
    """Record every match's count and every PnP pose of `cls`."""
    match, pnp = cls.match, cls.pnp_history_pose

    def rec_match(self, *a, **kw):
        kp_a, kp_b = match(self, *a, **kw)
        log.append(("match", len(kp_a)))
        return kp_a, kp_b

    def rec_pnp(self, *a, **kw):
        c2w = pnp(self, *a, **kw)
        log.append(("pnp", None if c2w is None else np.asarray(c2w)))
        return c2w
    monkeypatch.setattr(cls, "match", rec_match)
    monkeypatch.setattr(cls, "pnp_history_pose", rec_pnp)


def test_eval_superpoint_main_as_jax(tmp_path, monkeypatch):
    import scripts.eval_superpoint as jscript
    import vings_mono_tpu.loop.detect as jdetect
    import vings_mono_tpu.utils.profiling as prof
    import vings_mono_tpu_torch.loop.detect as tdetect
    from vings_mono_tpu_torch.runners import eval_superpoint

    npz = jax_random_npz(tmp_path / "superpoint_random_jax.npz")

    class JaxRandom(tdetect.LoopDetector):
        def __init__(self, cfg, sp_params_path=None, **kw):
            super().__init__(cfg, sp_params_path or npz, **kw)

    monkeypatch.setattr(prof, "enable_compile_cache", lambda *a: None)
    jlog, tlog = [], []
    recording(monkeypatch, jdetect.LoopDetector, jlog)
    recording(monkeypatch, tdetect.LoopDetector, tlog)
    monkeypatch.setattr(tdetect, "LoopDetector", JaxRandom)
    cv2.setRNGSeed(0)
    jout = jscript.main(ARGV)
    cv2.setRNGSeed(0)
    tout = eval_superpoint.main(ARGV + ["--device", "cpu"])

    assert [k for k, _ in tlog] == [k for k, _ in jlog]
    assert len(tlog) == 2 * 2 * 2          # pairs x nets x (match, pnp)
    for (kind, t), (_, j) in zip(tlog, jlog):
        if kind == "match":
            assert abs(t - j) <= MATCH_REL * j, (t, j)
        else:
            assert (t is None) == (j is None)
            if j is not None:
                np.testing.assert_allclose(t[:3, 3], j[:3, 3], rtol=0,
                                           atol=POS_ATOL)
    assert sorted(tout) == sorted(jout)
    for net in ("trained", "random"):
        assert sorted(tout[net]) == sorted(jout[net])
        assert tout[net]["pnp_success"] == jout[net]["pnp_success"]
        assert tout[net]["mean_matches"] == pytest.approx(
            jout[net]["mean_matches"], rel=MATCH_REL)
    assert tout["pairs"] == jout["pairs"] == 2
    assert tout["trained_beats_random"] == jout["trained_beats_random"]
