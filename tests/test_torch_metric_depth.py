"""Port parity for the metric-depth prior: `models/dpt_depth.py` and
`models/metric_depth.py` against the JAX package's on the same numpy
inputs and the same flax parameters.

Tolerances: the DPT networks agree to 2e-5 in depth (f32 through up to six
ViT blocks, on depths of a few room units), at the checkpoint's own
128x160, at 240x432 (the antialiased downsample to 128x160 and back)
and at 64x96 (upsampled to 128x160 and back). The npz backend is exact
(the same files, the same nearest resize). The tracker pins `disps_sens`
to 1/depth within 1e-5 relative, as JAX's tests/test_aux.py holds its own.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vings_mono_tpu.models import dpt_depth as jdpt
from vings_mono_tpu.models.metric_depth import MetricDepth as JMetric
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch.datasets.base import get_dataset
from vings_mono_tpu_torch.models import dpt_depth as tdpt
from vings_mono_tpu_torch.models.metric_depth import MetricDepth
from vings_mono_tpu_torch.tracker.tracker import Tracker
from vings_mono_tpu_torch.utils.config import load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = str(ROOT / "vings_mono_tpu/weights/metric_depth_selftrained.npz")
TOL = 2e-5


@pytest.fixture(scope="module")
def selftrained():
    _, jp, jpred = jdpt.load_dpt(WEIGHTS)
    model, pred = tdpt.load_dpt(WEIGHTS, device="cpu")
    return jp, jpred, model, pred


def test_dpt_matches_flax_on_the_same_parameters():
    """A narrow random DPT (dim 96, depth 2, taps (0, 1)) from flax's own
    init, converted: the same depth maps on a batch of two 64x64 images."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = jdpt.DPTDepth(dim=96, depth=2, taps=(0, 1))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tdpt.DPTDepth(dim=96, depth=2, taps=(0, 1), grid=(4, 4))
    tm.load_state_dict(tdpt.dpt_state_dict(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 64) and (got >= 0).all()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("hw", [(240, 432), (64, 96), (128, 160)],
                         ids=["240x432", "64x96", "128x160"])
def test_load_dpt_predicts_as_jax(selftrained, hw):
    """The self-trained checkpoint (dim 192, depth 6, 6 heads of 32, hw
    128x160) through both packages' predict at three input sizes."""
    jp, jpred, model, pred = selftrained
    assert (model.dim, model.depth, model.taps) == (192, 6, (1, 3, 5))
    x = np.random.default_rng(1).uniform(0, 1, (1, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jpred(jp, jnp.asarray(x)))
    got = pred(torch.from_numpy(x)).numpy()
    assert got.shape == (1, *hw)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_metric_depth_flax_backend_as_jax(tmp_path):
    """MetricDepth's `flax` backend on a room view (the net's training
    stream): the same depth as JAX's, clipped to d_max, on the device."""
    cfg = {"metric": {"backend": "flax", "weights": WEIGHTS, "d_max": 5.0},
           "dataset": {"module": "synthetic3d", "n_frames": 4},
           "frontend": {"image_size": [64, 96]}}
    pkt = get_dataset(load_config(overrides=cfg))[2]
    want = JMetric(j_load_config(overrides=cfg)).predict(pkt["rgb"], None)
    got = MetricDepth(load_config(overrides=cfg), device="cpu").predict(
        pkt["rgb"], pkt["intrinsic"])
    assert isinstance(got, torch.Tensor) and got.shape == (64, 96)
    assert float(got.max()) <= 5.0 and float(got.min()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_npz_backend_resizes_then_runs_out(tmp_path):
    """Files in sorted order: an .npz whose first array has the frame's
    shape, an .npy of another shape (nearest resize), then None once the
    files run out; every depth clipped to d_max. As JAX's, exactly."""
    rng = np.random.default_rng(2)
    np.savez(tmp_path / "000000.npz", depth=rng.uniform(0, 120, (48, 64))
             .astype(np.float32), other=np.zeros(3))
    np.save(tmp_path / "000001.npy",
            rng.uniform(0, 50, (24, 40)).astype(np.float32))
    over = {"metric": {"backend": "npz", "root": str(tmp_path),
                       "d_max": 80.0}}
    jm = JMetric(j_load_config(overrides=over))
    tm = MetricDepth(load_config(overrides=over), device="cpu")
    rgb = np.zeros((48, 64, 3), np.float32)
    for k in range(3):
        want, got = jm.predict(rgb, None), tm.predict(rgb, None)
        if k == 2:
            assert want is None and got is None
            continue
        assert got.shape == (48, 64) and got.dtype == np.float32
        assert got.max() <= 80.0
        np.testing.assert_array_equal(got, want)


def test_metric_depth_pins_disps_sens():
    """data_packet['depth'] of 4.0 -> disps_sens 0.25 at every 1/8 pixel of
    the first keyframe (JAX's tests/test_aux.py
    test_metric_depth_feeds_disps_sens on the port's tracker)."""
    cfg = load_config(overrides={
        "frontend": {"buffer": 8, "save_buffer": 8, "filter_thresh": -1.0,
                     "image_size": [64, 96], "ba_window": 8}})
    tracker = Tracker(cfg, 64, 96, device="cpu")
    tracker.track({"timestamp": 0.0,
                   "rgb": np.zeros((64, 96, 3), np.float32),
                   "intrinsic": np.asarray([40.0, 40, 48, 32], np.float32),
                   "depth": np.full((64, 96), 4.0, np.float32)})
    np.testing.assert_allclose(tracker.video.bufs.disps_sens[0].numpy(),
                               0.25, rtol=1e-5)
