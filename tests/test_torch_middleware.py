"""Port parity for the tracker -> mapper contract: `judge_and_package` (v3
and the nerfslam selection) from a JAX tracker state copied into the port,
the committed golden viz_out, `retrieve_to_tracker`, and the mapper's
`_pack_batch` taking a viz_out of tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_eval import _load_windows
from test_tracker import H, W, frames
from test_torch_tracker import both_trackers, copy_state, flat_params
from vings_mono_tpu import middleware as jmw
from vings_mono_tpu.ops import lie as jlie
from vings_mono_tpu_torch import middleware as tmw
from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
from vings_mono_tpu_torch.tracker.tracker import Tracker
from vings_mono_tpu_torch.tracker.video import empty_buffers
from vings_mono_tpu_torch.utils.config import load_config

TENSOR_KEYS = ("images", "depths", "depths_cov", "poses", "pixel_mask",
               "global_kf_id")
MW = {"max_depth": 2.0, "cov_times": 3.0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops at these sizes are small. With the default thread
    count every test worker spins a whole OpenMP team on each of them, and
    the workers (and the JAX runs beside them) starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packed_state():
    """A JAX tracker after 16 frames (one rollup: count_save 4) and a port
    tracker holding a copy of its state."""
    jtr, _ = both_trackers()
    for pkt in frames(16, np.random.default_rng(0)):
        jtr.track(pkt)
    assert jtr.frontend.new_frame_added and jtr.video.count_save == 4
    jtr.cfg["mapper"]["kf_capacity"] = 6
    jtr.cfg["middleware"] = dict(MW)
    tcfg = load_config(overrides={
        "mode": "vo", "frontend": dict(jtr.cfg["frontend"]),
        "mapper": {"kf_capacity": 6}, "middleware": dict(MW)})
    ttr = Tracker(tcfg, H, W, params=flat_params(jtr), device="cpu")
    copy_state(jtr, ttr)
    return jtr, ttr


def compare_viz_out(j, t):
    """Selection and ids equal, tensors within 1e-5 (relative to the
    largest magnitude for the covariances, which reach 1e6)."""
    assert j["n_valid"] == t["n_valid"]
    for k in ("valid_localkf_id", "global_kf_id_host",
              "viz_out_idx_to_f_idx"):
        np.testing.assert_array_equal(np.asarray(j[k]), np.asarray(t[k]), k)
    assert j["intrinsic"] == t["intrinsic"]
    np.testing.assert_array_equal(np.asarray(j["global_kf_id"]),
                                  t["global_kf_id"].numpy())
    assert t["global_kf_id"].dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j["pixel_mask"]),
                                  t["pixel_mask"].numpy())
    for k in ("images", "depths", "depths_cov", "poses"):
        a, b = np.asarray(j[k]), t[k].numpy()
        assert a.shape == b.shape, k
        scale = max(1.0, float(np.abs(a).max()))
        assert float(np.abs(a - b).max()) <= 1e-5 * scale, k


def test_v3_packaging_matches(packed_state):
    jtr, ttr = packed_state
    j = jmw.judge_and_package(jtr, jtr.cfg)
    t = tmw.judge_and_package(ttr, ttr.cfg)
    assert j is not None and t is not None
    assert 1 < t["n_valid"] <= 6
    # the gate zeroed some pixels and kept others, images along with depths
    z = (t["depths"] == 0)
    assert 0.01 < float(z.float().mean()) < 0.99
    assert float(t["images"][z.expand_as(t["images"])].abs().max()) == 0.0
    compare_viz_out(j, t)
    assert ttr.local_to_global_bias == jtr.local_to_global_bias == 4
    assert (t["global_kf_id_host"] == t["valid_localkf_id"][-1] + 4).any()


def test_nerfslam_packaging_matches(packed_state):
    jtr, ttr = packed_state
    jcfg = dict(jtr.cfg, mode="vo_nerfslam")
    tcfg = dict(ttr.cfg, mode="vo_nerfslam")
    j = jmw.judge_and_package(jtr, jcfg)
    t = tmw.judge_and_package(ttr, tcfg)
    compare_viz_out(j, t)
    # the newest frame is in: v3 leaves it out
    assert t["valid_localkf_id"][-1] == ttr.frontend.t1 - 1
    t2 = tmw.judge_and_package(
        ttr, dict(ttr.cfg, middleware=dict(MW, variant="nerfslam")))
    np.testing.assert_array_equal(t2["valid_localkf_id"],
                                  t["valid_localkf_id"])


def test_nothing_to_package(packed_state):
    _, ttr = packed_state
    ttr.frontend.new_frame_added = False
    try:
        assert tmw.judge_and_package(ttr, ttr.cfg) is None
        assert tmw.judge_and_package(
            ttr, dict(ttr.cfg, mode="vo_nerfslam")) is None
    finally:
        ttr.frontend.new_frame_added = True


@pytest.mark.parametrize("new_H", [None, 40])
def test_v0_kitti360_packaging_matches(packed_state, new_H):
    """The save-buffer + sky-crop packaging: the last keyframes the window
    rolled out, the bottom new_H rows, cu re-centred; the same selection,
    ids and intrinsics, arrays within 1e-5 (the covariances relative to
    their largest value)."""
    jtr, ttr = packed_state
    intr = {"fu": 80.0, "fv": 80.0, "cu": 32.0, "cv": 48.0, "H": 64,
            "W": 96}
    if new_H is not None:
        intr["new_H"] = new_H
    jcfg = dict(jtr.cfg, intrinsic=intr,
                middleware=dict(MW, variant="v0_kitti360"))
    tcfg = dict(ttr.cfg, intrinsic=intr,
                middleware=dict(MW, variant="v0_kitti360"))
    j = jmw.judge_and_package(jtr, jcfg)
    t = tmw.judge_and_package(ttr, tcfg)
    assert t["n_valid"] == j["n_valid"] == 4
    np.testing.assert_array_equal(t["valid_localkf_id"], [0, 1, 2, 3])
    for k in ("valid_localkf_id", "global_kf_id", "viz_out_idx_to_f_idx",
              "pixel_mask"):
        np.testing.assert_array_equal(t[k], np.asarray(j[k]), k)
    np.testing.assert_array_equal(t["global_kf_id_host"],
                                  np.asarray(j["global_kf_id"]))
    assert t["intrinsic"] == j["intrinsic"]
    h = 40 if new_H else 64
    assert t["images"].shape == (6, h, W, 3) and t["intrinsic"]["H"] == h
    assert t["intrinsic"]["cu"] == h / 2
    for k in ("images", "depths", "depths_cov", "poses"):
        a, b = np.asarray(j[k]), np.asarray(t[k])
        assert a.shape == b.shape, k
        scale = max(1.0, float(np.abs(a).max()))
        assert float(np.abs(a - b).max()) <= 1e-5 * scale, k
    ttr.frontend.new_frame_added = False
    try:
        assert tmw.judge_and_package(ttr, tcfg) is None
    finally:
        ttr.frontend.new_frame_added = True


@pytest.mark.parametrize("n", [6, 7])
def test_median_averages_the_middle_pair(n):
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    np.testing.assert_allclose(tmw._median(torch.from_numpy(x)).numpy(),
                               np.median(x, axis=1), rtol=1e-6)
    np.testing.assert_allclose(tmw._median(torch.from_numpy(x)).numpy(),
                               np.asarray(jnp.median(jnp.asarray(x), axis=1)),
                               rtol=1e-6)


@pytest.mark.parametrize("w", [0, 1])
def test_package_kernel_rebuilds_the_golden_window(w):
    """tests/fixtures/viz_out_golden.npz holds packaged windows; their
    inputs can be rebuilt (disps_up = 1/depth, the covariances, images and
    poses as they are), and packaging them again gives the window back:
    gated pixels stay zero in depth and image and take the largest kept
    covariance."""
    win = _load_windows()[w]
    K, Hh, Ww = win["images"].shape[:3]
    bufs = empty_buffers(K, Hh, Ww)
    d = win["depths"][..., 0]
    bufs.images = torch.from_numpy(win["images"].copy())
    bufs.disps_up = torch.from_numpy(
        np.where(d > 0, 1.0 / np.maximum(d, 1e-9) - 1e-6, 0.0)
        .astype(np.float32))
    bufs.depths_cov_up = torch.from_numpy(win["depths_cov"][..., 0].copy())
    w2c = np.linalg.inv(win["poses"]).astype(np.float32)
    bufs.poses = torch.from_numpy(np.array(
        jlie.se3_from_matrix(jnp.asarray(w2c))))
    rgbs, depths, covs, c2ws = tmw._package_kernel(
        bufs, torch.arange(K), k_cap=K, max_depth=1e5, cov_times=1e12)
    np.testing.assert_allclose(depths.numpy(), win["depths"], rtol=1e-4)
    np.testing.assert_array_equal(rgbs.numpy(), win["images"])
    np.testing.assert_allclose(c2ws.numpy(), win["poses"], atol=1e-5)
    kept = win["depths"] > 0
    np.testing.assert_array_equal(covs.numpy()[kept],
                                  win["depths_cov"][kept])
    if (~kept).any():
        assert np.all(covs.numpy()[~kept] == win["depths_cov"][kept].max())


def test_retrieve_to_tracker_matches(packed_state):
    jtr, ttr = packed_state
    t = tmw.judge_and_package(ttr, ttr.cfg)
    j = jmw.judge_and_package(jtr, jtr.cfg)
    rng = np.random.default_rng(3)
    new = np.asarray(j["poses"]).copy()
    new[:, :3, 3] += rng.normal(size=(new.shape[0], 3)).astype(np.float32)
    before = ttr.video.bufs.poses.clone()
    jbefore = jtr.video.bufs
    try:
        jmw.retrieve_to_tracker(j, jnp.asarray(new), jtr)
        tmw.retrieve_to_tracker(t, torch.from_numpy(new), ttr)
        np.testing.assert_allclose(ttr.video.bufs.poses.numpy(),
                                   np.asarray(jtr.video.bufs.poses),
                                   atol=1e-5)
        sel = t["valid_localkf_id"]
        assert float((ttr.video.bufs.poses[sel] - before[sel]).abs()
                     .max()) > 0.1
    finally:
        ttr.video.bufs.poses = before
        jtr.video.bufs = jbefore


def test_pack_batch_takes_tensors_as_it_takes_numpy(packed_state):
    """The mapper packs a viz_out of torch tensors (as the port's
    middleware hands it over) into the same KeyframeBatch, bit for bit, as
    the same viz_out in numpy; a tensor is not sent through numpy."""
    _, ttr = packed_state
    viz = tmw.judge_and_package(ttr, ttr.cfg)
    as_numpy = {k: (v.numpy().copy() if k in TENSOR_KEYS else v)
                for k, v in viz.items()}
    cfg = load_config(overrides={"mapper": {"kf_capacity": 6}})
    a = GaussianMapper(cfg, device="cpu")._pack_batch(viz)
    b = GaussianMapper(cfg, device="cpu")._pack_batch(as_numpy)
    for f in ("images", "depths", "depths_cov", "w2cs", "global_kf_id",
              "pixel_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f
    assert a.n_valid == b.n_valid == viz["n_valid"]
    # a window larger than the mapper's capacity is cropped the same way
    small = load_config(overrides={"mapper": {"kf_capacity": 3}})
    a = GaussianMapper(small, device="cpu")._pack_batch(viz)
    b = GaussianMapper(small, device="cpu")._pack_batch(as_numpy)
    assert a.images.shape[0] == 3 and torch.equal(a.images, b.images)
    assert torch.equal(a.w2cs, b.w2cs)

    m = GaussianMapper(cfg, device="cpu")

    class NoNumpy(torch.Tensor):
        def __array__(self, *a, **k):
            raise AssertionError("a tensor went through numpy")

    x = torch.ones((2, 3)).as_subclass(NoNumpy)
    assert m._tensor(x, torch.float32).shape == (2, 3)
    assert m._tensor(x, torch.int32).dtype == torch.int32
