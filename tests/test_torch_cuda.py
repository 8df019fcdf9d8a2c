"""Tests of the port that need an NVIDIA GPU. They import neither JAX nor
the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a CUDA device each test skips (decided inside the test)."""

import numpy as np
import pytest
import torch

from vings_mono_tpu_torch import middleware
from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
from vings_mono_tpu_torch.tracker.tracker import Tracker
from vings_mono_tpu_torch.utils.config import load_config

H, W = 64, 96
pytestmark = pytest.mark.cuda


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def cfg(keyframe_thresh):
    return load_config(overrides={
        "mode": "vo",
        "frontend": {
            "buffer": 24, "warm_up": 8, "filter_thresh": -1.0,
            "keyframe_thresh": keyframe_thresh,
            "frontend_thresh": 1e9,
            "frontend_window": 10, "frontend_radius": 2, "frontend_nms": 1,
            "max_factors": 24, "edge_capacity": 36, "inactive_capacity": 48,
            "ba_window": 12, "iters1": 1, "iters2": 1, "active_window": 10,
            "max_age": 8, "rollup_at": 14, "rollup_n": 4, "save_buffer": 64,
            "bf16_gru": False},
        "mapper": {"kf_capacity": 6},
        "middleware": {"max_depth": 2.0, "cov_times": 3.0}})


def frames(n):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for k in range(n):
        img = 0.5 + 0.5 * np.sin(0.11 * (xs + 3.5 * k)) * \
            np.cos(0.07 * (ys + 1.5 * k))
        rgb = np.stack([img, img * 0.8, img * 0.6], -1).astype(np.float32)
        yield {"timestamp": float(k), "rgb": rgb,
               "intrinsic": np.asarray([80.0, 80.0, W / 2, H / 2],
                                       np.float32)}


def tracked(device, keyframe_thresh=0.0, n=16):
    """A tracker after n frames and the last viz_out it packaged."""
    gen = torch.Generator().manual_seed(0)
    tr = Tracker(cfg(keyframe_thresh), H, W, device=device, generator=gen)
    viz = None
    for pkt in frames(n):
        tr.track(pkt)
        viz = middleware.judge_and_package(tr, tr.cfg) or viz
    return tr, viz


@pytest.fixture
def true_f32():
    """f32 convolutions in f32 on the card (no TF32), as on the CPU."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = prev


def test_tracker_on_the_card_follows_the_cpu_run(true_f32):
    """The same frames and weights on the card and on the CPU, f32: the
    same host bookkeeping, and the window within the feedback loop's f32
    spread (poses 1e-2, disparities 5e-2, as between the two packages)."""
    need_cuda()
    (a, _), (b, _) = tracked("cuda"), tracked("cpu")
    for k in ("ii", "jj", "age", "slot", "ii_inac", "jj_inac"):
        np.testing.assert_array_equal(getattr(a.graph, k),
                                      getattr(b.graph, k))
    assert a.video.counter == b.video.counter
    assert a.video.count_save == b.video.count_save > 0
    assert a.graph._prox_hits == b.graph._prox_hits > 4
    n = a.video.counter
    assert a.video.bufs.poses.is_cuda
    np.testing.assert_allclose(a.video.bufs.poses[:n].cpu().numpy(),
                               b.video.bufs.poses[:n].numpy(), atol=1e-2)
    np.testing.assert_allclose(a.video.bufs.disps[:n].cpu().numpy(),
                               b.video.bufs.disps[:n].numpy(), atol=5e-2)
    # the rollup's spill crossed to the host in the background and is whole
    m = a.video.count_save
    np.testing.assert_array_equal(a.video.images_save[:m],
                                  b.video.images_save[:m])
    np.testing.assert_allclose(a.video.poses_save[:m],
                               b.video.poses_save[:m], atol=1e-2)


def test_keyframe_gate_on_the_card_decides_as_on_the_cpu(true_f32):
    """keyframe_thresh 0.1: the gate reads the distance that was enqueued,
    with its copy to pinned memory, at the end of the previous frame."""
    need_cuda()
    (a, _), (b, _) = tracked("cuda", 0.1), tracked("cpu", 0.1)
    assert a.frontend._kf_dist_hits == b.frontend._kf_dist_hits >= 3
    assert a.video.counter == b.video.counter
    assert a.video.tstamps_host == b.video.tstamps_host
    np.testing.assert_array_equal(a.graph.ii, b.graph.ii)


def test_pack_batch_takes_cuda_tensors():
    """A viz_out of CUDA tensors reaches the mapper's KeyframeBatch on the
    card, equal to the same viz_out packed from host arrays."""
    need_cuda()
    tr, viz = tracked("cuda")
    assert viz is not None and viz["images"].is_cuda
    keys = ("images", "depths", "depths_cov", "poses", "pixel_mask",
            "global_kf_id")
    host = {k: (v.cpu().numpy() if k in keys else v)
            for k, v in viz.items()}
    a = GaussianMapper(tr.cfg, device="cuda")._pack_batch(viz)
    b = GaussianMapper(tr.cfg, device="cuda")._pack_batch(host)
    for f in ("images", "depths", "depths_cov", "w2cs", "global_kf_id",
              "pixel_mask"):
        assert getattr(a, f).is_cuda
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def vio_run(device, n=18):
    """tests/test_vio.py's VIO tracker (its configuration, wiggly IMU and
    pattern frames at 10 fps), random weights from seed 0."""
    from vings_mono_tpu_torch.tracker.imu import so3_exp
    from vings_mono_tpu_torch.tracker.vio import InertialFusion
    vcfg = load_config(overrides={"mode": "vio", "frontend": {
        **cfg(0.0)["frontend"], "rollup_at": 100, "vi_warmup": 10}})
    g = np.array([0.0, 0.0, -9.81])
    R, rows = np.eye(3), []
    for k in range(400):
        t = k / 100.0
        w = np.array([0.2 * np.sin(0.8 * t), 0.15, -0.1 * np.cos(0.5 * t)])
        a = np.array([1.5 * np.sin(2.0 * t), 1.0 * np.cos(2.0 * t),
                      0.3 * np.sin(1.0 * t)])
        rows.append(np.concatenate([[t], np.rad2deg(w), R.T @ (a - g)]))
        R = R @ so3_exp(w * 0.01)
    tr = Tracker(vcfg, H, W, device=device,
                 generator=torch.Generator().manual_seed(0))
    inertial = InertialFusion(tr.video, vcfg, np.asarray(rows), np.eye(4))
    tr.frontend.attach_inertial(inertial)
    for pkt in frames(n):
        tr.track({**pkt, "timestamp": pkt["timestamp"] / 10.0})
    return tr, inertial


def test_vio_tracker_on_the_card_follows_the_cpu_run(true_f32):
    """The VIO tracker on the card and on the CPU, both f32: the same VI-init
    frame, edge lists and inertial bookkeeping; poses, disparities and body
    states within 1e-3 (chip_smoke.py phase 8 reads ~1e-5)."""
    need_cuda()
    (a, ia), (b, ib) = vio_run("cuda"), vio_run("cpu")
    assert ia.vi_init_t1 == ib.vi_init_t1 >= 0
    assert a.video.imu_enabled and b.video.imu_enabled
    for k in ("ii", "jj", "age", "slot", "ii_inac", "jj_inac"):
        np.testing.assert_array_equal(getattr(a.graph, k),
                                      getattr(b.graph, k))
    assert (ia.last_t0, ia.last_t1) == (ib.last_t0, ib.last_t1)
    assert ia.stats["updates"] == ib.stats["updates"] > 0
    assert ia.stats["hessian_ms"] > 0 and ia.stats["pull_ms"] > 0
    n = a.video.counter
    for f in ("poses", "disps"):
        np.testing.assert_allclose(getattr(a.video.bufs, f)[:n].cpu().numpy(),
                                   getattr(b.video.bufs, f)[:n].numpy(),
                                   rtol=0, atol=1e-3, err_msg=f)
    for x, y in zip(ia.states, ib.states):
        for f in ("R", "p", "v", "b"):
            np.testing.assert_allclose(getattr(x, f), getattr(y, f),
                                       rtol=0, atol=1e-3, err_msg=f)
