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


def global_ba_card_vs_cpu():
    """GlobalBA from the same snapshot of a tracked video on the card and
    on the CPU (f32 network, banded PCG): the same stats, poses within
    1e-3 (chip_smoke.py phase 9 holds the same at 240x432)."""
    import copy
    import types
    from vings_mono_tpu_torch.tracker.backend import GlobalBA
    from vings_mono_tpu_torch.tracker.video import DepthVideo
    tr, _ = tracked("cuda")
    c = dict(tr.cfg, backend={**tr.cfg["backend"], "steps": 2})
    v = tr.video
    ns, nl = v.count_save, v.counter
    cpu_video = DepthVideo(c, H, W, device="cpu")
    cpu_video.count_save, cpu_video.counter = ns, nl
    for k in ("poses", "disps", "images", "disps_up"):
        getattr(cpu_video, k + "_save")[:ns] = getattr(v, k + "_save")[:ns]
    for k in ("poses", "disps", "images", "disps_up", "intrinsics"):
        getattr(cpu_video.bufs, k).copy_(getattr(v.bufs, k).cpu())
    cpu = types.SimpleNamespace(video=cpu_video, cfg=c,
                                model=copy.deepcopy(tr.model).cpu())
    sa = GlobalBA(tr, c).run()
    sb = GlobalBA(cpu, c).run()
    assert sa == sb and not sa["skipped"]
    a = np.concatenate([v.poses_save[:ns], v.bufs.poses[:nl].cpu().numpy()])
    b = np.concatenate([cpu_video.poses_save[:ns],
                        cpu_video.bufs.poses[:nl].numpy()])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    assert np.isfinite(v.disps_up_save[:ns]).all()


def test_global_ba_on_the_card_follows_the_cpu_run(true_f32):
    need_cuda()
    global_ba_card_vs_cpu()


def test_global_ba_with_default_flags_follows_the_cpu_run():
    """The same with PyTorch's default flags (TF32 convolutions allowed),
    as a product run has them: GlobalBA clears TF32 for its f32 network
    itself."""
    need_cuda()
    assert torch.backends.cudnn.allow_tf32
    global_ba_card_vs_cpu()
    assert torch.backends.cudnn.allow_tf32


def test_loop_and_dynamic_nets_on_the_card_follow_the_cpu():
    """Self-trained SuperPoint, LightGlue and FastSAM with PyTorch's
    default flags: the card's heat and descriptors, match scores and raw
    maps within 1e-4 of the CPU's (each net runs in true f32 however it is
    called)."""
    import pathlib
    from vings_mono_tpu_torch.models.fastsam import load_fastsam, raw_maps
    from vings_mono_tpu_torch.models.lightglue import load_lightglue
    from vings_mono_tpu_torch.models.superpoint import load_superpoint
    need_cuda()
    assert torch.backends.cudnn.allow_tf32
    wdir = pathlib.Path(__file__).resolve().parents[1] / \
        "vings_mono_tpu/weights"
    rng = np.random.default_rng(0)
    gray = torch.rand(1, 120, 160, 1)
    rgb = rng.uniform(size=(96, 128, 3)).astype(np.float32)
    desc = torch.nn.functional.normalize(torch.randn(64, 256), dim=-1)
    kp = torch.rand(64, 2) * 2 - 1
    valid = torch.rand(64) > 0.1
    out = {}
    for dev in ("cuda", "cpu"):
        sp = load_superpoint(str(wdir / "superpoint_selftrained.npz"),
                             device=dev)
        lg = load_lightglue(str(wdir / "lightglue_selftrained.npz"),
                            device=dev)
        d, k, m = (x.to(dev) for x in (desc, kp, valid))
        with torch.no_grad():
            heat, dmap = sp(gray.to(dev))
            scores = lg(d, d.flip(0), k, k.flip(0), m, m.flip(0))[0]
        fs = raw_maps(load_fastsam(str(wdir / "fastsam_selftrained.npz"),
                                   device=dev), rgb)
        out[dev] = [x.cpu() for x in (heat, dmap, scores) + tuple(fs)]
    for a, b in zip(out["cuda"], out["cpu"]):
        live = b > -1e8
        assert torch.allclose(a[live], b[live], rtol=0, atol=1e-4)


def plane_windows(n_kf=3, h=H, w=W, f=80.0):
    """viz_out windows of a textured plane 3 m ahead seen by a camera moving
    along x; the top quarter is sky (depth 0, rgb 0, as the middleware
    marks it)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    imgs, deps, poses = [], [], []
    for k in range(n_kf):
        tx = 0.1 * k
        u = (xs - w / 2) / f * 3.0 + tx
        v = (ys - h / 2) / f * 3.0
        img = 0.5 + 0.3 * np.sin(7 * u) * np.cos(5 * v)
        rgb = np.stack([img, 0.8 * img, 1 - img], -1)
        dep = np.full((h, w, 1), 3.0)
        rgb[:h // 4] = 0.0
        dep[:h // 4] = 0.0
        c2w = np.eye(4)
        c2w[0, 3] = tx
        imgs.append(rgb)
        deps.append(dep)
        poses.append(c2w)
    full = {"images": np.asarray(imgs, np.float32),
            "depths": np.asarray(deps, np.float32),
            "depths_cov": np.full((n_kf, h, w, 1), 0.01, np.float32),
            "poses": np.asarray(poses, np.float32),
            "viz_out_idx_to_f_idx": np.arange(n_kf, dtype=np.float64),
            "intrinsic": {"fu": f, "fv": f, "cu": h / 2, "cv": w / 2,
                          "H": h, "W": w},
            "pixel_mask": np.ones((n_kf, h, w), bool),
            "global_kf_id": np.arange(n_kf, dtype=np.int64)}
    first = {k: (x[:2] if isinstance(x, np.ndarray) else x)
             for k, x in full.items()}
    return [first, full]


@pytest.mark.parametrize("option", ["sky", "refine", "coarse"])
def test_mapper_options_on_the_card_follow_the_cpu(option):
    """GaussianMapper with use_sky, use_refine or coarse_frac 0.5 on the
    card (both tile kernels) and on the CPU (their plain twins), the same
    draws: per keyframe, Gaussians within 1 %, loss within 1 %, PSNR within
    0.1 dB (the port-vs-JAX tolerances of tests/test_torch_slice.py)."""
    need_cuda()
    over = {"mapper": {"capacity": 4096, "pair_capacity": 4096,
                       "chunk": 64, "side": 3, "kf_capacity": 4,
                       "points_per_frame": 400, "points_first_frame": 400,
                       "visible_capacity": 2048, "sky_capacity": 512},
            "training_args": {"iters": 4, "num_keyframe": 8},
            "adc_args": {"accum_thresh": 0.98}}
    extra = {"sky": {"use_sky": True}, "refine": {"use_refine": True},
             "coarse": {"training_args": {**over["training_args"],
                                          "coarse_frac": 0.5}}}[option]
    c = load_config(overrides={**over, **extra})
    a, b = GaussianMapper(c, device="cuda"), GaussianMapper(c, device="cpu")
    for viz in plane_windows():
        a.run(viz)
        b.run(viz)
        ma, mb = a.last_metrics, b.last_metrics
        assert abs(a.n_alive - b.n_alive) <= 0.01 * b.n_alive
        assert abs(ma["total"] - mb["total"]) <= 0.01 * abs(mb["total"])
        assert abs(ma["psnr"] - mb["psnr"]) <= 0.1
    if option == "sky":
        assert int(a.sky.state.n_alive()) == int(b.sky.state.n_alive()) > 0
    if option == "refine":
        # refine_poses itself from one state and window on both: Adam's
        # steps are lr-sized whatever the gradient's size, so the two runs'
        # maps, a few keyframes apart, are not where the 1e-3 is held
        from vings_mono_tpu_torch.mapper import refine, train
        from vings_mono_tpu_torch.mapper.mapper import _intr4
        from vings_mono_tpu_torch.mapper.state import (STATE_FIELDS,
                                                       state_from_numpy)
        viz = plane_windows()[1]
        a.state = state_from_numpy(
            {f: getattr(b.state, f).numpy() for f in STATE_FIELDS}, "cuda")
        out = []
        for m in (a, b):
            batch = m._pack_batch(viz)
            intr4 = _intr4(viz["intrinsic"])
            binned = train.bin_stack(m.state, batch, intr4, H, W,
                                     **m.bin_kwargs)
            out.append(refine.refine_poses(
                m.state, batch, binned, intr4, iters=20, height=H, width=W,
                render_kwargs=m.render_kwargs)[0].cpu().numpy())
        np.testing.assert_allclose(out[0], out[1], atol=1e-3)
        assert np.isfinite(a.refined_poses.cpu().numpy()).all()
    if option == "coarse":
        assert a._binned_c is not None


def test_dpt_on_the_card_follows_the_cpu():
    """The self-trained metric-depth DPT with PyTorch's default flags, at
    240x432 (the antialiased resize to 128x160 and back): the card's depth
    within 1e-4 relative of the CPU's (true f32 however it is called)."""
    import pathlib
    from vings_mono_tpu_torch.models.dpt_depth import load_dpt
    need_cuda()
    assert torch.backends.cudnn.allow_tf32
    weights = pathlib.Path(__file__).resolve().parents[1] / \
        "vings_mono_tpu/weights/metric_depth_selftrained.npz"
    x = torch.rand(2, 240, 432, 3, generator=torch.Generator().manual_seed(0))
    out = {dev: load_dpt(str(weights), device=dev)[1](x.to(dev)).cpu()
           for dev in ("cuda", "cpu")}
    assert out["cuda"].shape == (2, 240, 432)
    rel = (out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()
    assert float(rel) < 1e-4


def test_session_round_trip_on_the_card_as_on_the_cpu(tmp_path, true_f32):
    """A session the card's tracker and mapper write loads into a fresh
    card tracker bit for bit (buffers, edge state, map; the rebuilt
    correlation pyramids to one bf16 step) and into a CPU
    tracker, which then tracks the next frames as the card's tracker does
    (poses within 1e-2, the card-vs-CPU tolerance above)."""
    from vings_mono_tpu_torch.utils.checkpoint import (load_session,
                                                       save_session)
    need_cuda()
    c = cfg(0.0)
    c["mapper"].update({"capacity": 4096, "pair_capacity": 4096,
                        "chunk": 64, "visible_capacity": 2048,
                        "points_per_frame": 256, "points_first_frame": 512})
    c["training_args"] = dict(c["training_args"], iters=4)
    stream = list(frames(20))
    tr = Tracker(c, H, W, device="cuda",
                 generator=torch.Generator().manual_seed(0))
    mp = GaussianMapper(c, device="cuda")
    for pkt in stream[:16]:
        tr.track(pkt)
        viz = middleware.judge_and_package(tr, c)
        if viz is not None:
            mp.run(viz)
    assert mp.initialized and tr.video.count_save > 0
    save_session(str(tmp_path), tr, mp)
    loaded = {}
    for dev in ("cuda", "cpu"):
        t2 = Tracker(c, H, W, device=dev,
                     generator=torch.Generator().manual_seed(0))
        m2 = GaussianMapper(c, device=dev)
        load_session(str(tmp_path), t2, m2)
        loaded[dev] = t2
        for f in tr.video.bufs.fields():
            assert torch.equal(getattr(t2.video.bufs, f).cpu(),
                               getattr(tr.video.bufs, f).cpu()), f
        for f in ("net", "inp", "target", "weight"):
            assert torch.equal(getattr(t2.graph.edges, f).cpu(),
                               getattr(tr.graph.edges, f).cpu()), f
        # the live slots' pyramids are rebuilt, in other batches than the
        # live graph built them: to one bf16 rounding step
        live = torch.from_numpy(tr.graph.slot)
        torch.testing.assert_close(
            t2.graph.edges.corr1[live.to(dev)].float().cpu(),
            tr.graph.edges.corr1[live.cuda()].float().cpu(),
            rtol=2.0 ** -7, atol=1e-6)
        assert torch.equal(m2.state.xyz.cpu(), mp.state.xyz.cpu())
    for pkt in stream[16:]:
        for t in (tr, loaded["cpu"]):
            t.track(pkt)
    n = tr.video.counter
    assert loaded["cpu"].video.counter == n
    np.testing.assert_allclose(loaded["cpu"].video.bufs.poses[:n].numpy(),
                               tr.video.bufs.poses[:n].cpu().numpy(),
                               atol=1e-2)
