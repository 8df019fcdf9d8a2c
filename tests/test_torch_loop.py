"""Port parity for loop closure: `loop/rectify.py` (`rectify_poses`,
`_transform_gaussians`, `rectify_gaussians`, `rectify_tracker` with the
depth write-back, `retrain_gaussians`) and `loop/loop_model.py`
(`accept_candidate`, `find_candidates`, `_history`, `run`), against the
JAX package on the same numpy inputs, live, under JAX_PLATFORMS=cpu.

The state: twelve keyframes of the procedural room at 48x64 around a loop
(kf 11 comes back near kf 0), stored with a drift that grows along the
chain; eight in each package's save buffers and four in its live window;
a map of them trained by the JAX mapper and mirrored into the port
(`test_torch_dynamic.mirror_mapper`).

Tolerances: host f64 math (`rectify_poses`) within 1e-9; f32 transforms
within 1e-5; disparities from rendered depth within 1e-3 relative (the
rasterizer twins differ by ~1e-6, and depth = D / max(alpha, 1e-3)
amplifies that at faintly covered pixels); poses after a whole closure
(scipy's L-BFGS-B from histories that differ by f32 rounding) within
1e-4; the map after a retrain as tests/test_torch_mapper_options.py's
`train_on_window`: loss within 1 %, PSNR within 0.1 dB, positions within
1e-3."""

import copy
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dynamic import mapper_configs, mirror_mapper
from vings_mono_tpu.loop import loop_model as jloop
from vings_mono_tpu.loop import rectify as jrect
from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
from vings_mono_tpu.tracker.video import DepthVideo as JVideo
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch.datasets.synthetic3d import (render_room,
                                                       texture_params,
                                                       trajectory_c2w)
from vings_mono_tpu_torch.loop import loop_model as tloop
from vings_mono_tpu_torch.loop import rectify as trect
from vings_mono_tpu_torch.ops import lie
from vings_mono_tpu_torch.tracker.imu import so3_exp
from vings_mono_tpu_torch.tracker.video import DepthVideo
from vings_mono_tpu_torch.utils.config import load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
SP = ROOT / "vings_mono_tpu/weights/superpoint_selftrained.npz"
H, W = 48, 64
N_KF, N_SAVE = 12, 8
F = 0.9 * W
INTR = {"fu": F, "fv": F, "cu": H / 2, "cv": W / 2, "H": H, "W": W}
VIDEO_CFG = {"frontend": {"buffer": 8, "save_buffer": 16}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test worker: the lane runs several workers,
    and the JAX runs beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def drift(k):
    d = np.eye(4)
    d[:3, :3] = so3_exp(np.asarray([0.0, 0.012 * k, 0.004 * k]))
    d[:3, 3] = [0.035 * k, -0.01 * k, 0.02 * k]
    return d


@pytest.fixture(scope="module")
def room():
    """Images, true depths, true and drifted c2ws of the twelve keyframes,
    and a JAX mapper trained on them at the drifted poses."""
    tex = texture_params(0, sharpness=1.0)
    true = np.stack([trajectory_c2w(k, N_KF, revs=1.0) for k in range(N_KF)])
    drifted = np.stack([drift(k) @ true[k] for k in range(N_KF)])
    imgs, deps = zip(*(render_room(c, [F, F, W / 2, H / 2], H, W, tex=tex)
                       for c in true))
    imgs = np.asarray(imgs, np.float32)
    deps = np.asarray(deps, np.float32)
    jc, tc = mapper_configs()
    jm = JMapper(jc)
    for s in range(0, N_KF, 4):
        sl = slice(s, s + 4)
        jm.run({"images": imgs[sl], "depths": deps[sl, ..., None],
                "depths_cov": np.full((4, H, W, 1), 0.01, np.float32),
                "poses": drifted[sl].astype(np.float32),
                "viz_out_idx_to_f_idx": np.arange(s, s + 4, dtype=float),
                "intrinsic": INTR,
                "pixel_mask": np.ones((4, H, W), bool),
                "global_kf_id": np.arange(s, s + 4)})
    return dict(imgs=imgs, deps=deps, true=true, drifted=drifted, jm=jm,
                tc=tc)


def jax_mapper(room):
    """A copy of the room's JAX mapper that may train: the JAX train step
    donates its state's buffers, so each test trains its own arrays."""
    jm = copy.copy(room["jm"])
    jm.state, jm.opt = jax.tree_util.tree_map(jnp.copy, (jm.state, jm.opt))
    jm.invalidate_binning()
    return jm


class Graph:
    """The graph surface loop closure touches: the BA window and the
    target re-seed, counted."""

    def __init__(self, w_ba=8):
        self.w_ba = w_ba
        self.reseeds = 0

    def reseed_targets(self):
        self.reseeds += 1


def make_tracker(jax_side, room):
    """A tracker of either package holding the room: N_SAVE keyframes in
    the save buffers, the rest in the live window."""
    w2c = np.linalg.inv(room["drifted"])
    tq = lie.se3_from_matrix(t(w2c).float()).numpy()
    disp_up = 1.0 / room["deps"]
    disp = disp_up[:, 3::8, 3::8]
    if jax_side:
        video = JVideo(j_load_config(overrides=VIDEO_CFG), H, W)
    else:
        video = DepthVideo(load_config(overrides=VIDEO_CFG), H, W,
                           device="cpu")
    ns, nl = N_SAVE, N_KF - N_SAVE
    video.count_save = ns
    video.tstamp_save[:ns] = np.arange(ns)
    video.images_save[:ns] = room["imgs"][:ns]
    video.poses_save[:ns] = tq[:ns]
    video.disps_save[:ns] = disp[:ns]
    video.disps_up_save[:ns] = disp_up[:ns]
    video.depths_cov_up_save[:ns] = 0.01
    live = {"poses": tq[ns:], "disps": disp[ns:], "disps_up": disp_up[ns:],
            "images": room["imgs"][ns:]}
    if jax_side:
        video.bufs = video.bufs.replace(**{
            k: getattr(video.bufs, k).at[:nl].set(jnp.asarray(v))
            for k, v in live.items()})
    else:
        for k, v in live.items():
            getattr(video.bufs, k)[:nl] = t(v)
    video.counter = nl
    video.tstamps_host = [float(k) for k in range(ns, N_KF)]
    return types.SimpleNamespace(
        video=video, graph=Graph(),
        frontend=types.SimpleNamespace(t1=nl, _kf_dist_prefetch="stale"))


def live_rows(tracker, name):
    x = getattr(tracker.video.bufs, name)[:tracker.video.counter]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("span", [(0, 20), (5, 14), (3, 3)])
def test_rectify_poses_as_jax(span):
    """A chain with rotation and translation drift, a loop target with its
    own rotation: the same corrected trajectory within 1e-9 (the start,
    the chain and the rigidly carried frames after it; an empty chain
    returns a copy)."""
    n = 24
    c2ws = np.tile(np.eye(4), (n, 1, 1))
    for i in range(1, n):
        step = np.eye(4)
        step[:3, :3] = so3_exp(np.asarray([0.01, 0.05, -0.02]))
        step[:3, 3] = [1.0, 0.02, 0.1]
        c2ws[i] = c2ws[i - 1] @ step
    c2ws[:, 1, 3] += np.linspace(0, 1.5, n)
    a, b = span
    target = c2ws[b].copy()
    target[:3, :3] = target[:3, :3] @ so3_exp(np.asarray([0, 0.1, 0.03]))
    target[1, 3] -= 1.5
    got = trect.rectify_poses(c2ws, a, b, target)
    np.testing.assert_allclose(got, jrect.rectify_poses(c2ws, a, b, target),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got[:a + 1], c2ws[:a + 1])
    if b > a:
        np.testing.assert_allclose(got[b][:3, 3], target[:3, 3], atol=0.05)


def test_transform_gaussians_as_jax():
    """Gaussians attributed to four keyframes with their own corrections
    (ids past the last clamp to it): xyz and quat within 1e-5."""
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(64, 3)).astype(np.float32)
    quat = rng.normal(size=(64, 4)).astype(np.float32)
    gid = rng.integers(0, 6, 64).astype(np.int32)
    old = np.stack([np.eye(4)] * 4)
    new = old.copy()
    for k in range(4):
        old[k][:3, :3] = so3_exp(rng.normal(size=3) * 0.3)
        old[k][:3, 3] = rng.normal(size=3)
        new[k][:3, :3] = so3_exp(rng.normal(size=3) * 0.3)
        new[k][:3, 3] = rng.normal(size=3)
    old, new = old.astype(np.float32), new.astype(np.float32)
    jx, jq = jrect._transform_gaussians(jnp.asarray(xyz), jnp.asarray(quat),
                                        jnp.asarray(gid), jnp.asarray(old),
                                        jnp.asarray(new))
    tx, tq = trect._transform_gaussians(t(xyz), t(quat), t(gid), t(old),
                                        t(new))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=1e-5)


def test_rectify_gaussians_as_jax(room):
    """The same correction of the room's map in both packages: positions
    and rotations within 1e-5, the same rows pruned, both binning caches
    dropped."""
    jm = jax_mapper(room)
    tm = mirror_mapper(jm, room["tc"])
    tm._binned = tm._binned_c = object()      # caches to be dropped
    old = room["drifted"][:N_KF]
    new = room["true"][:N_KF]
    jn = jrect.rectify_gaussians(jm, old, new)
    jafter = jm.state
    tn = trect.rectify_gaussians(tm, old, new)
    assert tn == jn
    alive = np.asarray(jafter.alive)
    np.testing.assert_array_equal(tm.state.alive.numpy(), alive)
    assert alive.sum() > 300
    np.testing.assert_allclose(tm.state.xyz.numpy(), np.asarray(jafter.xyz),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.state.quat.numpy(),
                               np.asarray(jafter.quat), rtol=0, atol=1e-5)
    assert tm._binned is None and tm._binned_c is None


def test_rectify_tracker_with_writeback_as_jax(room):
    """Corrected poses over the save buffers and the live window, with the
    depth write-back over kfs 2..10 (save and live rows): the same poses
    within 1e-5, the same rewritten disparities within 1e-3 relative (they
    come from rendered depth), the same rows left alone, the graph re-seeded
    once and the keyframe-distance prefetch dropped."""
    jt, tt = make_tracker(True, room), make_tracker(False, room)
    new = room["true"]
    jrect.rectify_tracker(jt, new, mapper=room["jm"], intrinsic=INTR,
                          loop_start=2, loop_end=10)
    tm = mirror_mapper(room["jm"], room["tc"])
    trect.rectify_tracker(tt, new, mapper=tm, intrinsic=INTR, loop_start=2,
                          loop_end=10)
    jv, tv = jt.video, tt.video
    np.testing.assert_allclose(tv.poses_save[:N_SAVE],
                               jv.poses_save[:N_SAVE], rtol=0, atol=1e-5)
    for name in ("disps_up_save", "disps_save"):
        a, b = getattr(tv, name), getattr(jv, name)
        np.testing.assert_allclose(a[:11], b[:11], rtol=1e-3, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_array_equal(a[:2], b[:2])
    changed = ~np.isclose(tv.disps_up_save[2:11],
                          1.0 / room["deps"][2:11], rtol=1e-3)
    assert changed.mean() > 0.2
    for name in ("poses", "disps", "disps_up"):
        np.testing.assert_allclose(live_rows(tt, name), live_rows(jt, name),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    assert tt.graph.reseeds == jt.graph.reseeds == 1
    assert tt.frontend._kf_dist_prefetch is None


def test_retrain_gaussians_as_jax(room):
    """retrain_gaussians over the saved keyframes 1..7 (two windows) from
    the same map, key stream and save buffers: loss within 1 %, PSNR
    within 0.1 dB, positions within 1e-3."""
    jm = jax_mapper(room)
    tm = mirror_mapper(jm, room["tc"])
    jt, tt = make_tracker(True, room), make_tracker(False, room)
    jn = jrect.retrain_gaussians(jm, jt.video, INTR, 1, 9)
    jmet, jstate = jm.last_metrics, jm.state
    tn = trect.retrain_gaussians(tm, tt.video, INTR, 1, 9)
    assert tn == jn == N_SAVE - 1
    tmet = tm.last_metrics
    assert abs(tmet["total"] - jmet["total"]) <= 0.01 * abs(jmet["total"])
    assert abs(tmet["psnr"] - jmet["psnr"]) <= 0.1
    m = np.asarray(jstate.alive)
    np.testing.assert_array_equal(tm.state.alive.numpy(), m)
    np.testing.assert_allclose(tm.state.xyz.numpy()[m],
                               np.asarray(jstate.xyz)[m], atol=1e-3)
    assert trect.retrain_gaussians(tm, tt.video, INTR, 9, 12) == 0


def _policy(mod):
    lm = mod.LoopModel.__new__(mod.LoopModel)
    lm.min_history, lm.min_gap, lm.search_radius, lm.nms = 35, 20, 10.0, 5
    lm.closed_at = []
    return lm


def test_candidate_policy_as_jax():
    """accept_candidate over a grid of (cur, cand) with and without an
    earlier closure, and find_candidates on a circle that comes back to
    its start: the same answers."""
    jl, tl = _policy(jloop), _policy(tloop)
    for closed in ([], [45]):
        jl.closed_at, tl.closed_at = list(closed), list(closed)
        for cur in range(0, 80, 7):
            for cand in range(0, cur, 3):
                assert tl.accept_candidate(cur, cand) == \
                    jl.accept_candidate(cur, cand)
    n = 60
    c2ws = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        ang = 2 * np.pi * i / 50
        c2ws[i][:3, 3] = [10 * np.sin(ang), 10 * (1 - np.cos(ang)), 0]
    for closed in ([], [30]):
        jl.closed_at, tl.closed_at = list(closed), list(closed)
        for cur in (40, 50, 55, 59):
            assert tl.find_candidates(c2ws, cur) == \
                jl.find_candidates(c2ws, cur)
    jl.closed_at = tl.closed_at = []
    assert tl.find_candidates(c2ws, 50)[0] < 10


def test_history_as_jax(room):
    """_history over the save buffers and the live window: the same c2ws
    within 1e-5; the images the run reads are the clean buffers'."""
    jt, tt = make_tracker(True, room), make_tracker(False, room)
    jc2w, jimgs = jloop.LoopModel._history(None, jt)
    tc2w = tloop.LoopModel._history(tt)
    assert tc2w.shape == jc2w.shape == (N_KF, 4, 4)
    np.testing.assert_allclose(tc2w, jc2w, rtol=0, atol=1e-5)
    for g in (0, N_SAVE - 1, N_SAVE, N_KF - 1):
        np.testing.assert_array_equal(tloop.LoopModel._image(tt, g),
                                      jimgs[g])


def window(room, gids):
    gids = np.asarray(gids)
    return {"images": room["imgs"][gids],
            "depths": room["deps"][gids][..., None],
            "poses": room["drifted"][gids].astype(np.float32),
            "intrinsic": INTR, "global_kf_id": gids}


class StubDetector:
    """Returns kf 0's pose as the current frame's drifted frame sees it:
    the closure measures the true relative pose."""

    def __init__(self, room):
        self.room = room
        self.calls = []

    def detect(self, mapper, cur_img, cur_depth, cur_c2w, hist_img,
               hist_c2w_guess, intr, min_inliers=30):
        r = self.room
        self.calls.append(hist_c2w_guess)
        assert np.array_equal(cur_img, r["imgs"][N_KF - 1])
        return np.asarray(cur_c2w, np.float64) @ np.linalg.inv(
            r["true"][N_KF - 1]) @ r["true"][0]


def test_loop_model_run_closes_as_jax(room):
    """LoopModel.run with a manual candidate (11, 0) and a detector that
    measures the true relative pose, in both packages: the same trace
    (correction, gates), the bend over the save span and the rigid carry
    of the live window within 1e-4, the same map re-anchoring and a
    retrain; the closure moves the endpoint toward the truth."""
    cfg = {"looper": {"manual_candidates": [[N_KF - 1, 0]],
                      "retrain": True}}
    jm = jax_mapper(room)
    tm = mirror_mapper(jm, room["tc"])
    jt, tt = make_tracker(True, room), make_tracker(False, room)
    viz = window(room, [8, 9, 10, 11])
    jl = jloop.LoopModel(j_load_config(overrides=cfg),
                         detector=StubDetector(room))
    tl = tloop.LoopModel(load_config(overrides=cfg),
                         detector=StubDetector(room))
    assert jl.run(jm, jt, viz, 11)
    jxyz = np.asarray(jm.state.xyz)
    jalive = np.asarray(jm.state.alive)
    assert tl.run(tm, tt, viz, 11)
    assert tl.closed_at == jl.closed_at == [N_KF - 1]
    (jtr,), (ttr,) = jl.loop_traces, tl.loop_traces
    assert "rejected" not in ttr and ttr["cand_gid"] == 0
    for k in ("corr_t", "disp_t", "corr_rot_deg", "path_len", "corr_gate"):
        assert abs(ttr[k] - jtr[k]) <= 1e-4 * max(1.0, abs(jtr[k])), k
    jc, tc = (np.concatenate([v.video.poses_save[:N_SAVE],
                              live_rows(v, "poses")]) for v in (jt, tt))
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tt.video.poses_save[0],
                                  jt.video.poses_save[0])
    np.testing.assert_array_equal(tm.state.alive.numpy(), jalive)
    np.testing.assert_allclose(tm.state.xyz.numpy()[jalive], jxyz[jalive],
                               atol=1e-3)
    after = tloop.LoopModel._history(tt)
    err = [np.linalg.norm(c[N_KF - 1, :3, 3] - room["true"][N_KF - 1, :3, 3])
           for c in (room["drifted"], after)]
    assert err[1] < err[0], err


def test_loop_model_run_with_selftrained_superpoint_as_jax(room):
    """LoopModel.run end to end with the self-trained SuperPoint in both
    packages and manual candidates (11, 0) and (11, 1): the same
    attempts, each reaching the same stage with matches within 5 % and,
    past matching, PnP inliers within 10 %; the same decision."""
    pytest.importorskip("cv2")
    cfg = {"looper": {"superpoint_weights": str(SP),
                      "manual_candidates": [[N_KF - 1, 0], [N_KF - 1, 1]],
                      "min_inliers": 10, "retrain": False}}
    jm = jax_mapper(room)
    tm = mirror_mapper(jm, room["tc"])
    jt, tt = make_tracker(True, room), make_tracker(False, room)
    viz = window(room, [8, 9, 10, 11])
    jl = jloop.LoopModel(j_load_config(overrides=cfg))
    tl = tloop.LoopModel(load_config(overrides=cfg))
    jout = jl.run(jm, jt, viz, 11)
    tout = tl.run(tm, tt, viz, 11)
    assert tout == jout
    jtr, ttr = jl.detector.traces, tl.detector.traces
    assert len(ttr) == len(jtr) >= 1
    for a, b in zip(jtr, ttr):
        assert b["stage"] == a["stage"]
        assert abs(b["matches"] - a["matches"]) <= 0.05 * a["matches"] + 1
        if a["stage"] != "match":
            assert abs(b["pnp_inliers"] - a["pnp_inliers"]) <= \
                0.1 * a["pnp_inliers"] + 2
    assert jtr[0]["matches"] >= 40
    assert len(tl.loop_traces) == len(jl.loop_traces)
