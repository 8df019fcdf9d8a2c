"""Port parity for the VO tracker: the torch Tracker against the JAX one on
tests/test_tracker.py's 16-frame sequence at 64x96 with the same random
DroidNet parameters, f32 GRU (`bf16_gru: false`: the two CPU back ends
round bf16 convolutions differently and the tracker feeds its output back).

The tracker is a feedback loop, so it is compared at three depths: the host
bookkeeping as integers after every frame, one `graph.update` from a copied
state, and the buffers at the end of the sequence."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from test_tracker import H, W, frames, make_cfg as j_make_cfg
from vings_mono_tpu.tracker import frontend as jfrontend
from vings_mono_tpu.tracker.tracker import Tracker as JTracker
from vings_mono_tpu.tracker.video import empty_buffers as j_empty_buffers
from vings_mono_tpu_torch.tracker import frontend as tfrontend
from vings_mono_tpu_torch.tracker.tracker import Tracker
from vings_mono_tpu_torch.tracker.video import VideoBuffers, empty_buffers
from vings_mono_tpu_torch.utils.config import load_config

HOST_LISTS = ("ii", "jj", "age", "slot", "ii_inac", "jj_inac", "slot_inac",
              "ii_bad", "jj_bad")
BUF_FIELDS = [f for f in VideoBuffers.__dataclass_fields__]
EDGE_FIELDS = ("net", "inp", "target", "weight", "corr1", "corr2", "corr3",
               "corr4")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops at these sizes are small. With the default thread
    count every test worker spins a whole OpenMP team on each of them, and
    the workers (and the JAX runs beside them) starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfgs(**frontend):
    """The same configuration for both packages, f32 GRU unless asked."""
    jcfg = j_make_cfg()
    jcfg["frontend"].update({"bf16_gru": False, **frontend})
    tcfg = load_config(overrides={
        "mode": "vo", "frontend": copy.deepcopy(jcfg["frontend"])})
    return jcfg, tcfg


def flat_params(jtr):
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jtr.params).items()}


def both_trackers(params=None, **frontend):
    """Edge slot 0 is taken out of both free lists. The JAX update pads its
    slot list with zeros up to the store's capacity and scatters the padded
    rows too, so whatever edge lives in slot 0 has its GRU state, target
    and weight overwritten by a dead row on every update; the port indexes
    live slots only and has no such write. With slot 0 never handed out,
    the two run the same computation."""
    jcfg, tcfg = make_cfgs(**frontend)
    jtr = JTracker(jcfg, H, W, params=params)
    ttr = Tracker(tcfg, H, W, params=flat_params(jtr), device="cpu")
    jtr.graph.free_slots.remove(0)
    ttr.graph.free_slots.remove(0)
    return jtr, ttr


def host_state(tr):
    g, fe, v = tr.graph, tr.frontend, tr.video
    out = {k: np.asarray(getattr(g, k)).tolist() for k in HOST_LISTS}
    out.update(t0=fe.t0, t1=fe.t1, counter=v.counter,
               count_save=v.count_save, new_frame_added=fe.new_frame_added,
               free_slots=list(g.free_slots), free_inac=list(g.free_inac),
               tstamps=list(v.tstamps_host))
    return out


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, np.float32 if dtype is None else dtype))
    return t


def copy_state(jtr, ttr):
    """Carry a JAX tracker's whole state into a port tracker as numpy: the
    video buffers, both edge stores, the host edge lists and counters, the
    frontend's window and the motion filter's keyframe context."""
    for f in BUF_FIELDS:
        setattr(ttr.video.bufs, f, _t(getattr(jtr.video.bufs, f)))
    for f in EDGE_FIELDS:
        src = getattr(jtr.graph.edges, f)
        t = _t(jnp.asarray(src, jnp.float32))
        setattr(ttr.graph.edges, f,
                t.to(torch.bfloat16) if f.startswith("corr") else t)
    ttr.graph.inac.target = _t(jtr.graph.inac.target)
    ttr.graph.inac.weight = _t(jtr.graph.inac.weight)
    for k in HOST_LISTS:
        setattr(ttr.graph, k, np.array(getattr(jtr.graph, k), np.int64))
    ttr.graph.free_slots = list(jtr.graph.free_slots)
    ttr.graph.free_inac = list(jtr.graph.free_inac)
    ttr.graph._prox_prefetch = None
    v, jv = ttr.video, jtr.video
    v.counter, v.count_save = jv.counter, jv.count_save
    v.tstamps_host = list(jv.tstamps_host)
    for k in ("tstamp", "images", "poses", "disps", "disps_up",
              "depths_cov", "depths_cov_up"):
        getattr(v, f"_{k}_save")[:] = getattr(jv, f"{k}_save")
    fe, jfe = ttr.frontend, jtr.frontend
    for k in ("t0", "t1", "is_initialized", "count", "new_frame_added"):
        setattr(fe, k, getattr(jfe, k))
    fe._kf_dist_prefetch = None
    if jtr.filter.fmap is not None:
        ttr.filter.fmap = _t(jtr.filter.fmap)
        ttr.filter.net = _t(jtr.filter.net)
        ttr.filter.inp = _t(jtr.filter.inp)


def live(x, n):
    return np.asarray(x)[:n]


@pytest.fixture(scope="module")
def sequence():
    """Both trackers over the 16 frames, the host state after every frame;
    then one more `graph.update` in each from the JAX tracker's final
    state copied into a fresh port tracker."""
    jtr, ttr = both_trackers()
    rows = []
    for pkt in frames(16, np.random.default_rng(0)):
        jtr.track(pkt)
        ttr.track(dict(pkt))
        rows.append((host_state(jtr), host_state(ttr)))
    end = {f: np.asarray(getattr(jtr.video.bufs, f)) for f in BUF_FIELDS}
    saves = {k: np.array(getattr(jtr.video, f"{k}_save"))
             for k in ("tstamp", "images", "poses", "disps", "disps_up",
                       "depths_cov", "depths_cov_up")}

    fresh = Tracker(ttr.cfg, H, W, params=flat_params(jtr), device="cpu")
    copy_state(jtr, fresh)
    copied = host_state(fresh)
    jtr.graph._next_update_cov = True
    fresh.graph._next_update_cov = True
    jtr.graph.update(None, None, iters=2, use_inactive=True)
    fresh.graph.update(None, None, iters=2, use_inactive=True)
    return dict(jtr=jtr, ttr=ttr, rows=rows, end=end, saves=saves,
                fresh=fresh, copied=copied)


def test_host_bookkeeping_equal_after_every_frame(sequence):
    """Edge lists, ages, slots, inactive and bad lists, the free-slot
    queues, t0/t1, counter and count_save: equal as integers."""
    for k, (j, t) in enumerate(sequence["rows"]):
        assert j == t, (k, {key: (j[key], t[key]) for key in j
                            if j[key] != t[key]})
    last = sequence["rows"][-1][1]
    assert last["count_save"] > 0           # rollup_at: 14 fired
    assert len(last["ii"]) > 0 and len(last["ii_inac"]) > 0


def test_buffers_agree_at_the_end_of_the_sequence(sequence):
    """After 16 frames of feedback (24 + 17 updates with random weights,
    disparities up to ~9): poses within 1e-2, disparities within 5e-2. The
    JAX lookup interpolates the bf16 volumes in bf16 and the port in f32
    (see test_torch_corr), which a single update turns into ~3e-5 on poses
    and ~6e-4 on disparities; the loop feeds that back. Slots past
    `counter` are dead (the rolls wrap dropped frames into them), so
    [:counter + 1] only."""
    ttr, end = sequence["ttr"], sequence["end"]
    n = ttr.video.counter + 1
    for f, tol in (("poses", 1e-2), ("disps", 5e-2), ("disps_up", 5e-2),
                   ("damping", 1e-3), ("tstamp", 0), ("intrinsics", 1e-6),
                   ("images", 1e-6), ("fmaps", 1e-3), ("nets", 1e-3)):
        t = getattr(ttr.video.bufs, f).numpy()
        np.testing.assert_allclose(live(t, n - 1), live(end[f], n - 1),
                                   atol=tol, err_msg=f)
    # the seeded next slot
    np.testing.assert_allclose(ttr.video.bufs.poses[n - 1].numpy(),
                               end["poses"][n - 1], atol=1e-2)
    assert np.isfinite(ttr.video.bufs.poses.numpy()).all()


def test_rollup_spilled_the_same_keyframes(sequence):
    ttr, saves = sequence["ttr"], sequence["saves"]
    n = ttr.video.count_save
    assert n == 4
    np.testing.assert_array_equal(ttr.video.tstamp_save[:n],
                                  saves["tstamp"][:n])
    np.testing.assert_array_equal(ttr.video.images_save[:n],
                                  saves["images"][:n])
    for k in ("poses", "disps", "disps_up", "depths_cov", "depths_cov_up"):
        got = getattr(ttr.video, f"{k}_save")[:n]
        # covariances reach the 1e6 clamp: relative to the largest value
        scale = max(1.0, float(np.abs(saves[k][:n]).max()))
        np.testing.assert_allclose(got, saves[k][:n], atol=2e-2 * scale,
                                   err_msg=k)
    assert len(ttr.video.tstamps_host) == ttr.video.counter
    assert not ttr.video._pending_spills


def test_copied_state_is_the_jax_state(sequence):
    assert sequence["copied"] == sequence["rows"][-1][0]


def test_one_update_from_a_copied_state(sequence):
    """One GRU + 2 BA iterations + covariance from an identical state:
    poses, disparities, upsampled disparities and damping within 1e-3;
    the depth covariance (which divides by disp^4 and is clamped at 1e6)
    within 2 % of each value. The per-edge GRU outputs carry the JAX
    lookup's bf16 interpolation (up to 2e-2 of max |corr| on the GRU's
    input): flow targets within 1e-2 px, weights within 1e-2, the hidden
    state within 3e-2."""
    jtr, fresh = sequence["jtr"], sequence["fresh"]
    n = fresh.video.counter
    for f in ("poses", "disps", "disps_up", "damping"):
        j = live(getattr(jtr.video.bufs, f), n)
        t = live(getattr(fresh.video.bufs, f).numpy(), n)
        assert float(np.abs(t - j).max()) <= 1e-3, \
            (f, float(np.abs(t - j).max()))
    for f in ("depths_cov", "depths_cov_up"):
        j = live(getattr(jtr.video.bufs, f), n)
        t = live(getattr(fresh.video.bufs, f).numpy(), n)
        assert float((np.abs(t - j) / np.abs(j)).max()) <= 2e-2, f
        assert j.min() >= 1e-6 and j.max() <= 1e6 and j.std() > 0
    slots = fresh.graph.slot
    assert len(slots) > 0
    for f, tol in (("target", 1e-2), ("weight", 1e-2), ("net", 3e-2)):
        j = np.asarray(getattr(jtr.graph.edges, f))[slots]
        t = getattr(fresh.graph.edges, f).numpy()[slots]
        assert float(np.abs(t - j).max()) <= tol, \
            (f, float(np.abs(t - j).max()))
    # the update moved things: it is not comparing two no-ops
    assert float(np.abs(np.asarray(jtr.video.bufs.disps)[:n]
                        - sequence["end"]["disps"][:n]).max()) > 1e-4
    assert host_state(fresh)["age"] == host_state(jtr)["age"]


def test_one_bf16_update_from_a_copied_state(sequence):
    """The bf16 GRU on one update only (no feedback): bf16 keeps 8 bits and
    the two CPU back ends round their convolutions differently, so flow
    targets are held to 5e-2 px and disparities to 1e-2."""
    jtr = sequence["jtr"]
    jcfg, tcfg = make_cfgs(bf16_gru=True)
    tb = Tracker(tcfg, H, W, params=flat_params(jtr), device="cpu")
    assert tb.graph.update_module.delta2.weight.dtype == torch.bfloat16
    copy_state(jtr, tb)
    jtr.graph.bf16_gru = True
    try:
        jtr.graph.update(None, None, iters=2, use_inactive=True)
    finally:
        jtr.graph.bf16_gru = False
    tb.graph.update(None, None, iters=2, use_inactive=True)
    n = tb.video.counter
    slots = tb.graph.slot
    j = np.asarray(jtr.graph.edges.target)[slots]
    t = tb.graph.edges.target.numpy()[slots]
    assert float(np.abs(t - j).max()) <= 5e-2
    jd = live(jtr.video.bufs.disps, n)
    td = live(tb.video.bufs.disps.numpy(), n)
    assert float(np.abs(td - jd).max()) <= 1e-2
    assert tb.video.bufs.poses.dtype == torch.float32


def test_keyframe_removal_path():
    """keyframe_thresh 1e9: every post-warmup keyframe is removed again, by
    the same shifts in both packages."""
    jtr, ttr = both_trackers(keyframe_thresh=1e9)
    for pkt in frames(12, np.random.default_rng(1)):
        jtr.track(pkt)
        ttr.track(dict(pkt))
        assert host_state(jtr) == host_state(ttr)
    assert ttr.video.counter <= 10
    n = ttr.video.counter
    np.testing.assert_allclose(ttr.video.bufs.poses.numpy()[:n],
                               np.asarray(jtr.video.bufs.poses)[:n],
                               atol=1e-2)
    np.testing.assert_array_equal(ttr.video.bufs.images.numpy()[:n],
                                  np.asarray(jtr.video.bufs.images)[:n])


def test_keyframe_gate_takes_the_prefetched_distance():
    """keyframe_thresh 0.1 decides on the distance enqueued at the end of
    the previous frame: the same (stale) value in both packages, so the
    same decisions; and the prefetch is consumed in steady state."""
    jtr, ttr = both_trackers(keyframe_thresh=0.1)
    for pkt in frames(14, np.random.default_rng(2)):
        jtr.track(pkt)
        ttr.track(dict(pkt))
        assert host_state(jtr) == host_state(ttr)
    assert ttr.frontend._kf_dist_hits >= 3
    assert ttr.frontend._kf_dist_hits == jtr.frontend._kf_dist_hits
    assert np.isfinite(ttr.video.bufs.poses.numpy()).all()


def test_prefetched_proximity_matches_sync():
    """The end-of-frame proximity prefetch proposes exactly the edges the
    blocking query would (port only: both runs are the port's)."""
    _, tcfg = make_cfgs()
    gen = torch.Generator().manual_seed(0)
    tr_pre = Tracker(tcfg, H, W, device="cpu", generator=gen)
    tr_syn = Tracker(tcfg, H, W, params=tr_pre.model.state_dict(),
                     device="cpu")
    tr_syn.frontend._prefetch_proximity = lambda: None   # force sync path
    for pkt in frames(16, np.random.default_rng(0)):
        tr_pre.track(pkt)
        tr_syn.track(dict(pkt))
        for k in ("ii", "jj", "ii_inac"):
            np.testing.assert_array_equal(getattr(tr_pre.graph, k),
                                          getattr(tr_syn.graph, k))
    assert tr_pre.graph._prox_hits > 4
    assert tr_syn.graph._prox_hits == 0


@pytest.mark.parametrize("init", [0, 1])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_seed_next_matches(alpha, init):
    """The next slot's seed: pose by the damped constant-velocity model,
    disparity by the mean of the recent ones; abs tol 1e-6."""
    rng = np.random.default_rng(5)
    jb = j_empty_buffers(16, 48, 64)
    from vings_mono_tpu.ops import lie as jlie
    xi = (rng.normal(size=(4, 6)) * 0.1).astype(np.float32)
    poses = np.array(jb.poses)
    poses[:4] = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    disps = rng.uniform(0.5, 2, jb.disps.shape).astype(np.float32)
    jb = jb.replace(poses=jnp.asarray(poses), disps=jnp.asarray(disps))
    tb = empty_buffers(16, 48, 64)
    tb.poses, tb.disps = _t(poses), _t(disps)
    for t1 in (1, 4):
        jo = jfrontend._seed_next_kernel(
            jb, jnp.asarray([t1, init], np.int32), alpha)
        tfrontend._seed_next_kernel(tb, t1, bool(init), alpha)
        np.testing.assert_allclose(tb.poses.numpy(), np.asarray(jo.poses),
                                   atol=1e-6)
        np.testing.assert_allclose(tb.disps.numpy(), np.asarray(jo.disps),
                                   atol=1e-6)
        jb = jo
    if alpha > 0 and not init:
        assert float((tb.poses[4] - tb.poses[3]).abs().max()) > 1e-3


def test_uint8_frames_are_converted_on_the_device():
    _, tcfg = make_cfgs()
    tr = Tracker(tcfg, H, W, device="cpu")
    pkt = next(frames(1, None))
    u8 = (pkt["rgb"] * 255).round().astype(np.uint8)
    tr.track({**pkt, "rgb": u8})
    np.testing.assert_allclose(tr.video.bufs.images[0].numpy(),
                               u8.astype(np.float32) / 255.0, atol=1e-7)


def test_inertial_layer_and_monitor_raise():
    """The monitor is not ported and raises; the inertial layer is ported
    (tests/test_torch_vio.py): attaching one wires it into the graph."""
    _, tcfg = make_cfgs()
    tr = Tracker(tcfg, H, W, device="cpu")
    layer = object()
    tr.frontend.attach_inertial(layer)
    assert tr.frontend.inertial is layer and tr.graph.inertial is layer
    _, tcfg = make_cfgs(show_plot=True)
    with pytest.raises(NotImplementedError, match="show_plot"):
        Tracker(tcfg, H, W, device="cpu")


def test_filter_edges_and_reseed_targets(sequence):
    """filter_edges drops long-range edges whose mean weight collapsed;
    reseed_targets rewrites every stored target to the reprojection."""
    fresh = sequence["fresh"]
    g = copy.copy(fresh.graph)
    g.edges = copy.deepcopy(fresh.graph.edges)
    g.inac = copy.deepcopy(fresh.graph.inac)
    for k in HOST_LISTS:
        setattr(g, k, getattr(fresh.graph, k).copy())
    g.free_slots = list(fresh.graph.free_slots)
    long_range = np.abs(g.ii - g.jj) > 2
    assert long_range.any()
    k = int(np.where(long_range)[0][0])
    g.edges.weight[int(g.slot[k])] = 0.0
    pair = (int(g.ii[k]), int(g.jj[k]))
    n = len(g.ii)
    g.filter_edges()
    assert len(g.ii) < n and pair not in set(zip(g.ii.tolist(),
                                                 g.jj.tolist()))
    assert pair in set(zip(g.ii_bad.tolist(), g.jj_bad.tolist()))
    g.reseed_targets()
    want = fresh.video.reproject(g.ii, g.jj)
    torch.testing.assert_close(g.edges.target[torch.from_numpy(g.slot)],
                               want)
    wanti = fresh.video.reproject(g.ii_inac, g.jj_inac)
    torch.testing.assert_close(
        g.inac.target[torch.from_numpy(g.slot_inac)], wanti)
