"""Port parity for the inertial fusion layer (tracker/vio.py) and its wiring
into the tracker: the JAX package's InertialFusion and the port's on the
same seeded inputs.

  * conjugate_vision_hessian: the adjoint of T_cb is built in float32 by
    each package's ops.lie and widened to float64, so the conjugated
    Hessian is held to 1e-6 of its largest entry (identity T_bc: exact);
  * ba_hessian / ba_retract at the shapes the VIO update gives them
    (fixedp=0, the full 12-frame window), on the inputs the JAX tracker
    handed its first multi-sensor update: 1e-4 of the largest magnitude,
    as tests/test_torch_ba.py holds the dense BA;
  * visual_imu_alignment on ground-truth poses, GNSS alignment, the ZUPT
    gate and the loose parameters on an IMU gap (mirroring
    tests/test_vio.py): 1e-9 on states (float64 host math from float32
    poses that are bit-equal in both);
  * the tracker with an inertial layer attached on tests/test_vio.py's
    18-frame sequence (64x96, its IMU, f32 GRU, random weights, slot 0
    reserved in both): the host bookkeeping of graph, frontend and
    inertial layer equal after every frame, including the VI-init frame.
    States, poses and disparities within the tolerances of
    `test_states_poses_and_disparities_at_the_end`.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tracker import flat_params, host_state
from test_vio import FPS, H, W, frames, make_cfg, synth_imu
from vings_mono_tpu.ops import ba as jba
from vings_mono_tpu.ops import lie as jlie
from vings_mono_tpu.tracker import factor_graph as jfg
from vings_mono_tpu.tracker.tracker import Tracker as JTracker
from vings_mono_tpu.tracker.vio import InertialFusion as JInertial
from vings_mono_tpu.utils import geodesy as jgeo
from vings_mono_tpu_torch.ops import ba as tba
from vings_mono_tpu_torch.tracker import factor_graph as tfg
from vings_mono_tpu_torch.tracker.imu import Preintegration
from vings_mono_tpu_torch.tracker.tracker import Tracker
from vings_mono_tpu_torch.tracker.video import empty_buffers
from vings_mono_tpu_torch.tracker.vio import InertialFusion
from vings_mono_tpu_torch.utils import geodesy as tgeo
from vings_mono_tpu_torch.utils.config import load_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops at these sizes are small. With the default thread
    count every test worker spins a whole OpenMP team on each of them, and
    the workers (and the JAX runs beside them) starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs():
    jcfg = make_cfg()
    jcfg["frontend"]["bf16_gru"] = False
    tcfg = load_config(overrides={
        "mode": "vio", "frontend": copy.deepcopy(jcfg["frontend"])})
    return jcfg, tcfg


def rel_close(t, j, rel, what):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, what
    scale = max(float(np.abs(j).max()), 1e-12)
    err = float(np.abs(t - j).max())
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lever", [False, True])
def test_conjugate_vision_hessian(lever):
    rng = np.random.default_rng(0)
    P = 4
    M = rng.normal(size=(6 * P, 6 * P))
    Hc = M @ M.T
    S = Hc.reshape(P, 6, P, 6).transpose(0, 2, 1, 3).astype(np.float32)
    v = rng.normal(size=(P, 6)).astype(np.float32)
    T_bc = np.eye(4)
    if lever:
        T_bc[:3, :3] = jgeo.ypr2R([12.0, -4.0, 91.0])
        T_bc[:3, 3] = [0.3, -0.05, 1.2]
    jH, jv, jA = jfg.conjugate_vision_hessian(S, v, T_bc)
    tH, tv, tA = tfg.conjugate_vision_hessian(S, v, T_bc)
    assert tH.dtype == np.float64 and tA.dtype == np.float64
    tol = 1e-6 if lever else 0.0
    rel_close(tA, jA, tol, "A")
    rel_close(tH, jH, tol, "H")
    rel_close(tv, jv, tol, "v")


# ---------------------------------------------------------------------------
# the tracker sequence
INERTIAL_KEYS = ("vi_init_t1", "imu_enabled", "last_t0", "last_t1",
                 "gnss_init_t1", "reinit")


def inertial_state(tr, inertial):
    out = host_state(tr)
    out.update({k: getattr(inertial, k) for k in INERTIAL_KEYS})
    out.update(
        video_imu=tr.video.imu_enabled,
        visual_only_init=tr.video.visual_only_init,
        n_states=len(inertial.states),
        preint_dt=[p.dt for p in inertial.preints],
        n_meas=[len(p.meas) for p in inertial.preints],
        priors=sorted(inertial.prior_factors),
        marg_frames=None if inertial.marg_prior is None
        else list(inertial.marg_prior.frames),
        cur_ii=np.asarray(inertial.cur_ii)[inertial.cur_valid].tolist(),
        cur_jj=np.asarray(inertial.cur_jj)[inertial.cur_valid].tolist())
    return out


def both_vio_trackers():
    jcfg, tcfg = cfgs()
    jtr = JTracker(jcfg, H, W)
    ttr = Tracker(tcfg, H, W, params=flat_params(jtr), device="cpu")
    jtr.graph.free_slots.remove(0)
    ttr.graph.free_slots.remove(0)
    imu = synth_imu()
    ji = JInertial(jtr.video, jcfg, imu, np.eye(4))
    ti = InertialFusion(ttr.video, tcfg, imu, np.eye(4))
    jtr.frontend.attach_inertial(ji)
    ttr.frontend.attach_inertial(ti)
    return jtr, ttr, ji, ti


@pytest.fixture(scope="module")
def sequence():
    """Both trackers over the 18 frames; the host state after every frame,
    the states right after the VI-init frame, and the inputs of the JAX
    tracker's first multi-sensor update."""
    jtr, ttr, ji, ti = both_vio_trackers()
    captured = {}
    msba = ji.multi_sensor_ba

    def capture(*args, **kw):
        if not captured:
            captured["args"] = args
        return msba(*args, **kw)

    ji.multi_sensor_ba = capture
    rows, at_init = [], None
    for pkt in frames(18):
        jtr.track(pkt)
        ttr.track(dict(pkt))
        rows.append((inertial_state(jtr, ji), inertial_state(ttr, ti)))
        if at_init is None and ji.vi_init_t1 >= 0:
            at_init = ([s.copy() for s in ji.states],
                       [s.copy() for s in ti.states])
            cov_at_init = (np.array(jtr.video.bufs.depths_cov_up),
                           ttr.video.bufs.depths_cov_up.numpy().copy())
    return dict(jtr=jtr, ttr=ttr, ji=ji, ti=ti, rows=rows,
                at_init=at_init, cov_at_init=cov_at_init,
                captured=captured)


def test_host_bookkeeping_equal_after_every_frame(sequence):
    """Edge lists, slots, counters, t0/t1 and the inertial layer's own
    bookkeeping (VI-init frame, imu_enabled, last_t0/last_t1, the prior
    and marginal-prior frames, the preintegrated intervals and the edges
    kept for marginalization): equal after each of the 18 frames."""
    for k, (j, t) in enumerate(sequence["rows"]):
        assert j == t, (k, {key: (j[key], t[key]) for key in j
                            if j[key] != t[key]})
    last = sequence["rows"][-1][1]
    ti = sequence["ti"]
    assert ti.vi_init_t1 >= 0 and last["imu_enabled"] and last["video_imu"]
    assert last["marg_frames"] is not None and last["last_t0"] > 0
    assert ti.stats["updates"] > 5 and ti.stats["marg_pulls"] > 0
    # every outer iteration made one copy, each marginalization one more
    assert ti.stats["pulls"] == 2 * ti.stats["updates"] \
        + ti.stats["marg_pulls"]


def test_vi_init_frame_and_states_at_init(sequence):
    """VI init fires on the same frame; right after it the states agree to
    the tolerance its least-squares solves leave from float32 poses that
    differ by ~1e-5 (the VO parity's): rotations and gyro bias 2e-3,
    positions and velocities 1e-2."""
    j_init = [r[0]["vi_init_t1"] for r in sequence["rows"]]
    t_init = [r[1]["vi_init_t1"] for r in sequence["rows"]]
    assert j_init == t_init
    assert max(t_init) > 0
    js, ts = sequence["at_init"]
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert np.abs(a.R - b.R).max() <= 2e-3
        assert np.abs(a.b - b.b).max() <= 2e-3
        assert np.abs(a.p - b.p).max() <= 1e-2
        assert np.abs(a.v - b.v).max() <= 1e-2


def test_states_poses_and_disparities_at_the_end(sequence):
    """After 18 frames of feedback (7 frames of fused updates): body
    states R, p, v within 1e-2, 2e-2, 3e-2, biases within 1e-2; camera
    poses within 2e-2; disparities within 2e-2 on average and 0.1 of the
    largest disparity anywhere (the frames at the window's edge move most).
    """
    jtr, ttr, ji, ti = (sequence[k] for k in ("jtr", "ttr", "ji", "ti"))
    for a, b in zip(ji.states, ti.states):
        for f, tol in (("R", 1e-2), ("p", 2e-2), ("v", 3e-2), ("b", 1e-2)):
            err = float(np.abs(getattr(a, f) - getattr(b, f)).max())
            assert err <= tol, (f, err)
        assert np.isfinite(b.p).all() and np.isfinite(b.v).all()
    n = ttr.video.counter
    jp = np.asarray(jtr.video.bufs.poses)[:n]
    tp = ttr.video.bufs.poses[:n].numpy()
    assert float(np.abs(tp - jp).max()) <= 2e-2
    jd = np.asarray(jtr.video.bufs.disps)[:n]
    td = ttr.video.bufs.disps[:n].numpy()
    assert float(np.abs(td - jd).mean()) <= 2e-2
    assert float(np.abs(td - jd).max()) <= 0.1 * float(np.abs(jd).max())
    assert np.isfinite(td).all() and (td >= 0).all()


def test_ba_hessian_and_retract_at_the_vio_shapes(sequence):
    """The vision half-steps on the inputs of the JAX tracker's first
    multi-sensor update: the padded edge list (edge_capacity +
    inactive_capacity rows) there, its live rows here; fixedp=0 over the
    whole 12-frame window."""
    (tgt, wgt, eta, ii, jj, ev, base, t1, poses, disps,
     intr) = sequence["captured"]["args"]
    live = np.asarray(ev)
    assert live.sum() > 0 and live.sum() < live.shape[0]
    jS, jv, jaux = jba.ba_hessian(tgt, wgt, eta, poses, disps, intr, ii, jj,
                                  ev, fixedp=0)

    def t(x, rows=None):
        x = torch.from_numpy(np.array(x))
        return x if rows is None else x[torch.from_numpy(np.array(rows))]

    targs = (t(tgt, live), t(wgt, live), t(eta), t(poses), t(disps),
             t(intr), t(ii, live), t(jj, live), t(ev, live))
    tS, tv, taux = tba.ba_hessian(*targs, fixedp=0)
    assert tS.shape == (poses.shape[0],) * 2 + (6, 6)
    rel_close(tS.numpy(), jS, 1e-4, "S")
    rel_close(tv.numpy(), jv, 1e-4, "v")
    dx = (np.random.default_rng(1).normal(size=(poses.shape[0], 6))
          * 1e-3).astype(np.float32)
    jp, jd = jba.ba_retract(poses, disps, jnp.asarray(dx), jaux, fixedp=0)
    tp, td = tba.ba_retract(t(poses), t(disps), torch.from_numpy(dx), taux,
                            fixedp=0)
    rel_close(tp.numpy(), jp, 1e-4, "poses")
    rel_close(td.numpy(), jd, 1e-4, "disps")


# ---------------------------------------------------------------------------
# the inertial layer alone, on stand-in videos
class _Video:
    """Port stand-in: buffers on the CPU, a counter and timestamps."""

    def __init__(self, t1, disp0=1.0):
        self.bufs = empty_buffers(max(t1, 1), 32, 48)
        self.bufs.disps[:] = disp0
        self.counter = t1
        self.tstamps_host = [float(i) for i in range(t1)]
        self.imu_enabled = False
        self.visual_only_init = False


def _jvideo(t1, disp0=1.0):
    """JAX stand-in with .bufs.poses/.disps and .replace."""
    class _Bufs:
        def __init__(self, poses, disps):
            self.poses, self.disps = poses, disps

        def replace(self, **kw):
            return _Bufs(kw.get("poses", self.poses),
                         kw.get("disps", self.disps))

    class V:
        pass

    v = V()
    v.bufs = _Bufs(jnp.tile(jnp.asarray([0, 0, 0, 0, 0, 0, 1.0],
                                        jnp.float32), (t1, 1)),
                   jnp.full((t1, 4, 6), disp0, jnp.float32))
    v.tstamps_host = [float(i) for i in range(t1)]
    v.counter = t1
    v.imu_enabled = v.visual_only_init = False
    return v


def assert_fstates(t, j, tol=1e-9):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        for f in ("R", "p", "v", "b"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=0, atol=tol, err_msg=f)


def test_visual_imu_alignment_recovers_gyro_bias():
    """tests/test_vio.py's gyro-bias recovery in both packages, from the
    same float32 ground-truth poses: the same states and written poses
    (1e-9 on states, 1e-6 on the float32 poses), the bias within 5e-3 of
    the truth."""
    jcfg, tcfg = cfgs()
    bg_true = np.array([0.02, -0.01, 0.015])
    imu = synth_imu()
    imu[:, 1:4] += np.rad2deg(bg_true)
    from vings_mono_tpu.tracker.imu import so3_exp
    n_kf = 10
    ts = [k / FPS for k in range(n_kf)]
    R, p, v = np.eye(3), np.zeros(3), np.zeros(3)
    g = np.array([0, 0, -9.81])
    w2cs, kf_i, dt = [], 0, 0.01
    for row in imu:
        if kf_i < n_kf and row[0] >= ts[kf_i] - 1e-9:
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R, p
            w2cs.append(np.linalg.inv(T))
            kf_i += 1
        a_body, w = row[4:7], np.deg2rad(row[1:4]) - bg_true
        p = p + v * dt + 0.5 * (R @ a_body + g) * dt ** 2
        v = v + (R @ a_body + g) * dt
        R = R @ so3_exp(w * dt)
    tq = np.asarray(jlie.se3_from_matrix(jnp.asarray(np.asarray(w2cs),
                                                     jnp.float32)))
    jv, tv = _jvideo(n_kf), _Video(n_kf)
    jv.bufs = jv.bufs.replace(poses=jnp.asarray(tq))
    tv.bufs.poses[:n_kf] = torch.from_numpy(np.array(tq))
    jv.tstamps_host = tv.tstamps_host = list(ts)
    ji = JInertial(jv, jcfg, imu, np.eye(4))
    ti = InertialFusion(tv, tcfg, imu, np.eye(4))
    ji.init_states()
    ti.init_states()
    ji.visual_imu_alignment(0, n_kf, ignore_lever=True, disable_scale=True)
    ti.visual_imu_alignment(0, n_kf, ignore_lever=True, disable_scale=True)
    assert_fstates(ti.states, ji.states)
    np.testing.assert_allclose(ti.states[0].b[:3], bg_true, atol=5e-3)
    np.testing.assert_allclose(tv.bufs.poses[:n_kf].numpy(),
                               np.asarray(jv.bufs.poses), atol=1e-6)
    # with the scale free: the same scale, so the same disparities
    ji.visual_imu_alignment(0, n_kf, ignore_lever=False)
    ti.visual_imu_alignment(0, n_kf, ignore_lever=False)
    assert_fstates(ti.states, ji.states, tol=1e-6)
    np.testing.assert_allclose(tv.bufs.disps[:n_kf, :4, :6].numpy(),
                               np.asarray(jv.bufs.disps), rtol=1e-6)


def test_gnss_alignment_and_factors():
    """maybe_init_gnss in both packages on tests/test_vio.py's line
    trajectory and similarity-transformed GNSS fixes: the same states
    (1e-9), the fixes recovered, disparities rescaled by the same factor,
    the same GpsFactors."""
    jcfg, tcfg = cfgs()
    t1 = 10
    jv, tv = _jvideo(t1), _Video(t1)
    ji = JInertial(jv, jcfg, synth_imu(1.0), np.eye(4),
                   all_gnss=np.zeros((1, 4)))
    ti = InertialFusion(tv, tcfg, synth_imu(1.0), np.eye(4),
                        all_gnss=np.zeros((1, 4)))
    p_w = np.stack([[i, 0.2 * i, 0.0] for i in range(t1)])
    s_true, th = 3.0, 0.7
    Rz = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    enu = (Rz @ (s_true * (p_w - p_w[0])).T).T
    ten0 = tgeo.geod2cart(np.deg2rad(30.0), np.deg2rad(114.0), 40.0)
    np.testing.assert_array_equal(ten0, jgeo.geod2cart(
        np.deg2rad(30.0), np.deg2rad(114.0), 40.0))
    ecef = ten0[None] + (tgeo.Cen(ten0).T @ enu.T).T
    for mod, inertial in ((jfg, ji), (tfg, ti)):
        inertial.imu_enabled = True
        inertial.states = [mod.FrameState(np.eye(3), p_w[i],
                                          (p_w[1] - p_w[0]) * FPS)
                           for i in range(t1)]
        inertial.preints = [None] * t1
        inertial.odo_meas = [None] * t1
        inertial.gnss_meas = [ecef[i] if i % 2 == 0 else None
                              for i in range(t1)]
        assert inertial.maybe_init_gnss(t1)
    assert ti.gnss_init_t1 == ji.gnss_init_t1 == t1
    assert_fstates(ti.states, ji.states)
    for i in range(0, t1, 2):
        assert np.linalg.norm(ti.states[i].p - enu[i]) < 1e-3
    assert np.allclose(tv.bufs.disps[:t1].numpy(), 1.0 / s_true, atol=1e-4)
    np.testing.assert_allclose(tv.bufs.poses[:t1].numpy(),
                               np.asarray(jv.bufs.poses), atol=1e-5)
    jf = [f for f in ji._aux_factors(0, t1) if isinstance(f, jfg.GpsFactor)]
    tf = [f for f in ti._aux_factors(0, t1) if isinstance(f, tfg.GpsFactor)]
    assert len(tf) == len(jf) == 5
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.p_meas, b.p_meas, rtol=0, atol=1e-9)


def test_zupt_gate():
    """A >3 s stationary interval with tiny velocity pins the new frame
    with a zero body-velocity measurement, in both packages."""
    from vings_mono_tpu.tracker.imu import Preintegration as JPre
    jcfg, tcfg = cfgs()
    jcfg["frontend"]["zupt"] = tcfg["frontend"]["zupt"] = True
    out = []
    for mod, Pre, Inert, video in ((jfg, JPre, JInertial, _jvideo(4)),
                                   (tfg, Preintegration, InertialFusion,
                                    _Video(4))):
        inertial = Inert(video, jcfg, np.zeros((0, 7)), np.eye(4))
        inertial.states = [mod.FrameState(np.eye(3), np.zeros(3),
                                          np.full(3, 0.01))
                           for _ in range(3)]
        inertial.preints = [Pre(inertial.params) for _ in range(3)]
        inertial.gnss_meas = [None] * 3
        inertial.odo_meas = [None] * 3
        inertial.preints[1].dt = 4.0      # long stationary interval
        inertial.on_new_frame(4)
        out.append(inertial)
    ji, ti = out
    assert ti.odo_meas[3] is not None and np.allclose(ti.odo_meas[3], 0.0)
    assert [m is None for m in ti.odo_meas] == \
        [m is None for m in ji.odo_meas]
    assert_fstates(ti.states, ji.states)


def test_imu_gap_gets_loose_params():
    """A >25 ms gap in the IMU stream inflates the preintegration noise in
    both packages; the interval integrates to the same state (1e-12)."""
    jcfg, tcfg = cfgs()
    imu = synth_imu(1.0)
    gappy = np.concatenate([imu[:20], imu[28:]])  # 80 ms hole
    ji = JInertial(_jvideo(4), jcfg, gappy, np.eye(4))
    ti = InertialFusion(_Video(4), tcfg, gappy, np.eye(4))
    for (a, b) in ((0.15, 0.35), (0.5, 0.7)):
        jp = ji._integrate_interval(a, b)
        tp = ti._integrate_interval(a, b)
        assert tp.params.acc_n == jp.params.acc_n
        for f in ("dR", "dv", "dp", "J_Rbg", "cov"):
            np.testing.assert_allclose(getattr(tp, f), getattr(jp, f),
                                       rtol=1e-12, atol=1e-12)
        assert len(tp.meas) == len(jp.meas)
    assert ti._integrate_interval(0.15, 0.35).params.acc_n == \
        pytest.approx(ti.params.acc_n * 10)


def test_rollup_and_keyframe_removal_rekey_like_jax():
    """on_rm_keyframe merges the culled interval into the previous one and
    on_rollup rekeys states, priors, the marginal prior and the VI-init
    frame: the same lists in both packages."""
    jcfg, tcfg = cfgs()
    imu = synth_imu(2.0)
    n = 12
    jv, tv = _jvideo(n), _Video(n)
    jv.tstamps_host = tv.tstamps_host = [k / FPS for k in range(n)]
    ji = JInertial(jv, jcfg, imu, np.eye(4))
    ti = InertialFusion(tv, tcfg, imu, np.eye(4))
    for inertial, mod in ((ji, jfg), (ti, tfg)):
        inertial.init_states()
        inertial.set_prior(3, n)
        x = {k: inertial.states[k] for k in range(2, 6)}
        inertial.marg_prior = mod.marginalize(
            x, inertial._imu_factors(2, 6), [2])
        inertial.vi_init_t1 = 9
        inertial.on_rm_keyframe(7)
        inertial.on_rollup(2)
    assert [p.dt for p in ti.preints] == [p.dt for p in ji.preints]
    assert [len(p.meas) for p in ti.preints] == \
        [len(p.meas) for p in ji.preints]
    assert sorted(ti.prior_factors) == sorted(ji.prior_factors) == [1, 2]
    assert [f.i for f in ti.prior_factors[1]] == [1, 1]
    assert ti.marg_prior.frames == ji.marg_prior.frames
    assert sorted(ti.marg_prior.lin) == sorted(ji.marg_prior.lin)
    assert ti.vi_init_t1 == ji.vi_init_t1 == 7
    assert (ti.last_t0, ti.last_t1) == (ji.last_t0, ji.last_t1)
    np.testing.assert_allclose(ti.preints[4].dR, ji.preints[4].dR,
                               rtol=0, atol=1e-12)


def test_fused_updates_leave_the_depth_covariance_as_jax_does(sequence):
    """Both packages start `depths_cov_up` at 1.0, and neither computes a
    depth covariance in a fused (inertial) update: from VI init on, the
    slots of the keyframes appended after it hold, bit for bit, what they
    held at init (the last visual-only update's write over the window, or
    the initial 1.0), in both packages alike (ROADMAP.md, section C)."""
    jtr, ttr, ti = sequence["jtr"], sequence["ttr"], sequence["ti"]
    assert bool((empty_buffers(4, 32, 48).depths_cov_up == 1.0).all())
    n, k = ttr.video.counter, ti.vi_init_t1
    assert 0 < k < n and ti.stats["updates"] > 0
    j0, t0 = sequence["cov_at_init"]
    jc = np.asarray(jtr.video.bufs.depths_cov_up)
    tc = ttr.video.bufs.depths_cov_up.numpy()
    np.testing.assert_array_equal(jc[k:n], j0[k:n])
    np.testing.assert_array_equal(tc[k:n], t0[k:n])
    rel_close(tc[k:n], jc[k:n], 1e-2, "stale covariance")
