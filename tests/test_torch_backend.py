"""Port parity for the global-BA terminate pass: the solvers of ops/ba.py
(`ba_global`, `band_matvec`, `banded_pcg`, `ba_global_banded`) and
tracker/backend.py (`GlobalBA._build_edges`, `GlobalBA.run` through the
`target_fn` seam with oracle networks) against the JAX package on the same
numpy inputs, on the problems of tests/test_backend.py. Tolerances are
stated per test."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_backend import (_FakeTracker, _OracleCnet, _OracleFnet,
                          _OracleUpdate, _ate, _banded_problem,
                          _loopy_trajectory)
from vings_mono_tpu.ops import ba as jba
from vings_mono_tpu.ops import lie as jlie
from vings_mono_tpu.ops import projective as jpops
from vings_mono_tpu.tracker.backend import GlobalBA as JGlobalBA
from vings_mono_tpu.tracker.video import DepthVideo as JVideo
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch.ops import ba as tba
from vings_mono_tpu_torch.tracker.backend import GlobalBA
from vings_mono_tpu_torch.tracker.video import DepthVideo
from vings_mono_tpu_torch.utils.config import load_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def problem():
    """T = 12 drifted poses with ground-truth reprojection targets over a
    band-2 edge set, the JAX dense and banded solutions of it."""
    p = _banded_problem(np.random.default_rng(7), 12)
    gt, drift, disps, intr, target, weight, eta, ii, jj, valid, gi, gv, \
        free = p
    args = (target, weight, eta, drift, disps, intr, ii, jj, valid, gi, gv,
            free)
    jd = jba.ba_global(*args, iters=6)
    jb = jba.ba_global_banded(*args, iters=6, band=11, cg_iters=400)
    return dict(args=args, gt=gt, drift=drift, jax_dense=jd, jax_banded=jb)


def test_ba_global_matches_jax(problem):
    """Dense global BA, 6 Gauss-Newton steps: poses within 1e-4, disparities
    within 1e-3 of the JAX package's."""
    pd, dd = tba.ba_global(*(T(a) for a in problem["args"]), iters=6)
    jp, jd = problem["jax_dense"]
    np.testing.assert_allclose(pd.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(dd.numpy(), np.asarray(jd), atol=1e-3)
    e0 = _ate(np.asarray(problem["drift"]), np.asarray(problem["gt"]))
    assert _ate(pd.numpy(), np.asarray(problem["gt"])) < 0.6 * e0


def test_ba_global_banded_matches_jax_and_dense(problem):
    """Banded PCG global BA with the band covering the system: poses within
    1e-4 and disparities within 1e-3 of JAX's banded solve; against the
    port's dense solve at tests/test_backend.py's tolerances (poses 5e-4,
    disparities 5e-3)."""
    targs = [T(a) for a in problem["args"]]
    stats = {}
    pb, db = tba.ba_global_banded(*targs, iters=6, band=11, cg_iters=400,
                                  stats=stats)
    jp, jd = problem["jax_banded"]
    np.testing.assert_allclose(pb.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jd), atol=1e-3)
    pd, dd = tba.ba_global(*targs, iters=6)
    np.testing.assert_allclose(pb.numpy(), pd.numpy(), atol=5e-4)
    np.testing.assert_allclose(db.numpy(), dd.numpy(), atol=5e-3)
    used = [int(n) for n in stats["cg_iters_used"]]
    assert len(used) == 6 and all(0 < n < 400 for n in used), used


def _banded_spd(rng, n, band, shift=1.0):
    """A random SPD block-band system (n blocks of 6, half-band `band`)
    in band storage, and a rhs; `shift` scales the diagonal's lift (the
    smaller, the more CG iterations)."""
    A = np.zeros((n * 6, n * 6))
    for a in range(n):
        for b in range(max(0, a - band), min(n, a + band + 1)):
            A[6 * a:6 * a + 6, 6 * b:6 * b + 6] = rng.normal(size=(6, 6))
    A = A @ A.T
    A = A * (np.abs(np.arange(n * 6)[:, None] // 6
                    - np.arange(n * 6)[None, :] // 6) <= band)
    A += np.eye(n * 6) * (shift * np.abs(A).sum(1).max())
    Sb = np.zeros((n, 2 * band + 1, 6, 6))
    for a in range(n):
        for c in range(2 * band + 1):
            b = a + c - band
            if 0 <= b < n:
                Sb[a, c] = A[6 * a:6 * a + 6, 6 * b:6 * b + 6]
    rhs = rng.normal(size=(n, 6))
    return Sb.astype(np.float32), rhs.astype(np.float32)


def test_band_matvec_matches_jax():
    """One band product, within 1e-5 of the largest entry."""
    Sb, x = _banded_spd(np.random.default_rng(1), 9, 2)
    y = tba.band_matvec(T(Sb), T(x), 2).numpy()
    jy = np.asarray(jba.band_matvec(jnp.asarray(Sb), jnp.asarray(x), 2))
    np.testing.assert_allclose(y, jy, atol=1e-5 * np.abs(jy).max())


@pytest.mark.parametrize("seed,n,shift,stop", [
    (2, 10, 1.0, "before the first host read"),
    (3, 24, 0.03, "before the first host read"),
    (2, 40, 0.02, "after a host read")])
def test_banded_pcg_matches_jax_and_stops_early(seed, n, shift, stop):
    """The device-side stop flag stops where JAX's while_loop stops: the
    port's count k is the iteration after which JAX's result no longer
    changes (JAX at k iterations equals JAX at 200; at k-1 it does not),
    and x is within 1e-5 relative of JAX's, whether the flag froze the
    iterates before the host's first read or the host read it first."""
    Sb, b = _banded_spd(np.random.default_rng(seed), n, 2, shift)
    x, k = tba.banded_pcg(T(Sb), T(b), 2, iters=200, tol=1e-8)
    k = int(k)
    assert 1 < k < 200
    assert (k > tba.CG_CHECK_EVERY) == (stop == "after a host read")
    jx = np.asarray(jba.banded_pcg(jnp.asarray(Sb), jnp.asarray(b), 2,
                                   iters=200, tol=1e-8))
    scale = np.abs(jx).max()
    np.testing.assert_allclose(x.numpy(), jx, atol=1e-5 * scale)
    jn = np.asarray(jba.banded_pcg(jnp.asarray(Sb), jnp.asarray(b), 2,
                                   iters=k, tol=1e-8))
    jn1 = np.asarray(jba.banded_pcg(jnp.asarray(Sb), jnp.asarray(b), 2,
                                    iters=k - 1, tol=1e-8))
    np.testing.assert_array_equal(jn, jx)
    assert np.abs(jn1 - jx).max() > 0
    # a truncated run stops at its cap
    x3, k3 = tba.banded_pcg(T(Sb), T(b), 2, iters=3, tol=1e-8)
    assert int(k3) == 3
    j3 = np.asarray(jba.banded_pcg(jnp.asarray(Sb), jnp.asarray(b), 2,
                                   iters=3, tol=1e-8))
    np.testing.assert_allclose(x3.numpy(), j3, atol=1e-5 * scale)


def _port_gba(cfg, extra_edges=None):
    tracker = types.SimpleNamespace(
        cfg=cfg, video=types.SimpleNamespace(device=torch.device("cpu")))
    return GlobalBA(tracker, cfg, extra_edges=extra_edges)


def _jax_gba(backend, extra_edges=None):
    cfg = j_load_config(overrides={"backend": backend})
    tracker = _FakeTracker()
    tracker.cfg = cfg
    return JGlobalBA(tracker, cfg, extra_edges=extra_edges)


@pytest.mark.parametrize("T_len,band,extra", [
    (30, 64, None), (70, 64, None),
    (80, 8, [(5, 70), (12, 60)]), (80, 8, [(-1, 5), (3, 400), (7, 7)])])
def test_build_edges_identical(T_len, band, extra):
    """The edge lists are identical, element by element, with and without
    injected loop pairs (in and out of range)."""
    backend = {"thresh": 3.0 if band == 8 else 6.0, "nms": 2, "radius": 2,
               "degree_cap": 6, "band": band}
    poses, disps, intr8 = _loopy_trajectory(np.random.default_rng(3 + T_len),
                                            T_len)
    ji, jj = _jax_gba(backend, extra)._build_edges(T_len, poses, disps,
                                                   intr8, T_len)
    cfg = load_config(overrides={"backend": backend})
    ti, tj = _port_gba(cfg, extra)._build_edges(T_len, poses, disps, intr8,
                                                T_len)
    assert len(ji) > 2 * (T_len - 1) - 1
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tj, jj)


class _OracleModel:
    """The port's side of tests/test_backend.py's oracle networks: zero
    features, and an update whose delta is the motion feature's second
    half (the seeded target minus the reprojection)."""

    def fnet(self, x):
        return torch.zeros(x.shape[0], x.shape[1] // 8, x.shape[2] // 8, 128)

    def context(self, x):
        z = self.fnet(x)
        return z, z

    def update(self, net, inp, corr, motn, ii, num_frames, upsample):
        delta = motn[..., 2:4]
        hw = net.shape[1:3]
        return (net, delta, torch.ones_like(delta),
                torch.full((num_frames,) + hw, 1e-2),
                torch.zeros((num_frames,) + hw + (576,)))


def test_global_ba_run_matches_jax():
    """tests/test_backend.py's drifted 6-keyframe trajectory (4 saved + 2
    live) through GlobalBA.run in both packages, with the oracle networks
    and ground-truth targets through `target_fn`: the written-back poses
    within 1e-3 of JAX's, and JAX's own recovery bound (err1 < 0.55 *
    err0)."""
    H, W, F = 64, 96, 40.0
    h, w = H // 8, W // 8
    rng = np.random.default_rng(12)
    Tn = 6
    xi = np.zeros((Tn, 6), np.float32)
    for k in range(1, Tn):
        xi[k, :3] = xi[k - 1, :3] + rng.normal(size=3) * 0.06
        xi[k, 3:] = xi[k - 1, 3:] + rng.normal(size=3) * 0.015
    gt_poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    gt_disps = rng.uniform(0.25, 0.5, size=(Tn, h, w)).astype(np.float32)
    intr8 = np.asarray([F / 8, F / 8, w / 2, h / 2], np.float32)
    pert = np.zeros((Tn, 6), np.float32)
    for k in range(1, Tn):
        pert[k] = pert[k - 1] + rng.normal(size=6) * np.asarray(
            [0.02, 0.02, 0.02, 0.004, 0.004, 0.004])
    drift = np.asarray(jlie.se3_retr(jnp.asarray(gt_poses),
                                     jnp.asarray(pert)))
    ns = 4
    nl = Tn - ns
    images = rng.uniform(0, 1, size=(Tn, H, W, 3)).astype(np.float32)
    over = {"frontend": {"buffer": 8, "save_buffer": 16,
                         "filter_thresh": 0.0, "keyframe_thresh": 0.0},
            "backend": {"steps": 4, "iters": 4, "thresh": 1e9, "chunk": 8,
                        "degree_cap": 6, "encode_batch": 4}}

    def gt_targets(ii_p, jj_p):
        coords, _ = jpops.projective_transform(
            jnp.asarray(gt_poses), jnp.asarray(gt_disps),
            jnp.tile(jnp.asarray(intr8)[None], (Tn, 1)),
            jnp.asarray(np.clip(ii_p, 0, Tn - 1), jnp.int32),
            jnp.asarray(np.clip(jj_p, 0, Tn - 1), jnp.int32))
        return np.asarray(jnp.moveaxis(coords, -1, 1))

    # JAX
    jcfg = j_load_config(overrides=over)
    jv = JVideo(jcfg, H, W)
    jv.count_save = ns
    jv.poses_save[:ns] = drift[:ns]
    jv.disps_save[:ns] = gt_disps[:ns]
    jv.images_save[:ns] = images[:ns]
    jv.counter = nl
    jv.bufs = jv.bufs.replace(
        poses=jv.bufs.poses.at[:nl].set(drift[ns:]),
        disps=jv.bufs.disps.at[:nl].set(gt_disps[ns:]),
        images=jv.bufs.images.at[:nl].set(images[ns:]),
        intrinsics=jv.bufs.intrinsics.at[:].set(jnp.asarray(intr8)))
    jt = _FakeTracker()
    jt.video, jt.cfg, jt.params = jv, jcfg, {}
    jt.fnet_apply, jt.cnet_apply = _OracleFnet(), _OracleCnet()
    jt.update_apply = _OracleUpdate()
    jg = JGlobalBA(jt, jcfg)
    jg.target_fn = gt_targets
    jstats = jg.run()
    jafter = np.concatenate([jv.poses_save[:ns],
                             np.asarray(jv.bufs.poses[:nl])])

    # port
    cfg = load_config(overrides=over)
    tv = DepthVideo(cfg, H, W, device="cpu")
    tv.count_save = ns
    tv.poses_save[:ns] = drift[:ns]
    tv.disps_save[:ns] = gt_disps[:ns]
    tv.images_save[:ns] = images[:ns]
    tv.counter = nl
    tv.bufs.poses[:nl] = T(drift[ns:])
    tv.bufs.disps[:nl] = T(gt_disps[ns:])
    tv.bufs.images[:nl] = T(images[ns:])
    tv.bufs.intrinsics[:] = T(intr8)
    tt = types.SimpleNamespace(video=tv, cfg=cfg, model=_OracleModel())
    tg = GlobalBA(tt, cfg)
    tg.target_fn = gt_targets
    tstats = tg.run()
    tafter = np.concatenate([tv.poses_save[:ns], tv.bufs.poses[:nl].numpy()])

    assert tstats == jstats and not tstats["skipped"]
    np.testing.assert_allclose(tafter, jafter, atol=1e-3)
    err0 = _ate(drift, gt_poses)
    err1 = _ate(tafter, gt_poses)
    assert err1 < 0.55 * err0, (err0, err1)
    assert len(tg.cg_iters_used) == 4 * 4
