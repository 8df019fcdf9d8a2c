"""Port parity: ops.ba against the JAX module on the dense-BA problem of
tests/test_ba.py (`make_problem`). f32; each compared array within 1e-4 of
its largest magnitude (the normal equations sum ~1500 products per entry in
another order), poses and disparities after the solve within 1e-4 abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_ba import make_problem
from vings_mono_tpu.ops import ba as jba
from vings_mono_tpu.ops import lie as jlie
from vings_mono_tpu_torch.ops import ba as tba

REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops at these sizes are small. With the default thread
    count every test worker spins a whole OpenMP team on each of them, and
    the workers (and the JAX runs beside them) starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def close(t, j, what, rel=REL):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape, what
    scale = max(float(np.abs(j).max()), 1e-12)
    err = float(np.abs(t - j).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    poses_gt, disps, intr, ii, jj, target, weight, eta = make_problem(rng)
    pert = np.asarray(rng.normal(size=(3, 6)) * 0.02, np.float32)
    pert[0] = 0
    poses0 = jlie.se3_retr(poses_gt, jnp.asarray(pert))
    # two garbage edges marked dead, as a padded edge list carries them
    ii2 = jnp.concatenate([ii, jnp.asarray([0, 1], jnp.int32)])
    jj2 = jnp.concatenate([jj, jnp.asarray([0, 2], jnp.int32)])
    junk = jnp.asarray(rng.normal(size=(2,) + target.shape[1:]), jnp.float32)
    target2 = jnp.concatenate([target, junk * 50])
    weight2 = jnp.concatenate([weight, jnp.abs(junk)])
    valid2 = jnp.asarray([True] * ii.shape[0] + [False, False])
    intr_p = jnp.broadcast_to(intr[None], (3, 4))
    return dict(poses_gt=poses_gt, poses=poses0, disps=disps, intr=intr_p,
                ii=ii2, jj=jj2, target=target2, weight=weight2, eta=eta,
                valid=valid2, n_live=int(ii.shape[0]))


def args_of(p, live_only=False):
    n = p["n_live"] if live_only else p["ii"].shape[0]
    return (p["target"][:n], p["weight"][:n], p["eta"], p["poses"],
            p["disps"], p["intr"], p["ii"][:n], p["jj"][:n], p["valid"][:n])


@pytest.mark.parametrize("fixedp", [0, 1])
def test_build_system_and_schur(prob, fixedp):
    a = args_of(prob)
    jsys = jba.build_system(*a, fixedp=fixedp)
    tsys = tba.build_system(*T(*a), fixedp=fixedp)
    for t, j, what in zip(tsys, jsys, "HvECw"):
        close(t, j, what)
    jS, jv2, jQ = jba.schur_reduce(*jsys)
    tS, tv2, tQ = tba.schur_reduce(*tsys)
    close(tS, jS, "S")
    close(tv2, jv2, "v2")
    close(tQ, jQ, "Q")
    # with no pose fixed the system has a 7-dimensional gauge null space
    # that only the damping (ep = 0.1) holds up: it amplifies the f32
    # differences of S, so the step is held to 5e-3 there and 1e-3 otherwise
    close(tba.damped_solve(tS, tv2), jba.damped_solve(jS, jv2), "dx",
          rel=5e-3 if fixedp == 0 else 1e-3)


def test_dead_edges_are_inert_in_the_port(prob):
    """Live edges only == the padded list with its dead edges."""
    full = tba.build_system(*T(*args_of(prob)), fixedp=1)
    live = tba.build_system(*T(*args_of(prob, live_only=True)), fixedp=1)
    for a, b in zip(full, live):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("iters", [1, 4])
def test_ba(prob, iters):
    a = args_of(prob)
    jp, jd = jba.ba(*a, fixedp=1, iters=iters)
    tp, td = tba.ba(*T(*a), fixedp=1, iters=iters)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    assert float(td.min()) >= 0


@pytest.mark.parametrize("t0", [1, 2])
def test_ba_window_with_pinned_prefix(prob, t0):
    a = args_of(prob)
    jp, jd = jba.ba_window(*a, jnp.int32(t0), iters=2)
    tp, td = tba.ba_window(*T(*a), t0, iters=2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    # the pinned prefix did not move, the free poses did
    np.testing.assert_array_equal(tp.numpy()[:t0],
                                  np.asarray(prob["poses"])[:t0])
    assert np.abs(tp.numpy()[t0:] - np.asarray(prob["poses"])[t0:]).max() \
        > 1e-4


def test_ba_hessian_retract_and_covariance(prob):
    a = args_of(prob)
    jS, jv, jaux = jba.ba_hessian(*a, fixedp=0)
    tS, tv, taux = tba.ba_hessian(*T(*a), fixedp=0)
    close(tS, jS, "S")
    close(tv, jv, "v")
    rng = np.random.default_rng(1)
    dx = (rng.normal(size=(3, 6)) * 0.01).astype(np.float32)
    jp, jd = jba.ba_retract(prob["poses"], prob["disps"], jnp.asarray(dx),
                            jaux, fixedp=0)
    tp, td = tba.ba_retract(*T(prob["poses"], prob["disps"], dx), taux,
                            fixedp=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    for free in (None, np.asarray([False, True, True])):
        jc = jba.depth_covariance(
            jS, jaux[0], jaux[1], prob["disps"],
            free_mask=None if free is None else jnp.asarray(free))
        tc = tba.depth_covariance(
            tS, taux[0], taux[1], *T(prob["disps"]),
            free_mask=None if free is None else torch.from_numpy(free))
        close(tc, jc, "depth_cov", rel=1e-3)


def test_non_positive_definite_system_takes_the_fallback():
    """A pose system without a Cholesky factor: no exception, no NaN, the
    pose step is zero (JAX gets NaNs from its factorization and falls back
    the same way)."""
    S = torch.zeros((2, 2, 6, 6))
    S[0, 0] = -5.0 * torch.eye(6)
    S[1, 1] = torch.eye(6)
    v = torch.ones((2, 6))
    dx = tba.damped_solve(S, v)
    jdx = jba.damped_solve(jnp.asarray(S.numpy()), jnp.asarray(v.numpy()))
    assert torch.isfinite(dx).all()
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))
    assert float(dx.abs().max()) == 0.0
    nan = tba.damped_solve(S * float("nan"), v)
    assert float(nan.abs().max()) == 0.0
    # the covariance falls back to the depth block alone
    E = torch.ones((2, 2, 6, 4))
    Q = torch.full((2, 4), 0.5)
    cov = tba.depth_covariance(S, E, Q, torch.ones((2, 2, 2)))
    jcov = jba.depth_covariance(jnp.asarray(S.numpy()),
                                jnp.asarray(E.numpy()),
                                jnp.asarray(Q.numpy()), jnp.ones((2, 2, 2)))
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-6)
