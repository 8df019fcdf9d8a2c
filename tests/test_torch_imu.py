"""Port parity for the host side of the inertial layer: the SO(3) helpers,
`Preintegration`, every factor's residual and Jacobians, LM and
marginalization (tracker/imu.py and tracker/factor_graph.py of both
packages, float64 numpy in both: held to 1e-12), and the port's native
preintegration (csrc/preintegrate.cpp through ctypes) against its numpy twin
and against the JAX package's numpy (1e-12 on the state, 1e-10 on the
position-bias Jacobian, 1e-8 relative on the covariance: the C++ sums in
another order)."""

import numpy as np
import pytest

from test_imu import build_graph_problem, simulate
from vings_mono_tpu.tracker import factor_graph as jfg
from vings_mono_tpu.tracker import imu as jimu
from vings_mono_tpu_torch.tracker import factor_graph as tfg
from vings_mono_tpu_torch.tracker import imu as timu
from vings_mono_tpu_torch.tracker import imu_native

TOL = 1e-12
PRE_FIELDS = ("dR", "dv", "dp", "J_Rbg", "J_vbg", "J_vba", "J_pbg", "J_pba",
              "cov")


def rng_vecs(seed, n, scale):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=3) * scale for _ in range(n)]


@pytest.mark.parametrize("scale", [1e-10, 1e-3, 0.5, 3.0])
@pytest.mark.parametrize("fn", ["so3_exp", "right_jacobian",
                                "right_jacobian_inv", "skew"])
def test_so3_helpers_equal(fn, scale):
    for phi in rng_vecs(0, 8, scale):
        np.testing.assert_allclose(getattr(timu, fn)(phi),
                                   getattr(jimu, fn)(phi), rtol=0, atol=TOL)


@pytest.mark.parametrize("scale", [1e-10, 1e-3, 0.5, 3.0])
def test_so3_log_equal(scale):
    for phi in rng_vecs(1, 8, scale):
        R = jimu.so3_exp(phi)
        np.testing.assert_allclose(timu.so3_log(R), jimu.so3_log(R),
                                   rtol=0, atol=TOL)


def preints(mod, meas, bg=None, ba=None, params=None):
    pre = mod.Preintegration(params or mod.ImuParams(), bg=bg, ba=ba)
    for a, w, dt in meas:
        pre.integrate(a, w, dt)
    return pre


def assert_pre_equal(t, j, tol=TOL):
    for f in PRE_FIELDS:
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=0,
                                   atol=tol, err_msg=f)
    assert t.dt == j.dt
    assert len(t.meas) == len(j.meas)


BIAS = (np.array([0.01, -0.02, 0.005]), np.array([0.05, 0.02, -0.03]))


@pytest.mark.parametrize("loose", [False, True])
def test_preintegration_integrate_predict_merge(loose):
    _, meas = simulate(n_steps=60, bg=BIAS[0], ba=BIAS[1])
    jp, tp = jimu.ImuParams(), timu.ImuParams()
    if loose:
        jp, tp = jp.loose(), tp.loose()
        assert tp.acc_n == pytest.approx(timu.ImuParams().acc_n * 10)
    for k in ("acc_n", "gyr_n", "acc_w", "gyr_w", "integration_n"):
        assert getattr(tp, k) == getattr(jp, k)
    j = preints(jimu, meas[:30], *BIAS, params=jp)
    t = preints(timu, meas[:30], *BIAS, params=tp)
    assert_pre_equal(t, j)
    j2 = preints(jimu, meas[30:], *BIAS, params=jp)
    t2 = preints(timu, meas[30:], *BIAS, params=tp)
    j.merge_from(j2)
    t.merge_from(t2)
    assert_pre_equal(t, j)
    rng = np.random.default_rng(2)
    R0 = jimu.so3_exp(rng.normal(size=3))
    p0, v0 = rng.normal(size=3), rng.normal(size=3)
    bg, ba = BIAS[0] + 1e-3, BIAS[1] - 2e-3
    for a, b in zip(t.predict(R0, p0, v0, bg, ba),
                    j.predict(R0, p0, v0, bg, ba)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    np.testing.assert_allclose(t.information(), j.information(),
                               rtol=1e-12)


def mod_exp(rng):
    return jimu.so3_exp(rng.normal(size=3) * 0.7)


def factor_pairs(rng):
    """The same factor built in both packages, each kind once."""
    _, meas = simulate(n_steps=40)
    out = [(jfg.ImuFactor(0, 1, preints(jimu, meas)),
            tfg.ImuFactor(0, 1, preints(timu, meas)))]
    R0, p0 = mod_exp(rng), rng.normal(size=3)
    s6, s3 = np.abs(rng.normal(size=6)) + 0.1, np.abs(rng.normal(size=3))
    b0, v0 = rng.normal(size=6) * 0.01, rng.normal(size=3)
    for name, args in (("PriorPoseFactor", (0, R0, p0, s6)),
                       ("PriorBiasFactor", (1, b0, s6)),
                       ("PriorVelFactor", (0, v0, s3 + 0.1)),
                       ("GpsFactor", (1, p0, s3 + 0.1)),
                       ("VelBodyFactor", (0, v0, s3 + 0.1))):
        out.append((getattr(jfg, name)(*args), getattr(tfg, name)(*args)))
    return out


@pytest.mark.parametrize("k", range(6))
def test_factor_residuals_and_jacobians_equal(k):
    rng = np.random.default_rng(3)
    jf, tf = factor_pairs(rng)[k]
    s = {i: jfg.FrameState(mod_exp(rng), rng.normal(size=3),
                           rng.normal(size=3), rng.normal(size=6) * 0.01)
         for i in (0, 1)}
    ts = {i: tfg.FrameState(x.R, x.p, x.v, x.b) for i, x in s.items()}
    jr, jJ, jL = jf.linearize(s)
    tr, tJ, tL = tf.linearize(ts)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=TOL)
    np.testing.assert_allclose(tL, jL, rtol=1e-12)
    assert sorted(tJ) == sorted(jJ)
    for key in jJ:
        np.testing.assert_allclose(tJ[key], jJ[key], rtol=0, atol=TOL)


def to_port(x):
    return {k: tfg.FrameState(s.R, s.p, s.v, s.b) for k, s in x.items()}


def port_factors(factors):
    """The JAX factors rebuilt as the port's, from the same fields."""
    out = []
    for f in factors:
        if isinstance(f, jfg.ImuFactor):
            pre = timu.Preintegration(timu.ImuParams(), bg=f.preint.bg,
                                      ba=f.preint.ba)
            for name in PRE_FIELDS:
                setattr(pre, name, getattr(f.preint, name).copy())
            pre.dt = f.preint.dt
            out.append(tfg.ImuFactor(f.i, f.j, pre))
        elif isinstance(f, jfg.PriorPoseFactor):
            g = tfg.PriorPoseFactor(f.i, f.R0, f.p0, np.ones(6))
            g.Lam = f.Lam.copy()
            out.append(g)
        elif isinstance(f, jfg.MarginalPrior):
            out.append(tfg.MarginalPrior(f.frames, f.H, f.g,
                                         to_port(f.lin)))
        else:
            g = getattr(tfg, type(f).__name__).__new__(
                getattr(tfg, type(f).__name__))
            g.__dict__.update({k: np.copy(v) if isinstance(v, np.ndarray)
                               else v for k, v in f.__dict__.items()})
            out.append(g)
    return out


def assert_states_equal(t, j, tol=TOL):
    assert sorted(t) == sorted(j)
    for k in j:
        for f in ("R", "p", "v", "b"):
            np.testing.assert_allclose(getattr(t[k], f), getattr(j[k], f),
                                       rtol=0, atol=tol, err_msg=(k, f))


def test_lm_on_the_perturbed_window_equal():
    x_true, factors = build_graph_problem()
    rng = np.random.default_rng(3)
    x0 = {k: s.retract(np.concatenate(
        [rng.normal(size=3) * 0.05, rng.normal(size=3) * 0.02,
         rng.normal(size=3) * 0.05, np.zeros(6)]))
        for k, s in x_true.items()}
    frames = sorted(x_true)
    jx = jfg.optimize(x0, factors, frames, iters=10)
    tx = tfg.optimize(to_port(x0), port_factors(factors), frames, iters=10)
    assert_states_equal(tx, jx)
    jH, jb, _ = jfg.build_normal_equations(jx, factors, frames)
    tH, tb, _ = tfg.build_normal_equations(tx, port_factors(factors),
                                           frames)
    np.testing.assert_allclose(tH, jH, rtol=1e-12, atol=TOL)
    np.testing.assert_allclose(tb, jb, rtol=1e-12, atol=TOL)


def test_marginalize_then_optimize_equal():
    x_true, factors = build_graph_problem()
    marg = [f for f in factors if 0 in f.keys()]
    keep = [f for f in factors if 0 not in f.keys()]
    jprior = jfg.marginalize(x_true, marg, [0])
    tprior = tfg.marginalize(to_port(x_true), port_factors(marg), [0])
    assert tprior.frames == jprior.frames
    np.testing.assert_allclose(tprior.H, jprior.H, rtol=1e-12, atol=TOL)
    np.testing.assert_allclose(tprior.g, jprior.g, rtol=1e-12, atol=TOL)
    frames = [k for k in sorted(x_true) if k != 0]
    jx = jfg.optimize(x_true, keep + [jprior], frames, iters=5)
    tx = tfg.optimize(to_port(x_true), port_factors(keep) + [tprior],
                      frames, iters=5)
    assert_states_equal(tx, jx)
    # the rekey a rollup applies
    tprior.rekey({k: k - 1 for k in tprior.frames})
    assert tprior.frames == [k - 1 for k in jprior.frames]


def test_quadratic_factor_and_total_error_equal():
    rng = np.random.default_rng(4)
    x = {i: jfg.FrameState(mod_exp(rng), rng.normal(size=3),
                           rng.normal(size=3), rng.normal(size=6) * 0.01)
         for i in range(3)}
    M = rng.normal(size=(18, 18))
    H = M @ M.T
    v = rng.normal(size=18)
    lin = {k: s.retract(rng.normal(size=15) * 0.01) for k, s in x.items()}
    jq = jfg.QuadraticPoseFactor([0, 1, 2], H, v, lin)
    tq = tfg.QuadraticPoseFactor([0, 1, 2], H, v, to_port(lin))
    assert abs(tfg.total_error(to_port(x), [tq])
               - jfg.total_error(x, [jq])) <= TOL
    jH, jb, _ = jfg.build_normal_equations(x, [jq], [0, 1, 2])
    tH, tb, _ = tfg.build_normal_equations(to_port(x), [tq], [0, 1, 2])
    np.testing.assert_allclose(tH, jH, rtol=0, atol=TOL)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=TOL)


def native_rows(n_steps=80):
    _, meas = simulate(n_steps=n_steps)
    bg, ba = BIAS
    return np.asarray([[dt, *(a + ba), *(w + bg)] for a, w, dt in meas])


@pytest.mark.parametrize("reference", ["port_numpy", "jax_numpy"])
def test_native_preintegration_matches_numpy(reference):
    rows = native_rows()
    mod = timu if reference == "port_numpy" else jimu
    ref = mod.Preintegration(mod.ImuParams(), bg=BIAS[0], ba=BIAS[1])
    for row in rows:
        ref.integrate(row[1:4], row[4:7], row[0])
    nat = timu.Preintegration(timu.ImuParams(), bg=BIAS[0], ba=BIAS[1])
    imu_native.integrate_batch(nat, rows)
    for f in ("dR", "dv", "dp", "J_Rbg", "J_vbg", "J_vba", "J_pba"):
        np.testing.assert_allclose(getattr(nat, f), getattr(ref, f),
                                   rtol=0, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(nat.J_pbg, ref.J_pbg, rtol=0, atol=1e-10)
    np.testing.assert_allclose(nat.cov, ref.cov, rtol=1e-8, atol=1e-14)
    assert abs(nat.dt - ref.dt) < 1e-12
    # the raw rows are logged for re-integration (merge, VI init)
    assert len(nat.meas) == len(rows)
    np.testing.assert_array_equal(nat.meas[3][0], rows[3, 1:4])


def test_native_library_is_built_into_build_dir():
    lib = imu_native.get_lib()
    path = imu_native.library_path()
    assert path.is_file() and path.parent.name == "torch_kernels"
    assert path.parent.parent.name == "build"
    assert lib.preintegrate is not None


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent numpy fallback: a build that fails raises."""
    monkeypatch.setattr(imu_native, "_cxx", lambda: "false")
    monkeypatch.setattr(imu_native, "library_path",
                        lambda: tmp_path / "libpreintegrate-x.so")
    imu_native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="preintegrate.cpp"):
            imu_native.get_lib()
        pre = timu.Preintegration(timu.ImuParams())
        with pytest.raises(RuntimeError):
            imu_native.integrate_batch(pre, native_rows(4))
    finally:
        imu_native.get_lib.cache_clear()
