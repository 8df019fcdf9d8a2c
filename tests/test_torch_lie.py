"""Port parity: vings_mono_tpu_torch.ops.lie / quat_wxyz against the JAX
modules on the same numpy inputs (f32, abs tolerance 1e-5 on values of
order 1), including the small-angle branches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vings_mono_tpu.ops import lie as jlie
from vings_mono_tpu.ops import quat_wxyz as jq
from vings_mono_tpu_torch.ops import lie as tlie
from vings_mono_tpu_torch.ops import quat_wxyz as tq

TOL = 1e-5


def _rng():
    return np.random.default_rng(7)


def _poses(rng, n=32, small=False):
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:, 3:] *= 1e-5 if small else 0.8
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


def _both(name, *arrays, mod=(jlie, tlie)):
    j = getattr(mod[0], name)(*[jnp.asarray(a) for a in arrays])
    t = getattr(mod[1], name)(*[torch.from_numpy(np.array(a))
                                for a in arrays])
    return np.asarray(j), t.numpy()


UNARY_POSE = ["se3_inv", "se3_log", "se3_matrix", "se3_adjoint"]


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("name", UNARY_POSE)
def test_pose_functions(name, small):
    j, t = _both(name, _poses(_rng(), small=small))
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, atol=TOL)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-5, 0.0])
@pytest.mark.parametrize("name", ["so3_exp", "_so3_left_jacobian",
                                  "_so3_left_jacobian_inv"])
def test_so3_small_angle_branches(name, scale):
    phi = (_rng().normal(size=(16, 3)) * scale).astype(np.float32)
    j, t = _both(name, phi)
    # at |phi| ~ 1e-3 the closed forms (1 - cos)/theta^2 and
    # (theta - sin)/theta^3 cancel to ~10 % in f32 in either package; their
    # coefficients multiply K ~ 1e-3, so the two agree to 3e-4 there
    np.testing.assert_allclose(t, j, atol=3e-4 if scale == 1e-3 else TOL)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-7, 0.0])
def test_so3_log_and_exp_roundtrip(scale):
    phi = (_rng().normal(size=(16, 3)) * scale).astype(np.float32)
    q = np.array(jlie.so3_exp(jnp.asarray(phi)))
    q[::2] *= -1                      # both hemispheres
    j, t = _both("so3_log", q)
    np.testing.assert_allclose(t, j, atol=TOL)
    np.testing.assert_allclose(t, phi, atol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 1e-5])
def test_se3_exp_retr(scale):
    rng = _rng()
    xi = (rng.normal(size=(16, 6)) * scale).astype(np.float32)
    j, t = _both("se3_exp", xi)
    np.testing.assert_allclose(t, j, atol=TOL)
    j, t = _both("se3_retr", _poses(rng, 16), xi)
    np.testing.assert_allclose(t, j, atol=TOL)


def test_binary_pose_functions():
    rng = _rng()
    a, b = _poses(rng), _poses(rng)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    J = rng.normal(size=(32, 2, 6)).astype(np.float32)
    for name, args in (("se3_mul", (a, b)), ("se3_act", (a, x)),
                       ("se3_adjT_apply", (a, J)),
                       ("quat_mul", (a[:, 3:], b[:, 3:])),
                       ("quat_rotate", (a[:, 3:], x))):
        j, t = _both(name, *args)
        np.testing.assert_allclose(t, j, atol=TOL, err_msg=name)


def test_matrix_roundtrip_all_shepperd_branches():
    rng = _rng()
    # rotations by ~pi about each axis reach the three non-trace branches
    xi = np.zeros((7, 6), np.float32)
    xi[:, :3] = rng.normal(size=(7, 3))
    xi[0, 3:] = [0.3, -0.2, 0.1]
    for k in range(3):
        xi[1 + k, 3 + k] = 3.1
        xi[4 + k, 3 + k] = -3.0
    p = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    M = np.asarray(jlie.se3_matrix(jnp.asarray(p)))
    j, t = _both("se3_from_matrix", M)
    np.testing.assert_allclose(t, j, atol=TOL)
    np.testing.assert_allclose(
        tlie.se3_matrix(torch.from_numpy(t)).numpy(), M, atol=TOL)


def test_identity_constructors():
    assert tlie.se3_identity((3,)).tolist() == \
        np.asarray(jlie.se3_identity((3,))).tolist()
    assert tlie.quat_identity((2,)).tolist() == \
        np.asarray(jlie.quat_identity((2,))).tolist()


@pytest.mark.parametrize("name", ["mul", "from_xyzw", "to_xyzw",
                                  "normal_to_quat", "normalize",
                                  "to_matrix"])
def test_quat_wxyz(name):
    rng = _rng()
    q1 = rng.normal(size=(16, 4)).astype(np.float32)
    q2 = rng.normal(size=(16, 4)).astype(np.float32)
    if name == "mul":
        args = (q1, q2)
    elif name == "normal_to_quat":
        n = rng.normal(size=(16, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        n[0] = [0, 0, -1]             # the degenerate flip
        n[1] = [0, 0, 1]
        args = (n,)
    else:
        args = (q1,)
    j, t = _both(name, *args, mod=(jq, tq))
    np.testing.assert_allclose(t, j, atol=TOL)
