"""Port parity: ops.projective against the JAX module on the same numpy
inputs. Coordinates and Jacobians are held to 1e-5 relative to each
array's largest magnitude (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vings_mono_tpu.ops import lie as jlie
from vings_mono_tpu.ops import projective as jp
from vings_mono_tpu_torch.ops import projective as tp

REL = 1e-5


def problem(seed=0, P=4, H=12, W=16, per_frame_intr=False):
    rng = np.random.default_rng(seed)
    xi = np.zeros((P, 6), np.float32)
    xi[1:, :3] = rng.normal(size=(P - 1, 3)) * 0.2
    xi[1:, 3:] = rng.normal(size=(P - 1, 3)) * 0.05
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    disps = rng.uniform(0.05, 2.0, size=(P, H, W)).astype(np.float32)
    intr = np.asarray([20.0, 21.0, W / 2, H / 2], np.float32)
    if per_frame_intr:
        intr = intr[None] * rng.uniform(0.9, 1.1, (P, 1)).astype(np.float32)
    # all ordered pairs, self edges included (they take self_motion)
    ii, jj = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    return poses, disps, intr, ii.reshape(-1).astype(np.int32), \
        jj.reshape(-1).astype(np.int32)


def close(t, j, what):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape, what
    scale = max(1.0, float(np.abs(j).max()))
    assert float(np.abs(t - j).max()) <= REL * scale, \
        (what, float(np.abs(t - j).max()), scale)


def to_t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def test_coords_grid_and_iproj():
    close(tp.coords_grid(5, 7), jp.coords_grid(5, 7), "coords_grid")
    poses, disps, intr, ii, jj = problem(per_frame_intr=True)
    close(tp.iproj(*to_t(disps, intr)),
          jp.iproj(jnp.asarray(disps), jnp.asarray(intr)), "iproj")


@pytest.mark.parametrize("per_frame_intr", [False, True])
@pytest.mark.parametrize("return_depth", [False, True])
def test_projective_transform_with_jacobians(per_frame_intr, return_depth):
    args = problem(1, per_frame_intr=per_frame_intr)
    jc, jv, (jJi, jJj, jJz) = jp.projective_transform(
        *[jnp.asarray(a) for a in args], jacobian=True,
        return_depth=return_depth)
    tc, tv, (tJi, tJj, tJz) = tp.projective_transform(
        *to_t(*args), jacobian=True, return_depth=return_depth)
    close(tc, jc, "coords")
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < float(tv.mean()) <= 1
    for t, j, what in ((tJi, jJi, "Ji"), (tJj, jJj, "Jj"), (tJz, jJz, "Jz")):
        close(t, j, what)


def test_min_depth_clamp_and_validity():
    """Points behind or close to the target camera: Z is clamped to 1 in
    the projection and the pixel is marked invalid."""
    poses, disps, intr, ii, jj = problem(2)
    poses = poses.copy()
    poses[1, 2] = -3.0          # camera 1 moved far forward: Z1 < MIN_DEPTH
    jc, jv = jp.projective_transform(
        *[jnp.asarray(a) for a in (poses, disps, intr, ii, jj)])
    tc, tv = tp.projective_transform(*to_t(poses, disps, intr, ii, jj))
    assert float(np.asarray(jv).mean()) < 0.9
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    close(tc, jc, "coords")


def test_self_motion_on_self_edges():
    poses, disps, intr, _, _ = problem(3)
    ii = np.asarray([0, 1, 2], np.int32)
    sm = np.asarray([-0.3, 0.1, 0, 0, 0, 0, 1.0], np.float32)
    for motion in (None, sm):
        kw_j = {} if motion is None else {"self_motion": jnp.asarray(motion)}
        kw_t = {} if motion is None else {
            "self_motion": torch.from_numpy(motion)}
        jc, _ = jp.projective_transform(
            *[jnp.asarray(a) for a in (poses, disps, intr, ii, ii)], **kw_j)
        tc, _ = tp.projective_transform(*to_t(poses, disps, intr, ii, ii),
                                        **kw_t)
        close(tc, jc, "self edges")
        # not the identity flow: the planted motion moves the points
        assert float((tc - tp.coords_grid(12, 16)).abs().max()) > 1e-2


@pytest.mark.parametrize("beta", [0.3, 0.25])
def test_induced_flow_and_frame_distance(beta):
    args = problem(4)
    jf, jv = jp.induced_flow(*[jnp.asarray(a) for a in args])
    tf, tv = tp.induced_flow(*to_t(*args))
    close(tf, jf, "flow")
    jd = jp.frame_distance(*[jnp.asarray(a) for a in args], beta=beta)
    td = tp.frame_distance(*to_t(*args), beta=beta)
    close(td, jd, "frame_distance")
