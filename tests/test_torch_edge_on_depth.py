"""Why the two packages render a near edge-on surfel at different depths.

`tests/test_torch_multicard.py::test_dp_train_loop_dp4_matches_jax`
(padding_rank) holds the depth metric to 1e-2: after its 3rd iteration
both packages render pixel (row 24, column 23) of keyframe 2 behind
surfel 198 of the map, seen almost edge-on, at depth 156.89 (port) and
154.61 (JAX). This file pins the cause on that surfel and that camera,
copied here bit for bit (float32) from the JAX state after those 3
iterations.

Both packages compute the same formulas: `project_surfels` packs the
scaled normal n = a_u x a_v and c . n, and the ray-splat intersection
takes z = (c . n) / (n . q) with q = ((px - cx) / fx, (py - cy) / fy, 1).
At this pixel n . q is -7.42e-7 against terms of 0.068: its condition
number kappa = sum |n_k q_k| / |n . q| is 9.18e4. Each package's packed
n lies within 11 ulp of the float64 projection, with errors of opposite
sign, and kappa turns those few ulp into 0.9 % (JAX) and 0.6 % (port) of
the true z = 12064.7. On the same packed row the two packages'
intersections agree. So the depth divergence is f32 rounding of an
ill-conditioned intersection in both packages, not a fault of the port:
neither package is nearer the float64 truth by construction."""

import numpy as np
import jax.numpy as jnp
import torch

from vings_mono_tpu.mapper.cameras import make_camera as j_make_camera
from vings_mono_tpu.ops.rasterizer import projection as jproj
from vings_mono_tpu.ops.rasterizer import tile_kernel as jtk
from vings_mono_tpu_torch.mapper.cameras import make_camera
from vings_mono_tpu_torch.ops.rasterizer import projection as tproj
from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as ttk

H = W = 32
INTR4 = (30.0, 30.0, 16.0, 16.0)          # test_torch_parallel's camera
PIXEL = (24, 23)                          # (row, column)
# keyframe 2's world-to-camera (tests/synthetic.make_viz_out, rng 11)
W2C = [[0.9997172951698303, 0.021206211298704147, -0.010752738453447819,
        0.3692311942577362],
       [-0.02120419591665268, 0.9997751116752625, 0.0003014293615706265,
        -0.008050935342907906],
       [0.010756714269518852, -7.334096153499559e-05, 0.9999421238899231,
        0.045578666031360626],
       [0.0, 0.0, 0.0, 1.0]]
# surfel 198 of the JAX map after 3 iterations of the dp = 4 train loop
SURFEL = {
    "xyz": [0.8670127987861633, 1.0377585887908936, 4.2324042320251465],
    "log_scale": [-1.0823904275894165, -1.0823955535888672],
    "quat": [-0.25042980909347534, 0.40607452392578125, 0.2983841598033905,
             0.27269062399864197],
    "logit_opacity": [-2.314574956893921],
    "rgb": [0.2521795630455017, 0.4716579020023346, 0.41130632162094116],
}
ARGS = ("xyz", "log_scale", "quat", "logit_opacity", "rgb")
EPS32 = float(np.finfo(np.float32).eps) / 2      # unit roundoff, 2^-24
ULPS = 16       # the packed n's allowed error against float64, in ulp


def projections():
    """Each package's packed row of the surfel under keyframe 2's camera."""
    w2c = np.asarray(W2C, np.float32)
    arr = {k: np.asarray([v], np.float32) for k, v in SURFEL.items()}
    jp = jproj.project_surfels(
        *[jnp.asarray(arr[k]) for k in ARGS],
        j_make_camera(jnp.asarray(w2c), jnp.asarray(INTR4), H, W))
    tp = tproj.project_surfels(
        *[torch.tensor(arr[k]) for k in ARGS],
        make_camera(torch.tensor(w2c), INTR4, H, W))
    assert bool(jp.visible[0]) and bool(tp.visible[0])
    return np.asarray(jp.packed)[0], tp.packed[0].numpy()


def truth():
    """n, c . n and the ray q in float64, by the same formulas."""
    w2c = np.asarray(W2C, np.float32).astype(np.float64)
    s = {k: np.asarray(v, np.float32).astype(np.float64)
         for k, v in SURFEL.items()}
    w, x, y, z = s["quat"] / np.linalg.norm(s["quat"])
    rg = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    scale = np.exp(s["log_scale"])
    c = w2c[:3, :3] @ s["xyz"] + w2c[:3, 3]
    rc = w2c[:3, :3] @ rg
    n = np.cross(rc[:, 0] * scale[0], rc[:, 1] * scale[1])
    fx, fy, cx, cy = INTR4
    q = np.array([(PIXEL[1] - cx) / fx, (PIXEL[0] - cy) / fy, 1.0])
    return n, c, float(c @ n), q


def z_port(row):
    d = torch.tensor(row)[None, None, :]
    px, py = float(PIXEL[1]), float(PIXEL[0])
    fx, fy, cx, cy = INTR4
    qx = torch.full((1, 1, 1), (px - cx) / fx)
    qy = torch.full((1, 1, 1), (py - cy) / fy)
    alpha, z, _ = ttk._coverage(d, qx, qy, torch.full((1, 1, 1), px),
                                torch.full((1, 1, 1), py))
    return float(alpha.reshape(())), float(z.reshape(()))


def z_jax(row):
    data = jnp.asarray(row)[:, None]                 # (PK_PAD, 1)
    px, py = float(PIXEL[1]), float(PIXEL[0])
    fx, fy, cx, cy = INTR4
    one = lambda v: jnp.full((1, 1), v, jnp.float32)
    alpha, z, _ = jtk._coverage(data, one((px - cx) / fx),
                                one((py - cy) / fy), one(px), one(py))
    return float(alpha.reshape(())), float(z.reshape(()))


def test_edge_on_depth_is_f32_conditioning():
    jrow, trow = projections()
    n, c, cn, q = truth()
    terms = np.abs(n * q)
    den = float(n @ q)
    kappa = terms.sum() / abs(den)
    z64 = cn / den
    # the intersection is ill-conditioned at this pixel: kappa 9.18e4
    assert 9.0e4 <= kappa <= 9.4e4, kappa
    n_sl, cn_col = slice(6, 9), 9
    bounds = {}
    for name, row in (("jax", jrow), ("port", trow)):
        # the projection is f32-accurate in both packages: n within ULPS
        # ulp of float64 per component, c . n within ULPS roundings of
        # its terms
        dn = row[n_sl].astype(np.float64) - n
        ulp = np.spacing(np.abs(row[n_sl]))
        assert np.all(np.abs(dn) <= ULPS * ulp), (name, dn / ulp)
        dcn = float(row[cn_col]) - cn
        assert abs(dcn) <= ULPS * EPS32 * np.abs(c * n).sum(), (name, dcn)
        # first-order bound of z's relative error from the packed row's
        # own rounding (dn, dcn) and the intersection's (three products
        # summed: 3 roundings of the terms, one of the quotient)
        bounds[name] = (np.abs(dn * q).sum() + 3 * EPS32 * terms.sum()) \
            / abs(den) + abs(dcn / cn) + 2 * EPS32
    alpha_j, zj = z_jax(jrow)
    alpha_t, zt = z_port(trow)
    for name, z in (("jax", zj), ("port", zt)):
        rel = abs(z - z64) / abs(z64)
        assert rel <= bounds[name], (name, z, z64, rel, bounds[name])
    # they part by far more than a float32 rounding of z, by what kappa
    # makes of a few ulp of n: here 1.5 % of z
    assert abs(zt - zj) / abs(z64) > 1e3 * EPS32
    assert abs(zt - zj) / abs(z64) <= bounds["jax"] + bounds["port"]
    assert alpha_j > 0 and alpha_t > 0
    # the same packed row through both packages' intersections: equal up
    # to the intersection's own rounding
    for row in (jrow, trow):
        (aj, zj_), (at, zt_) = z_jax(row), z_port(row)
        assert abs(zj_ - zt_) <= 4 * EPS32 * kappa * abs(zj_), (zj_, zt_)
        assert abs(aj - at) <= 1e-6
