"""Port parity for the mapper's ops: SSIM, kNN, losses, sparse Adam, row
writes, densify with the JAX draws injected, and the training loop and its
controls with the JAX keyframe draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_viz_out
from vings_mono_tpu.ops.ssim import ssim as j_ssim
from vings_mono_tpu.ops.knn import knn_mean_sq_dist as j_knn
from vings_mono_tpu.mapper import state as jst
from vings_mono_tpu.mapper import train as jtr
from vings_mono_tpu.mapper.cameras import make_camera as j_make_camera
from vings_mono_tpu.mapper.densify import add_frame as j_add_frame
from vings_mono_tpu.mapper.losses import (mapper_loss as j_loss,
                                          psnr as j_psnr)
from vings_mono_tpu_torch.ops.ssim import ssim
from vings_mono_tpu_torch.ops.knn import knn_mean_sq_dist
from vings_mono_tpu_torch.mapper import state as tst
from vings_mono_tpu_torch.mapper import train as ttr
from vings_mono_tpu_torch.mapper.cameras import make_camera
from vings_mono_tpu_torch.mapper.densify import _median, add_frame
from vings_mono_tpu_torch.mapper.losses import mapper_loss, psnr

H = W = 32
F = 30.0
INTR4 = (F, F, W / 2, H / 2)
CAP = 2048
BIN = {"p_cap": 4096, "chunk": 64, "side": 3, "v_cap": 1024,
       "tile_cap": 512}
J_RKW = tuple(BIN.items()) + (("impl", "tile"), ("interpret", True))
T_RKW = tuple(BIN.items())
LRS = {"xyz": 1e-5, "rgb": 1e-4, "log_scale": 1e-3, "quat": 1e-3,
       "logit_opacity": 5e-2}


def t(x, dtype=None):
    return torch.tensor(np.array(x), dtype=dtype)


def to_torch_state(js):
    return tst.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in tst.STATE_FIELDS}, "cpu")


def assert_state_close(ts, js, atol=1e-5, fields=tst.STATE_FIELDS):
    for f in fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if a.dtype in (bool, np.int32):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol,
                                       err_msg=f)


@pytest.fixture(scope="module")
def window():
    viz, _ = make_viz_out(np.random.default_rng(11), n_kf=3, H=H, W=W)
    return viz


def test_ssim_matches():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, H, W + 8)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(H, W + 8)) > 0.3
    for m in (None, mask):
        ref = float(j_ssim(jnp.asarray(a), jnp.asarray(b),
                           None if m is None else jnp.asarray(m)))
        got = float(ssim(t(a), t(b), None if m is None else t(m)))
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_knn_matches():
    rng = np.random.default_rng(1)
    # far from the origin: the centring keeps f32 from cancelling
    pts = (rng.normal(size=(700, 3)) * 0.05 + [40.0, -3.0, 60.0]).astype(
        np.float32)
    valid = rng.uniform(size=700) > 0.2
    ref = np.asarray(j_knn(jnp.asarray(pts), jnp.asarray(valid), chunk=256))
    got = knn_mean_sq_dist(t(pts), t(valid), chunk=256).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-9)
    assert np.all(got[~valid] == 0) and np.all(got[valid] > 0)


def test_loss_and_psnr_match(window):
    rng = np.random.default_rng(2)
    rets = {"rgb": rng.uniform(0, 1, (3, H, W)),
            "depth": rng.uniform(3, 6, (1, H, W)),
            "accum": rng.uniform(0, 1, (1, H, W)),
            "normal": rng.normal(size=(3, H, W)),
            "dist": rng.uniform(0, 1e-3, (1, H, W))}
    rets = {k: v.astype(np.float32) for k, v in rets.items()}
    gt_rgb = np.moveaxis(window["images"][0], -1, 0)
    gt_d = np.moveaxis(window["depths"][0], -1, 0)
    cov = np.moveaxis(window["depths_cov"][0], -1, 0)
    pm = rng.uniform(size=(H, W)) > 0.1
    w2c = np.linalg.inv(window["poses"][0]).astype(np.float32)
    weights = {"rgb_loss": 1.0, "depth_loss": 1.0, "alpha_loss": 1.0,
               "normal_loss": 0.1, "dist_loss": 0.0}
    jt_, jm = j_loss({k: jnp.asarray(v) for k, v in rets.items()},
                     jnp.asarray(gt_rgb), jnp.asarray(gt_d),
                     jnp.asarray(cov),
                     j_make_camera(jnp.asarray(w2c), jnp.asarray(INTR4), H,
                                   W), weights, pixel_mask=jnp.asarray(pm))
    tt_, tm = mapper_loss({k: t(v) for k, v in rets.items()}, t(gt_rgb),
                          t(gt_d), t(cov), make_camera(t(w2c), INTR4, H, W),
                          weights, pixel_mask=t(pm))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(
        float(psnr(t(rets["rgb"]), t(gt_rgb), t(gt_d[0] > 0))),
        float(j_psnr(jnp.asarray(rets["rgb"]), jnp.asarray(gt_rgb),
                     jnp.asarray(gt_d[0] > 0))), rtol=1e-6)


def test_median_averages_even_count():
    x = np.random.default_rng(3).normal(size=(1, 4, 6)).astype(np.float32)
    np.testing.assert_allclose(float(_median(t(x))),
                               float(jnp.median(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(float(_median(t(x[:, :, :5]))),
                               float(jnp.median(jnp.asarray(x[:, :, :5]))))


def _random_state(seed, n_alive=300):
    rng = np.random.default_rng(seed)
    js = jst.empty_state(CAP)
    alive = np.zeros(CAP, bool)
    alive[rng.choice(CAP, n_alive, replace=False)] = True
    return js.replace(
        xyz=jnp.asarray(rng.normal(size=(CAP, 3)), jnp.float32),
        rgb=jnp.asarray(rng.uniform(size=(CAP, 3)), jnp.float32),
        alive=jnp.asarray(alive),
        stable=jnp.asarray(rng.uniform(size=CAP) > 0.8),
        local_scores=jnp.asarray(rng.uniform(0, 0.5, (CAP, 2)), jnp.float32))


def test_sparse_adam_step_matches():
    """Three masked steps; gradients hold zeros, tiny values and non-finite
    entries. Adam's eps of 1e-15 can turn a rounding difference in a
    near-zero gradient into a flip of the whole step, so the tolerance is
    stated in units of each parameter's lr: 2 lr where a flip can
    happen, 1e-3 lr elsewhere."""
    rng = np.random.default_rng(4)
    js = _random_state(4)
    ts = to_torch_state(js)
    jo, to = jst.adam_init(js), tst.adam_init(ts)
    for _ in range(3):
        grads = {k: rng.normal(size=np.asarray(getattr(js, k)).shape)
                 .astype(np.float32) * rng.choice([0.0, 1e-12, 1.0])
                 for k in tst.PARAM_FIELDS}
        grads["xyz"][5, 1] = np.nan
        grads["rgb"][7, 0] = np.inf
        mask = rng.uniform(size=CAP) > 0.5
        js, jo = jst.sparse_adam_step(
            js, {k: jnp.asarray(v) for k, v in grads.items()}, jo,
            jnp.asarray(mask), LRS)
        tst.sparse_adam_step(ts, {k: t(v) for k, v in grads.items()}, to,
                             t(mask), LRS)
    assert to.step == int(jo.step) == 3
    for k in tst.PARAM_FIELDS:
        a, b = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
        assert np.all(np.isfinite(b)), k
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * LRS[k], err_msg=k)
        tiny = np.abs(np.asarray(jo.m[k])) < 1e-6
        np.testing.assert_allclose(b[~tiny], a[~tiny], rtol=0,
                                   atol=1e-3 * LRS[k], err_msg=k)
        np.testing.assert_allclose(to.v[k].numpy(), np.asarray(jo.v[k]),
                                   rtol=1e-5, atol=1e-30, err_msg=k)


def test_write_and_kill_rows_match():
    rng = np.random.default_rng(5)
    js = _random_state(5)
    ts = to_torch_state(js)
    jo, to = jst.adam_init(js), tst.adam_init(ts)
    n = 64
    slots = rng.choice(CAP, n, replace=False).astype(np.int32)
    valid = rng.uniform(size=n) > 0.3
    new = {k: rng.normal(size=(n,) + np.asarray(getattr(js, k)).shape[1:])
           .astype(np.float32) for k in tst.PARAM_FIELDS}
    js2, jo2 = jst.write_rows(js, jo, jnp.asarray(slots),
                              jnp.asarray(valid),
                              {k: jnp.asarray(v) for k, v in new.items()},
                              jnp.asarray(7, jnp.int32))
    ts2 = to_torch_state(js)
    to2 = tst.adam_init(ts2)
    tst.write_rows(ts2, to2, t(slots), t(valid),
                   {k: t(v) for k, v in new.items()}, 7)
    assert_state_close(ts2, js2, atol=0)
    for k in tst.PARAM_FIELDS:
        np.testing.assert_array_equal(to2.m[k].numpy(), np.asarray(jo2.m[k]))
    kill = rng.uniform(size=CAP) > 0.5
    assert_state_close(tst.kill_rows(ts2, t(kill)),
                       jst.kill_rows(js2, jnp.asarray(kill)), atol=0)


def _batch(viz, lib):
    K = viz["images"].shape[0]
    arr = {k: np.moveaxis(viz[k], -1, 1).astype(np.float32)
           for k in ("images", "depths", "depths_cov")}
    w2cs = np.linalg.inv(viz["poses"]).astype(np.float32)
    gids = np.arange(K, dtype=np.int32)
    if lib == "jax":
        return jtr.KeyframeBatch(
            **{k: jnp.asarray(v) for k, v in arr.items()},
            w2cs=jnp.asarray(w2cs), global_kf_id=jnp.asarray(gids),
            n_valid=jnp.asarray(K, jnp.int32))
    return ttr.KeyframeBatch(**{k: t(v) for k, v in arr.items()},
                             w2cs=t(w2cs), global_kf_id=t(gids), n_valid=K)


def _densify_draws(key, n):
    g = jax.random.gumbel(key, (H * W,))
    q = jax.random.normal(jax.random.fold_in(key, 1), (n, 4))
    return t(g), t(q)


def _seeded(viz, n_points=300):
    """Both packages' states after first-frame densify of keyframes 0, 1."""
    js, jo = jst.empty_state(CAP), None
    jo = jst.adam_init(js)
    ts = tst.empty_state(CAP, "cpu")
    to = tst.adam_init(ts)
    jb, tb = _batch(viz, "jax"), _batch(viz, "torch")
    for i in range(2):
        key = jax.random.PRNGKey(100 + i)
        js, jo, jn, _ = j_add_frame(
            js, jo, jb.w2cs[i], jnp.asarray(INTR4), jb.images[i],
            jb.depths[i], key, jb.global_kf_id[i], height=H, width=W,
            n_points=n_points, first=True, render_kwargs=J_RKW)
        g, q = _densify_draws(key, n_points)
        _, _, tn, _ = add_frame(
            ts, to, tb.w2cs[i], INTR4, tb.images[i], tb.depths[i],
            tb.global_kf_id[i], height=H, width=W, gumbel=g, quat_noise=q,
            n_points=n_points, first=True, render_kwargs=T_RKW)
        assert int(tn) == int(jn) > 100
    return (js, jo, jb), (ts, to, tb)


def test_add_frame_with_jax_draws(window):
    """First-frame densify, then a pruning densify of keyframe 2: slots
    exactly, values to 1e-5 (the kNN scale init to 1e-4)."""
    (js, jo, jb), (ts, to, tb) = _seeded(window)
    assert_state_close(ts, js, fields=("xyz", "rgb", "quat",
                                       "logit_opacity", "alive",
                                       "globalkf_id"))
    np.testing.assert_allclose(ts.log_scale.numpy(),
                               np.asarray(js.log_scale), atol=1e-4)
    key = jax.random.PRNGKey(7)
    js, jo, jn, jk = j_add_frame(
        js, jo, jb.w2cs[2], jnp.asarray(INTR4), jb.images[2], jb.depths[2],
        key, jb.global_kf_id[2], height=H, width=W, n_points=300,
        first=False, accum_thresh=0.98, render_kwargs=J_RKW)
    g, q = _densify_draws(key, 300)
    _, _, tn, tk = add_frame(
        ts, to, tb.w2cs[2], INTR4, tb.images[2], tb.depths[2],
        tb.global_kf_id[2], height=H, width=W, gumbel=g, quat_noise=q,
        n_points=300, first=False, accum_thresh=0.98, render_kwargs=T_RKW)
    assert (int(tn), int(tk)) == (int(jn), int(jk))
    assert_state_close(ts, js, fields=("xyz", "rgb", "quat", "alive",
                                       "logit_opacity", "globalkf_id"))


def test_train_loop_and_controls_match(window):
    """Five iterations with the JAX keyframe draws, then the stable-mask
    and storage controls. Parameters to 2 lr (Adam sign flips, see
    test_sparse_adam_step_matches), scores and metrics to 1e-3 relative."""
    (js, jo, jb), (ts, to, tb) = _seeded(window)
    j_bins = jtr.bin_stack(js, jb, jnp.asarray(INTR4), H, W, **BIN)
    t_bins = ttr.bin_stack(ts, tb, INTR4, H, W, **BIN)
    key = jax.random.PRNGKey(9)
    iters, sched, k = 5, [], key
    for _ in range(iters):
        k, k1 = jax.random.split(k)
        sched.append(int(jax.random.randint(k1, (), 0, 3)))
    weights = {"rgb_loss": 1.0, "depth_loss": 1.0, "alpha_loss": 1.0,
               "normal_loss": 0.1, "dist_loss": 0.0}
    js, jo, _, _, jm = jtr.train_loop(
        js, jo, jb, j_bins, jnp.asarray(INTR4), key, iters=iters, height=H,
        width=W, weights=weights, lrs=LRS, render_kwargs=J_RKW)
    _, _, tm = ttr.train_loop(ts, to, tb, t_bins, INTR4, iters=iters,
                              height=H, width=W, kf_schedule=sched,
                              weights=weights, lrs=LRS, render_kwargs=T_RKW)
    for k2 in ("total", "psnr", "rgb", "depth", "normal"):
        np.testing.assert_allclose(float(tm[k2]), float(jm[k2]), rtol=1e-3,
                                   err_msg=k2)
    assert tm["loss_per_iter"].shape == (iters,)
    for f in tst.PARAM_FIELDS:
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=2 * LRS[f], err_msg=f)
    for f in ("local_scores", "global_scores", "globalkf_max_scores"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3 * a.max(),
                                   err_msg=f)
    np.testing.assert_array_equal(ts.globalkf_id.numpy(),
                                  np.asarray(js.globalkf_id))
    js = jtr.stablemask_control(js)
    ttr.stablemask_control(ts)
    np.testing.assert_array_equal(ts.stable.numpy(), np.asarray(js.stable))
    assert int(torch.count_nonzero(ts.local_scores)) == 0
    js, jn = jtr.storage_control(js, jb, j_bins, jnp.asarray(INTR4),
                                 height=H, width=W, render_kwargs=J_RKW)
    _, tn = ttr.storage_control(ts, tb, t_bins, INTR4, height=H, width=W,
                                render_kwargs=T_RKW)
    assert abs(int(tn) - int(jn)) <= max(2, 0.02 * int(jn))
    assert abs(int(ts.alive.sum()) - int(js.alive.sum())) <= max(
        2, 0.02 * int(jn))
