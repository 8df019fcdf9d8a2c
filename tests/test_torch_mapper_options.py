"""Port parity for the mapper's options: the sky sphere (`mapper/sky.py`,
the sky branch of `mapper_loss` and of the train loop), pose refinement
(`mapper/refine.py`), the coarse-to-fine phase (`pool2x2`, `half_batch`,
`half_intr4` and the mapper's second binning cache) and
`train_on_window`, against the JAX package on the same numpy inputs, with
the JAX random draws replayed into the port. Tolerances are stated per
test; whole mapper keyframes are held to tests/test_torch_slice.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_viz_out
from test_torch_slice import OVERRIDES, H, W, JaxDraws, port_mapper
from vings_mono_tpu.mapper import losses as jlosses
from vings_mono_tpu.mapper import refine as jrefine
from vings_mono_tpu.mapper import sky as jsky
from vings_mono_tpu.mapper import state as jstate
from vings_mono_tpu.mapper import train as jtrain
from vings_mono_tpu.mapper.cameras import make_camera as j_make_camera
from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
from vings_mono_tpu.mapper.mapper import _intr4 as j_intr4
from vings_mono_tpu.ops import lie as jlie
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch.mapper import losses, refine, sky, state, train
from vings_mono_tpu_torch.mapper.cameras import make_camera
from vings_mono_tpu_torch.mapper.mapper import _intr4
from vings_mono_tpu_torch.ops.rasterizer.binning import BinnedScene, num_tiles
from vings_mono_tpu_torch.utils.config import load_config

INTR4 = (30.0, 30.0, W / 2, H / 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def sky_windows():
    """tests/test_torch_slice.py's windows with the top quarter of every
    image marked sky as the middleware marks it: depth 0 and rgb 0."""
    viz, _ = make_viz_out(np.random.default_rng(3), n_kf=3, H=H, W=W)
    viz["depths"][:, :H // 4] = 0.0
    viz["images"][:, :H // 4] = 0.0
    first = {k: (v[:2] if isinstance(v, np.ndarray) and k != "intrinsic"
                 else v) for k, v in viz.items()}
    return [first, viz]


def test_pool_half_batch_half_intr4_exact():
    """pool2x2, half_batch (pixel mask included) and half_intr4 equal the
    JAX package's bit for bit."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(2, 3, H, W)).astype(np.float32)
    dep = rng.uniform(size=(2, 1, H, W)).astype(np.float32)
    cov = rng.uniform(size=(2, 1, H, W)).astype(np.float32)
    pm = rng.uniform(size=(2, H, W)) > 0.2
    w2c = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    jb = jtrain.KeyframeBatch(jnp.asarray(imgs), jnp.asarray(dep),
                              jnp.asarray(cov), jnp.asarray(w2c),
                              jnp.zeros(2, jnp.int32), jnp.asarray(2),
                              jnp.asarray(pm))
    tb = train.KeyframeBatch(t(imgs), t(dep), t(cov), t(w2c),
                             torch.zeros(2, dtype=torch.int32), 2, t(pm))
    np.testing.assert_array_equal(train.pool2x2(t(imgs)).numpy(),
                                  np.asarray(jtrain.pool2x2(imgs)))
    jh, th = jtrain.half_batch(jb), train.half_batch(tb)
    for f in ("images", "depths", "depths_cov", "pixel_mask"):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)), err_msg=f)
    intr = {"fu": 221.3, "fv": 461.4, "cu": 117.7, "cv": 392.9}
    np.testing.assert_array_equal(
        np.asarray(train.half_intr4(_intr4(intr)), np.float32),
        np.asarray(jtrain.half_intr4(j_intr4(intr))))


def test_fuse_rgb_and_sky_loss():
    """fuse_rgb exactly; mapper_loss with sky_rgb (and a pixel mask) within
    1e-5 relative of JAX's, every term."""
    rng = np.random.default_rng(1)
    rets = {"rgb": rng.uniform(size=(3, H, W)),
            "accum": rng.uniform(size=(1, H, W)),
            "depth": rng.uniform(1, 3, size=(1, H, W)),
            "normal": rng.normal(size=(3, H, W)),
            "dist": rng.uniform(size=(1, H, W)) * 1e-3}
    rets = {k: v.astype(np.float32) for k, v in rets.items()}
    srgb = {"rgb": rng.uniform(size=(3, H, W)).astype(np.float32)}
    np.testing.assert_array_equal(
        sky.fuse_rgb({k: t(v) for k, v in rets.items()},
                     {"rgb": t(srgb["rgb"])}).numpy(),
        np.asarray(jsky.fuse_rgb(rets, srgb)))
    gt = rng.uniform(size=(3, H, W)).astype(np.float32)
    gt[:, :8] = 0.0
    gt_d = rng.uniform(1, 3, size=(1, H, W)).astype(np.float32)
    gt_d[:, :8] = 0.0
    cov = rng.uniform(0.01, 0.1, size=(1, H, W)).astype(np.float32)
    sky_gt = rng.uniform(size=(3, H, W)).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    for pm in (None, rng.uniform(size=(H, W)) > 0.1):
        _, jm = jlosses.mapper_loss(
            {k: jnp.asarray(v) for k, v in rets.items()}, jnp.asarray(gt),
            jnp.asarray(gt_d), jnp.asarray(cov),
            j_make_camera(jnp.asarray(w2c), jnp.asarray(INTR4), H, W),
            sky_rgb=jnp.asarray(sky_gt),
            pixel_mask=None if pm is None else jnp.asarray(pm))
        _, tm = losses.mapper_loss(
            {k: t(v) for k, v in rets.items()}, t(gt), t(gt_d), t(cov),
            make_camera(t(w2c), INTR4, H, W), sky_rgb=t(sky_gt),
            pixel_mask=None if pm is None else t(pm))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_sky_add_frame_writes_same_rows():
    """sky_add_frame on an empty sphere with the JAX key's gumbel scores and
    quaternion noise injected: the same rows written, parameters within
    1e-5 (log scales 1e-4: a kNN of unit directions); the sphere rendered
    by render_sky within 1e-4."""
    viz = sky_windows()[1]
    gt = np.moveaxis(viz["images"][0], -1, 0)
    w2c = np.linalg.inv(viz["poses"][0]).astype(np.float32)
    n = 200
    key = jax.random.PRNGKey(5)
    js = jstate.empty_state(512)
    js, _, jn = jsky.sky_add_frame(js, jstate.adam_init(js),
                                   jnp.asarray(w2c), jnp.asarray(INTR4),
                                   jnp.asarray(gt), key, height=H, width=W,
                                   n_points=n)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (H * W,))))
    q = torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(key, 1), (n, 4))))
    ts = state.empty_state(512, "cpu")
    tn = sky.sky_add_frame(ts, state.adam_init(ts), t(w2c), INTR4, t(gt),
                           height=H, width=W, gumbel=g, quat_noise=q,
                           n_points=n)
    assert int(tn) == int(jn) > 50
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    m = np.asarray(js.alive)
    for f, tol in (("xyz", 1e-5), ("rgb", 1e-6), ("quat", 1e-6),
                   ("log_scale", 1e-4), ("logit_opacity", 1e-6)):
        np.testing.assert_allclose(getattr(ts, f).numpy()[m],
                                   np.asarray(getattr(js, f))[m], atol=tol,
                                   err_msg=f)
    # the render parameters put every live row on the radius-10 sphere,
    # and render_sky draws it as JAX does (rgb and alpha within 1e-4)
    xyz, _ = sky.sky_render_params(ts)
    np.testing.assert_allclose(torch.linalg.norm(xyz[ts.alive], dim=-1),
                               10.0, rtol=1e-5)
    kw = {"p_cap": 8192, "chunk": 64, "side": 3}
    jr = jsky.render_sky(js, j_make_camera(jnp.asarray(w2c),
                                           jnp.asarray(INTR4), H, W),
                         interpret=True, **kw)
    tr = sky.render_sky(ts, make_camera(t(w2c), INTR4, H, W), **kw)
    for k in ("rgb", "accum"):
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                   atol=1e-4, err_msg=k)
    assert float(tr["accum"].max()) > 0.1


def test_apply_pose_bias_to_gaussians():
    """Rows attributed to window keyframes move rigidly by each keyframe's
    correction, others stay: xyz and quat within 1e-5 of JAX's."""
    rng = np.random.default_rng(4)
    cap, K = 300, 3
    js = jstate.empty_state(cap)
    js = js.replace(
        xyz=jnp.asarray(rng.normal(size=(cap, 3)), jnp.float32),
        quat=jnp.asarray(rng.normal(size=(cap, 4)), jnp.float32),
        globalkf_id=jnp.asarray(rng.integers(0, 6, size=cap), jnp.int32))
    old = np.asarray(jlie.se3_matrix(jlie.se3_exp(jnp.asarray(
        rng.normal(size=(K, 6)) * 0.3, jnp.float32))))
    new = old @ np.asarray(jlie.se3_matrix(jlie.se3_exp(jnp.asarray(
        rng.normal(size=(K, 6)) * 0.05, jnp.float32))))
    gids = np.asarray([1, 4, 2], np.int32)
    jout = jrefine.apply_pose_bias_to_gaussians(
        js, jnp.asarray(gids), jnp.asarray(old), jnp.asarray(new))
    ts = state.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in state.STATE_FIELDS}, "cpu")
    refine.apply_pose_bias_to_gaussians(ts, t(gids), t(old), t(new))
    np.testing.assert_allclose(ts.xyz.numpy(), np.asarray(jout.xyz),
                               atol=1e-5)
    np.testing.assert_allclose(ts.quat.numpy(), np.asarray(jout.quat),
                               atol=1e-5)
    still = ~np.isin(np.asarray(js.globalkf_id), gids)
    np.testing.assert_array_equal(ts.xyz.numpy()[still],
                                  np.asarray(js.xyz)[still])


def _configs(extra):
    jc = j_load_config(overrides={
        **OVERRIDES, **extra,
        "mapper": {**OVERRIDES["mapper"], **extra.get("mapper", {}),
                   "interpret": True}})
    tc = load_config(overrides={
        **OVERRIDES, **extra,
        "mapper": {**OVERRIDES["mapper"], **extra.get("mapper", {})}})
    return jc, tc


def test_refine_poses_matches_jax():
    """refine_poses on a trained map with one keyframe's pose perturbed by
    a known SE3: the refined c2w within 1e-3 of JAX's; the gradient with
    respect to xi runs through the plain twins of both tile kernels."""
    jc, tc = _configs({})
    jm = JMapper(jc)
    wins = sky_windows()
    jm.run(wins[0])
    viz = dict(wins[1])
    pert = np.asarray(jlie.se3_matrix(jlie.se3_exp(jnp.asarray(
        [0.02, -0.01, 0.015, 0.01, -0.008, 0.005], jnp.float32))))
    viz["poses"] = viz["poses"].copy()
    viz["poses"][1] = viz["poses"][1] @ pert
    jbatch = jm._pack_batch(viz)
    intr = viz["intrinsic"]
    jb = jtrain.bin_stack(jm.state, jbatch, j_intr4(intr), H, W,
                          **jm.bin_kwargs)
    jnew, _ = jrefine.refine_poses(jm.state, jbatch, jb, j_intr4(intr),
                                   iters=20, height=H, width=W,
                                   render_kwargs=jm.render_kwargs)
    tm = port_mapper(tc)
    tm.state = state.state_from_numpy(
        {f: np.asarray(getattr(jm.state, f)) for f in state.STATE_FIELDS},
        "cpu")
    tm.H, tm.W = H, W
    tbatch = tm._pack_batch(viz)
    tb = train.bin_stack(tm.state, tbatch, _intr4(intr), H, W,
                         **tm.bin_kwargs)
    tnew, xi = refine.refine_poses(tm.state, tbatch, tb, _intr4(intr),
                                   iters=20, height=H, width=W,
                                   render_kwargs=tm.render_kwargs)
    assert float(torch.abs(xi).max()) > 1e-3
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), atol=1e-3)


def _run_both(extra, windows, check):
    jc, tc = _configs(extra)
    jm, tm = JMapper(jc), port_mapper(tc)
    for viz in windows:
        jm.run(viz)
        tm.run(viz)
        jmet, tmet = jm.last_metrics, tm.last_metrics
        jn, tn = jm.n_alive, tm.n_alive
        assert jn > 300
        assert abs(tn - jn) <= 0.01 * jn, (tn, jn)
        assert abs(tmet["total"] - jmet["total"]) <= 0.01 * abs(
            jmet["total"]), (tmet["total"], jmet["total"])
        assert abs(tmet["psnr"] - jmet["psnr"]) <= 0.1, (tmet["psnr"],
                                                         jmet["psnr"])
        check(jm, tm)
    return jm, tm


def test_mapper_run_with_sky():
    """use_sky: per keyframe at test_torch_slice's tolerances (Gaussians
    1 %, loss 1 %, PSNR 0.1 dB); the sphere's live rows within 1 %."""
    def check(jm, tm):
        js, ts = int(jm.sky.state.n_alive()), int(tm.sky.state.n_alive())
        assert js > 50 and abs(ts - js) <= 0.01 * js, (ts, js)
    _run_both({"use_sky": True, "mapper": {"sky_capacity": 512}},
              sky_windows(), check)


def test_mapper_run_with_refine():
    """use_refine: per keyframe at test_torch_slice's tolerances; the
    refined c2w poses within 1e-3 of JAX's."""
    def check(jm, tm):
        np.testing.assert_allclose(tm.refined_poses.numpy(),
                                   np.asarray(jm.refined_poses), atol=1e-3)
    _run_both({"use_refine": True}, sky_windows(), check)


def _pose_error(c2w, ref):
    d = np.linalg.inv(ref) @ c2w
    cos = np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)
    return float(np.linalg.norm(d[:3, 3])), float(np.degrees(np.arccos(cos)))


def _port_binned(jb):
    """A stacked JAX BinnedScene as the port's, with the port-only
    `tile_chunks` (each tile's first chunk) from the chunk tiles."""
    ty, tx = num_tiles(H, W)
    f = {k: None if getattr(jb, k) is None
         else torch.from_numpy(np.array(getattr(jb, k))) for k in jb._fields}
    tiles = torch.arange(ty * tx + 1, dtype=torch.int32)
    f["tile_chunks"] = torch.stack([
        torch.searchsorted(f["chunk_tile"][r, :int(f["n_chunks"][r])]
                           .contiguous(), tiles).to(torch.int32)
        for r in range(f["chunk_tile"].shape[0])])
    return BinnedScene(**f)


def test_refine_in_perturbed_replay_as_jax(monkeypatch):
    """A replay with one keyframe's pose perturbed by a known SE3 in every
    window that holds it, the first time as the last real slot of a padded
    window (so the map is seeded and trained with the perturbed pose),
    through JAX's mapper with use_refine. At each window's refinement the
    port's `refine_poses` takes the same inputs (JAX's state at that
    point, rebinned by the port): its refined c2w within 1e-3 of JAX's,
    and it moves the perturbed keyframe toward or away from the truth as
    JAX's does. The inputs are shared (JAX's state and its binning, which
    is stale on purpose: a fresh one moves the refined poses by ~1e-2)
    because refinement on a freshly seeded map amplifies rounding: the
    k-NN scales of `make_new_params` differ between the packages by ~2e-5
    in log_scale (f32 distances summed in another order), enough to move
    a refined pose by ~3e-3."""
    viz, _ = make_viz_out(np.random.default_rng(5), n_kf=4, H=H, W=W)
    kf = 2
    truth = viz["poses"][kf].astype(np.float64)
    pert = np.asarray(jlie.se3_matrix(jlie.se3_exp(jnp.asarray(
        [0.03, -0.02, 0.025, 0.004, -0.003, 0.002], jnp.float32))))
    viz["poses"] = viz["poses"].copy()
    viz["poses"][kf] = viz["poses"][kf] @ pert
    first = {k: (v[:kf + 1] if isinstance(v, np.ndarray) and k != "intrinsic"
                 else v) for k, v in viz.items()}
    jc, tc = _configs({"use_refine": True})
    calls = []
    orig = jrefine.refine_poses

    def recorded(st, batch, binned, intr4, **kw):
        out = orig(st, batch, binned, intr4, **kw)
        calls.append((st, binned, out[0]))
        return out
    monkeypatch.setattr(jrefine, "refine_poses", recorded)
    jm, tm = JMapper(jc), port_mapper(tc)
    tm.H, tm.W = H, W
    e0 = _pose_error(viz["poses"][kf].astype(np.float64), truth)
    for window in (first, viz):
        jm.run(window)
        jst, jb, jnew = calls[-1]
        tm.state = state.state_from_numpy(
            {f: np.asarray(getattr(jst, f)) for f in state.STATE_FIELDS},
            "cpu")
        intr = window["intrinsic"]
        tbatch = tm._pack_batch(window)
        tnew, _ = refine.refine_poses(tm.state, tbatch, _port_binned(jb),
                                      _intr4(intr),
                                      iters=20, height=H, width=W,
                                      render_kwargs=tm.render_kwargs)
        np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew),
                                   atol=1e-3)
        k = int(np.where(np.asarray(jm._gids_host) == kf)[0][0])
        ej = _pose_error(np.asarray(jnew)[k].astype(np.float64), truth)
        et = _pose_error(tnew.numpy()[k].astype(np.float64), truth)
        print(f"keyframe {kf}: perturbed {e0}, refined by JAX {ej}, by "
              f"the port {et} (m, deg)")
        assert (ej[0] > e0[0]) == (et[0] > e0[0]), (e0, ej, et)


def test_mapper_run_coarse_to_fine():
    """training_args.coarse_frac 0.5: per keyframe at test_torch_slice's
    tolerances; the coarse cache's pair bucket as JAX's."""
    def check(jm, tm):
        assert tm._binned_c is not None
        assert tm.bin_kwargs_c["p_cap"] == jm.bin_kwargs_c["p_cap"]
        assert tm.bin_kwargs_c["v_cap"] == jm.bin_kwargs_c["v_cap"]
    _run_both({"training_args": {**OVERRIDES["training_args"],
                                 "coarse_frac": 0.5}},
              sky_windows(), check)


def test_train_on_window():
    """train_on_window after one mapped window: loss within 1 % and PSNR
    within 0.1 dB of JAX's, the Gaussians' positions within 1e-3, both
    binning caches dropped."""
    jc, tc = _configs({})
    jm, tm = JMapper(jc), port_mapper(tc)
    wins = sky_windows()
    jm.run(wins[0])
    tm.run(wins[0])
    jm.train_on_window(wins[1], 6, weights={"dist_loss": 0.0})
    tm.train_on_window(wins[1], 6, weights={"dist_loss": 0.0})
    jmet, tmet = jm.last_metrics, tm.last_metrics
    assert abs(tmet["total"] - jmet["total"]) <= 0.01 * abs(jmet["total"])
    assert abs(tmet["psnr"] - jmet["psnr"]) <= 0.1
    m = np.asarray(jm.state.alive)
    np.testing.assert_array_equal(tm.state.alive.numpy(), m)
    np.testing.assert_allclose(tm.state.xyz.numpy()[m],
                               np.asarray(jm.state.xyz)[m], atol=1e-3)
    assert tm._binned is None and tm._binned_c is None
