"""Port parity for data parallelism over the keyframe window
(`vings_mono_tpu_torch/parallel/mesh.py` and the dp route of the mapper and
the runners) against the JAX package's `parallel/mesh.py` on the same numpy
inputs: two spawned CPU ranks over Gloo on the port's side, the
`cpu_devices` fixture's virtual devices on JAX's (the Pallas kernels in
interpret mode, as tests/test_parallel.py runs them), the JAX random draws
replayed into the port. Then the refusals, a killed or failing follower,
and the runner's clean exit. Tolerances are stated per test.

The tests that start a dp group of their own come first: a process holds
one process group at a time, and the module's shared group (`cpu_group`)
lives from its first user to the end of the module."""

import multiprocessing as mp
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_viz_out
from test_parallel import _tile_step_inputs
from test_torch_mapper_ops import BIN, J_RKW, LRS, T_RKW, _seeded
from test_torch_slice import JaxDraws
from test_torch_vo_slice import SMALL
from vings_mono_tpu.mapper import sky as jsky
from vings_mono_tpu.mapper import state as jst
from vings_mono_tpu.mapper import train as jtr
from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
from vings_mono_tpu.parallel import mesh as jmesh
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch.mapper import state as tst
from vings_mono_tpu_torch.mapper import train as ttr
from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
from vings_mono_tpu_torch.mapper.sky import sky_render_params
from vings_mono_tpu_torch.parallel import mesh
from vings_mono_tpu_torch.runners import run as run_t
from vings_mono_tpu_torch.utils.config import load_config

H = W = 32                 # test_torch_mapper_ops' window
INTR4 = (30.0, 30.0, W / 2, H / 2)
WEIGHTS = {"rgb_loss": 1.0, "depth_loss": 1.0, "alpha_loss": 1.0,
           "normal_loss": 0.1, "dist_loss": 0.0}
CPU2 = {"dp": 2, "platform": "cpu", "verify": True}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the followers copy the leader's thread count
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def no_children():
    return mp.active_children() == []


def jax_dp_schedule(key, iters, n_valid, dp, k_local):
    """The JAX dp loop's keyframe draws (mapper/train.py, axis_name
    branch): per iteration split the key, fold in the rank, draw within
    the rank's real slots."""
    out = []
    for _ in range(iters):
        key, k1 = jax.random.split(key)
        out.append([int(jax.random.randint(
            jax.random.fold_in(k1, r), (), 0,
            max(ttr.local_n_valid(n_valid, r, k_local), 1)))
            for r in range(dp)])
    return out


class JaxDpDraws(JaxDraws):
    """JaxDraws with the dp loop's per-rank keyframe draws."""

    def __init__(self, seed, dp, k_local):
        super().__init__(seed)
        self.dp, self.k_local = dp, k_local

    def schedule(self, iters, n_valid):
        return jax_dp_schedule(self._next(), iters, n_valid, self.dp,
                               self.k_local)


# ---- refusals (no process started) ----------------------------------------
@pytest.mark.parametrize("case", ["nccl_repeated", "too_few_cards",
                                  "nccl_on_cpu", "mixed", "platform"])
def test_placement_refusals(case, monkeypatch):
    """No fallback: a CUDA group that names more cards than the machine
    has raises RuntimeError (JAX's make_dp_mesh falls back to the CPU); a
    repeated CUDA device with NCCL raises ValueError naming gloo. The CUDA
    count is monkeypatched: the CPU cannot show it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls = {
        "nccl_repeated": (dict(devices=["cuda:0", "cuda:0"]), ValueError,
                          "backend: gloo"),
        "too_few_cards": ({}, RuntimeError, "does not fall back"),
        "nccl_on_cpu": (dict(platform="cpu", backend="nccl"), ValueError,
                        "gloo"),
        "mixed": (dict(devices=["cuda:0", "cpu"]), ValueError, "must all be cpu"),
        "platform": (dict(platform="tpu"), ValueError, "cpu' or 'cuda"),
    }
    kw, exc, match = calls[case]
    with pytest.raises(exc, match=match):
        mesh.dp_placement(2, **kw)
    assert no_children()


def test_placement_defaults(monkeypatch):
    """cuda:0 .. cuda:N-1 over NCCL, N cpu ranks over Gloo, two ranks on
    one card over Gloo when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    devs, be = mesh.dp_placement(2)
    assert [str(d) for d in devs] == ["cuda:0", "cuda:1"] and be == "nccl"
    devs, be = mesh.dp_placement(2, devices=["cuda", "cuda:0"],
                                 backend="gloo")
    assert [str(d) for d in devs] == ["cuda:0", "cuda:0"] and be == "gloo"
    devs, be = mesh.dp_placement(3, platform="cpu")
    assert [str(d) for d in devs] == ["cpu"] * 3 and be == "gloo"


def mapper_cfg(parallel, **mapper):
    return load_config(overrides={
        "mapper": {"capacity": 1024, "pair_capacity": 1024, "chunk": 64,
                   "kf_capacity": 4, **mapper},
        "parallel": parallel})


@pytest.mark.parametrize("case", ["kf_capacity", "sp", "rank0_device"])
def test_mapper_refusals(case, monkeypatch):
    """kf_capacity % dp raises ValueError (JAX asserts), also beside an sp
    (the mapper reads parallel.dp alone, as JAX's does), and a rank 0 on
    another device than the mapper's raises ValueError (two cards
    monkeypatched in); none starts a process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    parallel, exc, match = {
        "kf_capacity": ({"dp": 3, "platform": "cpu"}, ValueError,
                        "divide by parallel.dp"),
        "sp": ({"dp": 3, "sp": 2, "platform": "cpu"}, ValueError,
               "divide by parallel.dp 3"),
        "rank0_device": ({"dp": 2}, ValueError, "rank 0"),
    }[case]
    with pytest.raises(exc, match=match):
        GaussianMapper(mapper_cfg(parallel), device="cpu")
    assert no_children()


def test_check_ported_accepts_dp():
    """Every runner's check takes parallel.dp, and parallel.sp beside it
    (no runner reads sp, in either package); make_mesh's sp axis builds
    (dp, sp) as JAX's does (tests/test_torch_sp.py runs it)."""
    base = load_config()
    run_t.check_ported(dict(base, parallel={"dp": 4}))
    run_t.check_ported(dict(base, parallel={"dp": 2, "platform": "cpu",
                                            "backend": "gloo"}))
    run_t.check_ported(dict(base, parallel={"dp": 2, "sp": 2}))
    g = mesh.make_mesh(devices=["cpu"] * 2, dp=1)
    try:
        assert g.shape == {"dp": 1, "sp": 2}
    finally:
        g.close()
    assert no_children()


# ---- groups of their own ---------------------------------------------------
def tile_inputs():
    """tests/test_parallel.py's scene (200 surfels, K = 8 at 32x32) as
    numpy, for both packages."""
    rng = np.random.default_rng(3)
    st = tst.empty_state(512, "cpu")
    n = 200
    z = rng.uniform(2.0, 6.0, size=n).astype(np.float32)
    xyz = np.stack([(rng.uniform(0, 1, n) - 0.5) * z,
                    (rng.uniform(0, 1, n) - 0.5) * z, z], -1)
    st.xyz[:n] = torch.from_numpy(xyz)
    st.rgb[:n] = torch.from_numpy(
        rng.uniform(0, 1, (n, 3)).astype(np.float32))
    st.log_scale[:n] = -1.5
    st.logit_opacity[:n] = 1.0
    st.alive[:n] = True
    k = 8
    images = rng.uniform(0, 1, (k, 3, H, W)).astype(np.float32)
    depths = rng.uniform(2, 6, (k, 1, H, W)).astype(np.float32)
    batch = [torch.from_numpy(images), torch.from_numpy(depths),
             torch.full((k, 1, H, W), 0.01), torch.eye(4).repeat(k, 1, 1)]
    return st, tst.adam_init(st), batch


@pytest.mark.parametrize("how", ["killed", "raises"])
def test_a_failing_follower_raises_in_the_leader(how):
    """A follower killed between calls makes the next call raise at once
    (its process state, not a wait); a follower whose call raises sends
    its traceback, which the leader raises. Both within 15 s; close()
    leaves no child."""
    g = mesh.make_dp_mesh(2, platform="cpu")
    try:
        t0 = time.monotonic()
        if how == "killed":
            g._procs[0].kill()
            g._procs[0].join(10)
            with pytest.raises(RuntimeError, match="exited"):
                st, opt, batch = tile_inputs()
                mesh.sharded_tile_grads(g, st, opt, *batch, INTR4,
                                        height=H, width=W)
        else:
            with pytest.raises(RuntimeError, match="dp rank 1 failed"):
                g.call("no_such_body", {}, None)
        assert time.monotonic() - t0 < 15
    finally:
        g.close()
    assert no_children()


def mapper_windows():
    """tests/test_parallel.py test_mapper_dp_product_path's window (3
    keyframes at 32x48), first its first two keyframes: with kf_capacity
    4, rank 1 holds padding only (weight 0) in the first call, one real
    keyframe in the second."""
    h, w = 32, 48
    rng = np.random.default_rng(7)
    k = 3
    viz = {"images": rng.uniform(0, 1, (k, h, w, 3)).astype(np.float32),
           "depths": rng.uniform(2.0, 5.0, (k, h, w, 1)).astype(np.float32),
           "depths_cov": np.full((k, h, w, 1), 0.01, np.float32),
           "poses": np.tile(np.eye(4, dtype=np.float32)[None], (k, 1, 1)),
           "viz_out_idx_to_f_idx": np.arange(k, dtype=np.float64),
           "global_kf_id": np.arange(k, dtype=np.int64),
           "intrinsic": {"fu": 40.0, "fv": 40.0, "cu": h / 2, "cv": w / 2,
                         "H": h, "W": w}}
    first = {key: (v[:2] if isinstance(v, np.ndarray) else v)
             for key, v in viz.items()}
    return [first, viz]


MAPPER_OVERRIDES = {
    "training_args": {"iters": 4, "num_keyframe": 3},
    "mapper": {"capacity": 2048, "pair_capacity": 2048, "chunk": 64,
               "kf_capacity": 4, "points_per_frame": 128,
               "points_first_frame": 256, "visible_capacity": 512},
    "adc_args": {"accum_thresh": 0.98}}


def test_mapper_dp_matches_jax(cpu_devices):
    """GaussianMapper with parallel {dp: 2, platform: cpu} against JAX's
    with {dp: 2, platform: cpu}, the JAX key stream (densify draws and the
    per-rank keyframe draws) replayed: per keyframe and after a
    train_on_window (the loop retrain) at test_torch_slice's tolerances
    (Gaussians 1 %, loss 1 %, PSNR 0.1 dB). `verify` compares
    the follower's state digest with the leader's after every call: the
    ranks hold the same state bit for bit."""
    jm = JMapper(j_load_config(overrides={
        **MAPPER_OVERRIDES, "parallel": {"dp": 2, "platform": "cpu"},
        "mapper": {**MAPPER_OVERRIDES["mapper"], "impl": "tile",
                   "interpret": True}}))
    assert jm.mesh.shape["dp"] == 2
    tm = GaussianMapper(load_config(overrides={**MAPPER_OVERRIDES,
                                               "parallel": CPU2}),
                        device="cpu")
    try:
        draws = JaxDpDraws(0, 2, 2)
        tm._densify_draws = draws.densify(tm)
        tm._kf_schedule = draws.schedule
        assert tm.group.world == 2 and tm.group.verify
        for viz in mapper_windows():
            jm.run(viz)
            tm.run(viz)
            jmet, tmet = jm.last_metrics, tm.last_metrics
            jn, tn = jm.n_alive, tm.n_alive
            assert jn > 100 and abs(tn - jn) <= 0.01 * jn, (tn, jn)
            assert abs(tmet["total"] - jmet["total"]) <= 0.01 * abs(
                jmet["total"]), (tmet["total"], jmet["total"])
            assert abs(tmet["psnr"] - jmet["psnr"]) <= 0.1, (
                tmet["psnr"], jmet["psnr"])
        # a bin and a train call per window, each digest-checked
        assert tm.group.calls == 4
        # the loop-closure retrain route, JAX's key stream likewise
        jm.train_on_window(viz, 2)
        tm.train_on_window(viz, 2)
        jmet, tmet = jm.last_metrics, tm.last_metrics
        assert tm.group.calls == 6
        assert abs(tmet["total"] - jmet["total"]) <= 0.01 * abs(
            jmet["total"]), (tmet["total"], jmet["total"])
        assert abs(tmet["psnr"] - jmet["psnr"]) <= 0.1
        assert np.isfinite(np.asarray(tm.state.xyz)).all()
    finally:
        tm.close()
    assert no_children() and not tm.group.alive_followers()


def test_run_with_dp_leaves_no_child(tmp_path):
    """runners.run.run at 32x48 with parallel {dp: 2, platform: cpu} and
    the sky, pose refinement and the coarse-to-fine phase: the map trains
    through the group (finite loss; per mapped keyframe a bin and a train
    call at each resolution, every one digest-checked) and no child
    process is left when run returns."""
    cfg = load_config(overrides={
        **SMALL, "dataset": {**SMALL["dataset"], "n_frames": 9},
        "frontend": {**SMALL["frontend"], "image_size": [32, 48]},
        "training_args": {**SMALL["training_args"], "coarse_frac": 0.5},
        "use_sky": True, "use_refine": True,
        "parallel": CPU2, "output": {"save_dir": str(tmp_path)}})
    _, mapper, timer = run_t.run(cfg, str(tmp_path / "run"), device="cpu")
    assert mapper.group.closed and not mapper.group.alive_followers()
    assert no_children()
    assert mapper.time_idx > 0 and mapper.group.calls == 4 * mapper.time_idx
    assert np.isfinite(mapper.last_metrics["total"])
    assert (tmp_path / "run" / "ply" / "final_2dgs.ply").is_file()


# ---- the module's shared group --------------------------------------------
@pytest.fixture(scope="module")
def cpu_group():
    g = mesh.make_dp_mesh(2, platform="cpu")
    g.verify = True
    yield g
    g.close()
    assert no_children()


def test_follower_imports_no_jax(cpu_group):
    """A spawned follower's process has no JAX: its memory maps hold
    libtorch and no jaxlib (importing jax loads jaxlib's extension)."""
    (p,) = cpu_group.alive_followers()
    with open(f"/proc/{p.pid}/maps") as f:
        maps = f.read()
    assert "libtorch" in maps
    assert "jaxlib" not in maps and "/jax/" not in maps


def test_sharded_tile_grads_matches_jax(cpu_group, cpu_devices):
    """sharded_tile_grads at dp = 2 on tests/test_parallel.py's scene.
    Against the port at dp = 1 (the same sums split over two ranks),
    tests/test_parallel.py's tolerances: loss 1e-5 relative, visibility
    equal, gradients rtol 2e-4 / atol 1e-6. Against JAX at dp = 2: loss
    1e-5 relative, visibility equal, gradients within 1e-3 of each
    tensor's largest (the packages' rasterizer gradient parity,
    tests/test_torch_rasterizer.py: the backward rounds its per-pair
    gradients to bf16 in both, so last-bit differences before the
    rounding show at 4e-3 of one pair's share)."""
    jmesh_, jstate, jopt, jbatch, jintr, _, _ = _tile_step_inputs(
        cpu_devices, 2)
    with jmesh_:
        jg, jv, jl = jmesh.sharded_tile_grads(
            jstate, jopt, *jbatch, jintr, mesh=jmesh_, height=H, width=W,
            interpret=True)
    st, opt, batch = tile_inputs()
    tg, tv, tl = mesh.sharded_tile_grads(cpu_group, st, opt, *batch, INTR4,
                                         height=H, width=W)
    g1, v1, l1 = mesh.local_grads(st.params(), st.alive, *batch,
                                        INTR4, H, W, 4096, 128)
    assert abs(float(tl) - float(l1)) <= 1e-5 * abs(float(l1))
    assert torch.equal(tv, v1)
    for k in g1:
        np.testing.assert_allclose(tg[k].numpy(), g1[k].numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    jl = float(jl)
    assert abs(float(tl) - jl) <= 1e-5 * abs(jl)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tv.sum()) == 200
    for k in g1:
        a = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), a, rtol=0,
                                   atol=1e-3 * np.abs(a).max(), err_msg=k)


def test_sharded_tile_train_step_replicates(cpu_group):
    """sharded_tile_train_step and sharded_train_step(impl="tile") through
    the group: the same loss as the single-process step (1e-6), finite
    parameters, and the followers' parameters and moments bitwise equal
    to the leader's (`verify`)."""
    st, opt, batch = tile_inputs()
    calls = cpu_group.calls
    _, _, loss = mesh.sharded_tile_train_step(cpu_group, st, opt, *batch,
                                              INTR4, height=H, width=W)
    assert opt.step == 1 and torch.isfinite(st.xyz).all()
    st2, opt2, _ = tile_inputs()
    _, _, l2 = mesh.sharded_train_step(st2, opt2, *batch, INTR4, height=H,
                                       width=W, impl="tile", group=cpu_group)
    st3, opt3, _ = tile_inputs()
    _, _, l3 = mesh.sharded_train_step(st3, opt3, *batch, INTR4, height=H,
                                       width=W, impl="tile")
    assert abs(float(l2) - float(l3)) <= 1e-6 * abs(float(l3))
    assert abs(float(loss) - float(l3)) <= 1e-5 * abs(float(l3))
    assert cpu_group.calls == calls + 2


def _sky_states(viz_imgs):
    """A JAX sky sphere seeded from keyframe 0's sky pixels and the port's
    copy of it (the same rows: sky_add_frame's parity is
    tests/test_torch_mapper_options.py's)."""
    js = jst.empty_state(512)
    js, _, n = jsky.sky_add_frame(
        js, jst.adam_init(js), jnp.eye(4), jnp.asarray(INTR4),
        jnp.asarray(np.moveaxis(viz_imgs[0], -1, 0)), jax.random.PRNGKey(5),
        height=H, width=W, n_points=200)
    assert int(n) > 50
    ts = tst.state_from_numpy({f: np.array(getattr(js, f))
                               for f in tst.STATE_FIELDS}, "cpu")
    return (js, jst.adam_init(js)), (ts, tst.adam_init(ts))


@pytest.mark.parametrize("case", ["both_ranks", "zero_weight_rank", "sky"])
def test_dp_train_loop_matches_jax(case, cpu_group, cpu_devices):
    """dp_train_loop at dp = 2 for 4 iterations, the JAX per-rank keyframe
    draws replayed, against JAX's dp_train_loop on the same state, window
    (K = 4) and binning. n_valid 3 (both ranks train), 2 (rank 1 holds
    padding only: weight 0) and, with the sky sphere, 3. Metrics and
    scores to 1e-3 relative (scores also 1e-3 of their largest),
    globalkf_id and alive equal, as test_torch_mapper_ops' dp = 1 loop
    holds them (globalkf_id on 99.9 % of the rows where two ranks train:
    a Gaussian that both ranks' keyframes score alike goes to the larger
    score, which rounding decides). Parameters: 99.5 % of the elements to 2 lr (Adam's first
    steps are lr sign(g)), all to 2 lr per iteration; Adam moments: 99.5 %
    of the elements to 1e-3 relative plus 1e-3 of their largest. Why not
    every element: the packages' render gradients agree to ~1e-3 of their
    largest (bf16 per-pair rounding, test_sharded_tile_grads_matches_jax)
    and not at all on a near edge-on surfel, whose gradients blow up; on
    this window both show at dp = 1 with slot 2 rendered alone: a
    log_scale gradient of 2.6e-3 in JAX and -1.7e-3 in the port (largest
    2.16), and on row 212 2.156 in JAX and 0.020 in the port (its quat
    gradient ~2100 in both). A flipped step moves a parameter by up to
    2 lr. Every call is digest-checked across the ranks."""
    viz, _ = make_viz_out(np.random.default_rng(11), n_kf=4, H=H, W=W)
    sky_imgs = viz["images"].copy()
    if case == "sky":
        viz["depths"][:, :H // 4] = 0.0
        viz["images"][:, :H // 4] = 0.0
    n_valid = 2 if case == "zero_weight_rank" else 3
    (js, jo, jb), (ts, to, tb) = _seeded(viz)
    jb = jb._replace(n_valid=jnp.asarray(n_valid, jnp.int32))
    tb = tb._replace(n_valid=n_valid)
    j_bins = jtr.bin_stack(js, jb, jnp.asarray(INTR4), H, W, **BIN)
    t_bins = ttr.bin_stack(ts, tb, INTR4, H, W, **BIN)
    iters, key = 4, jax.random.PRNGKey(9)
    sched = jax_dp_schedule(key, iters, n_valid, 2, 2)
    if n_valid == 2:
        assert all(row[1] == 0 for row in sched)
    jsky_kw, tsky = {}, None
    if case == "sky":
        (jss, jso), (tss, tso) = _sky_states(viz["images"])
        sp = jsky.sky_render_params(jss)
        jsb = jtr.bin_stack(jss.replace(xyz=sp[0], log_scale=sp[1]), jb,
                            jnp.asarray(INTR4), H, W, **BIN)
        xyz, ls = sky_render_params(tss)
        tsb = ttr.bin_stack(tst.GaussianState(**{
            **{f: getattr(tss, f) for f in tst.STATE_FIELDS},
            "xyz": xyz, "log_scale": ls}), tb, INTR4, H, W, **BIN)
        simg = np.moveaxis(sky_imgs, -1, 1)
        jsky_kw = dict(use_sky=True, sky_state=jss, sky_opt=jso,
                       sky_images=jnp.asarray(simg), sky_binned=jsb)
        tsky = (tss, tso, torch.from_numpy(simg), tsb)
    dmesh = jmesh.make_dp_mesh(2, devices=cpu_devices[:2])
    js, jo, jss2, jso2, jm = jmesh.dp_train_loop(
        dmesh, js, jo, jb, j_bins, jnp.asarray(INTR4), key, iters=iters,
        height=H, width=W, weights=WEIGHTS, lrs=LRS, render_kwargs=J_RKW,
        **jsky_kw)
    calls = cpu_group.calls
    _, _, tm = mesh.dp_train_loop(
        cpu_group, ts, to, tb, t_bins, INTR4, iters=iters, height=H,
        width=W, kf_schedule=sched, weights=WEIGHTS, lrs=LRS,
        render_kwargs=T_RKW, sky=tsky)
    assert cpu_group.calls == calls + 1 and to.step == iters
    for k in ("total", "psnr", "rgb", "depth", "normal"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3,
                                   err_msg=k)
    assert tm["loss_per_iter"].shape == (iters,)
    pairs = [(ts, to, js, jo)]
    if case == "sky":
        pairs.append((tss, tso, jss2, jso2))
    for s_t, o_t, s_j, o_j in pairs:
        for f in tst.PARAM_FIELDS:
            d = np.abs(getattr(s_t, f).numpy() - np.asarray(getattr(s_j, f)))
            assert np.mean(d <= 2 * LRS[f]) >= 0.995, (f, d.max())
            assert d.max() <= 2 * iters * LRS[f], (f, d.max())
        for f in ("local_scores", "global_scores", "globalkf_max_scores"):
            a, b = np.asarray(getattr(s_j, f)), getattr(s_t, f).numpy()
            np.testing.assert_allclose(b, a, rtol=1e-3,
                                       atol=1e-3 * np.abs(a).max(),
                                       err_msg=f)
        for m in ("m", "v"):
            for k in tst.PARAM_FIELDS:
                a, b = np.asarray(getattr(o_j, m)[k]), getattr(o_t, m)[k]
                ok = np.abs(b.numpy() - a) <= 1e-3 * (np.abs(a)
                                                      + np.abs(a).max())
                assert np.mean(ok) >= 0.995, (m, k, np.mean(ok))
        assert o_t.step == int(o_j.step) == iters
        same = s_t.globalkf_id.numpy() == np.asarray(s_j.globalkf_id)
        # two valid ranks' scores of one Gaussian can tie to rounding,
        # and the packages' rounding then attributes it differently
        assert same.all() if case == "zero_weight_rank" else \
            np.mean(same) >= 0.999, np.flatnonzero(~same)
        np.testing.assert_array_equal(s_t.alive.numpy(),
                                      np.asarray(s_j.alive))
    if case == "zero_weight_rank":
        # rank 1 renders padding: no row is attributed to its slots
        assert set(np.unique(ts.globalkf_id[ts.alive].numpy())) <= {0, 1}
