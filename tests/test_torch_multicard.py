"""The port's dp path at dp = 4 on the CPU, the size `profile_multicard.py`
runs over NCCL on four cards: four spawned CPU ranks over Gloo against the
JAX package's dp = 4 on four of the `cpu_devices` fixture's virtual devices
(the Pallas kernels in interpret mode), at tests/test_torch_parallel.py's
sizes and tolerances. Then the script's own CPU-side behaviour: its part f
(a follower that raises inside a call) on CPU ranks, and its refusal
without four cards.

A process holds one process group at a time: the test that starts a group
of its own comes before the module's shared group (`dp4_group`)."""

import ast
import multiprocessing as mp
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import profile_multicard as pm
from synthetic import make_viz_out
from test_parallel import _tile_step_inputs
from test_torch_mapper_ops import BIN, J_RKW, LRS, T_RKW, _seeded
from test_torch_parallel import (H, INTR4, W, WEIGHTS, jax_dp_schedule,
                                 tile_inputs)
from vings_mono_tpu.mapper import train as jtr
from vings_mono_tpu.parallel import mesh as jmesh
from vings_mono_tpu_torch.mapper import state as tst
from vings_mono_tpu_torch.mapper import train as ttr
from vings_mono_tpu_torch.parallel import mesh

DP = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the followers copy the leader's thread count: four ranks share the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_follower_raising_inside_a_call_raises_in_the_leader(monkeypatch):
    """profile_multicard.py's part f on four CPU ranks: rank 1's poses
    arrive malformed, so it raises after the call's broadcast and scatter
    while the other ranks wait in the next collective. The leader raises
    rank 1's failure within the group's timeout (part f's 60 s; the check
    asks for it) and close() leaves no child. chip_smoke.py's 240x800
    scene is cut to 32x48 with 200 surfels."""
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "H", 32)
    monkeypatch.setattr(cs, "W", 48)
    monkeypatch.setattr(cs, "DP_SURFELS", 200)
    monkeypatch.setattr(cs, "DP_P_CAP", 1 << 14)
    lines = []
    pm.failure_part(lambda part, msg: lines.append(msg),
                    {"dp": DP, "platform": "cpu"})
    assert len(lines) == 1 and "dp rank 1 failed" in lines[0], lines
    assert mp.active_children() == []


# ---- the module's shared group --------------------------------------------
@pytest.fixture(scope="module")
def dp4_group():
    g = mesh.make_dp_mesh(DP, platform="cpu")
    g.verify = True
    yield g
    g.close()
    assert mp.active_children() == []


def test_sharded_tile_grads_dp4_matches_jax(dp4_group, cpu_devices):
    """sharded_tile_grads at dp = 4 (K = 8: two keyframes a rank) against
    the port at dp = 1 (loss 1e-5 relative, visibility equal, gradients
    rtol 2e-4 / atol 1e-6) and against JAX at dp = 4 (loss 1e-5 relative,
    visibility equal, gradients within 1e-3 of each tensor's largest: the
    bf16 per-pair rounding, as test_sharded_tile_grads_matches_jax). The
    group counts each collective's bytes: the broadcast of the parameters
    is among them."""
    jmesh_, jstate, jopt, jbatch, jintr, _, _ = _tile_step_inputs(
        cpu_devices, DP)
    with jmesh_:
        jg, jv, jl = jmesh.sharded_tile_grads(
            jstate, jopt, *jbatch, jintr, mesh=jmesh_, height=H, width=W,
            interpret=True)
    st, opt, batch = tile_inputs()
    n_bytes = dp4_group.comm_bytes
    tg, tv, tl = mesh.sharded_tile_grads(dp4_group, st, opt, *batch, INTR4,
                                         height=H, width=W)
    params = sum(p.numel() * p.element_size() for p in st.params().values())
    assert dp4_group.comm_bytes - n_bytes > params
    g1, v1, l1 = mesh.local_grads(st.params(), st.alive, *batch, INTR4, H,
                                  W, 4096, 128)
    assert abs(float(tl) - float(l1)) <= 1e-5 * abs(float(l1))
    assert torch.equal(tv, v1)
    for k in g1:
        np.testing.assert_allclose(tg[k].numpy(), g1[k].numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    jl = float(jl)
    assert abs(float(tl) - jl) <= 1e-5 * abs(jl)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for k in g1:
        a = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), a, rtol=0,
                                   atol=1e-3 * np.abs(a).max(), err_msg=k)


@pytest.mark.parametrize("n_valid", [4, 3], ids=["every_rank",
                                                  "padding_rank"])
def test_dp_train_loop_dp4_matches_jax(n_valid, dp4_group, cpu_devices):
    """One dp_train_loop call at dp = 4 for 4 iterations on a window of K =
    4, each rank training its one slot: 4 valid keyframes, or 3 (rank 3
    holds padding: weight 0). The JAX per-rank keyframe draws replayed,
    against JAX's dp_train_loop on four virtual devices, at
    test_dp_train_loop_matches_jax's tolerances (which state why): metrics
    and scores 1e-3 relative (scores also 1e-3 of their largest),
    parameters 99.5 % of the elements to 2 lr and all to 2 lr per
    iteration, Adam moments 99.5 % to 1e-3 relative plus 1e-3 of their
    largest, globalkf_id on 99.9 % of the rows, alive equal; but the depth
    metric to 1e-2. It weights each pixel by 1 / depths_cov = 100, and
    with 3 valid keyframes one pixel of keyframe 2 sees a near edge-on
    surfel: on the same state after 3 iterations the packages render it
    at depth 156.89 (port) and 154.61 (JAX), and their single-process
    losses on that keyframe part by 0.8 % (0.27333 against 0.27111), the
    dp metric by 0.3 %. That is f32 rounding of an intersection whose
    condition number is 9.18e4, the same formula in both packages
    (tests/test_torch_edge_on_depth.py pins it). The call is
    digest-checked across the ranks."""
    viz, _ = make_viz_out(np.random.default_rng(11), n_kf=4, H=H, W=W)
    (js, jo, jb), (ts, to, tb) = _seeded(viz)
    jb = jb._replace(n_valid=jnp.asarray(n_valid, jnp.int32))
    tb = tb._replace(n_valid=n_valid)
    j_bins = jtr.bin_stack(js, jb, jnp.asarray(INTR4), H, W, **BIN)
    t_bins = ttr.bin_stack(ts, tb, INTR4, H, W, **BIN)
    iters, key = 4, jax.random.PRNGKey(9)
    sched = jax_dp_schedule(key, iters, n_valid, DP, 1)
    assert all(row == [0] * DP for row in sched)
    dmesh = jmesh.make_dp_mesh(DP, devices=cpu_devices[:DP])
    js, jo, _, _, jm = jmesh.dp_train_loop(
        dmesh, js, jo, jb, j_bins, jnp.asarray(INTR4), key, iters=iters,
        height=H, width=W, weights=WEIGHTS, lrs=LRS, render_kwargs=J_RKW)
    calls = dp4_group.calls
    _, _, tm = mesh.dp_train_loop(
        dp4_group, ts, to, tb, t_bins, INTR4, iters=iters, height=H,
        width=W, kf_schedule=sched, weights=WEIGHTS, lrs=LRS,
        render_kwargs=T_RKW)
    assert dp4_group.calls == calls + 1 and to.step == iters
    for k in ("total", "psnr", "rgb", "depth", "normal"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=1e-2 if k == "depth" else 1e-3,
                                   err_msg=k)
    for f in tst.PARAM_FIELDS:
        d = np.abs(getattr(ts, f).numpy() - np.asarray(getattr(js, f)))
        assert np.mean(d <= 2 * LRS[f]) >= 0.995, (f, d.max())
        assert d.max() <= 2 * iters * LRS[f], (f, d.max())
    for f in ("local_scores", "global_scores", "globalkf_max_scores"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-3,
                                   atol=1e-3 * np.abs(a).max(), err_msg=f)
    for m in ("m", "v"):
        for k in tst.PARAM_FIELDS:
            a, b = np.asarray(getattr(jo, m)[k]), getattr(to, m)[k]
            ok = np.abs(b.numpy() - a) <= 1e-3 * (np.abs(a)
                                                  + np.abs(a).max())
            assert np.mean(ok) >= 0.995, (m, k, np.mean(ok))
    assert to.step == int(jo.step) == iters
    same = ts.globalkf_id.numpy() == np.asarray(js.globalkf_id)
    assert np.mean(same) >= 0.999, np.flatnonzero(~same)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


# ---- the script without four cards ----------------------------------------
def test_profile_multicard_refuses_without_four_cards():
    """Where no card is present the script exits 1 and says it needs four
    CUDA devices, with no result line. Neither it nor chip_smoke.py, which
    it imports, names jax or the JAX package, and the run imported
    neither."""
    probe = ("import runpy, sys\n"
             "sys.argv = ['profile_multicard.py']\n"
             "try:\n"
             "    runpy.run_path('profile_multicard.py', "
             "run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    print('exit', e.code)\n"
             "print('modules', sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'vings_mono_tpu')))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120).stdout
    assert "needs 4 CUDA devices" in out, out
    assert "exit 1" in out and "modules []" in out, out
    assert "check " not in out and "passed" not in out, out
    for name in ("profile_multicard.py", "chip_smoke.py"):
        with open(os.path.join(ROOT, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) else []
            for m in mods:
                assert m.split(".")[0] not in ("jax", "vings_mono_tpu"), \
                    (name, m)
