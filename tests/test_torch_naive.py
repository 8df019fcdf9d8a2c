"""Port parity for `mapper.impl: naive`: `render(impl="naive")` against the
JAX package's naive branch, and the port's GaussianMapper on
tests/test_mapper.py's `impl: naive` configuration against JAX's, the JAX
random draws replayed into the port. The naive branch leaves the score
carrier out of the graph in both packages, so the per-Gaussian scores are
zero there (ROADMAP.md §C). Tolerances are stated per test."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_viz_out
from test_mapper import small_cfg
from test_torch_rasterizer import NAMES, cams, make_scene, t_params
from test_torch_slice import JaxDraws
from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
from vings_mono_tpu.ops.rasterizer import render as j_render
from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
from vings_mono_tpu_torch.ops.rasterizer import render
from vings_mono_tpu_torch.utils.config import load_config

render_mod = importlib.import_module(
    "vings_mono_tpu_torch.ops.rasterizer.render")
CHANNELS = ("rgb", "depth", "accum", "normal", "dist", "flow")


def test_render_naive_matches_jax():
    """Channels to 1e-5 absolute, visibility and radii equal; gradients of
    a random weighting of the channels to 1e-4 of each tensor's largest;
    the score carrier's gradient zero in both (the naive branch never
    reads it)."""
    arrs = make_scene(3)
    jc, tc = cams()
    rng = np.random.default_rng(4)
    wts = {k: rng.normal(size=np.asarray(j_render(
        *[jnp.asarray(a) for a in arrs], jc, impl="naive")[k]).shape)
        .astype(np.float32) for k in CHANNELS}

    def j_loss(params, carrier):
        r = j_render(*params, jc, score_carrier=carrier, impl="naive")
        return sum(jnp.sum(r[k] * wts[k]) for k in CHANNELS), r

    jp = [jnp.asarray(a) for a in arrs]
    (_, jr), (jg, jcg) = jax.value_and_grad(j_loss, argnums=(0, 1),
                                            has_aux=True)(
        jp, jnp.zeros((len(arrs[0]), 2), jnp.float32))
    tp = t_params(arrs, grad=True)
    carrier = torch.zeros((len(arrs[0]), 2), requires_grad=True)
    tr = render(*tp, tc, score_carrier=carrier, impl="naive")
    loss = sum(torch.sum(tr[k] * torch.from_numpy(wts[k]))
               for k in CHANNELS)
    *tg, tcg = torch.autograd.grad(loss, tp + [carrier], allow_unused=True)
    for k in CHANNELS:
        np.testing.assert_allclose(tr[k].detach().numpy(), np.asarray(jr[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tr["visible"].numpy(),
                                  np.asarray(jr["visible"]))
    assert int(tr["visible"].sum()) > 50
    np.testing.assert_allclose(tr["radii"].detach().numpy(),
                               np.asarray(jr["radii"]), rtol=1e-5)
    for name, a, b in zip(NAMES, jg, tg):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max(), err_msg=name)
    assert not np.asarray(jcg).any() and tcg is None


def test_render_refuses_an_unknown_impl():
    arrs = make_scene(3)
    _, tc = cams()
    with pytest.raises(ValueError, match="impl 'pallas'"):
        render(*t_params(arrs), tc, impl="pallas")


def port_mapper(cfg):
    m = GaussianMapper(cfg, device="cpu")
    draws = JaxDraws(int(cfg.get("seed", 0)))
    m._densify_draws = draws.densify(m)
    m._kf_schedule = draws.schedule
    return m


def windows():
    """tests/test_mapper.py's stream: three keyframes, then the same
    window one timestamp on."""
    viz, _ = make_viz_out(np.random.default_rng(3), n_kf=3)
    viz2 = dict(viz)
    viz2["viz_out_idx_to_f_idx"] = np.arange(1, 4, dtype=np.float64)
    return [viz, viz2]


def test_mapper_impl_naive_matches_jax(monkeypatch):
    """GaussianMapper on tests/test_mapper.py's config (mapper.impl naive,
    iterations cut from 30 to 8) against JAX's, per keyframe: Gaussians
    1 %, loss 1 %, PSNR 0.1 dB (tests/test_torch_slice.py's tolerances).
    The tile kernels' wrappers never run (the render module's forward
    wrapper is replaced by one that raises), no score moves in either
    package, and at the second keyframe (num_keyframe 2) both mark every
    live Gaussian stable."""
    def no_tile(*a, **k):
        raise AssertionError("a tile kernel ran under mapper.impl: naive")
    monkeypatch.setattr(render_mod, "rasterize_forward", no_tile)
    over = {"training_args": {"iters": 8}}
    jcfg = small_cfg()
    jcfg["training_args"] = {**jcfg["training_args"], **over["training_args"]}
    jm = JMapper(jcfg)
    tm = port_mapper(load_config(overrides={
        "mapper": jcfg["mapper"], "training_args": jcfg["training_args"]}))
    assert dict(tm.render_kwargs)["impl"] == "naive"
    for viz in windows():
        jm.run(viz)
        tm.run(viz)
        jmet, tmet, jn, tn = jm.last_metrics, tm.last_metrics, jm.n_alive, \
            tm.n_alive
        assert jn > 200 and abs(tn - jn) <= 0.01 * jn, (tn, jn)
        assert abs(tmet["total"] - jmet["total"]) <= 0.01 * abs(
            jmet["total"]), (tmet["total"], jmet["total"])
        assert abs(tmet["psnr"] - jmet["psnr"]) <= 0.1, (tmet["psnr"],
                                                         jmet["psnr"])
        for f in ("local_scores", "global_scores"):
            assert not np.asarray(getattr(jm.state, f)).any(), f
            assert not getattr(tm.state, f).any(), f
    assert tm.time_idx == jm.time_idx == 2
    np.testing.assert_array_equal(tm.state.stable.numpy(),
                                  np.asarray(jm.state.stable))
    np.testing.assert_array_equal(tm.state.stable.numpy(),
                                  tm.state.alive.numpy())
    # render_at takes the naive route too
    viz = windows()[0]
    tr = tm.render_at(np.linalg.inv(viz["poses"][0]).astype(np.float32),
                      viz["intrinsic"])
    assert torch.isfinite(tr["rgb"]).all() and float(tr["accum"].max()) > 0.5
