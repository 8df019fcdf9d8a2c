"""Port parity of the LightGlue self-training recipe
(vings_mono_tpu_torch/runners/train_lightglue.py) against the JAX
package's scripts/train_lightglue.py at the script's shapes (240x320,
N_KP 256, 2 layers), from the repository's lightglue_selftrained.npz
and superpoint_selftrained.npz in both: the same seed gives the same
`sample_views` views bit for bit, `gt_assignment` the same assignment on
the same keypoints, and the frozen SuperPoint the script's keypoints;
one pair's loss (1e-4 relative) and every parameter's gradient (1e-2 of
its own largest magnitude; the noise rule of tests/test_torch_trainer.py)
against `jax.value_and_grad` of the script's loss, which is nested in
its main() and so copied below; the optimizer against the script's chain
(1e-6); the checkpoint read by JAX's LoopDetector and by the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vings_mono_tpu.loop.detect import LoopDetector as JLoopDetector
from vings_mono_tpu.models import superpoint as j_superpoint
from vings_mono_tpu.models.lightglue import LightGlue as JLightGlue
from vings_mono_tpu_torch.models.flax_weights import (
    flax_tree_from_state_dict, load_pickled_params, state_dict_from_flax)
from vings_mono_tpu_torch.models.lightglue import load_lightglue
from vings_mono_tpu_torch.models.superpoint import load_superpoint
from vings_mono_tpu_torch.runners import train_lightglue as tlg

from test_torch_recipe_parity import (LOSS_REL, WEIGHTS, assert_grads_close,
                                      assert_steps_as_optax, flat, load_script,
                                      torch_grads)

LG = WEIGHTS / "lightglue_selftrained.npz"
SP = WEIGHTS / "superpoint_selftrained.npz"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    return load_script("train_lightglue")


@pytest.fixture(scope="module")
def views():
    return tlg.sample_views(np.random.default_rng(4))


@pytest.fixture(scope="module")
def inputs(views):
    """(da, db, ka, kb, va, vb, gt) from the port's frozen SuperPoint."""
    sp = load_superpoint(str(SP))
    return tuple(t.numpy() for t in tlg.pair_inputs(sp, views, "cpu"))


def jax_loss_fn(lg, p, da, db, ka, kb, va, vb, gt, N_KP=tlg.N_KP):
    """scripts/train_lightglue.py:136-154 (nested in its main()), copied
    as it is."""
    scores, z0, z1 = lg.apply(p, da, db, ka, kb, va, vb)
    matched = gt >= 0
    gt_c = jnp.clip(gt, 0)
    nll_m = -jnp.take_along_axis(scores, gt_c[:, None], 1)[:, 0]
    # unmatchable valid points should have low matchability
    nll_u0 = -jnp.log(jnp.clip(1.0 - z0, 1e-9))
    matched_b = jnp.zeros(N_KP, bool).at[gt_c].set(matched)
    nll_u1 = -jnp.log(jnp.clip(1.0 - z1, 1e-9))
    n_m = jnp.clip(matched.sum(), 1)
    loss = (jnp.where(matched, nll_m, 0.0).sum() / n_m
            + 0.5 * jnp.where(va & ~matched, nll_u0, 0.0).sum()
            / jnp.clip((va & ~matched).sum(), 1)
            + 0.5 * jnp.where(vb & ~matched_b, nll_u1, 0.0).sum()
            / jnp.clip((vb & ~matched_b).sum(), 1))
    # diagnostic: argmax accuracy on matched rows
    acc = jnp.sum((jnp.argmax(scores, 1) == gt_c) & matched) / n_m
    return loss, acc


def jax_params():
    params, _ = load_pickled_params(str(LG))
    return {"params": params}


@pytest.fixture(scope="module")
def jax_step(inputs):
    lg = JLightGlue(**tlg.ARCH)
    (loss, acc), grads = jax.jit(jax.value_and_grad(
        lambda p, *a: jax_loss_fn(lg, p, *a), has_aux=True))(
        jax_params(), *(jnp.asarray(x) for x in inputs))
    return float(loss), float(acc), flat(grads)


def to_flat(model):
    return flat({"params": flax_tree_from_state_dict(model.state_dict())})


def test_views_and_assignment_as_the_script(script, views, inputs):
    ref = script.sample_views(np.random.default_rng(4))
    for a, b in zip(views, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rgb_a, dep_a, c2w_a, rgb_b, dep_b, c2w_b, intr = views
    sp = load_superpoint(str(SP))
    xa, _, va, _ = (t.numpy() for t in tlg.extract_keypoints(sp, rgb_a))
    xb, _, vb, _ = (t.numpy() for t in tlg.extract_keypoints(sp, rgb_b))
    args = (xa, va, dep_a, c2w_a, xb, vb, dep_b, c2w_b, intr)
    gt = tlg.gt_assignment(*args)
    assert np.array_equal(gt, script.gt_assignment(*args))
    assert np.array_equal(gt, inputs[-1]) and (gt >= 0).sum() >= 20
    # the frozen SuperPoint finds the script's keypoints (near-ties of
    # the heat may swap a few of the weakest)
    model, params = j_superpoint.load_superpoint(str(SP))
    heat, _ = model.apply(params, jnp.asarray(rgb_a @ tlg.GRAY)[None, ...,
                                                                 None])
    jxy, _, jva = j_superpoint.nms_keypoints(heat[0], tlg.N_KP)
    mine = {tuple(p) for p in xa[va]}
    theirs = {tuple(p) for p in np.asarray(jxy)[np.asarray(jva)]}
    assert len(mine & theirs) >= 0.98 * max(len(mine), len(theirs))


def test_last_write_scatter_as_the_script():
    """The script's `.at[gt_c].set(matched)` at repeated indices: the
    last write wins, in the port's scatter_last as in JAX on the CPU."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 6, 40)
    vals = rng.uniform(size=40) < 0.5
    want = np.asarray(jnp.zeros(8, bool).at[idx].set(vals))
    got = tlg.scatter_last(8, torch.as_tensor(idx), torch.as_tensor(vals),
                           False)
    assert np.array_equal(got.numpy(), want)


def test_loss_and_gradients_as_the_script(inputs, jax_step):
    jloss, jacc, jgrads = jax_step
    model = tlg.build_model(str(LG), "cpu")
    loss, acc = tlg.lightglue_loss(model, *(torch.as_tensor(x)
                                            for x in inputs))
    loss.backward()
    loss = float(loss.detach())
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)
    assert abs(float(acc) - jacc) <= 0.02
    tgrads = flat({"params": flax_tree_from_state_dict(torch_grads(model))})
    assert_grads_close(tgrads, jgrads, min_held=60)


def test_optimizer_steps_as_the_script(jax_step):
    _, _, jgrads = jax_step
    model = tlg.build_model(str(LG), "cpu")
    moved = assert_steps_as_optax(
        model, jax_params(), jgrads, to_flat,
        lambda f: state_dict_from_flax(f, renames={"scale": "weight"}),
        1e-4, 20, 1.0)
    assert max(moved.values()) > 1e-6


def test_checkpoint_loads_in_both_packages(tmp_path):
    model = tlg.build_model(str(LG), "cpu")
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        for p in model.parameters():
            p.add_(1e-3 * torch.randn(p.shape, generator=gen))
    path = tmp_path / "lg.npz"
    tlg.save_weights(str(path), model)
    back = load_lightglue(str(path))
    assert back.layers == tlg.ARCH["layers"]
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    det = JLoopDetector({}, lg_params_path=str(path))
    assert det.lg.layers == tlg.ARCH["layers"]
    got, want = flat(det.lg_params), to_flat(model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
