"""Port parity of the metric-depth self-training recipe
(vings_mono_tpu_torch/runners/train_metric_depth.py) against the JAX
package's scripts/train_metric_depth.py at the script's shapes (128x160,
dim 192, depth 6, taps (1, 3, 5), a batch of 4), from the repository's
metric_depth_selftrained.npz in both: the same seed gives the same
`sample` bit for bit; one batch's loss (1e-4 relative) and every
parameter's gradient (1e-2 of its own largest magnitude; the noise rule
of tests/test_torch_trainer.py) against `jax.value_and_grad` of the
script's loss, which is nested in its main() and so copied below; the
DPT's upsampling, which the port writes as gathers, against
`jax.image.resize`; the optimizer against the script's chain (1e-6); the
checkpoint read by JAX's `load_dpt` and by the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from vings_mono_tpu.models import dpt_depth as j_dpt
from vings_mono_tpu_torch.models.dpt_depth import (dpt_flax_tree,
                                                   dpt_state_dict, load_dpt,
                                                   resize)
from vings_mono_tpu_torch.models.flax_weights import load_pickled_params
from vings_mono_tpu_torch.runners import train_metric_depth as tmd

from test_torch_recipe_parity import (LOSS_REL, WEIGHTS, assert_grads_close,
                                      assert_steps_as_optax, flat, load_script,
                                      torch_grads)

MD = WEIGHTS / "metric_depth_selftrained.npz"
SEEDS = (1, 2, 3, 4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    return load_script("train_metric_depth")


@pytest.fixture(scope="module")
def batch():
    picks = [tmd.sample(np.random.default_rng(s)) for s in SEEDS]
    return tuple(np.stack([p[k] for p in picks]) for k in range(2))


def jax_loss_fn(model, p, rgb, dep):
    """scripts/train_metric_depth.py:79-86 (nested in its main()), copied
    as it is."""
    pred = model.apply(p, rgb)
    err = jnp.abs(jnp.log(jnp.clip(pred, 1e-3)) -
                  jnp.log(jnp.clip(dep, 1e-3)))
    # absolute relative error diagnostic
    absrel = jnp.mean(jnp.abs(pred - dep) / jnp.clip(dep, 1e-3))
    return err.mean(), absrel


def jax_params():
    params, _ = load_pickled_params(str(MD))
    return {"params": params}


@pytest.fixture(scope="module")
def jax_step(script, batch):
    model = j_dpt.DPTDepth(**{k: v for k, v in script.ARCH.items()
                              if k != "hw"})
    (loss, absrel), grads = jax.jit(jax.value_and_grad(
        lambda p, *a: jax_loss_fn(model, p, *a), has_aux=True))(
        jax_params(), *(jnp.asarray(x) for x in batch))
    return float(loss), float(absrel), flat(grads)


def to_flat(model):
    return flat({"params": dpt_flax_tree(model)})


def from_flat(f):
    return dpt_state_dict(unflatten_dict(
        {tuple(k.split("/")): v for k, v in f.items()})["params"])


def test_sample_as_the_script(script):
    assert tmd.ARCH == script.ARCH and (tmd.H, tmd.W) == (script.H, script.W)
    for seed in (0, 1):
        a = tmd.sample(np.random.default_rng(seed))
        b = script.sample(np.random.default_rng(seed))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_upsampling_as_jax_image_resize():
    x = np.random.default_rng(0).normal(size=(2, 5, 8, 10)).astype(
        np.float32)
    for size in ((128, 160), (240, 432), (9, 31)):
        want = jax.image.resize(jnp.asarray(x), (2, 5) + size, "bilinear")
        got = resize(torch.as_tensor(x), size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)


def test_loss_and_gradients_as_the_script(batch, jax_step):
    jloss, jabsrel, jgrads = jax_step
    model = tmd.build_model(str(MD), "cpu")
    loss, (absrel,) = tmd.depth_loss(model, *(torch.as_tensor(x)
                                              for x in batch))
    loss.backward()
    loss = float(loss.detach())
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)
    assert abs(float(absrel) - jabsrel) <= LOSS_REL * abs(jabsrel)
    tgrads = flat({"params": dpt_flax_tree(model, torch_grads(model))})
    assert_grads_close(tgrads, jgrads, min_held=80)


def test_optimizer_steps_as_the_script(jax_step):
    _, _, jgrads = jax_step
    model = tmd.build_model(str(MD), "cpu")
    moved = assert_steps_as_optax(model, jax_params(), jgrads, to_flat,
                                  from_flat, 3e-4, 20, 1.0)
    assert max(moved.values()) > 1e-6


def test_checkpoint_loads_in_both_packages(tmp_path):
    model = tmd.build_model(str(MD), "cpu")
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        for p in model.parameters():
            p.add_(1e-3 * torch.randn(p.shape, generator=gen))
    path = tmp_path / "md.npz"
    tmd.save_weights(str(path), model)
    back, _ = load_dpt(str(path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    jmodel, params, _ = j_dpt.load_dpt(str(path))
    assert (jmodel.dim, jmodel.depth, tuple(jmodel.taps)) == (
        192, 6, (1, 3, 5))
    got, want = flat(params), to_flat(model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
