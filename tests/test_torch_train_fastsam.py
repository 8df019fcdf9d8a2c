"""Port parity of the FastSAM self-training recipe
(vings_mono_tpu_torch/runners/train_fastsam.py) against the JAX
package's scripts/train_fastsam.py at the script's shapes (160x224,
MAXOBJ 3, strides 8/16/32; a batch of 2), from the repository's
fastsam_selftrained.npz in both: the same seed gives the same `sample`
bit for bit; the port's FastSAM trains the same set of tensors as JAX's
param tree, the FrozenBN statistics among them; one batch's loss (1e-4
relative) and every parameter's gradient (1e-2 of its own largest
magnitude; the noise rule of tests/test_torch_trainer.py) against the
script's own `make_step` through an optax transformation that hands the
gradient back; the optimizer against the script's chain at its clip of
5.0 (1e-6), moving `mean` and `var`; the checkpoint read by JAX's
DynamicModel and by the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from vings_mono_tpu.dynamic.dynamic_model import DynamicModel as JDynamic
from vings_mono_tpu.models.fastsam import FastSAM as JFastSAM
from vings_mono_tpu_torch.models.flax_weights import (
    flax_tree_from_state_dict, load_pickled_params, state_dict_from_flax)
from vings_mono_tpu_torch.models.fastsam import load_fastsam
from vings_mono_tpu_torch.runners import train_fastsam as tfs

from test_torch_recipe_parity import (LOSS_REL, WEIGHTS, assert_grads_close,
                                      assert_steps_as_optax, flat,
                                      grad_catcher, load_script, torch_grads)

FS = WEIGHTS / "fastsam_selftrained.npz"
SEEDS = (2, 3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    return load_script("train_fastsam")


@pytest.fixture(scope="module")
def batch():
    picks = [tfs.sample(np.random.default_rng(s)) for s in SEEDS]
    return tuple(np.stack([p[k] for p in picks]) for k in range(4))


def jax_params():
    params, _ = load_pickled_params(str(FS))
    return {"params": params}


@pytest.fixture(scope="module")
def jax_step(script, batch):
    opt = grad_catcher()
    params = jax_params()
    step = script.make_step(JFastSAM(), opt)
    _, grads, loss, aux = step(params, opt.init(params),
                               *(jnp.asarray(x) for x in batch))
    return float(loss), [float(a) for a in aux], flat(grads)


def to_flat(model):
    return flat({"params": flax_tree_from_state_dict(model.state_dict())})


def test_sample_as_the_script(script, batch):
    for seed in (0, 1):
        a = tfs.sample(np.random.default_rng(seed))
        b = script.sample(np.random.default_rng(seed))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    rgb, boxes, masks, valid = batch
    assert rgb.shape == (2, tfs.H, tfs.W, 3) and valid.any(1).all()


def test_trains_the_tensors_of_the_jax_param_tree():
    """Every leaf of JAX's FastSAM tree, the FrozenBN statistics included,
    is a trainable parameter of the port's, and nothing else is."""
    shapes = jax.eval_shape(JFastSAM().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    want = {"/".join(k): tuple(v.shape)
            for k, v in flatten_dict(shapes).items()}
    model = tfs.build_model(None, "cpu")
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert not list(model.buffers())
    got = {k: v.shape for k, v in to_flat(model).items()}
    assert got == want
    assert len(trained) == len(want)
    stats = [k for k in want if k.endswith(("/mean", "/var"))]
    assert len(stats) > 100


def test_loss_and_gradients_as_the_script(batch, jax_step):
    jloss, jaux, jgrads = jax_step
    model = tfs.build_model(str(FS), "cpu")
    loss, aux = tfs.fastsam_loss(model, *(torch.as_tensor(x)
                                          for x in batch))
    loss.backward()
    loss = float(loss.detach())
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)
    for t, j in zip(aux, jaux):
        assert abs(float(t) - j) <= LOSS_REL * abs(j) + 1e-6, (aux, jaux)
    tgrads = flat({"params": flax_tree_from_state_dict(torch_grads(model))})
    assert_grads_close(tgrads, jgrads, min_held=150)
    # the statistics get gradients of their own
    assert any(np.abs(g).max() > 0 for k, g in tgrads.items()
               if k.endswith("/var"))


def test_optimizer_steps_as_the_script(jax_step):
    """Clip 5.0 + AdamW: the statistics move with the rest. (Where this
    batch gives a statistic no gradient, as in the heads of a stride with
    no object, the decay alone moves it by less than an f32 ulp.)"""
    _, _, jgrads = jax_step
    model = tfs.build_model(str(FS), "cpu")
    moved = assert_steps_as_optax(model, jax_params(), jgrads, to_flat,
                                  state_dict_from_flax, 8e-4, 20,
                                  tfs.CLIP_NORM)
    stats = [k for k in moved if k.endswith(("/mean", "/var"))
             and np.abs(jgrads[k]).max() > 0]
    assert len(stats) > 100
    assert all(moved[k] > 0.0 for k in stats)


def test_checkpoint_loads_in_both_packages(tmp_path):
    model = tfs.build_model(str(FS), "cpu")
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        for p in model.parameters():
            p.add_(1e-3 * torch.randn(p.shape, generator=gen))
    path = tmp_path / "fs.npz"
    tfs.save_weights(str(path), model)
    back = load_fastsam(str(path))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    dyn = JDynamic({"dynamic": {"backend": "flax", "weights": str(path)}})
    got, want = flat(dyn._seg_params), to_flat(model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
