"""Port parity of the SuperPoint self-training recipe
(vings_mono_tpu_torch/runners/train_superpoint.py) against the JAX
package's scripts/train_superpoint.py at the script's shapes (120x160,
3 pairs), from the repository's superpoint_selftrained.npz in both: the
same seed gives the same `random_pair` sample bit for bit; one batch's
loss (1e-4 relative) and every parameter's gradient (1e-2 of its own
largest magnitude; the noise rule of tests/test_torch_trainer.py)
against the script's own `make_train_step` through an optax
transformation that hands the gradient back; the optimizer against the
script's chain (1e-6); the checkpoint read by both packages'
`load_superpoint`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vings_mono_tpu.models import superpoint as j_superpoint
from vings_mono_tpu.models.droid_net import load_flax_weights
from vings_mono_tpu_torch.models.flax_weights import (flax_from_state_dict,
                                                     state_dict_from_flax)
from vings_mono_tpu_torch.models.superpoint import load_superpoint
from vings_mono_tpu_torch.runners import train_superpoint as tsp

from test_torch_recipe_parity import (LOSS_REL, WEIGHTS, assert_grads_close,
                                      assert_steps_as_optax, flat,
                                      grad_catcher, load_script, torch_grads)

SP = WEIGHTS / "superpoint_selftrained.npz"
SEEDS = (5, 6, 7)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    return load_script("train_superpoint")


@pytest.fixture(scope="module")
def batch():
    """The script's batch of 3 pairs, from the port's sampler."""
    return tsp.stack_pairs([tsp.random_pair(np.random.default_rng(s))
                            for s in SEEDS])


@pytest.fixture(scope="module")
def jax_step(script, batch):
    """(loss, diagnostics, gradients) of one step of the script's own
    make_train_step."""
    params = load_flax_weights(str(SP))
    opt = grad_catcher()
    step = script.make_train_step(
        j_superpoint.SuperPoint(with_logits=True), opt)
    _, grads, loss, aux = step(params, opt.init(params),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [float(a) for a in aux], flat(grads)


def test_random_pair_as_the_script(script):
    for seed in (0, 1):
        a = tsp.random_pair(np.random.default_rng(seed))
        b = script.random_pair(np.random.default_rng(seed))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert a["valid"].sum() >= 16


def test_stack_pairs_interleaves_views_as_the_script(batch):
    assert batch["gray"].shape == (6, tsp.H, tsp.W, 1)
    assert batch["labels"].shape == (6, (tsp.H // 8) * (tsp.W // 8))
    assert batch["pts_a"].shape == (3, tsp.K, 2)
    assert batch["valid"].shape == (3, tsp.K)
    pair = tsp.random_pair(np.random.default_rng(SEEDS[1]))
    assert np.array_equal(batch["gray"][2:4], pair["gray"])
    assert np.array_equal(batch["pts_b"][1], pair["pts_b"])


def test_loss_and_gradients_as_the_script(batch, jax_step):
    jloss, jaux, jgrads = jax_step
    model = tsp.build_model(str(SP), "cpu")
    table = torch.as_tensor(tsp.target_table())
    loss, aux = tsp.superpoint_loss(model, tsp.to_batch(batch, "cpu"),
                                    table)
    loss.backward()
    loss = float(loss.detach())
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss), (loss, jloss)
    # det_ce and nce to the loss's tolerance; the accuracies are counts
    # of argmaxes, equal unless a near-tie flips
    for t, j in zip(aux[:2], jaux[:2]):
        assert abs(float(t) - j) <= LOSS_REL * abs(j) + 1e-6
    for t, j in zip(aux[2:], jaux[2:]):
        assert abs(float(t) - j) <= 0.02, (aux, jaux)
    tgrads = flax_from_state_dict(torch_grads(model))
    assert_grads_close(tgrads, jgrads, min_held=20)


def test_optimizer_steps_as_the_script(jax_step):
    _, _, jgrads = jax_step
    model = tsp.build_model(str(SP), "cpu")
    moved = assert_steps_as_optax(
        model, load_flax_weights(str(SP)), jgrads,
        lambda m: flax_from_state_dict(m.state_dict()),
        state_dict_from_flax, 3e-4, 20, 1.0)
    assert max(moved.values()) > 1e-6


def test_checkpoint_loads_in_both_packages(tmp_path):
    """save_weights writes what both packages' load_superpoint read: the
    f16 shipped weights come back with the same values, moved weights
    bit for bit."""
    model = tsp.build_model(str(SP), "cpu")
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        for p in model.parameters():
            p.add_(1e-3 * torch.randn(p.shape, generator=gen))
    path = tmp_path / "sp.npz"
    tsp.save_weights(str(path), model)
    back = load_superpoint(str(path))
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    _, params = j_superpoint.load_superpoint(str(path))
    got, want = flat(params), flax_from_state_dict(model.state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
