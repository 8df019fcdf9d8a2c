"""Port parity of the DROID trainer (models/droid_trainer.py,
runners/train_droid.py) on the repository's self-trained DroidNet weights
and one room clip of 3 frames at 48x64, one unrolled step: the loss and
every parameter's gradient against one `jax.value_and_grad` of the JAX
package's `droid_training_loss` (module-scoped: it takes ~40 s on a CPU),
the optimizer step against optax's chain, the skip-on-nonfinite rule, the
covisibility sampling, and the checkpoint layout both packages read.

Tolerances: the loss to 1e-4 relative; each parameter tensor's gradient
to 1e-2 of its own largest magnitude (the two packages sum the
correlation, the Hessian and the convolutions in other orders). The
biases ahead of an instance norm have a true gradient of 0, so both
packages give rounding noise there: a tensor whose JAX gradient stays
below 1e-6 of the largest gradient of all is held to that bound in both.
The optimizer step to 1e-6 absolute on the parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vings_mono_tpu.datasets import tartanair as j_tartanair
from vings_mono_tpu.models import droid_trainer as jt
from vings_mono_tpu.models.droid_net import DroidNet as JDroidNet
from vings_mono_tpu.models.droid_net import load_flax_weights
from vings_mono_tpu.ops import lie as j_lie
from vings_mono_tpu_torch.datasets import tartanair
from vings_mono_tpu_torch.models import droid_trainer as tt
from vings_mono_tpu_torch.models.droid_net import (DroidNet,
                                                   load_droid_weights,
                                                   save_droid_weights)
from vings_mono_tpu_torch.models.flax_weights import (flax_from_state_dict,
                                                     state_dict_from_flax)
from vings_mono_tpu_torch.runners.train_droid import random_clip

from test_torch_vo_slice import WEIGHTS

LOSS_REL = 1e-4
GRAD_REL = 1e-2
NOISE = 1e-6
STEP_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torch_model():
    model = DroidNet()
    model.load_state_dict(load_droid_weights(WEIGHTS))
    return model


@pytest.fixture(scope="module")
def clip():
    return random_clip(np.random.default_rng(3), p=3, h=48, w=64)


@pytest.fixture(scope="module")
def jax_loss_and_grads(clip):
    params = load_flax_weights(str(WEIGHTS))
    batch = jt.TrainBatch(**{k: jnp.asarray(v) for k, v in clip.items()})
    loss, grads = jax.value_and_grad(lambda p: jt.droid_training_loss(
        JDroidNet(), p, batch, num_steps=1))(params)
    return float(loss), {"/".join(k): np.asarray(v)
                         for k, v in flatten_dict(grads).items()}


def torch_loss_and_grads(clip):
    model = torch_model()
    batch = tt.TrainBatch(**{k: torch.as_tensor(v) for k, v in clip.items()})
    loss = tt.droid_training_loss(model, batch, num_steps=1)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return float(loss.detach()), flax_from_state_dict(grads)


def test_loss_and_gradients_as_jax(clip, jax_loss_and_grads):
    jloss, jgrads = jax_loss_and_grads
    tloss, tgrads = torch_loss_and_grads(clip)
    assert np.isfinite(tloss)
    assert abs(tloss - jloss) <= LOSS_REL * abs(jloss), (tloss, jloss)
    assert sorted(tgrads) == sorted(jgrads)
    gmax = max(np.abs(g).max() for g in jgrads.values())
    n_held = 0
    for k, jg in jgrads.items():
        tg, scale = tgrads[k], np.abs(jg).max()
        if scale < NOISE * gmax:
            assert np.abs(tg).max() < NOISE * gmax, k
            continue
        err = np.abs(tg - jg).max()
        assert err <= GRAD_REL * scale, (k, err, scale)
        n_held += 1
    assert n_held > 60 and gmax > 1e-3


def optax_chain(lr, steps):
    warmup = min(100, max(steps // 10, 1))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
        end_value=lr * 0.05)
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(sched, weight_decay=1e-5))


def test_optimizer_steps_as_optax(jax_loss_and_grads):
    """Four steps of clip + AdamW + warmup-cosine (the first at rate 0) on
    the JAX gradients scaled up 50x (clipped) and then down (not
    clipped), from the same parameters."""
    _, jgrads = jax_loss_and_grads
    lr, steps = 2e-4, 20
    scales = (50.0, 50.0, 1e-3, 50.0)
    params = load_flax_weights(str(WEIGHTS))
    opt = optax_chain(lr, steps)
    state = opt.init(params)
    update = jax.jit(opt.update)
    for s in scales:
        g = unflatten_dict({tuple(k.split("/")): jnp.asarray(v * s)
                            for k, v in jgrads.items()})
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
    want = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(params).items()}

    model = torch_model()
    opt_t, sched_t = tt.make_optimizer(model, lr, steps)
    rates = []
    for s in scales:
        rates.append(opt_t.param_groups[0]["lr"])
        grads = state_dict_from_flax({k: v * s for k, v in jgrads.items()})
        for n, p in model.named_parameters():
            p.grad = grads[n]
        assert tt.apply_gradients(opt_t, sched_t)
    got = flax_from_state_dict(model.state_dict())
    assert rates[0] == 0.0 and rates[1] == pytest.approx(lr / 2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=STEP_ATOL,
                                   err_msg=k)
    start = flax_from_state_dict(torch_model().state_dict())
    moved = max(np.abs(got[k] - start[k]).max() for k in got)
    assert moved > 1e-5


def test_a_nonfinite_step_changes_nothing(clip):
    """A NaN image gives a NaN loss: make_train_step applies nothing, and
    the parameters, the Adam state and the schedule stay as they were;
    the next good step is the optimizer's third."""
    model = torch_model()
    opt, sched = tt.make_optimizer(model, 2e-4, 20)
    step = tt.make_train_step(model, opt, sched, num_steps=1)
    good = tt.TrainBatch(**{k: torch.as_tensor(v) for k, v in clip.items()})
    step(good)                                    # step 1, at rate 0
    step(good)                                    # step 2 moves
    before = {k: v.clone() for k, v in model.state_dict().items()}
    adam = {id(p): {k: v.clone() for k, v in s.items()}
            for p, s in opt.state.items()}
    epoch, rate = sched.last_epoch, opt.param_groups[0]["lr"]
    bad_images = good.images.clone()
    bad_images[0, 0, 0, 0] = float("nan")
    loss, applied = step(good._replace(images=bad_images))
    assert not applied and not torch.isfinite(loss)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in opt.state.items():
        for k, v in s.items():
            assert torch.equal(v, adam[id(p)][k])
    assert sched.last_epoch == epoch and opt.param_groups[0]["lr"] == rate
    assert all(int(s["step"]) == 2 for s in opt.state.values())
    loss, applied = step(good)
    assert applied and torch.isfinite(loss)
    assert all(int(s["step"]) == 3 for s in opt.state.values())


def test_covisibility_sampling_as_jax():
    P = 8
    rng = np.random.default_rng(11)
    xi = np.zeros((P, 6), np.float32)
    xi[1:, 0] = 0.25 * np.arange(1, P)
    xi[1:, 3:] = rng.normal(size=(P - 1, 3)) * 0.02
    poses = np.asarray(j_lie.se3_exp(jnp.asarray(xi)))
    disps = rng.uniform(0.3, 0.6, (P, 8, 12)).astype(np.float32)
    intr = np.asarray([10.0, 10.0, 6.0, 4.0], np.float32)
    D = tartanair.build_frame_graph(poses, disps, intr)
    Dj = j_tartanair.build_frame_graph(poses, disps, intr)
    assert np.isinf(np.diag(D)).all()
    np.testing.assert_allclose(D, Dj, rtol=1e-5, atol=1e-5)
    for seed in range(3):
        a = tartanair.sample_covisible_clip(
            D, n_frames=5, thresh=float(np.median(D[np.isfinite(D)])),
            rng=np.random.default_rng(seed))
        b = j_tartanair.sample_covisible_clip(
            D, n_frames=5, thresh=float(np.median(D[np.isfinite(D)])),
            rng=np.random.default_rng(seed))
        assert np.array_equal(a, b) and len(set(a.tolist())) == 5
    img = rng.uniform(0, 1, (6, 8, 3)).astype(np.float32)
    assert np.array_equal(
        tartanair.augment_rgb(np.random.default_rng(4), img),
        j_tartanair.augment_rgb(np.random.default_rng(4), img))


def test_saved_weights_load_in_jax_and_back(tmp_path):
    """save_droid_weights writes what JAX's load_flax_weights reads: the
    repository's weights come back under the same keys with the same
    values; trained (non-f16) parameters come back bit for bit in both
    packages."""
    model = torch_model()
    path = tmp_path / "droid.npz"
    save_droid_weights(str(path), model)
    got = {"/".join(k): np.asarray(v) for k, v in
           flatten_dict(load_flax_weights(str(path))).items()}
    ref = {"/".join(k): np.asarray(v) for k, v in
           flatten_dict(load_flax_weights(str(WEIGHTS))).items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], ref[k])
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1e-3 * torch.randn(p.shape, generator=gen))
    save_droid_weights(str(path), model)
    back = load_droid_weights(str(path))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    want = flax_from_state_dict(model.state_dict())
    got = {"/".join(k): np.asarray(v) for k, v in
           flatten_dict(load_flax_weights(str(path))).items()}
    for k in want:
        assert np.array_equal(got[k], want[k]), k
