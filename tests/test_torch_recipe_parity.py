"""What the port's self-training recipes share
(vings_mono_tpu_torch/runners/self_training.py), held here, and the
checks the recipe tests (tests/test_torch_train_*.py) share: loading a
script as a module, an optax transformation that hands the gradient
back, the gradient tolerance with the noise rule of
tests/test_torch_trainer.py, and optimizer steps against the scripts'
optax chain. The tests below: the room camera as every script builds it,
the sample pool (filled, capped, refreshed, a producer's error raised, a
fixed pool drawn as the scripts draw) and the loop's log lines and
checkpoints."""

import importlib.util
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vings_mono_tpu_torch.models import droid_trainer as tt
from vings_mono_tpu_torch.runners import self_training

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "vings_mono_tpu" / "weights"
LOSS_REL = 1e-4
GRAD_REL = 1e-2
NOISE = 1e-6
STEP_ATOL = 1e-6


def load_script(name):
    """scripts/<name>.py as a module (its `__main__` guard keeps main()
    from running)."""
    spec = importlib.util.spec_from_file_location(
        f"recipe_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def grad_catcher():
    """An optax transformation whose updates are zero and whose state is
    the last gradient: through a script's own step it hands the gradient
    back at full precision."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads
    return optax.GradientTransformation(init, update)


def flat(tree):
    """A flax tree -> {'a/b/c': numpy array}."""
    from flax.traverse_util import flatten_dict
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(tree).items()}


def torch_grads(model):
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def assert_grads_close(tgrads, jgrads, min_held):
    """Each tensor's gradient within GRAD_REL of its own largest JAX
    magnitude; a tensor whose JAX gradient stays below NOISE of the
    largest of all is held to that bound in both. Returns the count
    held to GRAD_REL."""
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
    assert n_held >= min_held and gmax > 0
    return n_held


def optax_chain(lr, steps, clip):
    """The scripts' optimizer: clip_by_global_norm + adamw(1e-5) at the
    warmup-cosine schedule."""
    warmup = min(100, max(steps // 10, 1))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
        end_value=lr * 0.05)
    return optax.chain(optax.clip_by_global_norm(clip),
                       optax.adamw(sched, weight_decay=1e-5))


def assert_steps_as_optax(model, params, jgrads, to_flat, from_flat, lr,
                          steps, clip, scales=(1e3, 1e3, 1e-3)):
    """Steps of the port's make_optimizer + apply_gradients(clip_norm=
    clip) against the script's chain from the same parameters, on the
    JAX gradients scaled by `scales` (clipped, then not): the parameters
    to STEP_ATOL. to_flat(model) -> {'params/...': array} and
    from_flat(flat) -> the model's named gradients convert between the
    two layouts. Returns the largest move of a parameter."""
    opt = optax_chain(lr, steps, clip)
    state = opt.init(params)
    update = jax.jit(opt.update)
    from flax.traverse_util import unflatten_dict
    for s in scales:
        g = unflatten_dict({tuple(k.split("/")): jnp.asarray(v * s)
                            for k, v in jgrads.items()})
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
    want = flat(params)
    # copies: a 1-D tensor's numpy view shares the parameter's memory
    start = {k: v.copy() for k, v in to_flat(model).items()}
    opt_t, sched_t = tt.make_optimizer(model, lr, steps)
    for s in scales:
        grads = from_flat({k: v * s for k, v in jgrads.items()})
        for n, p in model.named_parameters():
            p.grad = grads[n]
        assert tt.apply_gradients(opt_t, sched_t, clip_norm=clip)
    got = to_flat(model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=STEP_ATOL,
                                   err_msg=k)
    return {k: float(np.abs(got[k] - start[k]).max()) for k in got}


@pytest.mark.parametrize("name", ["train_superpoint", "train_lightglue"])
def test_room_camera_as_the_scripts(name):
    c2w = load_script(name)._c2w
    rng = np.random.default_rng(0)
    for _ in range(5):
        pos, yaw, pitch = rng.normal(size=3), rng.uniform(-3, 3), \
            rng.uniform(-0.5, 0.5)
        assert np.array_equal(self_training.room_c2w(pos, yaw, pitch),
                              c2w(pos, yaw, pitch))


def test_the_pool_fills_caps_and_refreshes():
    made = []
    lock = threading.Lock()

    def sample(rng):
        with lock:
            made.append(len(made))
            return made[-1]
    pool = self_training.SamplePool(sample, seed=0, cap=4, min_fill=3)
    try:
        assert len(pool.items) >= 3
        for _ in range(200):
            with lock:
                if len(made) > 20:
                    break
            threading.Event().wait(0.01)
        brng = np.random.default_rng(1)
        picks = pool.draw(brng, size=6)
        one = pool.draw(brng)
    finally:
        pool.close()
    assert len(made) > 20 and len(pool.items) == 4
    assert max(pool.items) > 3            # later samples replaced earlier
    assert len(picks) == 6 and set(picks + [one]) <= set(made)
    assert not pool._thread.is_alive()


def test_a_fixed_pool_draws_as_the_scripts():
    items = list(range(7))
    pool = self_training.SamplePool.fixed(items)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    assert pool.draw(a, size=4) == [items[i] for i in
                                    b.integers(len(items), size=4)]
    assert pool.draw(a) == items[b.integers(len(items))]
    pool.close()


def test_a_producer_error_is_raised():
    def broken(rng):
        raise ValueError("no room")
    with pytest.raises(RuntimeError, match="producer") as e:
        self_training.SamplePool(broken, seed=0, cap=4, min_fill=1)
    assert isinstance(e.value.__cause__, ValueError)


def test_the_loop_logs_and_saves(capsys):
    saved, seen = [], []
    hist = self_training.train_loop(
        lambda b: (torch.tensor(float(b)), (torch.tensor(2.0 * b),), True),
        iter(range(1, 8)).__next__, 7, saved.append, "out.npz", 3,
        ("loss", "twice"), log_every=2,
        on_step=lambda it, loss, ok: seen.append((it, loss, ok)))
    assert hist == [[float(k), 2.0 * k] for k in range(1, 8)]
    assert saved == ["out.npz"] * 3          # steps 3, 6 and the last
    assert seen == [(k, float(k + 1), True) for k in range(7)]
    out = capsys.readouterr().out
    assert "step 2/7 loss 1.5000 twice 3.0000" in out
    assert out.count("saved out.npz") == 3
