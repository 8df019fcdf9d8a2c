"""Port parity: models.droid_net against the flax DroidNet with the flax
parameters carried across (`flax_weights.state_dict_from_flax`), on the weights
in the repository and on random flax parameters. f32, every output within
1e-4 of its largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from vings_mono_tpu.models import droid_net as jnet
from vings_mono_tpu_torch.models import droid_net as tnet
from vings_mono_tpu_torch.models.flax_weights import state_dict_from_flax

import pathlib

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / \
    "vings_mono_tpu/weights/droid_selftrained.npz"
REL = 1e-4
h, w = 6, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops at these sizes are small. With the default thread
    count every test worker spins a whole OpenMP team on each of them, and
    the workers (and the JAX runs beside them) starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_flax_params():
    model = jnet.DroidNet()
    rng = jax.random.PRNGKey(3)
    fvars = model.init(rng, jnp.zeros((1, 64, 64, 3)),
                       method=jnet.DroidNet.extract_features)
    uvars = model.init(
        rng, jnp.zeros((1, h, w, 128)), jnp.zeros((1, h, w, 128)),
        jnp.zeros((1, h, w, 196)), None, jnp.zeros((1,), jnp.int32), 2, True,
        method=jnet.DroidNet.run_update)
    return {"params": {**fvars["params"], **uvars["params"]}}


def flat_numpy(variables):
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(variables).items()}


@pytest.fixture(scope="module", params=["selftrained", "random"])
def nets(request):
    variables = jnet.load_droid_weights(str(WEIGHTS)) \
        if request.param == "selftrained" else random_flax_params()
    tm = tnet.DroidNet()
    tm.load_state_dict(state_dict_from_flax(
        flat_numpy(variables)))
    return jnet.DroidNet(), variables, tm.eval()


def close(t, j, what):
    j = np.asarray(j)
    t = t.detach().numpy()
    assert t.shape == j.shape, what
    scale = float(np.abs(j).max())
    err = float(np.abs(t - j).max())
    assert err <= REL * scale, (what, err, scale)


def image(seed=0, H=48, W=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)


def test_encoders(nets):
    jm, variables, tm = nets
    img = image()
    x = jnet.normalize_image(jnp.asarray(img))
    tx = tnet.normalize_image(torch.from_numpy(img))
    close(tx, x, "normalize_image")
    with torch.no_grad():
        close(tm.fnet(tx), jm.apply(variables, x,
                                    method=lambda m, a: m.fnet(a)), "fnet")
        jf, jn, ji = jm.apply(variables, x,
                              method=jnet.DroidNet.extract_features)
        tf, tn, ti = tm.extract_features(tx)
    assert tf.shape == (1, 6, 8, 128)
    close(tf, jf, "fmap")
    close(tn, jn, "tanh(net)")
    close(ti, ji, "relu(inp)")


def update_inputs(seed, n):
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.normal(size=(n, h, w, 128))).astype(np.float32),
            np.abs(rng.normal(size=(n, h, w, 128))).astype(np.float32),
            rng.normal(size=(n, h, w, 196)).astype(np.float32),
            rng.normal(size=(n, h, w, 4)).astype(np.float32) * 3)


def test_update_without_graph_agg(nets):
    jm, variables, tm = nets
    net, inp, corr, _ = update_inputs(1, 1)
    jout = jm.apply(variables, *map(jnp.asarray, (net, inp, corr)),
                    method=jnet.DroidNet.run_update)
    with torch.no_grad():
        tout = tm.run_update(*map(torch.from_numpy, (net, inp, corr)))
    for t, j, what in zip(tout[:3], jout[:3], ("net", "delta", "weight")):
        close(t, j, what)
    assert tout[3] is None and tout[4] is None


def test_update_with_graph_agg_and_an_invalid_edge(nets):
    """Five edges over 3 frames; the last edge is sent to the extra segment
    (index 3), as the graph does with an invalid edge: only rows [:3] are
    read, and they must not see it."""
    jm, variables, tm = nets
    net, inp, corr, flow = update_inputs(2, 5)
    ii = np.asarray([0, 0, 2, 1, 3], np.int32)
    jout = jm.apply(variables, *map(jnp.asarray, (net, inp, corr, flow, ii)),
                    4, True, method=jnet.DroidNet.run_update)
    with torch.no_grad():
        tout = tm.run_update(*map(torch.from_numpy,
                                  (net, inp, corr, flow, ii)), 4, True)
        alone = tm.run_update(*(torch.from_numpy(x[:4]) for x in
                                (net, inp, corr, flow, ii)), 4, True)
    for t, j, what in zip(tout, jout, ("net", "delta", "weight", "eta",
                                       "upmask")):
        close(t, j, what)
    assert tout[3].shape == (4, h, w) and tout[4].shape == (4, h, w, 576)
    torch.testing.assert_close(alone[3][:3], tout[3][:3])
    torch.testing.assert_close(alone[4][:3], tout[4][:3])


def test_state_dict_covers_every_parameter(nets):
    _, variables, tm = nets
    sd = state_dict_from_flax(flat_numpy(variables))
    assert set(sd) == set(tm.state_dict())
    assert len(sd) == 102


def test_load_droid_weights_npz_is_f32():
    sd = tnet.load_droid_weights(str(WEIGHTS))
    assert len(sd) == 102
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert sd["fnet.conv1.weight"].shape == (32, 3, 7, 7)


def reference_state_dict(tm, gen):
    """A synthetic droid.pth: the reference's names, 'module.' prefix, and
    3-channel delta/weight heads (the loader trims them to 2)."""
    names = {"update.corr_enc1": "update.corr_encoder.0",
             "update.corr_enc2": "update.corr_encoder.2",
             "update.flow_enc1": "update.flow_encoder.0",
             "update.flow_enc2": "update.flow_encoder.2",
             "update.weight1": "update.weight.0",
             "update.weight2": "update.weight.2",
             "update.delta1": "update.delta.0",
             "update.delta2": "update.delta.2",
             "update.agg.eta": "update.agg.eta.0",
             "update.agg.upmask": "update.agg.upmask.0"}
    ref = {}
    for key, v in tm.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if mod in names:
            mod = names[mod]
        elif mod.endswith(".downsample"):
            mod = mod + ".0"
        for k in (1, 2, 3):
            mod = mod.replace(f"layer{k}_0", f"layer{k}.0") \
                .replace(f"layer{k}_1", f"layer{k}.1")
        if mod in ("update.weight.2", "update.delta.2"):
            extra = torch.randn((1,) + tuple(v.shape[1:]), generator=gen)
            v = torch.cat([v, extra])
        ref[f"module.{mod}.{leaf}"] = v.clone()
    return ref


def test_droid_pth_converter_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(5)
    tm = tnet.DroidNet(generator=gen)
    ref = reference_state_dict(tm, gen)
    assert ref["module.update.delta.2.weight"].shape[0] == 3
    path = tmp_path / "droid.pth"
    torch.save(ref, path)
    sd = tnet.load_droid_weights(str(path))
    want = tm.state_dict()
    assert set(sd) == set(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    # and against the JAX converter on the same checkpoint
    jp = flat_numpy(jnet.convert_droid_checkpoint(
        {k: v.numpy() for k, v in ref.items()}))
    sd2 = state_dict_from_flax(jp)
    for k in want:
        assert torch.equal(sd2[k], want[k]), k


def test_random_init_is_seeded():
    a = tnet.DroidNet(generator=torch.Generator().manual_seed(1))
    b = tnet.DroidNet(generator=torch.Generator().manual_seed(1))
    c = tnet.DroidNet(generator=torch.Generator().manual_seed(2))
    assert all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.fnet.conv1.weight, c.fnet.conv1.weight)
