"""Port parity for the loop detector's nets: SuperPoint
(`models/superpoint.py`: the net, `nms_keypoints`, `sample_descriptors`,
`mutual_nearest_match`, the checkpoint converter and the `.onnx` reader)
and LightGlue (`models/lightglue.py`), against the JAX package on the same
numpy inputs, live, under JAX_PLATFORMS=cpu.

Tolerances: the continuous maps (SuperPoint heat and descriptors,
LightGlue scores) within 1e-4 absolute; the functions after them on the
same input arrays exactly; the discrete outputs of a whole extract (the
keypoint set, where f32 rounding of the heat can flip a threshold or a
top-k tie) by overlap, at least 0.98 of the valid keypoints."""

import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vings_mono_tpu.loop.detect import LoopDetector as JDetector
from vings_mono_tpu.models import lightglue as jlg
from vings_mono_tpu.models import superpoint as jsp
from vings_mono_tpu.utils.onnx_weights import \
    load_onnx_initializers as j_load_onnx
from vings_mono_tpu_torch.datasets.synthetic3d import (render_room,
                                                       texture_params,
                                                       trajectory_c2w)
from vings_mono_tpu_torch.loop.detect import LoopDetector
from vings_mono_tpu_torch.models import lightglue as tlg
from vings_mono_tpu_torch.models import superpoint as tsp
from vings_mono_tpu_torch.models.flax_weights import state_dict_from_flax
from vings_mono_tpu_torch.utils.onnx_weights import load_onnx_initializers

ROOT = pathlib.Path(__file__).resolve().parents[1]
SP = ROOT / "vings_mono_tpu/weights/superpoint_selftrained.npz"
LG = ROOT / "vings_mono_tpu/weights/lightglue_selftrained.npz"
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test worker: the lane runs several workers,
    and the JAX runs beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def room_view(k, h, w, n=24):
    intr = np.asarray([0.9 * w, 0.9 * w, w / 2, h / 2])
    rgb, depth = render_room(trajectory_c2w(k, n), intr, h, w,
                             tex=texture_params(0, sharpness=1.0))
    return rgb, depth


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def superpoints():
    return jsp.load_superpoint(str(SP)), tsp.load_superpoint(str(SP))


def test_superpoint_heat_and_descriptors(superpoints):
    """Self-trained weights in both packages, one 64x64 room view: heat and
    descriptor maps within 1e-4."""
    (jm, jp), tm = superpoints
    gray = room_view(3, 64, 64)[0] @ np.asarray([0.299, 0.587, 0.114])
    x = gray[None, :, :, None].astype(np.float32)
    jh, jd = jm.apply(jp, jnp.asarray(x))
    with torch.no_grad():
        th, td, tl = tm(t(x), with_logits=True)
    assert th.shape == (1, 64, 64) and td.shape == (1, 8, 8, 256)
    assert tl.shape == (1, 8, 8, 65)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(td.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_superpoint_random_init_from_generator():
    """Without weights the port draws flax's lecun-normal initialisation
    from a generator: the same seed gives the same net, another seed
    another; the outputs have the JAX function's shapes."""
    a = tsp.load_superpoint(generator=torch.Generator().manual_seed(1))
    b = tsp.load_superpoint(generator=torch.Generator().manual_seed(1))
    c = tsp.load_superpoint(generator=torch.Generator().manual_seed(2))
    assert torch.equal(a.conv3a.weight, b.conv3a.weight)
    assert not torch.equal(a.conv3a.weight, c.conv3a.weight)
    assert float(a.conv3a.bias.abs().max()) == 0.0
    w = a.conv3a.weight
    assert abs(float(w.std()) - (1 / w[0].numel()) ** 0.5) < 0.1 * float(
        w.std())
    heat, desc = a(torch.rand(1, 64, 96, 1))
    assert heat.shape == (1, 64, 96) and desc.shape == (1, 8, 12, 256)


@pytest.mark.parametrize("case", ["peaks", "net"])
def test_nms_keypoints_as_jax(case, superpoints):
    """The same heat array into both: the same keypoints, scores and valid
    flags (the JAX test's three peaks, and a net's heat)."""
    if case == "peaks":
        heat = np.zeros((64, 64), np.float32)
        for y, x, v in [(10, 20, 0.9), (40, 50, 0.8), (11, 21, 0.5)]:
            heat[y, x] = v
        max_kp = 8
    else:
        (jm, jp), _ = superpoints
        gray = room_view(5, 64, 96)[0].mean(-1)
        heat = np.asarray(jm.apply(jp, jnp.asarray(
            gray[None, :, :, None], jnp.float32))[0][0])
        max_kp = 64
    jxy, js, jv = (np.asarray(a) for a in jsp.nms_keypoints(
        jnp.asarray(heat), max_kp=max_kp))
    txy, ts, tv = (a.numpy() for a in tsp.nms_keypoints(t(heat), max_kp))
    assert jv.sum() >= 2 and (tv == jv).all()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(txy[tv], jxy[jv])
    if case == "peaks":
        assert {(int(x), int(y)) for x, y in txy[tv]} == {(20, 10), (50, 40)}


def test_sample_descriptors_as_jax():
    rng = np.random.default_rng(0)
    desc = rng.normal(size=(6, 8, 256)).astype(np.float32)
    xy = rng.uniform(-4, 70, (40, 2)).astype(np.float32)
    j = np.asarray(jsp.sample_descriptors(jnp.asarray(xy), jnp.asarray(desc),
                                          (48, 64)))
    tt = tsp.sample_descriptors(t(xy), t(desc), (48, 64)).numpy()
    np.testing.assert_allclose(tt, j, rtol=0, atol=1e-6)


def test_mutual_nearest_match_as_jax():
    """A permuted, noisy copy with some keypoints invalid: the same
    matches and the same accepted set."""
    rng = np.random.default_rng(1)
    d = rng.normal(size=(64, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    perm = rng.permutation(64)
    d2 = d[perm] + 0.05 * rng.normal(size=d.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v1 = rng.uniform(size=64) > 0.1
    v2 = rng.uniform(size=64) > 0.1
    ji, jo = (np.asarray(a) for a in jsp.mutual_nearest_match(
        jnp.asarray(d), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2)))
    ti, to = (a.numpy() for a in tsp.mutual_nearest_match(
        t(d), t(d2), t(v1), t(v2)))
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ti[to], ji[jo])
    assert to.sum() > 40


def test_extract_and_match_as_jax():
    """LoopDetector.extract (cv2 resize to 512 wide, the net, NMS, the
    descriptor sampling) and the mutual-NN match on two room views: the
    valid keypoints overlap by at least 0.98, their descriptors agree
    within 1e-4 where both have them, and the matched pairs overlap by at
    least 0.95."""
    pytest.importorskip("cv2")
    jd, td = JDetector({}, str(SP)), LoopDetector({}, str(SP))
    a, b = room_view(2, 48, 64)[0], room_view(4, 48, 64)[0]
    fa_j, fa_t = jd.extract(a), td.extract(a)
    keys_j = {tuple(k) for k in np.round(fa_j[0][fa_j[2]], 4)}
    keys_t = {tuple(k) for k in np.round(fa_t[0][fa_t[2]], 4)}
    assert len(keys_j) > 100
    assert len(keys_j & keys_t) >= 0.98 * max(len(keys_j), len(keys_t))
    both = fa_j[2] & fa_t[2] & np.all(fa_j[0] == fa_t[0], axis=-1)
    np.testing.assert_allclose(fa_t[3][both], fa_j[3][both], rtol=0,
                               atol=TOL)
    mj = jd.match(fa_j, jd.extract(b))
    mt = td.match(fa_t, td.extract(b))
    pj = {tuple(np.round(np.r_[p, q], 4)) for p, q in zip(*mj)}
    pt = {tuple(np.round(np.r_[p, q], 4)) for p, q in zip(*mt)}
    assert len(pj) >= 20
    assert len(pj & pt) >= 0.95 * max(len(pj), len(pt))


def _lg_inputs(seed, N=32, M=40):
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(N, 256)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 = np.concatenate([d0[:24] + 0.1 * rng.normal(size=(24, 256)),
                         rng.normal(size=(M - 24, 256))]).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    k0 = rng.uniform(0, 64, (N, 2)).astype(np.float32)
    k1 = rng.uniform(0, 64, (M, 2)).astype(np.float32)
    v0 = np.ones(N, bool)
    v0[-3:] = False
    v1 = np.ones(M, bool)
    v1[-2:] = False
    return d0, d1, k0, k1, v0, v1


def _lg_both(jmodel, jparams, tmodel, inputs):
    d0, d1, k0, k1, v0, v1 = inputs
    jk0 = jlg.normalize_keypoints(jnp.asarray(k0), (64, 64))
    jk1 = jlg.normalize_keypoints(jnp.asarray(k1), (64, 64))
    tk0 = tlg.normalize_keypoints(t(k0), (64, 64))
    tk1 = tlg.normalize_keypoints(t(k1), (64, 64))
    np.testing.assert_allclose(tk0.numpy(), np.asarray(jk0), atol=1e-7)
    js, jz0, jz1 = (np.asarray(a) for a in jmodel.apply(
        jparams, jnp.asarray(d0), jnp.asarray(d1), jk0, jk1,
        jnp.asarray(v0), jnp.asarray(v1)))
    with torch.no_grad():
        ts, tz0, tz1 = (a.numpy() for a in tmodel(
            t(d0), t(d1), tk0, tk1, t(v0), t(v1)))
    live = np.isfinite(js) & (js > -1e8)
    np.testing.assert_allclose(ts[live], js[live], rtol=0, atol=TOL)
    np.testing.assert_allclose(tz0, jz0, rtol=0, atol=TOL)
    np.testing.assert_allclose(tz1, jz1, rtol=0, atol=TOL)
    for thr in (0.0, 0.1):
        ji, jo = (np.asarray(a) for a in jlg.extract_matches(
            jnp.asarray(js), jnp.asarray(v0), jnp.asarray(v1), thr))
        ti, to = (a.numpy() for a in tlg.extract_matches(
            t(ts), t(v0), t(v1), thr))
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(ti[to], ji[jo])
    return ts


def test_lightglue_one_layer_from_jax_init():
    """LightGlue(layers=1) with the JAX init's parameters carried across:
    scores and matchability within 1e-4, the same matches."""
    inputs = _lg_inputs(0)
    jm = jlg.LightGlue(layers=1)
    d0, d1, k0, k1, v0, v1 = inputs
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(d0), jnp.asarray(d1),
                     jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(v0),
                     jnp.asarray(v1))
    tm = tlg.LightGlue(layers=1)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params["params"]),
        renames={"scale": "weight"}))
    _lg_both(jm, params, tm.eval(), inputs)


def test_lightglue_selftrained_as_jax():
    """The self-trained checkpoint (pickled tree, arch layers 2) loaded
    by each package: scores within 1e-4, the same matches."""
    data = np.load(LG, allow_pickle=True)
    layers = int(data["arch"].item()["layers"])
    jm = jlg.LightGlue(layers=layers)
    tm = tlg.load_lightglue(str(LG))
    assert tm.layers == layers == 2
    _lg_both(jm, {"params": data["params"].item()}, tm, _lg_inputs(1))


def test_converters_take_the_public_torch_names():
    """A SuperPoint and a LightGlue state_dict in the public torch naming
    through each package's converter: the port's tensors are the JAX
    tree's, transposed."""
    rng = np.random.default_rng(2)
    sd = {}
    for name, cin, cout, k in tsp._LAYERS:
        sd[name + ".weight"] = rng.normal(size=(cout, cin, k, k)).astype(
            np.float32)
        sd[name + ".bias"] = rng.normal(size=cout).astype(np.float32)
    want = state_dict_from_flax(jsp.convert_superpoint_checkpoint(sd))
    got = tsp.convert_superpoint_checkpoint(sd)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    tsp.SuperPoint().load_state_dict(got)

    lsd = {}

    def dense(name, i, o):
        lsd[name + ".weight"] = rng.normal(size=(o, i)).astype(np.float32)
        lsd[name + ".bias"] = rng.normal(size=o).astype(np.float32)

    dense("input_proj", 256, 256)
    dense("log_assignment.final_proj", 256, 256)
    dense("log_assignment.matchability", 256, 1)
    for i in range(jlg.LAYERS):
        for kind, qkv in (("self", ("Wqkv_q", "Wqkv_k", "Wqkv_v")),
                          ("cross", ("Wq", "Wk", "Wv"))):
            base = f"transformers.{i}.{kind}_attn"
            for n in qkv + ("out_proj",):
                dense(f"{base}.{n}", 256, 256)
            dense(f"{base}.ffn.0", 512, 512)
            for leaf in ("weight", "bias"):      # the LayerNorm
                lsd[f"{base}.ffn.1.{leaf}"] = rng.normal(size=512).astype(
                    np.float32)
            dense(f"{base}.ffn.3", 512, 256)
    want = state_dict_from_flax(jlg.convert_lightglue_checkpoint(lsd)[
        "params"], renames={"scale": "weight"})
    got = tlg.convert_lightglue_checkpoint(lsd)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    tlg.LightGlue().load_state_dict(got)


def test_onnx_initializer_reader_as_jax(tmp_path):
    """A hand-encoded ONNX protobuf (raw and packed-float tensors, packed
    dims): both readers return the same arrays."""
    def varint(v):
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out

    def field(num, wt, payload):
        key = varint((num << 3) | wt)
        return key + (varint(len(payload)) + payload if wt == 2 else payload)

    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    raw = (field(1, 0, varint(2)) + field(1, 0, varint(3))
           + field(2, 0, varint(1)) + field(8, 2, b"convPa.weight")
           + field(9, 2, w.tobytes()))
    b = np.asarray([0.5, -1.5, 2.25], np.float32)
    packed = (field(1, 2, varint(3)) + field(2, 0, varint(1))
              + field(8, 2, b"convPa.bias")
              + field(4, 2, struct.pack("<3f", *b)))
    p = tmp_path / "tiny.onnx"
    p.write_bytes(field(7, 2, field(5, 2, raw) + field(5, 2, packed)))
    got, want = load_onnx_initializers(str(p)), j_load_onnx(str(p))
    assert sorted(got) == sorted(want) == ["convPa.bias", "convPa.weight"]
    np.testing.assert_array_equal(got["convPa.weight"], w)
    np.testing.assert_array_equal(got["convPa.bias"], b)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
