"""Port parity for dynamic masking: the FastSAM-class segmenter
(`models/fastsam.py`: the net, `decode_boxes`, `_nms`,
`segment_everything`) and `dynamic/dynamic_model.py` (`get_dynamic_mask`
with the `cc`, `precomputed` and learned backends, `apply_to_viz_out`),
against the JAX package on the same numpy inputs, live, under
JAX_PLATFORMS=cpu. `mirror_mapper` gives the port the JAX mapper's state,
Adam moments and random-key stream, so both packages render and train the
same map.

Tolerances: FastSAM's raw maps within 1e-4 absolute (their values reach
~12); `decode_boxes` within 1e-6 relative + 1e-5 and `_nms` exactly on the same arrays;
the masks of whole calls (thresholds on f32 values: `scores > conf`,
`m > 0.5`, the error quantile) by IoU, at least 0.99 per mask."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_viz_out
from test_torch_slice import OVERRIDES, JaxDraws
from vings_mono_tpu.dynamic.dynamic_model import DynamicModel as JDynamic
from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
from vings_mono_tpu.models import fastsam as jfs
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch import middleware
from vings_mono_tpu_torch.datasets.synthetic3d import (render_room,
                                                       texture_params,
                                                       trajectory_c2w)
from vings_mono_tpu_torch.dynamic.dynamic_model import DynamicModel
from vings_mono_tpu_torch.mapper import state as tstate
from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
from vings_mono_tpu_torch.models import fastsam as tfs
from vings_mono_tpu_torch.utils.config import load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
FS = ROOT / "vings_mono_tpu/weights/fastsam_selftrained.npz"
IOU = 0.99


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test worker: the lane runs several workers,
    and the JAX runs beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


def room_with_blob(h=64, w=96):
    rgb, _ = render_room(trajectory_c2w(3, 24),
                         np.asarray([0.9 * w, 0.9 * w, w / 2, h / 2]), h, w,
                         tex=texture_params(0, sharpness=1.0))
    rgb = rgb.copy()
    rgb[h // 4:h // 2, w // 4:w // 2] = (1.0, 0.1, 0.1)
    return rgb


def mapper_configs(extra=None):
    """The JAX and the port config of tests/test_torch_slice.py's small
    mapper."""
    extra = extra or {}
    over = {**OVERRIDES, **extra}
    jc = j_load_config(overrides={**over, "mapper": {
        **OVERRIDES["mapper"], "interpret": True}})
    return jc, load_config(overrides=over)


def mirror_mapper(jm, tc):
    """A port mapper holding the JAX mapper's state, Adam moments, image
    size, history and random-key stream."""
    tm = GaussianMapper(tc, device="cpu")
    tm.state = tstate.state_from_numpy(
        {f: np.array(getattr(jm.state, f)) for f in tstate.STATE_FIELDS},
        "cpu")
    tm.opt = tstate.SparseAdamState(
        m={k: t(v) for k, v in jm.opt.m.items()},
        v={k: t(v) for k, v in jm.opt.v.items()}, step=int(jm.opt.step))
    tm.H, tm.W = jm.H, jm.W
    tm.initialized = jm.initialized
    tm.history, tm.time_idx = list(jm.history), jm.time_idx
    tm.bin_kwargs["p_cap"] = int(jm.bin_kwargs["p_cap"])
    draws = JaxDraws()
    draws.key = jm.key
    tm._densify_draws = draws.densify(tm)
    tm._kf_schedule = draws.schedule
    return tm


# ---------------------------------------------------------------------------
# FastSAM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fastsams():
    data = np.load(FS, allow_pickle=True)
    return (jfs.FastSAM(), {"params": data["params"].item()},
            tfs.load_fastsam(str(FS)))


def test_fastsam_raw_maps(fastsams):
    """Self-trained weights at width 0.25 on a 64x64 room view: the three
    strides' raw maps and the prototypes within 1e-4."""
    jm, jp, tm = fastsams
    x = room_with_blob(64, 64)[None]
    jpreds, jproto = jm.apply(jp, jnp.asarray(x))
    with torch.no_grad():
        tpreds, tproto = tm(t(x))
    assert [p.shape[1:3] for p in tpreds] == [(8, 8), (4, 4), (2, 2)]
    assert tproto.shape == (1, 16, 16, 32)
    for a, b in zip(jpreds, tpreds):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(tproto.numpy(), np.asarray(jproto), rtol=0,
                               atol=1e-4)


def test_fastsam_random_init_shapes():
    """Without weights the port draws flax's initialisation from a
    generator; the JAX test's shapes at 64x96."""
    m = tfs.load_fastsam(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        preds, proto = m(torch.zeros(1, 64, 96, 3))
    assert [p.shape[1:3] for p in preds] == [(8, 12), (4, 6), (2, 3)]
    assert preds[0].shape[-1] == 4 * tfs.REG_MAX + 1 + 32
    assert proto.shape == (1, 16, 24, 32)


@pytest.mark.parametrize("case", ["one_hot", "random"])
def test_decode_boxes_as_jax(case):
    """The JAX test's one-hot DFL (exact bin distances) and a random raw
    map: boxes (pixels, up to ~200), scores and coefficients within 1e-6
    relative plus 1e-5 absolute."""
    rng = np.random.default_rng(0)
    pred = np.zeros((1, 4, 6, 4 * tfs.REG_MAX + 1 + 32), np.float32)
    if case == "one_hot":
        box = np.full((4, tfs.REG_MAX), -20.0, np.float32)
        for side, k in enumerate([2, 3, 4, 5]):
            box[side, k] = 20.0
        pred[..., :4 * tfs.REG_MAX] = box.reshape(-1)
    else:
        pred[:] = rng.normal(size=pred.shape) * 3
    j = [np.asarray(a) for a in jfs.decode_boxes(jnp.asarray(pred), 16)]
    tt = [a.numpy() for a in tfs.decode_boxes(t(pred), 16)]
    for a, b in zip(j, tt):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5)
    if case == "one_hot":
        np.testing.assert_allclose(tt[0][0, 0], [(0.5 - 2) * 16,
                                                 (0.5 - 3) * 16,
                                                 (0.5 + 4) * 16,
                                                 (0.5 + 5) * 16], atol=1e-4)


def test_nms_as_jax():
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 60, (80, 2))
    wh = rng.uniform(4, 30, (80, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(size=80).astype(np.float32)
    for thr, cap in ((0.6, 64), (0.3, 10)):
        keep = tfs._nms(boxes, scores, thr, cap)
        np.testing.assert_array_equal(keep, jfs._nms(boxes, scores, thr,
                                                     cap))
    assert list(tfs._nms(np.asarray([[0, 0, 10, 10], [1, 1, 11, 11],
                                     [50, 50, 60, 60]], np.float32),
                         np.asarray([0.9, 0.8, 0.7], np.float32), 0.5)) \
        == [0, 2]


def test_segment_everything_masks(fastsams):
    """The self-trained net on a 64x96 room view with a red blob (zero-
    padded to 64x96, no padding needed; and a 48x80 crop, padded): the same
    number of masks, each with IoU >= 0.99 against JAX's."""
    jm, jp, tm = fastsams
    rgb = room_with_blob(64, 96)
    for img in (rgb, rgb[:48, :80]):
        mj = jfs.segment_everything(jm, jp, img)
        mt = tfs.segment_everything(tm, img)
        assert len(mt) == len(mj) >= 1
        for a, b in zip(mj, mt):
            assert b.shape == img.shape[:2] and b.dtype == bool
            assert iou(a, b) >= IOU


# ---------------------------------------------------------------------------
# DynamicModel
# ---------------------------------------------------------------------------

def blob_pair(h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    pred = gt.copy()
    pred[20:40, 20:40] += 0.5          # a moving object = coherent error
    pred[5:8, 50:53] += 0.3            # and a smaller one
    return gt, pred


def test_dynamic_mask_cc_as_jax():
    """The default `cc` backend on the JAX test's blob: the same mask."""
    pytest.importorskip("cv2")
    gt, pred = blob_pair()
    jmask = JDynamic(j_load_config()).get_dynamic_mask(gt, pred)
    tmask = DynamicModel(load_config()).get_dynamic_mask(gt, pred)
    np.testing.assert_array_equal(tmask, jmask)
    assert tmask[25:35, 25:35].mean() > 0.5 and tmask[:10, :10].mean() < 0.2


def test_dynamic_mask_precomputed_as_jax(tmp_path):
    """The `precomputed` backend reads the same label maps in order."""
    gt, pred = blob_pair()
    labels = np.zeros((64, 64), np.int32)
    labels[18:42, 18:42] = 1
    labels[:10, :10] = 2
    np.save(tmp_path / "000000.npy", labels)
    np.save(tmp_path / "000001.npy", np.where(labels == 2, 3, 0))
    cfg = {"dynamic": {"backend": "precomputed", "ann_root": str(tmp_path)}}
    jd = JDynamic(j_load_config(overrides=cfg))
    td = DynamicModel(load_config(overrides=cfg))
    for _ in range(3):
        np.testing.assert_array_equal(td.get_dynamic_mask(gt, pred),
                                      jd.get_dynamic_mask(gt, pred))
    assert td.idx == jd.idx == 2


def test_dynamic_mask_learned_backend_as_jax():
    """`backend: flax` (the configuration name both packages share) runs
    the self-trained FastSAM: the same dynamic mask by IoU."""
    rgb = room_with_blob(64, 96)
    pred = rgb.copy()
    pred[16:32, 24:48] = 0.5
    cfg = {"dynamic": {"backend": "flax", "weights": str(FS)}}
    jmask = JDynamic(j_load_config(overrides=cfg)).get_dynamic_mask(
        rgb, pred)
    tmask = DynamicModel(load_config(overrides=cfg)).get_dynamic_mask(
        rgb, pred)
    assert jmask.sum() > 50
    assert iou(jmask, tmask) >= IOU


@pytest.fixture(scope="module")
def mapped():
    """The JAX mapper after one window of tests/synthetic.py keyframes,
    and the window of three keyframes whose newest shows a blob."""
    jc, tc = mapper_configs({"training_args": {"iters": 8,
                                                "num_keyframe": 8}})
    viz, _ = make_viz_out(np.random.default_rng(6), n_kf=3)
    viz["n_valid"] = 3
    jm = JMapper(jc)
    jm.run(viz)
    imgs = viz["images"].copy()
    imgs[2, 10:22, 10:22] = (1.0, 0.1, 0.1)
    return jm, tc, dict(viz, images=imgs)


def test_apply_to_viz_out_as_jax(mapped):
    """apply_to_viz_out (`cc`) on the same map and window: the newest
    keyframe's mask by IoU >= 0.99 against JAX's, the blob masked, the
    other keyframes untouched, and the port's pixel_mask tensor a new one
    (the input's is not written)."""
    pytest.importorskip("cv2")
    jm, tc, viz = mapped
    tm = mirror_mapper(jm, tc)
    jout = JDynamic(j_load_config()).apply_to_viz_out(viz, jm)
    shared = torch.ones(viz["pixel_mask"].shape, dtype=torch.bool)
    td = DynamicModel(load_config())
    tout = td.apply_to_viz_out(dict(viz, pixel_mask=shared), tm)
    jpm, tpm = np.asarray(jout["pixel_mask"]), tout["pixel_mask"].numpy()
    assert iou(~jpm[2], ~tpm[2]) >= IOU
    assert (~tpm[2, 12:20, 12:20]).mean() > 0.5
    assert tpm[0].all() and tpm[1].all()
    assert bool(shared.all()) and tout["pixel_mask"] is not shared
    assert td.n_masked == int((~tpm[2]).sum())


def test_second_window_mask_is_all_ones_again(mapped):
    """Through the middleware's cache: a tracker's windows all carry the
    one cached all-ones pixel_mask; apply_to_viz_out masks each window's
    newest keyframe in a copy, so the next window's mask is all ones
    again."""
    pytest.importorskip("cv2")
    from vings_mono_tpu_torch.tracker.tracker import Tracker
    jm, tc, _ = mapped
    tm = mirror_mapper(jm, tc)
    cfg = load_config(overrides={
        "mode": "vo",
        "frontend": {"buffer": 16, "warm_up": 4, "filter_thresh": -1.0,
                     "keyframe_thresh": 0.0, "frontend_thresh": 1e9,
                     "frontend_window": 8, "frontend_radius": 2,
                     "frontend_nms": 1, "max_factors": 16,
                     "edge_capacity": 24, "inactive_capacity": 32,
                     "ba_window": 8, "iters1": 1, "iters2": 1,
                     "active_window": 8, "max_age": 6, "rollup_at": 12,
                     "rollup_n": 4, "save_buffer": 32, "bf16_gru": False},
        "mapper": {"kf_capacity": 4},
        "middleware": {"max_depth": 1e3, "cov_times": 1e9}})
    tracker = Tracker(cfg, 32, 32, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    dm = DynamicModel(load_config())
    ys, xs = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    seen = []
    for k in range(9):
        img = 0.5 + 0.5 * np.sin(0.3 * (xs + 2 * k)) * np.cos(0.2 * ys)
        tracker.track({"timestamp": float(k), "rgb": np.stack(
            [img, 0.8 * img, 1 - img], -1).astype(np.float32),
            "intrinsic": np.asarray([30.0, 30.0, 16.0, 16.0], np.float32)})
        viz = middleware.judge_and_package(tracker, cfg)
        if viz is None:
            continue
        assert viz["pixel_mask"] is tracker._pixel_mask_cache
        assert bool(viz["pixel_mask"].all())
        out = dm.apply_to_viz_out(viz, tm)
        seen.append(int((~out["pixel_mask"]).sum()))
    assert len(seen) >= 3 and min(seen) > 0, seen
    assert bool(tracker._pixel_mask_cache.all())
