"""Port parity for utils/vis.py: `colorize` (matplotlib and its grayscale
fallback), `rgbdnua_panel`, `get_bev_c2w` and `draw_trajectory` exactly;
`vis_map` (with host pages of a storage manager composited) and `vis_bev`
against the JAX package's on the same map, uint8 within 2 levels."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import OVERRIDES, windows
from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
from vings_mono_tpu.storage.manager import StorageManager as JStorage
from vings_mono_tpu.utils import vis as jvis
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
from vings_mono_tpu_torch.mapper.state import STATE_FIELDS, state_from_numpy
from vings_mono_tpu_torch.storage.manager import FIELDS, StorageManager
from vings_mono_tpu_torch.utils import vis
from vings_mono_tpu_torch.utils.config import load_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _c2ws(rng, n=7):
    out = []
    for k in range(n):
        a = 0.3 * k
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]]
        c2w[:3, 3] = [2 * np.sin(a), 0.1 * rng.normal(), 2 * np.cos(a)]
        out.append(c2w)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("matplotlib", [True, False])
def test_colorize(monkeypatch, matplotlib):
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    x = np.random.default_rng(0).uniform(-1, 3, size=(17, 23))
    x[3, 4] = np.nan
    for kw in ({}, {"vmin": 0, "vmax": 2, "cmap": "viridis"}):
        out = vis.colorize(torch.from_numpy(x), **kw)
        np.testing.assert_array_equal(out, jvis.colorize(x, **kw))
        assert out.dtype == np.uint8 and out.shape == (17, 23, 3)
    if not matplotlib:
        assert (out[..., 0] == out[..., 1]).all()


def test_rgbdnua_panel_bev_c2w_and_trajectory():
    rng = np.random.default_rng(1)
    H, W = 20, 28
    pred = {"rgb": rng.uniform(size=(3, H, W)),
            "depth": rng.uniform(0, 4, size=(1, H, W)),
            "normal": rng.normal(size=(3, H, W)),
            "accum": rng.uniform(size=(1, H, W)),
            "dist": rng.uniform(size=(1, H, W)) * 1e-2}
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    gt_rgb = rng.uniform(size=(3, H, W)).astype(np.float32)
    gt_d = rng.uniform(0, 5, size=(1, H, W)).astype(np.float32)
    gt_cov = rng.uniform(size=(1, H, W)).astype(np.float32)
    for cov in (gt_cov, None):
        p = vis.rgbdnua_panel({k: torch.from_numpy(v) for k, v in
                               pred.items()}, gt_rgb, torch.from_numpy(gt_d),
                              cov)
        assert p.shape == (2 * H, 4 * W, 3) and p.dtype == np.uint8
        np.testing.assert_array_equal(
            p, jvis.rgbdnua_panel(pred, gt_rgb, gt_d, cov))
    c2ws = _c2ws(rng)
    bev = vis.get_bev_c2w(c2ws)
    np.testing.assert_array_equal(bev, jvis.get_bev_c2w(c2ws))
    w2c = np.linalg.inv(bev)
    intr4 = (0.7 * 64, 0.7 * 64, 32, 24)
    img_t = vis.draw_trajectory(np.zeros((48, 64, 3), np.uint8), c2ws, w2c,
                                intr4)
    img_j = jvis.draw_trajectory(np.zeros((48, 64, 3), np.uint8), c2ws, w2c,
                                 intr4)
    np.testing.assert_array_equal(img_t, img_j)
    if vis.cv2 is not None:
        assert img_t.any()


@pytest.fixture(scope="module")
def mappers():
    """A JAX map after tests/test_torch_slice.py's first window, the same
    map in the port, and in each a storage manager that holds the rows of
    one half of the map (x above the median) on the host, killed on the
    device."""
    jm = JMapper(j_load_config(overrides={
        **OVERRIDES, "mapper": {**OVERRIDES["mapper"], "interpret": True}}))
    jm.run(windows()[0])
    arrays = {f: np.asarray(getattr(jm.state, f)) for f in STATE_FIELDS}
    alive = arrays["alive"]
    x = arrays["xyz"][:, 0]
    paged = alive & (x > np.median(x[alive]))
    assert paged.sum() > 50 and (arrays["alive"] & ~paged).sum() > 50
    cfg = {"storage_manager": {"distance_threshold": 1.0, "every": 1}}
    js, ts = JStorage(cfg), StorageManager(cfg)
    for st in (js, ts):
        st.host = {f: arrays[f][paged].copy() for f in FIELDS}
        st.n_host = int(paged.sum())
    arrays["alive"] = arrays["alive"] & ~paged
    jm.state = jm.state.replace(alive=jnp.asarray(arrays["alive"]))
    tm = GaussianMapper(load_config(overrides=OVERRIDES), device="cpu")
    tm.state = state_from_numpy(arrays, "cpu")
    tm.initialized = True
    return jm, tm, js, ts


def _close(a, b, levels=2):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= levels, d.max()


def test_vis_map_with_host_pages_and_vis_bev(mappers, tmp_path):
    jm, tm, js, ts = mappers
    c2ws = windows()[1]["poses"].astype(np.float32)
    for storage in (None, (js, ts)):
        jimg = jvis.vis_map(jm, c2ws, None, size=(48, 64),
                            storage=None if storage is None else storage[0])
        timg = vis.vis_map(tm, c2ws, str(tmp_path / "map.png"),
                           size=(48, 64),
                           storage=None if storage is None else storage[1])
        _close(timg, jimg)
        assert (timg.sum(-1) > 0).mean() > 0.05
    # the composite adds the paged rows
    bare = vis.vis_map(tm, c2ws, None, size=(48, 64))
    assert (timg.sum(-1) > 0).sum() > (bare.sum(-1) > 0).sum()
    jb = jvis.vis_bev(jm, c2ws[1], None, size=(24, 24))
    tb = vis.vis_bev(tm, c2ws[1], str(tmp_path / "bev.png"), size=(24, 24))
    _close(tb, jb)
    assert ((tmp_path / "map.png").is_file() and
            (tmp_path / "bev.png").is_file()) == (vis.cv2 is not None)
