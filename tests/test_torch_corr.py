"""Port parity: ops.corr (all-pairs pyramid + windowed bilinear lookup as a
direct gather) and ops.upsample against the JAX modules.

Tolerances, both relative to the largest |corr| of the pyramid:
  * f32 pyramid: 1e-5 (both interpolate in f32; the sums differ in order);
  * bf16 pyramid: 2e-2. The JAX lookup rounds its interpolation weights and
    its intermediate to bf16 (three bf16 roundings, 2^-8 relative each),
    the port interpolates in f32 from the same bf16-stored values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vings_mono_tpu.ops import corr as jc
from vings_mono_tpu.ops import upsample as ju
from vings_mono_tpu_torch.ops import corr as tc
from vings_mono_tpu_torch.ops import upsample as tu

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def fmaps(seed, n, h, w, c=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, w, c)).astype(np.float32),
            rng.normal(size=(n, h, w, c)).astype(np.float32))


def coords_cases(rng, n, h, w):
    """Named coordinate fields (n, h, w, 2) at level-0 resolution."""
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None] \
        .repeat(n, 0).astype(np.float32)
    return {
        "in_range_fractional": grid + rng.uniform(-2, 2, grid.shape),
        "exact_integers": grid + rng.integers(-2, 3, grid.shape),
        "negative": -rng.uniform(0.0, 9.0, grid.shape),
        "straddling_the_border": grid * 0 + rng.uniform(-4, 4, grid.shape)
        + np.asarray([w - 1, h - 1]),
        "far_out_of_range": grid + rng.choice([-1e6, 1e6, 3e9, -3e9],
                                              grid.shape),
    }


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw", [(8, 12), (7, 13), (6, 8)])
def test_pyramid_matches(hw, dtype):
    """Odd sizes floor like avg_pool2d; 6x8 pools its last level away."""
    jdt, tdt, tol = DTYPES[dtype]
    f1, f2 = fmaps(0, 2, *hw)
    jp = jc.build_pyramid(jnp.asarray(f1), jnp.asarray(f2), dtype=jdt)
    tp = tc.build_pyramid(torch.from_numpy(f1), torch.from_numpy(f2),
                          dtype=tdt)
    scale = float(np.abs(np.asarray(jp.levels[0], np.float32)).max())
    h, w = hw
    for lvl, (jl, tl) in enumerate(zip(jp.levels, tp.levels)):
        assert tl.dtype == tdt
        assert tuple(tl.shape) == jl.shape == (2, h * w, h >> lvl, w >> lvl)
        err = np.abs(tl.float().numpy() - np.asarray(jl, np.float32)).max() \
            if tl.numel() else 0.0
        assert err <= tol * scale, (lvl, err, scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["in_range_fractional", "exact_integers",
                                  "negative", "straddling_the_border",
                                  "far_out_of_range"])
def test_lookup_matches(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    n, h, w = 2, 7, 13
    f1, f2 = fmaps(1, n, h, w)
    coords = coords_cases(np.random.default_rng(2), n, h, w)[case] \
        .astype(np.float32)
    jp = jc.build_pyramid(jnp.asarray(f1), jnp.asarray(f2), dtype=jdt)
    # the port looks up in the JAX pyramid's own stored values, so only the
    # interpolation differs
    tp = tc.CorrPyramid(levels=[
        torch.from_numpy(np.array(l, np.float32)).to(tdt)
        for l in jp.levels])
    want = np.asarray(jc.lookup(jp, jnp.asarray(coords)))
    got = tc.lookup(tp, torch.from_numpy(coords))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (n, h, w, 4 * 49)
    scale = float(np.abs(np.asarray(jp.levels[0], np.float32)).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= tol * scale, (err, scale)
    if case in ("negative", "far_out_of_range"):
        # every tap of level 0 lies outside: exact zeros, not clamped reads
        lvl0 = got[..., :49]
        far = coords[..., 0] < -4
        assert float(lvl0[torch.from_numpy(far)].abs().max()) == 0.0
    else:
        assert float(np.abs(want).max()) > 0.1 * scale


def test_lookup_is_level_major_y_offset_major():
    """A volume that is 1 at one target pixel: the window's hit sits at
    (dy, dx) = (-1, +2) of level 0, index (dy + r) * 7 + (dx + r)."""
    h, w = 8, 8
    vol = torch.zeros((1, h * w, h, w))
    vol[:, :, 2, 6] = 1.0
    pyr = tc.CorrPyramid(levels=[vol, vol[..., :4, :4] * 0,
                                 vol[..., :2, :2] * 0, vol[..., :1, :1] * 0])
    coords = torch.zeros((1, h, w, 2))
    coords[..., 0], coords[..., 1] = 4.0, 3.0
    out = tc.lookup(pyr, coords)
    hit = out[0, 0, 0].nonzero().flatten().tolist()
    assert hit == [(-1 + 3) * 7 + (2 + 3)]


def test_stack_pyramids():
    f1, f2 = fmaps(3, 2, 8, 8)
    a = tc.build_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    s = tc.stack_pyramids([a, a])
    assert [tuple(l.shape) for l in s.levels] == \
        [(4,) + tuple(l.shape[1:]) for l in a.levels]


@pytest.mark.parametrize("d", [1, 3])
def test_cvx_upsample_matches(d):
    """Softmax over the 9 neighbours, neighbour-major; abs tol 1e-5."""
    rng = np.random.default_rng(4)
    data = rng.normal(size=(2, 5, 6, d)).astype(np.float32)
    mask = rng.normal(size=(2, 5, 6, 576)).astype(np.float32) * 3
    want = np.asarray(ju.cvx_upsample(jnp.asarray(data), jnp.asarray(mask)))
    got = tu.cvx_upsample(torch.from_numpy(data), torch.from_numpy(mask))
    assert got.shape == want.shape == (2, 40, 48, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if d == 1:
        w2 = np.asarray(ju.upsample_disp(jnp.asarray(data[..., 0]),
                                         jnp.asarray(mask)))
        g2 = tu.upsample_disp(torch.from_numpy(data[..., 0]),
                              torch.from_numpy(mask))
        np.testing.assert_allclose(g2.numpy(), w2, atol=1e-5)
