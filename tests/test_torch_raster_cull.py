"""The tile kernels' cull, on the CPU: `pair_pixel_bounds` and
`pair_block_mask` (the PyTorch statement of the rectangle and of the
per-warp test that csrc/rasterizer.cu computes per pair) must hold every
pixel the coverage gives alpha > 0, on seeded random and on adversarial
surfels, so that culling changes no output bit."""

import numpy as np
import pytest
import torch

from vings_mono_tpu_torch.ops.rasterizer import (Camera, bin_surfels,
                                                 project_surfels)
from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
from vings_mono_tpu_torch.ops.rasterizer.projection import (ALPHA_EPS,
                                                            PK_OPAC)
from vings_mono_tpu_torch.ops.rasterizer.render import camera_meta
from vings_mono_tpu_torch.ops.rasterizer.stress import (CLASSES,
                                                        adversarial_pairs,
                                                        adversarial_scene)

H, W = 32, 48
F = 30.0
CHUNK = 64
CAM = Camera(torch.eye(4), F, F, W / 2, H / 2, H, W)
META = camera_meta(CAM, "cpu")
CASES = [("random", 0), ("random", 1), ("random", 2), ("adversarial", 0),
         ("adversarial", 1), ("adversarial", 2)]


def random_pairs(seed, n=120):
    """A binned random scene, as the mapper would hand it to the kernels."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 6.0, size=n)
    arrs = [np.stack([(rng.uniform(0.0, 1.0, n) - 0.5) * z * W / F,
                      (rng.uniform(0.0, 1.0, n) - 0.5) * z * H / F, z], -1),
            np.log(rng.uniform(0.03, 0.5, size=(n, 2))),
            rng.normal(size=(n, 4)), rng.normal(size=(n, 1)) * 1.5 + 0.5,
            rng.uniform(0, 1, size=(n, 3))]
    proj = project_surfels(*(torch.from_numpy(a.astype(np.float32))
                             for a in arrs), CAM)
    b = bin_surfels(proj, height=H, width=W, p_cap=4096, chunk=CHUNK)
    compact = torch.cat([proj.packed[b.sel.long()],
                         proj.packed.new_zeros((1, tk.GR_PAD))])
    return compact[b.pair_idx.long()].T.contiguous(), b.tile_chunks


def pairs_of(kind, seed):
    if kind == "random":
        return random_pairs(seed)
    return adversarial_pairs(seed, CAM, CHUNK, chunks_per_tile=2,
                             per_class=24)


def coverage_of_all(pair_data, tile_chunks):
    """alpha (chunks, G, PIX) of every pair at every pixel of its tile (no
    early termination), with px, py (chunks, 1, PIX)."""
    n_chunks = int(tile_chunks[-1])
    tiles = torch.repeat_interleave(
        torch.arange(tile_chunks.shape[0] - 1),
        (tile_chunks[1:] - tile_chunks[:-1]).long())
    d = pair_data[:, :n_chunks * CHUNK].reshape(tk.GR_PAD, n_chunks, CHUNK)
    qx, qy, px, py = tk._pixel_rays(tiles, int(META[4]), META)
    alpha, _, _ = tk._coverage(d.permute(1, 2, 0), qx, qy, px, py)
    return alpha, px, py, n_chunks


@pytest.mark.parametrize("kind,seed", CASES)
def test_bounds_contain_every_covered_pixel(kind, seed):
    pair_data, tile_chunks = pairs_of(kind, seed)
    alpha, px, py, n_chunks = coverage_of_all(pair_data, tile_chunks)
    x0, x1, y0, y1 = (b[:n_chunks * CHUNK].reshape(n_chunks, CHUNK, 1)
                      for b in tk.pair_pixel_bounds(pair_data, META))
    inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
    covered = alpha > 0
    assert int(covered.sum()) > 100
    assert not bool((covered & ~inside).any())
    # and the cull is worth having: it removes most of the empty work
    assert int(inside.sum()) < 0.6 * inside.numel()


@pytest.mark.parametrize("kind,seed", CASES)
def test_block_mask_holds_every_covered_block(kind, seed):
    """The kernels' per-warp test (ellipse against the warp's 8x4 pixel
    block) keeps every block with a covered pixel, and is tighter than the
    rectangle."""
    pair_data, tile_chunks = pairs_of(kind, seed)
    alpha, px, py, n_chunks = coverage_of_all(pair_data, tile_chunks)
    d = pair_data[:, :n_chunks * CHUNK].reshape(tk.GR_PAD, n_chunks, CHUNK, 1)
    bx, by = torch.floor(px / 8) * 8, torch.floor(py / 4) * 4
    mask = tk.pair_block_mask(d, META, bx, bx + 7, by, by + 3)
    assert not bool(((alpha > 0) & ~mask).any())
    x0, x1, y0, y1 = (b[:n_chunks * CHUNK].reshape(n_chunks, CHUNK, 1)
                      for b in tk.pair_pixel_bounds(pair_data, META))
    in_rect = (bx <= x1) & (bx + 7 >= x0) & (by <= y1) & (by + 3 >= y0)
    assert not bool((mask & ~in_rect).any())
    assert int(mask.sum()) < int(in_rect.sum())


@pytest.mark.parametrize("kind,seed", CASES)
def test_plain_twins_bitwise_unchanged_by_cull(kind, seed):
    pair_data, tile_chunks = pairs_of(kind, seed)
    out, evals, hits = tk.forward_plain(pair_data, tile_chunks, META, CHUNK)
    out_c, evals_c, hits_c = tk.forward_plain(pair_data, tile_chunks, META,
                                              CHUNK, cull=True)
    assert torch.equal(out, out_c)
    assert (evals, int(hits)) == (evals_c, int(hits_c))
    assert bool(torch.isfinite(out).all())
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=tuple(out.shape)).astype(np.float32))
    grads = tk.backward_plain(pair_data, tile_chunks, META, CHUNK, out, g)
    grads_c = tk.backward_plain(pair_data, tile_chunks, META, CHUNK, out, g,
                                cull=True)
    assert torch.equal(grads, grads_c)
    assert bool(torch.isfinite(grads).all())
    assert float(grads[tk.GR_SCORE_IMP].max()) > 0.1


@pytest.mark.parametrize("tilt", [0.0, 0.3, 0.6])
def test_bounds_of_a_known_ellipse(tilt):
    """A surfel on the optical axis, turned about the x axis: the box is
    the ellipse's, to a pixel's margin, x and y not swapped."""
    z, su, sv, opac = 4.0, 0.3, 0.2, 0.8
    xyz = np.array([[0.0, 0.0, z]], np.float32)
    quat = np.array([[np.cos(tilt / 2), np.sin(tilt / 2), 0, 0]], np.float32)
    logit = np.array([[np.log(opac / (1 - opac))]], np.float32)
    proj = project_surfels(
        torch.from_numpy(xyz), torch.log(torch.tensor([[su, sv]])),
        torch.from_numpy(quat), torch.from_numpy(logit),
        torch.zeros((1, 3)), CAM)
    x0, x1, y0, y1 = (float(b[0]) for b in
                      tk.pair_pixel_bounds(proj.packed.T.contiguous(), META))
    r = np.sqrt(2 * np.log(255 * opac))
    # the ellipse's points c + r (su cos t, sv cos(tilt) sin t, sv sin(tilt)
    # sin t), projected
    t = np.linspace(0, 2 * np.pi, 20001)
    depth = z + r * sv * np.sin(tilt) * np.sin(t)
    ex = F * r * su * np.cos(t) / depth + W / 2
    ey = F * r * sv * np.cos(tilt) * np.sin(t) / depth + H / 2
    m = tk.CULL_MARGIN
    for got, want in ((x0, ex.min() - m), (x1, ex.max() + m),
                      (y0, ey.min() - m), (y1, ey.max() + m)):
        assert abs(got - want) < 0.02, (got, want)


@pytest.mark.parametrize("opacity,covers", [
    (0.0, False), (float(np.float32(ALPHA_EPS)) * 0.999, False),
    (float(np.float32(ALPHA_EPS)), True), (0.5, True),
    (float("nan"), False)])
def test_bounds_at_the_opacity_threshold(opacity, covers):
    pair_data, _ = random_pairs(3)
    pair_data = pair_data[:, :8].clone()
    pair_data[PK_OPAC] = opacity
    x0, x1, y0, y1 = tk.pair_pixel_bounds(pair_data, META)
    if covers:
        assert bool((x0 <= x1).all()) and bool((y0 <= y1).all())
        # the rectangle holds the screen center, where rho2d = 0
        assert bool((x0 <= pair_data[10]).all() & (pair_data[10] <= x1).all())
    else:
        assert bool((x0 > x1).all()) and bool((y0 > y1).all())


@pytest.mark.parametrize("name", ["edge_on", "across_camera_plane"])
def test_pairs_that_must_not_be_culled(name):
    """Exactly edge-on surfels and surfels through the camera plane have no
    ellipse: their rectangle is the whole plane."""
    per_class = 12
    arrs, _ = adversarial_scene(0, CAM, per_class)
    proj = project_surfels(*(torch.from_numpy(a) for a in arrs), CAM)
    i = CLASSES.index(name) * per_class
    rows = [i] if name == "edge_on" else list(range(i, i + per_class))
    packed = proj.packed[rows].clone()
    packed[:, PK_OPAC] = 0.5
    x0, x1, y0, y1 = tk.pair_pixel_bounds(packed.T.contiguous(), META)
    inf = float("inf")
    if name == "edge_on":       # tilt 0: the first of the class
        assert (float(x0), float(x1), float(y0), float(y1)) == (
            -inf, inf, -inf, inf)
    else:
        # whoever crosses the plane z = 0 within its cutoff is unculled
        z = torch.from_numpy(arrs[0][rows, 2])
        reach = torch.exp(torch.from_numpy(arrs[1][rows])).amax(1) * 0.3
        crosses = (z < reach)
        assert bool(crosses.any())
        assert bool((x0[crosses] == -inf).all() & (x1[crosses] == inf).all())
