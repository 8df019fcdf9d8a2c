"""Port parity: the PyTorch rasterizer (vings_mono_tpu_torch) against the
JAX one on the same numpy inputs. The JAX tile path runs its Pallas kernels
in interpret mode; the port runs the plain twins of its CUDA kernels (the
tensors lie on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vings_mono_tpu.ops.rasterizer import (Camera as JCamera,
                                           bin_surfels as j_bin,
                                           project_surfels as j_project,
                                           rasterize_binned as
                                           j_rasterize_binned,
                                           render as j_render)
from vings_mono_tpu.ops.rasterizer import tile_kernel as jtk
from vings_mono_tpu.ops.rasterizer.naive import render_naive as j_naive
from vings_mono_tpu.ops.rasterizer.binning import (_vsearch_left as
                                                   j_vsearch)
from vings_mono_tpu_torch.ops.rasterizer import (Camera, ProjectedSurfels,
                                                 bin_surfels, project_surfels,
                                                 rasterize_binned, render)
from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
from vings_mono_tpu_torch.ops.rasterizer.binning import _vsearch_left
from vings_mono_tpu_torch.ops.rasterizer.naive import render_naive
from vings_mono_tpu_torch.ops.rasterizer.render import camera_meta

H, W = 32, 48
N = 90
P_CAP = 4096
CHUNK = 64
F = 30.0
NAMES = ["xyz", "log_scale", "quat", "logit_opacity", "rgb"]


def make_scene(seed, n=N):
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 6.0, size=n)
    x = (rng.uniform(0.05, 0.95, size=n) - 0.5) * z * W / F
    y = (rng.uniform(0.05, 0.95, size=n) - 0.5) * z * H / F
    return [np.stack([x, y, z], -1).astype(np.float32),
            np.log(rng.uniform(0.1, 0.5, size=(n, 2))).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32),
            (rng.normal(size=(n, 1)) * 0.5 + 1.0).astype(np.float32),
            rng.uniform(0, 1, size=(n, 3)).astype(np.float32)]


def w2c_np():
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = R
    m[:3, 3] = [0.05, -0.02, 0.1]
    return m


def cams():
    m = w2c_np()
    jc = JCamera(w2c=jnp.asarray(m), fx=jnp.float32(F), fy=jnp.float32(F),
                 cx=jnp.float32(W / 2), cy=jnp.float32(H / 2), height=H,
                 width=W)
    tc = Camera(torch.from_numpy(m), F, F, W / 2, H / 2, H, W)
    return jc, tc


def torch_proj(jproj):
    return ProjectedSurfels(*(torch.from_numpy(np.array(x))
                              for x in jproj))


def t_params(arrs, grad=False):
    return [torch.tensor(a).requires_grad_(grad) for a in arrs]


def test_projection_packed_matches():
    arrs = make_scene(0)
    jc, tc = cams()
    alive = np.ones(N, bool)
    alive[::7] = False
    jp = j_project(*map(jnp.asarray, arrs), jc, alive=jnp.asarray(alive))
    tp = project_surfels(*t_params(arrs), tc, alive=torch.from_numpy(alive))
    for name, a, b in zip(jp._fields, jp, tp):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("side,tile_cap,v_cap,p_cap", [
    (5, 0, 0, P_CAP), (3, 0, 64, P_CAP), (5, 64, 0, P_CAP),
    (5, 0, 0, 256)])
def test_binning_exact(side, tile_cap, v_cap, p_cap):
    arrs = make_scene(1)
    jc, _ = cams()
    jp = j_project(*map(jnp.asarray, arrs), jc)
    kw = dict(height=H, width=W, p_cap=p_cap, chunk=CHUNK, side=side,
              tile_cap=tile_cap, v_cap=v_cap)
    jb = j_bin(jp, **kw)
    tb = bin_surfels(torch_proj(jp), **kw)
    assert int(jb.n_pairs) > 0
    for name in ("pair_idx", "pair_valid", "sel", "chunk_tile",
                 "chunk_first", "grad_tbl", "n_padded", "overflow",
                 "n_chunks", "n_pairs"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert bool(tb.overflow) == (p_cap == 256)
    # the port-only chunk ranges agree with the chunk table
    tcn = tb.tile_chunks.numpy()
    ct, cf = np.asarray(jb.chunk_tile), np.asarray(jb.chunk_first)
    for t in range(len(tcn) - 1):
        live = np.nonzero((ct == t) & (cf & 2 == 2))[0]
        assert list(live) == list(range(tcn[t], tcn[t + 1]))


def test_vsearch_left_matches():
    a = np.sort(np.random.default_rng(2).integers(0, 50, 300)).astype(
        np.int32)
    v = np.arange(-2, 55, dtype=np.int32)
    np.testing.assert_array_equal(
        _vsearch_left(torch.from_numpy(a), torch.from_numpy(v)).numpy(),
        np.asarray(j_vsearch(jnp.asarray(a), jnp.asarray(v))))


def _pair_inputs(seed, opacity_shift=0.0):
    """One binning fed to both kernels: JAX pair data + chunk tables and
    the port's tile chunk ranges."""
    arrs = make_scene(seed)
    arrs[3] = arrs[3] + opacity_shift
    jc, tc = cams()
    jp = j_project(*map(jnp.asarray, arrs), jc)
    jb = j_bin(jp, height=H, width=W, p_cap=P_CAP, chunk=CHUNK)
    tb = bin_surfels(torch_proj(jp), height=H, width=W, p_cap=P_CAP,
                     chunk=CHUNK)
    compact = jnp.concatenate([jp.packed[jb.sel], jnp.zeros((1, 24))])
    pair_data = compact[jb.pair_idx].T
    jmeta = jnp.asarray([F, F, W / 2, H / 2, W // 16, 0, 0, 0],
                        jnp.float32)
    return (jb, pair_data, jmeta, tb, camera_meta(tc, "cpu"),
            (H // 16) * (W // 16))


@pytest.mark.parametrize("opacity_shift", [0.0, 4.0])
def test_forward_kernel_channels(opacity_shift):
    """opacity_shift 4 makes tiles opaque, exercising early termination."""
    jb, pd, jmeta, tb, tmeta, T = _pair_inputs(3, opacity_shift)
    ref = np.asarray(jtk.rasterize_forward(pd, jb.chunk_tile,
                                           jb.chunk_first, jmeta, T,
                                           interpret=True))
    out, evals, hits = tk.forward_plain(torch.from_numpy(np.array(pd)),
                                        tb.tile_chunks, tmeta, CHUNK)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert ref[:, 4].max() > 0.5
    assert 0 < int(hits) < evals <= int(jb.n_chunks) * CHUNK * 256
    # the wrapper takes the plain twin for a CPU tensor
    n0 = tk.rasterize_forward.launches
    np.testing.assert_array_equal(
        tk.rasterize_forward(torch.from_numpy(np.array(pd)),
                             tb.tile_chunks, tmeta, CHUNK).numpy(),
        out.numpy())
    assert tk.rasterize_forward.launches == n0


@pytest.mark.parametrize("opacity_shift", [0.0, 4.0])
def test_backward_kernel_pair_grads(opacity_shift):
    jb, pd, jmeta, tb, tmeta, T = _pair_inputs(4, opacity_shift)
    out = jtk.rasterize_forward(pd, jb.chunk_tile, jb.chunk_first, jmeta, T,
                                interpret=True)
    g = np.random.default_rng(5).normal(size=out.shape).astype(np.float32)
    ref = np.asarray(jtk.rasterize_backward(
        pd, jb.chunk_tile, jb.chunk_first, jmeta, out, jnp.asarray(g),
        interpret=True))
    args = (torch.from_numpy(np.array(pd)), tb.tile_chunks, tmeta, CHUNK,
            torch.from_numpy(np.array(out)), torch.from_numpy(g))
    got = tk.backward_plain(*args).numpy()
    # per row, relative to the row's largest entry (sum order differs)
    scale = np.abs(ref).max(axis=1, keepdims=True) + 1e-12
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)
    assert np.abs(ref[tk.GR_SCORE_IMP]).max() > 0.1
    np.testing.assert_array_equal(got[23], 0.0)
    ref16 = np.asarray(jtk.rasterize_backward(
        pd, jb.chunk_tile, jb.chunk_first, jmeta, out, jnp.asarray(g),
        interpret=True, out_dtype=jnp.bfloat16).astype(jnp.float32))
    got16 = tk.backward_plain(*args, out_dtype=torch.bfloat16).float()
    np.testing.assert_allclose(got16.numpy() / scale, ref16 / scale,
                               atol=1e-2)


def _loss_terms(r, tgt_rgb, tgt_depth, lib):
    mean, absf = (jnp.mean, jnp.abs) if lib == "jax" else (torch.mean,
                                                           torch.abs)
    return (mean(absf(r["rgb"] - tgt_rgb))
            + 0.3 * mean(absf(r["depth"] - tgt_depth))
            + 0.1 * mean(r["dist"]) + 0.05 * mean(r["accum"])
            + 0.05 * mean(r["normal"]))


def test_render_gradients_match():
    """All five parameter groups through the exact f32 reduction; the
    tolerance is relative to each group's largest gradient (the depth
    division by alpha amplifies sum-order differences)."""
    arrs = make_scene(6)
    jc, tc = cams()
    rng = np.random.default_rng(7)
    tgt_rgb = rng.uniform(0, 1, size=(3, H, W)).astype(np.float32)
    tgt_depth = rng.uniform(2, 6, size=(1, H, W)).astype(np.float32)

    def jloss(p):
        r = j_render(*p, jc, impl="tile", interpret=True, p_cap=P_CAP,
                     chunk=CHUNK, grad_reduce="f32")
        return _loss_terms(r, tgt_rgb, tgt_depth, "jax")

    jg = jax.grad(jloss)([jnp.asarray(a) for a in arrs])
    tp = t_params(arrs, grad=True)
    r = render(*tp, tc, p_cap=P_CAP, chunk=CHUNK, grad_reduce="f32")
    _loss_terms(r, torch.from_numpy(tgt_rgb), torch.from_numpy(tgt_depth),
                "torch").backward()
    for name, a, b in zip(NAMES, jg, tp):
        a, b = np.asarray(a), b.grad.numpy()
        assert np.all(np.isfinite(b)), name
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-3,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("grad_reduce", ["f32", "bf16"])
def test_packed_gradients_match(grad_reduce):
    """Gradient with respect to the packed payload, per Gaussian and field,
    through both pair->Gaussian reductions: f32 to 1e-4 and the bf16
    gather-reduce to 1e-2 of each field's largest entry. (Further down,
    the projection's backward sums fields that cancel, so bf16 rounding is
    only bounded relative to the packed gradients.)"""
    arrs = make_scene(11)
    jc, tc = cams()
    jp = j_project(*map(jnp.asarray, arrs), jc)
    jb = j_bin(jp, height=H, width=W, p_cap=P_CAP, chunk=CHUNK)
    tb = bin_surfels(torch_proj(jp), height=H, width=W, p_cap=P_CAP,
                     chunk=CHUNK)
    if grad_reduce == "f32":
        jb, tb = jb._replace(grad_tbl=None), tb._replace(grad_tbl=None)
    tgt = np.random.default_rng(12).uniform(0, 1, (13, H, W)).astype(
        np.float32)
    mask = np.zeros(16, np.float32)
    mask[[0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12]] = 1.0

    def jloss(packed, carrier):
        ch = j_rasterize_binned(packed, carrier, jb, jc, interpret=True)
        return jnp.sum((ch[:13] - tgt) ** 2 * mask[:13, None, None])

    jgp, jgc = jax.grad(jloss, argnums=(0, 1))(
        jp.packed, jnp.zeros((N, 2), jnp.float32))
    packed = torch.from_numpy(np.array(jp.packed)).requires_grad_()
    carrier = torch.zeros((N, 2), requires_grad=True)
    ch = rasterize_binned(packed, carrier, tb, tc)
    torch.sum((ch[:13] - torch.from_numpy(tgt)) ** 2
              * torch.from_numpy(mask[:13, None, None])).backward()
    tol = 1e-4 if grad_reduce == "f32" else 1e-2
    for a, b in ((jgp, packed.grad), (jgc, carrier.grad)):
        a, b = np.asarray(a), b.numpy()
        scale = np.abs(a).max(axis=0) + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=tol)


def test_render_channels_and_scores_match():
    arrs = make_scene(8)
    jc, tc = cams()

    def jloss(c):
        r = j_render(*map(jnp.asarray, arrs), jc, impl="tile",
                     interpret=True, p_cap=P_CAP, chunk=CHUNK,
                     score_carrier=c)
        return jnp.sum(jnp.abs(r["rgb"])), r

    (_, jr), js = jax.value_and_grad(jloss, has_aux=True)(
        jnp.zeros((N, 2), jnp.float32))
    carrier = torch.zeros((N, 2), requires_grad=True)
    tr = render(*t_params(arrs), tc, p_cap=P_CAP, chunk=CHUNK,
                score_carrier=carrier)
    torch.sum(torch.abs(tr["rgb"])).backward()
    for key in ("rgb", "depth", "accum", "normal", "dist", "wm", "wm2",
                "radii", "visible"):
        np.testing.assert_allclose(tr[key].detach().numpy(),
                                   np.asarray(jr[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    s = carrier.grad.numpy()
    scale = np.abs(np.asarray(js)).max(axis=0) + 1e-12
    np.testing.assert_allclose(s / scale, np.asarray(js) / scale, atol=1e-2)
    # importance column == total accumulated alpha
    np.testing.assert_allclose(s[:, 0].sum(), tr["accum"].sum().item(),
                               rtol=1e-3)


def test_naive_matches_jax_naive_and_tile():
    arrs = make_scene(9)
    jc, tc = cams()
    jp = j_project(*map(jnp.asarray, arrs), jc)
    order = np.argsort(np.where(np.asarray(jp.visible),
                                np.asarray(jp.depth), np.inf), kind="stable")
    mask = np.asarray(jp.visible)[order]
    ref = np.asarray(j_naive(jp.packed, jnp.asarray(order),
                             jnp.asarray(mask), jc, jc.fx, jc.fy, jc.cx,
                             jc.cy))
    tp = project_surfels(*t_params(arrs), tc)
    got = render_naive(tp.packed, torch.from_numpy(order),
                       torch.from_numpy(mask), tc)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    tile = render(*t_params(arrs), tc, p_cap=P_CAP, chunk=CHUNK)
    np.testing.assert_allclose(tile["rgb"].detach().numpy(), got[0:3].numpy(),
                               rtol=2e-4, atol=2e-5)


def test_empty_scene_renders_zero():
    arrs = make_scene(10)
    _, tc = cams()
    r = render(*t_params(arrs), tc, p_cap=P_CAP, chunk=CHUNK,
               alive=torch.zeros(N, dtype=torch.bool))
    assert torch.count_nonzero(r["rgb"]) == 0
    assert torch.count_nonzero(r["accum"]) == 0


def test_tile_depth_cap_matches():
    """A stack of near-opaque splats on one spot: the capped render keeps
    the nearest pairs per tile and agrees with the JAX capped render."""
    n = 64
    z = np.linspace(2.0, 2.1, n).astype(np.float32)
    arrs = [np.stack([0.0 * z, 0.0 * z, z], -1),
            np.full((n, 2), np.log(0.4), np.float32),
            np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (n, 1)),
            np.full((n, 1), 3.0, np.float32),
            np.random.default_rng(0).uniform(0, 1, (n, 3)).astype(
                np.float32)]
    jc, tc = cams()
    for cap in (0, 16):
        jr = j_render(*map(jnp.asarray, arrs), jc, impl="tile",
                      interpret=True, p_cap=P_CAP, chunk=16, tile_cap=cap)
        tr = render(*t_params(arrs), tc, p_cap=P_CAP, chunk=16, tile_cap=cap)
        np.testing.assert_allclose(tr["rgb"].detach().numpy(),
                                   np.asarray(jr["rgb"]), atol=1e-5)
    sat = tr["accum"][0] > 0.999
    assert bool(sat.any())
