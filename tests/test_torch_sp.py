"""Port parity for the (dp, sp) mesh of `vings_mono_tpu_torch/parallel/
mesh.py`: `make_mesh` with sp > 1, the row bands and `shard_batch`, and
`sharded_train_step` over four spawned CPU ranks (dp 2, sp 2) over Gloo,
against the JAX package's `parallel/mesh.py` on the `cpu_devices` fixture's
virtual devices (the Pallas kernels in interpret mode, as
tests/test_parallel.py runs them) and against the port's own step rendered
whole in one process.

Tolerances:
- the naive step against JAX's sharded_train_step(impl="naive") on a
  (2, 2) mesh: loss 1e-5 relative; gradients within 1e-3 of each tensor's
  largest against jax.grad of JAX's unsharded naive mean loss; parameters
  after the step within 2 lr on 99.5 % of the elements and within 2 lr
  everywhere (Adam's first step is lr sign(g), so a gradient near zero may
  step either way: tests/test_torch_parallel.py's rule);
- the tile step at sp 2 against the port's whole-image step: loss 1e-5
  relative, visibility equal, gradients rtol 2e-4 / atol 1e-6 (JAX's own
  dp tolerance, tests/test_parallel.py). The split reduces per-pair
  gradients in f32 (mesh.sharded_grads), so the whole-image side does
  too; against jax.grad of JAX's unsharded tile loss with the same f32
  reduction, within 1e-3 of each tensor's largest (the packages'
  rasterizer gradient parity);
- the row bands' loss parts against the whole image's: 1e-5 relative.

The test that starts a group of its own comes first: a process holds one
process group at a time, and the module's group (`sp_group`) lives from
its first user to the end of the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from test_torch_parallel import H, INTR4, W, no_children, tile_inputs
from vings_mono_tpu.mapper import state as jst
from vings_mono_tpu.mapper.cameras import make_camera as j_make_camera
from vings_mono_tpu.mapper.losses import mapper_loss as j_mapper_loss
from vings_mono_tpu.ops.rasterizer import render as j_render
from vings_mono_tpu.parallel import mesh as jmesh
from vings_mono_tpu_torch.mapper import state as tst
from vings_mono_tpu_torch.mapper.cameras import make_camera
from vings_mono_tpu_torch.mapper.losses import (combine_parts,
                                                mapper_loss_parts)
from vings_mono_tpu_torch.ops.rasterizer import render
from vings_mono_tpu_torch.ops.rasterizer.render import band_camera
from vings_mono_tpu_torch.parallel import mesh

LOSS_REL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
JAX_OF_MAX = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the followers copy the leader's thread count
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- no group ------------------------------------------------------------
def test_row_bands():
    """Whole 16-row tile rows, as even as they go, a one-tile-row halo
    clipped at the edges; sp beyond the tile rows raises."""
    assert mesh.row_bands(240, 2) == [(0, 128, 0, 144), (128, 240, 112, 240)]
    assert mesh.row_bands(40, 2) == [(0, 32, 0, 40), (32, 40, 16, 40)]
    assert mesh.row_bands(64, 4) == [(0, 16, 0, 32), (16, 32, 0, 48),
                                     (32, 48, 16, 64), (48, 64, 32, 64)]
    assert mesh.row_bands(32, 1) == [(0, 32, 0, 32)]
    with pytest.raises(ValueError, match="3 tile rows"):
        mesh.row_bands(40, 4)


def test_make_mesh_8_cpu_devices_is_4_by_2():
    """JAX's split rule: 8 devices are dp 4, sp 2; rank (d, s) = 2 d + s.
    close() leaves no child."""
    g = mesh.make_mesh(devices=["cpu"] * 8)
    try:
        assert g.shape == {"dp": 4, "sp": 2} and g.world == 8
        assert g.coords == (0, 0) and g.backend == "gloo"
        assert len(g.alive_followers()) == 7
    finally:
        g.close()
    assert no_children()


def scene(h, w, k=4, n=256, seed=0, capacity=512):
    """__graft_entry__.py's dryrun scene (256 surfels at depth 2-6, K
    random images and depths, cameras at the origin), at h x w with the
    focal scaled by h / 32."""
    rng = np.random.default_rng(seed)
    st = tst.empty_state(capacity, "cpu")
    z = rng.uniform(2.0, 6.0, n).astype(np.float32)
    xyz = np.stack([(rng.uniform(0, 1, n) - 0.5) * z * w / h,
                    (rng.uniform(0, 1, n) - 0.5) * z, z], -1)
    st.xyz[:n] = torch.from_numpy(xyz.astype(np.float32))
    st.rgb[:n] = torch.from_numpy(
        rng.uniform(0, 1, (n, 3)).astype(np.float32))
    st.log_scale[:n] = -1.5
    st.logit_opacity[:n] = 1.0
    st.alive[:n] = True
    images = rng.uniform(0, 1, (k, 3, h, w)).astype(np.float32)
    images[:, :, :3] = 0.0            # sky rows along the top edge
    depths = rng.uniform(2, 6, (k, 1, h, w)).astype(np.float32)
    depths[:, :, -2:, :5] = 0.0       # invalid depth at the bottom edge
    batch = [torch.from_numpy(images), torch.from_numpy(depths),
             torch.full((k, 1, h, w), 0.01), torch.eye(4).repeat(k, 1, 1)]
    f = 30.0 * h / 32
    return st, tst.adam_init(st), batch, (f, f, w / 2, h / 2)


@pytest.mark.parametrize("impl", ["naive", "tile"])
def test_band_parts_add_up_to_the_image(impl):
    """The loss parts of sp = 4 row bands of a 64x48 image, each band
    rendered over its rows and halo (render's rows), add up to the whole
    image's parts, numerators and denominators: the first and last bands
    hold SSIM's zero padding and the normals' zero border, the inner bands
    read their halo. 1e-5 relative; each band's maps against the whole
    image's rows, 1e-5 absolute. The scene holds a surfel wider than the
    binning's 5-tile clamp (side): a band keeps the whole image's tiles of
    it."""
    h, w = 64, 48
    st, _, batch, intr4 = scene(h, w, k=1)
    n = int(st.alive.sum())
    st.xyz[n] = torch.tensor([0.0, 0.1, 3.0])
    st.log_scale[n] = 0.5
    st.logit_opacity[n] = -1.0
    st.alive[n] = True
    img, dep, cov, w2c = (x[0] for x in batch)
    cam = make_camera(w2c, intr4, h, w)
    args = (st.xyz, st.log_scale, st.quat, st.logit_opacity, st.rgb)
    kw = dict(alive=st.alive, impl=impl, p_cap=8192, chunk=64)
    full = render(*args, cam, **kw)
    assert float(full["radii"][n]) > 5 * 16
    whole = mapper_loss_parts(full, img, dep, cov, cam)
    nums, dens = torch.zeros(6), torch.zeros(6)
    for r0, r1, h0, h1 in mesh.row_bands(h, 4):
        band = render(*args, cam, rows=(h0, h1), **kw)
        for key in ("rgb", "depth", "accum", "normal", "dist"):
            np.testing.assert_allclose(
                band[key].detach().numpy(),
                full[key][:, h0:h1].detach().numpy(), atol=1e-5,
                err_msg=f"{key} rows {h0}..{h1 - 1}")
        assert torch.equal(band["visible"], full["visible"])
        n, d = mapper_loss_parts(
            band, img[..., h0:h1, :], dep[..., h0:h1, :],
            cov[..., h0:h1, :], band_camera(cam, h0, h1),
            rows=(r0 - h0, r1 - h0))
        nums += n
        dens += d
    np.testing.assert_allclose(nums.numpy(), whole[0].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(dens.numpy(), whole[1].numpy())
    assert float(whole[1][3]) == 3 * w       # the sky rows are counted
    np.testing.assert_allclose(float(combine_parts(nums, dens)[0]),
                               float(combine_parts(*whole)[0]), rtol=1e-5)


def test_shard_batch():
    """JAX's shard_batch rule on the leader: 3-D and up over dp and the
    row bands with their halo (uneven at 40 rows), 1-D and 2-D over dp
    when K divides, else replicated; scalars and non-tensors replicated."""
    g = mesh.DPGroup(0, 4, "cpu", "gloo", 1.0, sp=2)
    assert g.shape == {"dp": 2, "sp": 2}
    imgs = torch.arange(4 * 3 * 40 * 8, dtype=torch.float32).view(4, 3, 40, 8)
    ids = torch.arange(4)
    odd = torch.arange(3)
    parts = mesh.shard_batch(g, {"images": imgs, "ids": ids, "odd": odd,
                                 "s": torch.tensor(2.0), "n": 7})
    assert len(parts) == 4
    for r, p in enumerate(parts):
        d, s = divmod(r, 2)
        h0, h1 = [(0, 40), (16, 40)][s]
        assert torch.equal(p["images"], imgs[2 * d:2 * d + 2, :, h0:h1])
        assert torch.equal(p["ids"], ids[2 * d:2 * d + 2])
        assert torch.equal(p["odd"], odd) and p["n"] == 7
        assert float(p["s"]) == 2.0


# ---- the module's group -----------------------------------------------------
@pytest.fixture(scope="module")
def sp_group():
    g = mesh.make_mesh(devices=["cpu"] * 4, dp=2)
    g.verify = True
    yield g
    g.close()
    assert no_children()


def test_group_is_2_by_2(sp_group):
    assert sp_group.shape == {"dp": 2, "sp": 2} and sp_group.world == 4
    assert len(sp_group.alive_followers()) == 3


def to_jax_state(st):
    js = jst.empty_state(st.capacity)
    return js.replace(**{f: jnp.asarray(getattr(st, f).numpy())
                         for f in tst.STATE_FIELDS})


def jax_mean_loss_grads(st, batch, intr4, h, w, **render_kw):
    """jax.grad of JAX's mean mapper loss over the keyframes, each
    rendered whole."""
    js = to_jax_state(st)
    imgs, deps, covs, w2cs = (jnp.asarray(x.numpy()) for x in batch)
    i4 = jnp.asarray(intr4, jnp.float32)

    def loss(params):
        def per_kf(img, dep, cov, w2c):
            cam = j_make_camera(w2c, i4, h, w)
            rets = j_render(params["xyz"], params["log_scale"],
                            params["quat"], params["logit_opacity"],
                            params["rgb"], cam, alive=js.alive, **render_kw)
            return j_mapper_loss(rets, img, dep, cov, cam)[0]
        return jnp.mean(jax.vmap(per_kf)(imgs, deps, covs, w2cs))
    return jax.grad(loss)(js.params())


def assert_close_to_max(got, ref, of_max=JAX_OF_MAX):
    for k in ref:
        a = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), a, rtol=0,
                                   atol=of_max * np.abs(a).max(), err_msg=k)


def assert_grads_agree(got, ref):
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_naive_step_matches_jax(sp_group, cpu_devices):
    """sharded_train_step(impl="naive") on the (2, 2) group against JAX's
    on make_mesh(cpu_devices[:4], dp=2) with shard_batch, on
    tests/test_parallel.py's 32x32 scene (200 surfels, K = 8)."""
    st, opt, batch = tile_inputs()
    jgrads = jax_mean_loss_grads(st, batch, INTR4, H, W, impl="naive")
    tg, tv, tl = mesh.sharded_grads(sp_group, st, opt, *batch, INTR4,
                                    height=H, width=W, impl="naive")
    assert_close_to_max(tg, jgrads)
    assert int(tv.sum()) == 200

    jm = jmesh.make_mesh(devices=cpu_devices[:4], dp=2)
    assert dict(jm.shape) == {"dp": 2, "sp": 2}
    js, jo = jmesh.replicate(jm, (to_jax_state(st), jst.adam_init(
        to_jax_state(st))))
    with jm:
        # the poses over dp alone, as __graft_entry__.py places them: with
        # shard_batch's rule their 4x4 rows would go over sp, and then
        # JAX's xyz gradient leaves its unsharded one (ROADMAP.md §C)
        jb = jmesh.shard_batch(jm, tuple(jnp.asarray(x.numpy())
                                         for x in batch[:3]))
        jb += (jax.device_put(jnp.asarray(batch[3].numpy()), NamedSharding(
            jm, PartitionSpec("dp"))),)
        js, jo, jl = jmesh.sharded_train_step(
            js, jo, *jb, jnp.asarray(INTR4, jnp.float32), height=H,
            width=W, impl="naive")
    calls = sp_group.calls
    st, opt, tl2 = mesh.sharded_train_step(st, opt, *batch, INTR4, height=H,
                                           width=W, impl="naive",
                                           group=sp_group)
    assert sp_group.calls == calls + 1 and opt.step == 1
    jl = float(jl)
    for loss in (tl, tl2):
        assert abs(float(loss) - jl) <= LOSS_REL * abs(jl), (float(loss), jl)
    for f, lr in tst.DEFAULT_LRS.items():
        d = np.abs(getattr(st, f).numpy() - np.asarray(getattr(js, f)))
        assert np.mean(d <= 2 * lr) >= 0.995 and d.max() <= 2 * lr, (f, d)


def test_tile_step_sp2_matches_whole_image_and_jax(sp_group):
    """sharded_tile_grads at sp 2 (p_cap 4096, chunk 128, JAX's defaults)
    against the port's whole-image gradients and against JAX's, on the
    32x32 scene; then the tile step runs and replicates (verify)."""
    st, opt, batch = tile_inputs()
    tg, tv, tl = mesh.sharded_tile_grads(sp_group, st, opt, *batch, INTR4,
                                         height=H, width=W)
    g1, v1, l1 = mesh.local_grads(st.params(), st.alive, *batch, INTR4, H,
                                  W, 4096, 128, "tile", "f32")
    assert abs(float(tl) - float(l1)) <= LOSS_REL * abs(float(l1))
    assert torch.equal(tv, v1) and int(tv.sum()) == 200
    assert_grads_agree(tg, g1)
    jgrads = jax_mean_loss_grads(st, batch, INTR4, H, W, impl="tile",
                                 p_cap=4096, chunk=128, interpret=True,
                                 grad_reduce="f32")
    assert_close_to_max(tg, jgrads)
    _, _, loss = mesh.sharded_train_step(st, opt, *batch, INTR4, height=H,
                                         width=W, impl="tile",
                                         group=sp_group)
    assert abs(float(loss) - float(l1)) <= LOSS_REL * abs(float(l1))
    assert opt.step == 1 and torch.isfinite(st.xyz).all()


def straddling_scene(h, w, row):
    """scene() plus one large surfel facing the camera, centred on `row`
    (a band boundary)."""
    st, opt, batch, intr4 = scene(h, w)
    n = int(st.alive.sum())
    z = 4.0
    st.xyz[n] = torch.tensor([0.3, (row - intr4[3]) / intr4[1] * z, z])
    st.rgb[n] = torch.tensor([0.9, 0.2, 0.1])
    st.log_scale[n] = -0.5
    st.logit_opacity[n] = 2.0
    st.alive[n] = True
    return st, opt, batch, intr4, n


@pytest.mark.parametrize("impl", ["naive", "tile"])
@pytest.mark.parametrize("rows", [40, 64])
def test_uneven_bands_and_a_straddling_surfel(sp_group, impl, rows):
    """sp 2 where the bands differ (40 rows: 32 + 8, the second band's
    halo cut at row 16) and where they are even with cut halos (64 rows),
    with a surfel across the boundary whose gradient comes from both
    bands: against the whole-image gradients (rtol 2e-4 / atol 1e-6),
    loss 1e-5 relative, visibility equal."""
    r0 = mesh.row_bands(rows, 2)[1][0]
    st, opt, batch, intr4, n = straddling_scene(rows, 48, r0)
    g2, v2, l2 = mesh.sharded_grads(sp_group, st, opt, *batch, intr4,
                                    height=rows, width=48, impl=impl,
                                    p_cap=4096, chunk=64)
    g1, v1, l1 = mesh.local_grads(st.params(), st.alive, *batch, intr4,
                                  rows, 48, 4096, 64, impl, "f32")
    assert abs(float(l2) - float(l1)) <= LOSS_REL * abs(float(l1))
    assert torch.equal(v2, v1) and bool(v2[n])
    assert_grads_agree(g2, g1)
    # the surfel covers rows on both sides of the boundary r0
    cam = make_camera(batch[3][0], intr4, rows, 48)
    rets = render(st.xyz[n:n + 1], st.log_scale[n:n + 1], st.quat[n:n + 1],
                  st.logit_opacity[n:n + 1], st.rgb[n:n + 1], cam,
                  impl="naive")
    covered = (rets["accum"][0] > 0.5).any(dim=1)
    assert covered[r0 - 3:r0].all() and covered[r0:r0 + 3].all()
    assert float(g2["xyz"][n].abs().sum()) > 0


def test_sp_beyond_tile_rows_raises(sp_group):
    """16 rows are one tile row: sp 2 raises on the leader before any
    call, and the group still serves the next one."""
    st, opt, batch, intr4 = scene(16, 32)
    calls = sp_group.calls
    with pytest.raises(ValueError, match="1 tile rows"):
        mesh.sharded_train_step(st, opt, *batch, intr4, height=16, width=32,
                                group=sp_group)
    assert sp_group.calls == calls and opt.step == 0
    st, opt, batch, intr4 = scene(32, 32)
    mesh.sharded_train_step(st, opt, *batch, intr4, height=32, width=32,
                            group=sp_group)
    assert sp_group.calls == calls + 1 and opt.step == 1
