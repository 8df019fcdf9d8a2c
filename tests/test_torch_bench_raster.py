"""runners/bench_raster.py and runners/tune_binning.py against the JAX
package's scripts: their scenes rebuilt by the scripts' own module
statements (selected with `ast`; numpy draws only, so cheap at full
size) equal the port's bit for bit, and the port's binning of the
tune_binning scene gives JAX's pair count, chunk count and overflow at
one grid point. Then runners/bench_scatter.py's reductions B-E against
A (index_add_)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from vings_mono_tpu_torch.runners import bench_raster, bench_scatter
from vings_mono_tpu_torch.runners import tune_binning

ROOT = Path(__file__).resolve().parents[1]


class _jnp:
    """What the scripts' scene statements use of jax.numpy."""
    float32 = np.float32

    @staticmethod
    def asarray(a, dtype=None):
        return np.asarray(a, dtype)


def _scene_ns(script, names):
    """Run the script's module-level statements that bind `names` (and
    its helper defs), in order, with numpy for jax.numpy."""
    tree = ast.parse((ROOT / script).read_text())
    keep = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            keep.append(node)
        elif isinstance(node, ast.Assign):
            bound = {n.id for t in node.targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)}
            if bound & set(names):
                keep.append(node)
    ns = {"np": np, "jnp": _jnp}
    exec(compile(ast.Module(keep, []), script, "exec"), ns)
    return ns


def test_bench_raster_scene_equals_the_script():
    ns = _scene_ns("scripts/bench_raster.py",
                   ("N", "H", "W", "rng", "z", "x", "y", "params"))
    assert (ns["N"], ns["H"], ns["W"]) == (bench_raster.N, bench_raster.H,
                                           bench_raster.W)
    want = ns["params"]
    got = bench_raster.raster_scene()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def tune_ns():
    return _scene_ns("scripts/tune_binning.py",
                     ("H", "W", "N_CAP", "N_ALIVE", "F", "rng", "z", "x",
                      "y", "full", "params", "alive"))


def test_tune_binning_scene_equals_the_script():
    ns = tune_ns()
    assert (ns["H"], ns["W"], ns["N_CAP"], ns["N_ALIVE"], ns["F"]) == (
        tune_binning.H, tune_binning.W, tune_binning.N_CAP,
        tune_binning.N_ALIVE, tune_binning.F)
    params, alive = tune_binning.binning_scene()
    for g, w in zip(params, ns["params"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(alive, ns["alive"])


def test_tune_binning_grid_equals_the_script():
    tree = ast.parse((ROOT / "scripts/tune_binning.py").read_text())
    loops = [n for n in tree.body if isinstance(n, ast.For)]
    want = tuple(tuple(v) for v in eval(ast.unparse(loops[0].iter)))
    assert want == tune_binning.GRID
    tree = ast.parse((ROOT / "scripts/bench_raster.py").read_text())
    loops = [n for n in tree.body if isinstance(n, ast.For)]
    want = tuple(tuple(v) for v in eval(ast.unparse(loops[0].iter)))
    assert want == bench_raster.COMBOS


def test_binning_counts_equal_jax_at_a_grid_point():
    import jax.numpy as jnp
    from vings_mono_tpu.ops.rasterizer import Camera as JCamera
    from vings_mono_tpu.ops.rasterizer import bin_for_camera as jbin
    from vings_mono_tpu_torch.ops.rasterizer import bin_for_camera
    params, alive = tune_binning.binning_scene()
    v_cap, p_cap, chunk, side = tune_binning.GRID[2]
    kw = dict(p_cap=p_cap, chunk=chunk, side=side, v_cap=v_cap)
    F, H, W = tune_binning.F, tune_binning.H, tune_binning.W
    jcam = JCamera(w2c=jnp.eye(4, dtype=jnp.float32), fx=jnp.float32(F),
                   fy=jnp.float32(F), cx=jnp.float32(W / 2),
                   cy=jnp.float32(H / 2), height=H, width=W)
    want = jbin(*(jnp.asarray(p) for p in params), jcam,
                alive=jnp.asarray(alive), **kw)
    cam = bench_raster.identity_camera(F, H, W, torch.device("cpu"))
    got = bin_for_camera(*(torch.as_tensor(p) for p in params), cam,
                         alive=torch.as_tensor(alive), **kw)
    assert int(got.n_pairs) == int(want.n_pairs)
    assert int(got.n_chunks) == int(want.n_chunks)
    assert bool(got.overflow) == bool(want.overflow)
    assert int(got.n_pairs) > 0


def _pair_idx(seed, V=60, P=700, kmax=9):
    """A pair-slot table: each compact row holds 0..kmax slots at random
    places, the other slots V (none)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(V), rng.integers(0, kmax + 1, V))
    idx = np.full(P, V, np.int64)
    idx[rng.permutation(P)[:len(rows)]] = rows
    return idx


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_variants_match_index_add(seed):
    V, kmax = 60, 9
    pair_idx = _pair_idx(seed, V=V, kmax=kmax)
    assert np.bincount(pair_idx[pair_idx < V]).max() == kmax
    fns = bench_scatter.variants(pair_idx, V, kmax, torch.device("cpu"))
    g = torch.as_tensor(np.random.default_rng(seed + 5).standard_normal(
        (len(pair_idx), bench_scatter.C)), dtype=torch.float32)
    ref = fns["A index_add_"](g)
    assert ref.shape == (V + 1, bench_scatter.C)
    for name, fn in fns.items():
        tol = 1e-2 if "bf16" in name else 1e-5
        assert bench_scatter.rel_err(ref, fn(g), V) <= tol, name
    # the table keeps every slot of a row in slot order
    tbl = bench_scatter.inverse_table(pair_idx, V, kmax)
    for r in range(V):
        slots = np.nonzero(pair_idx == r)[0]
        np.testing.assert_array_equal(tbl[r, :len(slots)], slots)
        assert (tbl[r, len(slots):] == len(pair_idx)).all()
