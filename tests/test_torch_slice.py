"""Port parity for the mapping slice: the PyTorch GaussianMapper against the
JAX one from one config and one stream of keyframes, with the JAX random
draws replayed into the port; checkpoints carried across; and the port's
independence from JAX."""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from synthetic import make_viz_out
from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
from vings_mono_tpu_torch.runners import run_mapping
from vings_mono_tpu_torch.datasets.replay import save_viz_out
from vings_mono_tpu_torch.utils.config import load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
H = W = 32
OVERRIDES = {
    "mapper": {"capacity": 4096, "pair_capacity": 4096, "chunk": 64,
               "side": 3, "kf_capacity": 4, "points_per_frame": 400,
               "points_first_frame": 400, "visible_capacity": 2048},
    "training_args": {"iters": 4, "num_keyframe": 8},
    "adc_args": {"accum_thresh": 0.98},
}


class JaxDraws:
    """Replays the JAX mapper's key stream (mapper.py `_next_key`) into the
    port's draw hooks: add_frame's gumbel/quaternion draws (densify.py) and
    the train loop's per-iteration keyframe draws (train.py)."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def densify(self, mapper):
        def draws(n_points):
            k = self._next()
            g = jax.random.gumbel(k, (mapper.H * mapper.W,))
            q = jax.random.normal(jax.random.fold_in(k, 1), (n_points, 4))
            return torch.tensor(np.asarray(g)), torch.tensor(np.asarray(q))
        return draws

    def schedule(self, iters, n_valid):
        k = self._next()
        out = []
        for _ in range(iters):
            k, k1 = jax.random.split(k)
            out.append(int(jax.random.randint(k1, (), 0, max(n_valid, 1))))
        return out


def port_mapper(cfg):
    m = GaussianMapper(cfg, device="cpu")
    draws = JaxDraws(int(cfg.get("seed", 0)))
    m._densify_draws = draws.densify(m)
    m._kf_schedule = draws.schedule
    return m


def windows():
    viz, _ = make_viz_out(np.random.default_rng(3), n_kf=3, H=H, W=W)
    first = {k: (v[:2] if isinstance(v, np.ndarray) and k != "intrinsic"
                 else v) for k, v in viz.items()}
    return [first, viz]


@pytest.fixture(scope="module")
def both_mappers():
    jm = JMapper(j_load_config(overrides={
        **OVERRIDES, "mapper": {**OVERRIDES["mapper"], "interpret": True}}))
    tm = port_mapper(load_config(overrides=OVERRIDES))
    rows = []
    for viz in windows():
        jm.run(viz)
        tm.run(viz)
        rows.append((jm.last_metrics, jm.n_alive, tm.last_metrics,
                     tm.n_alive))
    return jm, tm, rows


def test_mappers_agree_per_keyframe(both_mappers):
    _, _, rows = both_mappers
    for jmet, jn, tmet, tn in rows:
        assert jn > 300
        assert abs(tn - jn) <= 0.01 * jn, (tn, jn)
        assert abs(tmet["total"] - jmet["total"]) <= 0.01 * abs(
            jmet["total"]), (tmet["total"], jmet["total"])
        assert abs(tmet["psnr"] - jmet["psnr"]) <= 0.1, (tmet["psnr"],
                                                         jmet["psnr"])


def test_load_ckpt_of_jax_map_renders_same(both_mappers, tmp_path):
    jm, _, _ = both_mappers
    path = tmp_path / "jax_ckpt.npz"
    jm.save_ckpt(str(path))
    tm = GaussianMapper(load_config(overrides=OVERRIDES), device="cpu")
    tm.load_ckpt(str(path))
    assert tm.n_alive == jm.n_alive and tm.time_idx == jm.time_idx
    viz = windows()[1]
    w2c = np.linalg.inv(viz["poses"][1]).astype(np.float32)
    jr = jm.render_at(w2c, viz["intrinsic"])
    tr = tm.render_at(w2c, viz["intrinsic"])
    for key in ("rgb", "accum", "normal"):
        np.testing.assert_allclose(tr[key].numpy(), np.asarray(jr[key]),
                                   atol=1e-4, err_msg=key)
    # and back: the port's checkpoint loads into the JAX mapper
    path2 = tmp_path / "torch_ckpt.npz"
    tm.save_ckpt(str(path2))
    jm2 = JMapper(j_load_config(overrides={
        **OVERRIDES, "mapper": {**OVERRIDES["mapper"], "interpret": True}}))
    jm2.load_ckpt(str(path2))
    np.testing.assert_array_equal(np.asarray(jm2.state.xyz),
                                  np.asarray(jm.state.xyz))


def test_run_mapping_replays_windows(tmp_path):
    root = tmp_path / "replay"
    root.mkdir()
    for i, viz in enumerate(windows()):
        save_viz_out(str(root / f"vizout_{i:04d}.npz"), viz)
    cfg = load_config(overrides={**OVERRIDES,
                                 "dataset": {"root": str(root)}})
    mapper, records = run_mapping.run(cfg, str(tmp_path / "out"),
                                      device="cpu")
    assert [r["window"] for r in records] == [0, 1]
    assert all(r["losses_finite"] for r in records)
    assert (tmp_path / "out" / "ply" / "final_2dgs.ply").is_file()
    assert mapper.n_alive == records[-1]["n_alive"] > 300


def test_entry_points_default_to_cuda():
    cfg = load_config(overrides=OVERRIDES)
    assert cfg["device"]["mapper"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GaussianMapper(cfg)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "vings_mono_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "vings_mono_tpu"), \
                f"{f.relative_to(ROOT)} imports {mod}"
