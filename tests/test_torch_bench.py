"""runners/bench.py against the JAX package's root bench.py, read with
`ast` (the script is never imported or run): its config overrides, the
gated lane's overrides, the synthetic frame, the printed keys and the
frame-index plan; then a CPU run of the port's bench at a reduced size,
and the refusal to run without the gated lane's weights. No JAX."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest

from vings_mono_tpu_torch.runners import bench, bench_common

ROOT = Path(__file__).resolve().parents[1]


def _tree(rel):
    return ast.parse((ROOT / rel).read_text())


def _call_overrides(tree):
    """The `overrides=` expressions of the script's load_config calls."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "load_config":
            for kw in node.keywords:
                if kw.arg == "overrides":
                    out.append(kw.value)
    return out


def _eval(node, ns=None):
    return eval(compile(ast.Expression(node), "<script>", "eval"),
                dict(ns or {}))


def _func(tree, name):
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    raise AssertionError(f"no def {name}")


def test_overrides_equal_bench_py():
    first, gated = _call_overrides(_tree("bench.py"))
    assert _eval(first) == bench_common.bench_overrides()
    cfg = bench_common.load(bench_common.bench_overrides())
    want = _eval(gated, {"cfg": cfg, "wpath": "w.npz"})
    assert want == bench_common.gated_overrides(cfg, "w.npz")


@pytest.mark.parametrize("script,kw", [
    ("bench.py", {}),
    ("scripts/mfu.py", {"third": False, "f32": False}),
    ("scripts/bench_profile.py", {"u8": False}),
])
def test_frame_equals_the_scripts_bitwise(script, kw):
    H, W = 240, 432
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ns = {"np": np, "H": H, "W": W, "xs": xs, "ys": ys}
    fdef = _func(_tree(script), "frame")
    exec(compile(ast.Module([fdef], []), script, "exec"), ns)
    port = bench_common.make_frame(H, W, **kw)
    for k in (0, 1, 7, 74, 133):
        a, b = ns["frame"](k), port(k)
        assert a["timestamp"] == b["timestamp"]
        assert a["rgb"].dtype == b["rgb"].dtype
        np.testing.assert_array_equal(a["rgb"], b["rgb"])
        np.testing.assert_array_equal(a["intrinsic"], b["intrinsic"])


def test_printed_keys_equal_bench_py():
    tree = _tree("bench.py")
    keys, metric = set(), None
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            ks = [_eval(k) for k in node.keys if k is not None]
            if "metric" in ks and "allkf_fps" in ks:
                keys |= set(ks)
                metric = _eval(node.values[ks.index("metric")])
        if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name) and node.value.id == "out" and \
                isinstance(node.ctx, ast.Store):
            keys.add(_eval(node.slice))
    assert keys == set(bench.KEYS)
    assert metric == bench.METRIC
    src = (ROOT / "bench.py").read_text()
    assert f"/ {bench.BASELINE_FPS}" in src


def test_frame_plan_equals_bench_py():
    main = _func(_tree("bench.py"), "main")
    consts = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.Constant, ast.Tuple)):
            tgt = node.targets[0]
            names = [tgt] if isinstance(tgt, ast.Name) else \
                list(getattr(tgt, "elts", []))
            vals = _eval(node.value)
            vals = vals if isinstance(vals, tuple) else (vals,)
            for n, v in zip(names, vals):
                if isinstance(n, ast.Name):
                    consts.setdefault(n.id, v)
    assert (consts["n_warm"], consts["n_meas"], consts["g_warm"]) == \
        (12, 60, 28)
    plan = bench.frame_plan(n_warm=consts["n_warm"],
                            n_meas=consts["n_meas"],
                            g_warm=consts["g_warm"])
    assert plan == {"warm": (0, 14), "throwaway": (14, 74),
                    "measured": (74, 134), "gated_warm": (0, 34),
                    "gated_measured": (34, 94)}
    # the two post-freeze ranges of the script: +2 and +6 frames
    src = ast.unparse(main)
    assert f"range(n_warm, n_warm + {bench.N_POST})" in src
    assert f"range(g_warm, g_warm + {bench.G_POST})" in src


SMALL = {"training_args": {"iters": 3},
         "mapper": {"capacity": 1 << 12, "pair_capacity": 1 << 13,
                    "visible_capacity": 1 << 11, "points_per_frame": 200,
                    "points_first_frame": 400}}


@pytest.mark.slow
def test_cpu_run_at_a_reduced_size(capsys):
    """The whole bench (both lanes, bench_mfu) at 48x64."""
    out = bench.main(["--device", "cpu"], n_warm=9, n_meas=2, g_warm=9,
                     height=48, width=64, extra=SMALL)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    import json
    assert json.loads(printed) == out
    assert tuple(out) == bench.KEYS
    for k in bench.KEYS[1:]:
        if k != "unit":
            assert math.isfinite(out[k]), (k, out[k])
    assert out["allkf_fps"] > 0 and out["value"] > 0


def test_missing_gated_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        bench.run("cpu", weights=str(tmp_path / "absent.npz"))
