"""The trace readers (utils/profiling.py's device busy time as an
interval union; runners/bench_common.py's device time per program
through `gpu_user_annotation` ranges) on hand-written chrome traces; the
named program ranges in a CPU `torch.profiler` trace of the mapper, the
tracker and global BA; the MFU tool's constants and raster term against
scripts/mfu.py read with `ast`; and, under `slow`, the tools' whole runs
at small sizes on the CPU. No JAX."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from vings_mono_tpu_torch.runners import bench_common as bc
from vings_mono_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


def kernel(ts, dur, tid, name="k", pid=0):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": pid,
            "tid": tid, "ts": ts, "dur": dur}


def annotation(name, ts, dur, tid, pid=0, cat="gpu_user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


def test_busy_is_the_union_over_two_overlapping_streams():
    # stream 7: [0, 100) and [300, 400); stream 8: [50, 150) and
    # [120, 200); a CPU op and a memcpy [500, 510) on stream 7
    events = [kernel(0, 100, 7), kernel(300, 100, 7), kernel(50, 100, 8),
              kernel(120, 80, 8),
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
               "tid": 1, "ts": 0, "dur": 1000},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "pid": 0,
               "tid": 7, "ts": 500, "dur": 10}]
    # union: [0, 200) + [300, 400) + [500, 510) = 310 us; the sum of the
    # durations would be 390
    assert profiling.busy_union_ms(events) == pytest.approx(0.310)
    assert sum(e["dur"] for e in events if profiling.is_device(e)) == 390
    assert bc.device_span_ms(events) == pytest.approx(0.510)
    assert profiling.busy_union_ms([]) == 0.0


def test_program_time_by_gpu_user_annotation():
    events = [
        # train_loop ran twice on stream 7, _fused_update on stream 8
        annotation("train_loop", 0, 1000, "host", cat="user_annotation"),
        annotation("train_loop", 2000, 1000, "host", cat="user_annotation"),
        annotation("_fused_update", 0, 3000, "t2", cat="user_annotation"),
        annotation("train_loop", 10, 200, 7),
        annotation("train_loop", 2010, 100, 7),
        annotation("_fused_update", 40, 500, 8),
        kernel(10, 50, 7), kernel(100, 110, 7),      # first train_loop
        kernel(2010, 100, 7),                        # second
        kernel(400, 30, 7),                          # outside both
        kernel(60, 20, 8), kernel(530, 10, 8),       # _fused_update
        kernel(60, 500, 9),                          # other stream
    ]
    got = bc.program_ms(events, ("train_loop", "_fused_update",
                                 "storage_control"))
    assert got["train_loop"] == (pytest.approx(0.260), 2)
    assert got["_fused_update"] == (pytest.approx(0.030), 1)
    # never ran: no range at all
    assert got["storage_control"] == (0.0, 0)
    # ran on the host but the trace has no device range: an error
    with pytest.raises(RuntimeError, match="add_frame"):
        bc.program_ms(events + [annotation("add_frame", 0, 5, "host",
                                           cat="user_annotation")],
                      ("add_frame",))


SMALL = {"training_args": {"iters": 2},
         "mapper": {"capacity": 1 << 12, "pair_capacity": 1 << 13,
                    "visible_capacity": 1 << 11, "points_per_frame": 200,
                    "points_first_frame": 400}}
# the trace test's pipeline: 32x48, the frontend initialized after 3
# frames, one train iteration per keyframe
TINY = {"frontend": {"warm_up": 3}, "training_args": {"iters": 1},
        "mapper": {"capacity": 1 << 11, "pair_capacity": 1 << 12,
                   "visible_capacity": 1 << 10, "points_per_frame": 100,
                   "points_first_frame": 200}}
NAMED = ("train_loop", "add_frame", "bin_stack", "storage_control",
         "_fused_update", "ba_global")


@pytest.fixture
def one_thread():
    """One intra-op thread for the block: the pipeline's thousands of
    small ops each open an OpenMP region, and beside other busy workers
    those regions wait on threads the host does not schedule (this test
    ran 25x slower than alone in a whole parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_cpu_trace_names_every_program(tmp_path, one_thread):
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
    from vings_mono_tpu_torch.middleware import judge_and_package
    from vings_mono_tpu_torch.ops import ba as ba_ops
    from vings_mono_tpu_torch.runners.mfu import ba_inputs
    from vings_mono_tpu_torch.tracker.tracker import Tracker
    dev = torch.device("cpu")
    cfg = bc.load(bc.bench_overrides(), TINY, dev)
    frames = bc.make_frame(32, 48)
    tracker = Tracker(cfg, 32, 48, device=dev)
    mapper = GaussianMapper(cfg, device=dev)
    windows, k = [], 0
    while len(windows) < 4:
        tracker.track(frames(k))
        viz = judge_and_package(tracker, cfg)
        if viz is not None:
            windows.append(viz)
        k += 1
    for v in windows[:3]:
        mapper.run(v)
    ba_args = ba_inputs(dev, 32, 48, T=8, E=16, D=4)
    with profiling.trace(str(tmp_path)):
        mapper.run(windows[3])           # the 4th keyframe: storage
        tracker.track(frames(k))
        ba_ops.ba_global(*ba_args, iters=1)
    events = profiling.load_trace(str(tmp_path))
    host = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(NAMED) <= host, set(NAMED) - host
    # a CPU trace has no device ranges: attribution refuses, not zeros
    with pytest.raises(RuntimeError, match="no device range"):
        bc.program_ms(events, NAMED)


def _assigns(tree):
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            out.setdefault(ast.unparse(node.targets[0]).strip("()"),
                           node.value)
    return out


def test_mfu_constants_and_raster_term_equal_the_script():
    from vings_mono_tpu_torch.runners import mfu
    from vings_mono_tpu_torch.utils.mfu import raster_flops
    a = _assigns(ast.parse((ROOT / "scripts/mfu.py").read_text()))
    ns = {}
    for name in ("ITERS", "PAIR_PIX_FWD, BWD_MULT"):
        exec(f"{name} = {ast.unparse(a[name])}", ns)
    want = eval(ast.unparse(a["f_pallas"]), ns)
    assert ns["ITERS"] == mfu.ITERS
    p_cap = bc.WINDOW_MAPPER["pair_capacity"]
    assert raster_flops(p_cap, mfu.ITERS) == want
    t, e, _, _, d = eval(ast.unparse(a["T, E, h8, w8, D"]),
                         {"H": 240, "W": 432})
    assert (t, e, d) == (mfu.BA_T, mfu.BA_E, mfu.BA_D)
    # the script's train-loop mapper is WINDOW_MAPPER
    calls = [n for n in ast.walk(ast.parse(
        (ROOT / "scripts/mfu.py").read_text())) if isinstance(n, ast.Call)
        and getattr(n.func, "id", "") == "load_config"]
    ovs = [eval(ast.unparse(c.keywords[0].value)) for c in calls]
    assert [o["mapper"] for o in ovs if "mapper" in o] == \
        [bc.WINDOW_MAPPER]


def test_ba_inputs_equal_the_script():
    from vings_mono_tpu_torch.runners.mfu import ba_inputs
    src = (ROOT / "scripts/mfu.py").read_text()
    body = src[src.index("T, E, h8, w8, D"):src.index("ba_args = (")]

    class jnp_shim:
        float32, int32 = np.float32, np.int32

        @staticmethod
        def asarray(a, dtype=None):
            return np.asarray(a, dtype)

        @staticmethod
        def tile(a, reps):
            return np.tile(a, reps)

        @staticmethod
        def arange(n):
            return np.arange(n)

        @staticmethod
        def full(shape, v, dtype):
            return np.full(shape, v, dtype)

        @staticmethod
        def zeros(shape, dtype):
            return np.zeros(shape, dtype)

        @staticmethod
        def ones(shape, dtype):
            return np.ones(shape, dtype)

    class At:
        def __init__(self, a):
            self.a = a

        def __getitem__(self, idx):
            a = self.a

            class Setter:
                def set(self, v):
                    b = a.copy()
                    b[idx] = v
                    return b
            return Setter()

    ns = {"np": np, "jnp": jnp_shim, "H": 240, "W": 432}
    body = body.replace(".at[", ".__at__[")
    np_at = type("A", (np.ndarray,), {"__at__": property(
        lambda self: At(np.asarray(self)))})
    ns["jnp"].tile = staticmethod(lambda a, r: np.tile(a, r).view(np_at))
    ns["jnp"].ones = staticmethod(
        lambda s, dtype: np.ones(s, dtype).view(np_at))
    exec(body, ns)
    got = [t.numpy() for t in ba_inputs(torch.device("cpu"))]
    want = (ns["target"], ns["weight"], ns["eta"], ns["poses"],
            ns["disps"], ns["intr"], ns["ii"], ns["jj"], ns["ev"],
            ns["gi"], ns["gv"], ns["free"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.slow
def test_tools_run_on_the_cpu_at_small_sizes():
    """Every tool that needs no device trace, whole, at 64x96."""
    from vings_mono_tpu_torch.runners import (bench_mapper, bench_profile,
                                              bench_scatter, bench_tracker,
                                              bench_tracker_micro,
                                              profile_host,
                                              profile_train_map)
    from vings_mono_tpu_torch.utils.device import reproducible
    dev = torch.device("cpu")
    with reproducible():
        assert bench_mapper.measure(dev, SMALL, 64, 96, (1, 2))
        assert bench_tracker.measure(dev, 64, 96)
        micro = bench_tracker_micro.measure(dev, None, 64, 96, n=2)
        assert micro["device_events_per_frame"] == 0
        out, profs = profile_host.profile(dev, 10, 2, SMALL, 64, 96)
        assert out["windows"] > 0 and set(profs) == {"tracker", "mapper"}
    timer, _ = bench_profile.main(["--device", "cpu"], extra=SMALL,
                                  height=64, width=96, n_frames=11,
                                  n_warm=9)
    assert timer.counts["map"] > 0
    out = bench_scatter.main(["--device", "cpu"], extra=SMALL, height=64,
                             width=96)
    assert max(out["rel_err"].values()) < 1e-2
    rows = profile_train_map.main(["--device", "cpu"], extra=SMALL,
                                  height=64, width=96, iters=2)
    assert any("vings_mono_tpu_torch/mapper/train.py" in f
               for _, _, _, frames in rows for f in frames)
