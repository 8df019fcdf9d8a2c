"""The one reader of device time (`utils.profiling.device_time`) that
chip_smoke.py's profiled phases, profile_reproducible.py and
runners/profile_train_map.py share: kernels, memcpy and memset only, the
busy time a union over streams, never a `record_function` range. No JAX,
no card: chrome traces built by hand, and a CPU profile."""

import json

import pytest
import torch

import chip_smoke as cs
import profile_reproducible as pr
from vings_mono_tpu_torch.utils.profiling import (busy_union_ms,
                                                  device_time,
                                                  profile_events)


def ev(name, cat, ts, dur, tid):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def range_over_two_streams():
    """`train_loop` as a program range (host and device sides) over two
    kernels on streams 7 and 8 that overlap by 40 us, a memcpy and a
    memset after them, and the host ops that launched them."""
    return [
        ev("train_loop", "user_annotation", 0.0, 500.0, 1),
        ev("train_loop", "gpu_user_annotation", 10.0, 400.0, 7),
        ev("train_loop", "gpu_user_annotation", 60.0, 300.0, 8),
        ev("aten::mm", "cpu_op", 2.0, 5.0, 1),
        ev("raster_forward", "kernel", 10.0, 100.0, 7),     # 10-110
        ev("raster_backward", "kernel", 70.0, 100.0, 8),    # 70-170
        ev("Memcpy DtoH", "gpu_memcpy", 200.0, 20.0, 7),    # 200-220
        ev("Memset", "gpu_memset", 230.0, 10.0, 8),         # 230-240
        {"ph": "i", "name": "marker", "cat": "kernel", "ts": 300.0,
         "pid": 0, "tid": 7},
    ]


def test_range_not_counted_and_overlap_counted_once():
    busy, rows = device_time(range_over_two_streams())
    # union: 10-170 (160 us), 200-220 (20), 230-240 (10) = 190 us; a sum
    # of the durations would say 230 us, and with the ranges 930 us
    assert busy == pytest.approx(0.190)
    assert busy == busy_union_ms(range_over_two_streams())
    names = {name for _, _, name in rows}
    assert names == {"raster_forward", "raster_backward", "Memcpy DtoH",
                     "Memset"}
    assert rows[0][2] in ("raster_forward", "raster_backward")
    assert sum(ms for ms, _, _ in rows) == pytest.approx(0.230)
    assert sum(n for _, n, _ in rows) == 4


def test_cpu_profile_with_a_range_has_no_device_time():
    """A real torch.profiler run on the CPU: the range is in the trace,
    and the reader finds no device work in it."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("train_loop"):
            (x @ x).sum()
    events = profile_events(prof)
    assert any(e.get("name") == "train_loop" for e in events)
    assert device_time(events) == (0.0, [])
    dev, host = pr.ops(prof)
    assert dev == {} and any("mm" in k for k in host)


def test_print_profile_fails_where_busy_exceeds_wall(capsys):
    rows = [(6.0, 3, "raster_forward"), (2.0, 1, "Memcpy DtoH")]
    cs.print_profile("phase 6", "keyframe", 10.0, (8.0, rows))
    out = capsys.readouterr().out
    assert "idle share 0.200" in out and "raster_forward" in out
    with pytest.raises(SystemExit):
        cs.print_profile("phase 6", "keyframe", 10.0, (12.0, rows))
    assert "busy 12.0 ms > wall 10.0 ms" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cs.print_profile("phase 7", "frame", 10.0, (0.0, []))


def test_profiled_phases_read_through_the_one_reader():
    """No device time in chip_smoke.py or profile_reproducible.py is read
    from `key_averages` any more (the rows that counted the ranges)."""
    for name in ("chip_smoke.py", "profile_reproducible.py"):
        with open(cs.ROOT / name) as f:
            src = f.read()
        assert "self_device_time_total" not in src, name
        assert "self_cuda_time_total" not in src, name
    json.dumps(range_over_two_streams())
