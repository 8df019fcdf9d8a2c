"""Stage timing, device traces and FLOP counts.

`StageTimer`: host wall-clock per named stage. With `sync_device` set to a
CUDA device, each stage ends with `torch.cuda.synchronize`, so a stage's
time holds the device work it enqueued; without it a stage's time is the
host's only, and device work may run on into the next stage. The report says
which of the two it is.

`trace` records a `torch.profiler` trace (CPU and, where there is a card,
CUDA activity, every thread) as a chrome trace; `load_trace` reads it
back, `device_events` sums its device events (kernels, memcpy, memset)
by name. `device_time` is the one reader of device time: it counts those
events alone, as a union of intervals over every stream, and never the
program ranges (`record_function`), which the profiler also reports with
a device time. `count_flops` counts a call's FLOPs with
`torch.utils.flop_counter.FlopCounterMode`."""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

# NVIDIA's data sheet for the H100 SXM5 (`nvidia-smi`: NVIDIA H100 80GB
# HBM3, 700 W): the dense bf16 tensor-core peak, without sparsity. As the
# JAX package reads its TPU's bf16 peak, it is the denominator of the MFU
# even for f32 programs, so the MFU is a lower bound on how the card is used
H100_PEAK_FLOPS = 989e12

# the chrome trace's categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class StageTimer:
    def __init__(self, sync_device=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync_device = None
        if sync_device is not None \
                and torch.device(sync_device).type == "cuda":
            self.sync_device = torch.device(sync_device)

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync_device is not None:
                torch.cuda.synchronize(self.sync_device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @property
    def mode(self):
        return "host wall-clock after torch.cuda.synchronize" \
            if self.sync_device is not None \
            else "host wall-clock, no device synchronize"

    def report(self):
        lines = [f"stage times: {self.mode}"]
        for k in sorted(self.totals):
            n = max(self.counts[k], 1)
            lines.append(f"{k}: total {self.totals[k]:.2f}s, "
                         f"n={self.counts[k]}, "
                         f"avg {1e3 * self.totals[k] / n:.1f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(dirname):
    """torch.profiler trace of the block, written to
    `dirname/trace.json` as a chrome trace (chrome://tracing, Perfetto).
    CUDA activity is recorded where a card is present, and the ranges of
    every thread (a threaded runner's mapper runs in a thread of its
    own)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))


def load_trace(trace_dir):
    """The events of the first chrome trace under `trace_dir` (`*.json`
    or `*.json.gz`); [] when there is none."""
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True) +
                   glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                             recursive=True))
    if not files:
        return []
    opener = gzip.open if files[0].endswith(".gz") else open
    with opener(files[0], "rt") as f:
        return json.load(f)["traceEvents"]


def is_device(event):
    """A device event of a chrome trace: a kernel, memcpy or memset."""
    return event.get("ph") == "X" and event.get("cat") in DEVICE_CATEGORIES


def device_ms_by_name(events):
    """{event name: (total ms, count)} over the device events."""
    agg = {}
    for e in events:
        if is_device(e):
            ms, n = agg.get(e["name"], (0.0, 0))
            agg[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    return agg


def busy_union_ms(events):
    """Device busy time (ms) as the union of the device events'
    intervals over every device and stream: two overlapping kernels on
    two streams count once, where a sum of their durations counts
    both."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                for e in events if is_device(e))
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
    if cur_s is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def profile_events(prof):
    """The chrome-trace events of a finished `torch.profiler.profile`
    (kept on it: a profile exports its trace once)."""
    if getattr(prof, "chrome_events", None) is None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                prof.chrome_events = json.load(f)["traceEvents"]
    return prof.chrome_events


def device_time(events):
    """(busy ms, rows) of a chrome trace's device work: busy is the union
    of the kernel, memcpy and memset intervals over every device and
    stream (`busy_union_ms`); rows are (total ms, count, name) of those
    events by name, largest first. A program range (`record_function`,
    category `gpu_user_annotation` on the device, `user_annotation` on
    the host) spans its kernels and is not counted: it is no device work
    of its own."""
    rows = sorted(((ms, n, name) for name, (ms, n)
                   in device_ms_by_name(events).items()), reverse=True)
    return busy_union_ms(events), rows


def device_events(trace_dir):
    """The first chrome trace under `trace_dir` -> {event name: (total
    ms, count)} over its device events only: kernels, memcpy and memset.
    {} when there is no trace."""
    return device_ms_by_name(load_trace(trace_dir))


def count_flops(fn, *args, **kwargs):
    """FLOPs of one call of fn(*args, **kwargs) as
    `torch.utils.flop_counter.FlopCounterMode` counts them: matmuls,
    convolutions and attention, forward and backward; elementwise ops,
    reductions, gathers and custom kernels count 0."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()
