"""Stage timing, device traces and FLOP counts.

`StageTimer`: host wall-clock per named stage. With `sync_device` set to a
CUDA device, each stage ends with `torch.cuda.synchronize`, so a stage's
time holds the device work it enqueued; without it a stage's time is the
host's only, and device work may run on into the next stage. The report says
which of the two it is.

`trace` records a `torch.profiler` trace (CPU and, where there is a card,
CUDA activity) as a chrome trace; `device_events` sums its device events
(kernels, memcpy, memset) by name. `count_flops` counts a call's FLOPs with
`torch.utils.flop_counter.FlopCounterMode`."""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
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
    CUDA activity is recorded where a card is present."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))


def device_events(trace_dir):
    """The first chrome trace under `trace_dir` (`*.json` or `*.json.gz`)
    -> {event name: (total ms, count)} over its device events only:
    kernels, memcpy and memset. {} when there is no trace."""
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True) +
                   glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                             recursive=True))
    if not files:
        return {}
    opener = gzip.open if files[0].endswith(".gz") else open
    with opener(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    agg = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        ms, n = agg.get(e["name"], (0.0, 0))
        agg[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    return agg


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
