"""Stage timing: host wall-clock per named stage. With `sync_device` set to
a CUDA device, each stage ends with `torch.cuda.synchronize`, so a stage's
time holds the device work it enqueued; without it a stage's time is the
host's only, and device work may run on into the next stage. The report says
which of the two it is."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
