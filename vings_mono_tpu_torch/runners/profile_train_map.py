"""The train loop's top device ops mapped to the port's source lines, the
counterpart of the JAX package's `scripts/profile_train_map.py` (which
maps XLA fusion names to source through HLO metadata).

Usage: python -m vings_mono_tpu_torch.runners.profile_train_map
           [NAME ...] [--device cuda|cpu]

One train loop of 50 iterations on `bench_common.synthetic_window`
(240x432, chunk 128) under `torch.profiler.profile(with_stack=True)`;
the ops are grouped by name and their 5 innermost Python frames inside
the package, as `key_averages(group_by_stack_n=5)` groups them where the
profiler fills `stack` (this one records each Python call as an event of
its own, an ancestor of the op). Prints the rows with the most self
device time (self CPU time without a card) or, given NAMEs, the rows
whose op name contains one, each with its frames. The last line
is one JSON record. Inside `utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import json

from .bench_common import (WINDOW_MAPPER, device_name, load, sync,
                           synthetic_window, window_train)
from .eval_all import card_line
from .eval_common import add_device_flag

PACKAGE = "vings_mono_tpu_torch"
ITERS, TOP = 50, 12


def port_frames(event, depth):
    """The `depth` innermost Python frames inside the package above an
    op: its recorded stack where the profiler fills `stack`, else its
    ancestors, where the profiler records each Python call as an event of
    its own."""
    frames = [f for f in (event.stack or []) if PACKAGE in f]
    e = event.cpu_parent
    while not event.stack and e is not None:
        if PACKAGE in e.name:
            frames.append(e.name)
        e = e.cpu_parent
    return tuple(frames[:depth])


def rows_of(prof, cuda, targets=(), depth=5):
    """[(op name, self ms, calls, [port frames])], the ops grouped by name
    and their `depth` innermost port frames, by self device ms (self CPU
    ms without a card)."""
    from torch.autograd import DeviceType
    agg = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU \
                or getattr(e, "is_user_annotation", False) \
                or (".py(" in e.name and "): " in e.name):
            continue     # a kernel, a named range or a Python frame
        if targets and not any(t in e.name for t in targets):
            continue
        us = e.self_device_time_total if cuda else e.self_cpu_time_total
        key = (e.name, port_frames(e, depth))
        ms, n = agg.get(key, (0.0, 0))
        agg[key] = (ms + us / 1e3, n + 1)
    out = sorted(((name, ms, n, list(fr)) for (name, fr), (ms, n)
                  in agg.items()), key=lambda x: -x[1])
    return out if targets else out[:TOP]


def main(argv=None, extra=None, height=240, width=432, iters=ITERS):
    p = argparse.ArgumentParser()
    p.add_argument("targets", nargs="*")
    add_device_flag(p)
    args = p.parse_args(argv)
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with reproducible():
        cfg = load({"training_args": {"iters": iters,
                                      "num_keyframe": 5},
                    "mapper": dict(WINDOW_MAPPER)}, extra, device)
        mapper, batch, binned, intr4 = synthetic_window(cfg, device,
                                                        height, width)
        run, _, _ = window_train(mapper, batch, binned, intr4, iters,
                                 height, width)
        run()
        sync(device)
        # verbose: without it some PyTorch releases record no stacks
        with profile(activities=acts, with_stack=True,
                     experimental_config=_ExperimentalConfig(verbose=True)
                     ) as prof:
            run()
            sync(device)
    rows = rows_of(prof, cuda, args.targets)
    busy = None
    if cuda:
        from ..utils.profiling import device_time, profile_events
        busy, _ = device_time(profile_events(prof))
    print(f"on {device_name(device)} [{card_line()}]: train_loop "
          f"iters={iters}, self {'device' if cuda else 'CPU'} ms"
          + (f"; device busy {busy:.2f} ms (kernels, memcpy, memset)"
             if cuda else ""))
    for name, ms, n, frames in rows:
        print(f"==== {name}: {ms:.2f} ms, {n} calls")
        for f in frames:
            print(f"    {f}")
    print(json.dumps({
        "device": device_name(device), "device_busy_ms": busy,
        "rows": [{"op": name, "self_ms": ms, "calls": n, "frames": frames}
                 for name, ms, n, frames in rows]}), flush=True)
    return rows


if __name__ == "__main__":
    main()
