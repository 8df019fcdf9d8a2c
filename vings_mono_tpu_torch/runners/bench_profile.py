"""Per-stage wall times of the bench's pipeline, run serially, the
counterpart of the JAX package's `scripts/bench_profile.py`.

Usage: python -m vings_mono_tpu_torch.runners.bench_profile
           [--device cuda|cpu]

The profiling scripts' config (`bench_common.PROFILE_FRONTEND`, the
bench's mapper at chunk 256 without adaptive iterations) on f32 frames at
240x432. Every frame is tracked, packaged and mapped in this thread;
`StageTimer(sync_device=device)` ends each stage with a device
synchronize, so a stage's time holds its device work. Stages: track,
package, map; within them graph.update, graph.add_proximity,
graph.add_factors, map.pack_batch, map.refresh_binned (full and coarse,
with the cache hit, bucket and pair count), map.add_frame,
map.train_loop[iters]@HxW and map.storage_control. Of 30 frames the
first 14 are dropped from the totals; the last line is one JSON record of
each stage's mean ms. Inside `utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

from .bench_common import (BENCH_MAPPER, BENCH_TRAINING, PROFILE_FRONTEND,
                           bench_overrides, device_name, load, make_frame)
from .eval_all import card_line
from .eval_common import add_device_flag

MAPPER = {k: v for k, v in BENCH_MAPPER.items() if k != "adaptive_iters"}


@contextlib.contextmanager
def patched(pairs):
    """Set (owner, name, value) attributes inside the block, restoring
    the old values after."""
    old = [(o, n, getattr(o, n)) for o, n, _ in pairs]
    for o, n, v in pairs:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in old:
            setattr(o, n, v)


def stage_patches(sub):
    """The fine-grained stages as wrappers timed by `sub`."""
    from ..mapper import mapper as mm
    from ..tracker import graph as gm

    def timed(name, fn):
        def wrapper(*a, **k):
            with sub(name(a, k) if callable(name) else name):
                return fn(*a, **k)
        return wrapper

    G, M = gm.CovisibleGraph, mm.GaussianMapper
    refresh = M._refresh_binned

    def timed_refresh(self, *a, **k):
        sfx = k.get("sfx", "")
        cached = getattr(self, "_binned" + sfx)
        with sub(f"map.refresh_binned{sfx}"):
            r = refresh(self, *a, **k)
        kw = getattr(self, "bin_kwargs" + sfx)
        print(f"  refresh{sfx}: cache="
              f"{'hit' if cached is not None else 'MISS'} "
              f"p_cap={kw['p_cap']} n_pairs={int(r.n_pairs.max())} "
              f"overflow={bool(r.overflow.any())}", flush=True)
        return r

    return [
        (G, "update", timed("graph.update", G.update)),
        (G, "add_proximity_factors",
         timed("graph.add_proximity", G.add_proximity_factors)),
        (G, "add_factors", timed("graph.add_factors", G.add_factors)),
        (M, "_pack_batch", timed("map.pack_batch", M._pack_batch)),
        (M, "_refresh_binned", timed_refresh),
        (mm, "train_loop", timed(
            lambda a, k: f"map.train_loop[{k.get('iters')}]"
                         f"@{k.get('height')}x{k.get('width')}",
            mm.train_loop)),
        (mm, "add_frame", timed("map.add_frame", mm.add_frame)),
        (mm, "storage_control",
         timed("map.storage_control", mm.storage_control)),
    ]


def main(argv=None, extra=None, height=240, width=432, n_frames=30,
         n_warm=14):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)

    from ..mapper.mapper import GaussianMapper
    from ..middleware import judge_and_package
    from ..tracker.tracker import Tracker
    from ..utils.device import reproducible, resolve_device
    from ..utils.profiling import StageTimer
    device = resolve_device(args.device)
    frames = make_frame(height, width, u8=False)
    with reproducible():
        cfg = load(bench_overrides(PROFILE_FRONTEND, MAPPER, BENCH_TRAINING),
                   extra, device)
        tracker = Tracker(cfg, height, width, device=device)
        mapper = GaussianMapper(cfg, device=device)
        timer, sub = StageTimer(device), StageTimer(device)
        with patched(stage_patches(sub)):
            for k in range(n_frames):
                if k == n_warm:   # drop the warm-up from the totals
                    for t in (timer, sub):
                        t.totals.clear()
                        t.counts.clear()
                t0 = time.perf_counter()
                with timer("track"):
                    tracker.track(frames(k))
                with timer("package"):
                    viz = judge_and_package(tracker, cfg)
                if viz is not None:
                    with timer("map"):
                        mapper.run(viz)
                ps = mapper.last_metrics.get("psnr")
                print(f"frame {k}: {time.perf_counter() - t0:.2f}s psnr="
                      f"{ps if ps is None else round(ps, 2)}", flush=True)
    print(f"== totals ({device_name(device)} [{card_line()}], frames "
          f"{n_warm}-{n_frames - 1}) ==")
    print(timer.report())
    print(sub.report())
    print(json.dumps({"device": device_name(device), "card": card_line(),
                      "frames": n_frames - n_warm, "avg_ms": {
                          k: 1e3 * t.totals[k] / t.counts[k]
                          for t in (timer, sub) for k in t.totals}}),
          flush=True)
    return timer, sub


if __name__ == "__main__":
    main()
