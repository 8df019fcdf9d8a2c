"""Pipelined tracker || mapper, the counterpart of the reference's
2-process pipeline (scripts/run_multiprocess.py: tracking process ->
queue (qsize < 5 backpressure) -> mapping process).

Usage: python -m vings_mono_tpu_torch.runners.run_multiprocess <config.yaml>
           [--prefix NAME] [--max-frames N] [--device cuda|cpu]

One card serves both stages from two host threads: the tracker thread runs
ahead while the mapper thread trains on an earlier keyframe window. Each
thread issues its device work on its own CUDA stream, so a host wait in
the tracker (the motion filter reads back once per frame) does not wait
for the mapper's queued work. Only host arrays cross between them: each
window is copied to the host before it is queued and uploaded again by the
mapper, so no stream waits on another. A window packaged while five wait
in the queue is dropped (the reference's backpressure), so what is mapped
depends on how fast the mapper runs. An exception in either thread stops
both and is raised again by `run`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import queue
import threading

import torch

BACKLOG = 5   # windows waiting for the mapper beyond which one is dropped


@contextlib.contextmanager
def worker_stream(device):
    """Issue the block's device work on a new CUDA stream of `device` and
    wait for it at the end, so that what the block returns is complete
    for any other stream; on the CPU a no-op."""
    if device.type != "cuda":
        yield
        return
    stream = torch.cuda.Stream(device)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        stream.synchronize()


class Workers:
    """Threads of one pipeline. Each runs its function under its own CUDA
    stream and inside `utils.device.reproducible` (each op is
    deterministic; what is mapped still depends on the backpressure); the
    first exception stops the others (`stop`) and `join` raises it in the
    calling thread."""

    def __init__(self):
        self.threads = []
        self.errors = []
        self.stop = threading.Event()

    def start(self, fn, device, on_exit=None):
        """Run fn() in a thread on `device`'s stream; on_exit() runs after
        it however it ends (a queue's end sentinel)."""
        def body():
            from ..utils.device import reproducible
            try:
                with reproducible(), worker_stream(device):
                    fn()
            except Exception as e:   # raised again by join()
                self.errors.append(e)
                self.stop.set()
            finally:
                if on_exit is not None:
                    on_exit()
        t = threading.Thread(target=body, daemon=True)
        t.start()
        self.threads.append(t)

    def finished(self):
        return any(not t.is_alive() for t in self.threads)

    def join(self, timeout=None):
        for t in self.threads:
            t.join(timeout)
        if self.errors:
            raise self.errors[0]


def tracking_worker(cfg, q, save_dir, max_frames, device, stats, stop):
    """Track the dataset's frames until `stop` is set and queue each
    packaged window's host copy unless BACKLOG windows wait; counts the
    windows packaged and dropped in `stats`. Returns the tracker."""
    from ..datasets.base import get_dataset
    from ..middleware import judge_and_package, to_host
    from ..utils.trajectory import save_trajectory
    from .run import build_tracker

    stats.update(windows=0, dropped=0)
    dataset = get_dataset(cfg)
    tracker = build_tracker(cfg, dataset, device)
    n = len(dataset) if max_frames is None else min(len(dataset),
                                                    max_frames)
    for idx in range(n):
        if stop.is_set():
            break
        tracker.track(dataset[idx])
        viz_out = judge_and_package(tracker, cfg)
        if viz_out is None:
            continue
        stats["windows"] += 1
        if q.qsize() < BACKLOG:
            q.put(to_host(viz_out))
        else:
            stats["dropped"] += 1
    save_trajectory(tracker, save_dir)
    return tracker


def mapping_worker(cfg, q, save_dir, device, stats):
    """Hand every queued window to the mapper until the None sentinel
    (counted in `stats` as mapped; the mapper trains on those that bring
    a new keyframe); writes the final .ply. Returns the mapper. With
    `parallel.dp` > 1 this thread leads the dp group, which it closes
    however it ends."""
    from ..mapper.mapper import GaussianMapper
    stats["mapped"] = 0
    mapper = GaussianMapper(cfg, device=device)
    try:
        while True:
            viz_out = q.get()
            if viz_out is None:
                break
            mapper.run(viz_out)
            stats["mapped"] += 1
        os.makedirs(os.path.join(save_dir, "ply"), exist_ok=True)
        mapper.save_ply(os.path.join(save_dir, "ply", "final_2dgs.ply"))
    finally:
        mapper.close()
    return mapper


def run(cfg, save_dir, max_frames=None, device=None):
    """Track and map in two threads. Returns (tracker, mapper, stats):
    stats counts the windows packaged, mapped and dropped."""
    from ..utils.device import resolve_device
    from .run import check_ported

    check_ported(cfg)
    devs = {k: resolve_device(device or cfg["device"][k])
            for k in ("tracker", "mapper")}
    q = queue.Queue(maxsize=BACKLOG + 3)
    stats, results = {}, {}
    workers = Workers()

    def track():
        results["tracker"] = tracking_worker(
            cfg, q, save_dir, max_frames, devs["tracker"], stats,
            workers.stop)

    def map_():
        results["mapper"] = mapping_worker(cfg, q, save_dir,
                                           devs["mapper"], stats)

    workers.start(track, devs["tracker"], on_exit=lambda: q.put(None))
    workers.start(map_, devs["mapper"])
    workers.join()
    print(f"windows: {stats['windows']} packaged, {stats['mapped']} "
          f"mapped, {stats['dropped']} dropped by the backpressure")
    return results["tracker"], results["mapper"], stats


def main(argv=None):
    from ..utils.config import load_config, make_run_dir
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--prefix", default="")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the config's, cuda)")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    save_dir = make_run_dir(cfg, args.prefix)
    run(cfg, save_dir, args.max_frames, device=args.device)


if __name__ == "__main__":
    main()
