"""Live mobile pipeline (reference scripts/run_multiprocess_mobile.py):
websocket server -> tracker -> mapper over three queues, with the mapper's
render of each window's newest keyframe streamed back to the phone.

Usage: python -m vings_mono_tpu_torch.runners.run_multiprocess_mobile
           <config.yaml> [--device cuda|cpu]

The tracker and the mapper are threads as in `run_multiprocess`: each on
its own CUDA stream, host copies of the windows on the queue, a window
dropped while five wait, and an exception in either stops the pipeline
and is raised again (the server stops with it).
"""

from __future__ import annotations

import argparse
import asyncio
import queue

import numpy as np

from .run_multiprocess import BACKLOG, Workers

POLL_S = 0.5   # how often a waiting worker looks at the stop flag


def put_latest(q, item):
    """Put item on a bounded queue, dropping the oldest entry when it is
    full: the server shows only the newest render."""
    while True:
        try:
            q.put_nowait(item)
            return
        except queue.Full:
            try:
                q.get_nowait()
            except queue.Empty:
                pass


def tracking_worker(cfg, s2t, t2m, device, stop, stats):
    """Track the frames the server queues ({'timestamp', 'rgb'}) until the
    None sentinel or `stop`; frames are resized to `frontend.image_size`
    and the config's intrinsics scaled to it. Queues each packaged
    window's host copy unless BACKLOG windows wait."""
    import cv2
    from ..datasets.base import scaled_intrinsic
    from ..middleware import judge_and_package, to_host
    from ..tracker.tracker import Tracker
    stats.update(frames=0, windows=0, dropped=0)
    H, W = (int(cfg["frontend"]["image_size"][0]),
            int(cfg["frontend"]["image_size"][1]))
    tracker = Tracker(cfg, H, W, weights_path=cfg["frontend"].get("weight"),
                      device=device)
    intr = scaled_intrinsic(cfg["intrinsic"], H, W)
    while not stop.is_set():
        try:
            pkt = s2t.get(timeout=POLL_S)
        except queue.Empty:
            continue
        if pkt is None:
            break
        rgb = np.asarray(pkt["rgb"], np.float32)
        if rgb.shape[:2] != (H, W):
            rgb = cv2.resize(rgb, (W, H))
        tracker.track({"timestamp": pkt["timestamp"], "rgb": rgb,
                       "intrinsic": intr})
        stats["frames"] += 1
        viz = judge_and_package(tracker, cfg)
        if viz is None:
            continue
        stats["windows"] += 1
        if t2m.qsize() < BACKLOG:
            t2m.put(to_host(viz))
        else:
            stats["dropped"] += 1
    return tracker


def mapping_worker(cfg, t2m, m2s, device, stats):
    """Map every queued window until the None sentinel and put the render
    of its newest keyframe, (H, W, 3) float32 on the host, on m2s."""
    from ..mapper.mapper import GaussianMapper
    stats["mapped"] = 0
    mapper = GaussianMapper(cfg, device=device)
    try:
        while True:
            viz = t2m.get()
            if viz is None:
                break
            mapper.run(viz)
            stats["mapped"] += 1
            w2c = np.linalg.inv(np.asarray(viz["poses"][-1]))
            rets = mapper.render_at(w2c, viz["intrinsic"])
            put_latest(m2s, rets["rgb"].movedim(0, -1).cpu().numpy())
    finally:
        mapper.close()   # the dp group, with parallel.dp > 1
    return mapper


def start_workers(cfg, s2t, m2s, device=None):
    """Start the tracker and mapper threads between the server's queues.
    Returns (workers, results, stats): `workers.join()` waits and raises
    a worker's exception; `results` gets the tracker and the mapper."""
    from ..utils.device import resolve_device
    from .run import check_ported
    check_ported(cfg)
    devs = {k: resolve_device(device or cfg["device"][k])
            for k in ("tracker", "mapper")}
    t2m = queue.Queue(maxsize=BACKLOG + 3)
    workers = Workers()
    results, stats = {}, {}

    def track():
        results["tracker"] = tracking_worker(cfg, s2t, t2m, devs["tracker"],
                                             workers.stop, stats)

    def map_():
        results["mapper"] = mapping_worker(cfg, t2m, m2s, devs["mapper"],
                                           stats)

    workers.start(track, devs["tracker"], on_exit=lambda: t2m.put(None))
    workers.start(map_, devs["mapper"])
    return workers, results, stats


def main(argv=None):
    from ..server.server import WebsocketServer
    from ..utils.config import load_config, make_run_dir
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--device", default=None,
                   help="torch device (default: the config's, cuda)")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    save_dir = make_run_dir(cfg, "mobile_")

    s2t = queue.Queue(maxsize=32)
    m2s = queue.Queue(maxsize=4)
    workers, _, _ = start_workers(cfg, s2t, m2s, args.device)

    async def until_a_worker_ends():
        while not workers.finished():
            await asyncio.sleep(POLL_S)
    try:
        WebsocketServer(cfg, s2t, m2s, save_dir).run(until_a_worker_ends())
    finally:
        workers.stop.set()
        workers.join()


if __name__ == "__main__":
    main()
