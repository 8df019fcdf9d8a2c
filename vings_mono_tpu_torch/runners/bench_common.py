"""What the measurement entry points share (`bench`, `bench_*`,
`profile_*`, `mfu`, `tune_binning`, `report_parity`): the configuration
overrides of the JAX package's `bench.py` and of its profiling scripts,
the synthetic frames, the pipeline steps of the bench (warm-up, the
halved-iterations keyframe, the overlapped tracker || mapper section), a
synthetic keyframe window for the mapper-level tools, and the readers of
a `torch.profiler` chrome trace: the device's busy time as a union of
intervals, and device time per program.

Programs are named by `torch.profiler.record_function` ranges at their
call sites, as the JAX package's jit names them: `train_loop`,
`add_frame`, `bin_stack` and `storage_control` in `GaussianMapper.run`,
`_fused_update` in `CovisibleGraph.update`, `ba_global` in `ops/ba.py`.
On the card each range shows in the trace as a `gpu_user_annotation` on
the stream that ran its kernels; a program's device time is the sum of the
device events inside its ranges on the same device and stream.

Every tool keeps its script's sizes, seeds and printed keys, runs on the
card unless `--device` says otherwise (`utils.device.resolve_device`) and
runs inside `utils.device.reproducible`, so that it measures what the
runners run.
"""

from __future__ import annotations

import bisect
import dataclasses
import queue
import time
from collections import defaultdict

import numpy as np
import torch

from ..utils.profiling import is_device

H, W = 240, 432
FOCAL = 220.0

# bench.py:35-51, also profile_overlap.py and profile_host.py
BENCH_FRONTEND = {
    "buffer": 48, "warm_up": 8, "filter_thresh": -1.0,
    "keyframe_thresh": 0.0, "frontend_thresh": 1e9,
    "frontend_window": 12, "frontend_radius": 2, "frontend_nms": 1,
    "max_factors": 48, "edge_capacity": 48,
    "inactive_capacity": 64, "ba_window": 16,
    "iters1": 2, "iters2": 1, "active_window": 12, "max_age": 12,
    # the first rollup fires in the throwaway pass; after it rollups are
    # measured steady-state work
    "rollup_at": 24, "rollup_n": 16, "save_buffer": 256,
}
# bench_profile.py, mfu.py, profile_map_run.py, bench_tracker_micro.py
PROFILE_FRONTEND = dict(BENCH_FRONTEND, edge_capacity=64,
                        inactive_capacity=128, rollup_at=40)
BENCH_TRAINING = {"iters": 50, "num_keyframe": 5, "coarse_frac": 0.5}
BENCH_MAPPER = {"capacity": 1 << 18, "pair_capacity": 1 << 18,
                "chunk": 256, "side": 3, "visible_capacity": 1 << 16,
                "kf_capacity": 8, "adaptive_iters": 23.0,
                "points_per_frame": 20000, "points_first_frame": 30000}
# the mapper-level scripts (mfu.py, bench_mapper.py, profile_train.py,
# bench_scatter.py, profile_train_map.py): chunk 128, no adaptive iters
WINDOW_MAPPER = {"capacity": 1 << 18, "pair_capacity": 1 << 18,
                 "chunk": 128, "side": 3, "visible_capacity": 1 << 16,
                 "kf_capacity": 8, "points_per_frame": 20000,
                 "points_first_frame": 30000}

GATED_FILTER_THRESH = 1.75   # bench.py:200-201, the gated lane
GATED_KEYFRAME_THRESH = 2.0
QUEUE_SIZE = 4               # bench.py's tracker -> mapper queue


def merge(base, extra):
    """base with extra merged one level deep (dicts of sections)."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in base.items()}
    for k, v in (extra or {}).items():
        if isinstance(v, dict):
            out.setdefault(k, {}).update(v)
        else:
            out[k] = v
    return out


def bench_overrides(frontend=BENCH_FRONTEND, mapper=BENCH_MAPPER,
                    training=BENCH_TRAINING):
    """The overrides dict of bench.py's `load_config` (or of a profiling
    script's, with its own sections; None leaves a section out)."""
    out = {"mode": "vo", "frontend": dict(frontend)}
    if training is not None:
        out["training_args"] = dict(training)
    if mapper is not None:
        out["mapper"] = dict(mapper)
    return out


def gated_overrides(cfg, weights):
    """bench.py's gated lane (:197-203): the loaded bench config with the
    motion filter and keyframe test on, driven by trained weights."""
    return {"mode": "vo",
            "frontend": dict(cfg["frontend"],
                             filter_thresh=GATED_FILTER_THRESH,
                             keyframe_thresh=GATED_KEYFRAME_THRESH,
                             weight=weights),
            "training_args": dict(cfg["training_args"]),
            "mapper": dict(cfg["mapper"])}


def load(overrides, extra=None, device=None):
    """load_config of overrides merged with `extra` (smaller sizes for a
    CPU run), with both stages on `device`."""
    from ..utils.config import load_config
    ov = merge(overrides, extra)
    if device is not None:
        ov = merge(ov, {"device": {"tracker": str(device),
                                   "mapper": str(device)}})
    return load_config(overrides=ov)


def make_frame(height=H, width=W, third=True, f32=True, u8=True):
    """The scripts' synthetic photometric frame k. bench.py's (:59-66) has
    the third sine term, casts to f32 and quantizes to 8 bits; mfu.py's
    lacks the third term and quantizes from f64; bench_profile.py's and
    bench_tracker_micro.py's stay f32 in [0, 1]."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width),
                         indexing="ij")
    intr = np.asarray([FOCAL, FOCAL, width / 2, height / 2], np.float32)

    def frame(k):
        img = 0.5 + 0.3 * np.sin(0.05 * (xs + 4.0 * k)) * \
            np.cos(0.04 * (ys + 2.0 * k))
        if third:
            img = img + 0.2 * np.sin(0.13 * xs + 0.1 * k)
        rgb = np.stack([img, img * 0.8,
                        np.abs(np.sin(0.02 * xs + 0.2 * k))], -1)
        if f32:
            rgb = rgb.astype(np.float32)
        rgb = np.clip(rgb, 0, 1)
        if u8:
            rgb = (rgb * 255).astype(np.uint8)
        return {"timestamp": float(k), "rgb": rgb, "intrinsic": intr}
    return frame


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def track_and_map(tracker, mapper, cfg, frames, ks):
    """Track frames ks and map each packaged window in this thread, as
    the scripts' warm-up does. Returns the last window (None if none) and
    the count of windows."""
    from ..middleware import judge_and_package
    last, n = None, 0
    for k in ks:
        tracker.track(frames(k))
        viz = judge_and_package(tracker, cfg)
        if viz is not None:
            last, n = viz, n + 1
            mapper.run(viz)
    return last, n


def halved_iters_keyframe(mapper, viz):
    """bench.py:95-118: one more keyframe (stamps + 1000, so the mapper
    takes it as new) with the host PSNR forced to 99 after the deferred
    stats drained, so that the adaptive rule halves its iterations. The
    JAX package compiles the halved loop here; here it trains the map one
    keyframe further, so that the measured section starts from the same
    map and frame indices as the JAX bench's. False when there was no
    window to repeat."""
    if viz is None or mapper.metrics is None:
        return False
    vz = dict(viz)
    vz["viz_out_idx_to_f_idx"] = \
        np.asarray(vz["viz_out_idx_to_f_idx"]) + 1000.0
    mapper._drain_stats()
    mapper._pending_stats = []
    mapper._last_psnr_host = 99.0
    mapper.run(vz)
    return True


def _put(q, item, stop):
    """q.put that gives up once `stop` is set (the consumer died)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return
        except queue.Full:
            continue


def overlapped(tracker, mapper, cfg, frames, ks, device):
    """The bench's measured section: this thread tracks frames ks
    (frames(k) gives frame k) while a mapper thread maps the packaged
    windows from a queue of QUEUE_SIZE, each thread on its own CUDA stream
    (`run_multiprocess.Workers`; the windows cross as host copies).
    Blocks on a full queue, as bench.py does: no window is dropped. The
    time ends after both streams are synchronized. Returns (seconds,
    windows mapped)."""
    from ..middleware import judge_and_package, to_host
    from ..utils.device import reproducible
    from .run_multiprocess import Workers, worker_stream
    q = queue.Queue(maxsize=QUEUE_SIZE)
    workers = Workers()

    def map_worker():
        while True:
            v = q.get()
            if v is None:
                return
            mapper.run(v)

    workers.start(map_worker, torch.device(device))
    t0 = time.perf_counter()
    n_kf = 0
    try:
        with reproducible(), worker_stream(torch.device(device)):
            for k in ks:
                if workers.stop.is_set():
                    break
                tracker.track(frames(k))
                viz = judge_and_package(tracker, cfg)
                if viz is not None:
                    _put(q, to_host(viz), workers.stop)
                    n_kf += 1
    finally:
        _put(q, None, workers.stop)
        workers.join()
    return time.perf_counter() - t0, n_kf


# ---- the bench's pipeline up to its measured section ------------------
@dataclasses.dataclass
class Warmed:
    tracker: object
    mapper: object
    next_frame: int       # first frame index after the warm-up
    windows: int          # windows mapped in the warm-up


def warm_pipeline(cfg, frames, device, n_warm=12, n_post=2, weights=None,
                  halved=True, height=H, width=W):
    """bench.py:56-118 (and its gated lane's :204-220): build the tracker
    and the mapper, map frames 0..n_warm-1, freeze the pair buckets, map
    n_post more, then (halved) the halved-iterations keyframe; the device
    is synchronized at the end, so the kernels' first-use build and every
    first call land here."""
    from ..mapper.mapper import GaussianMapper
    from ..tracker.tracker import Tracker
    tracker = Tracker(cfg, height, width, weights_path=weights,
                      device=device)
    mapper = GaussianMapper(cfg, device=device)
    viz, n = track_and_map(tracker, mapper, cfg, frames, range(n_warm))
    sync(device)
    mapper.freeze_buckets()
    viz2, n2 = track_and_map(tracker, mapper, cfg, frames,
                             range(n_warm, n_warm + n_post))
    viz = viz2 if viz2 is not None else viz
    if halved:
        n2 += halved_iters_keyframe(mapper, viz)
    sync(device)
    return Warmed(tracker, mapper, n_warm + n_post, n + n2)


# ---- a synthetic keyframe window (the mapper-level scripts) -----------
def synthetic_window(cfg, device, height=H, width=W, n_points=None,
                     k=8, seed=0):
    """mfu.py's `setup_mapper` (also bench_mapper.py, profile_train.py,
    bench_scatter.py, profile_train_map.py): a K-keyframe batch of
    uniform noise from numpy's generator `seed` (images in [0, 1], depths
    in [2, 20], covariance 0.01, cameras 0.1 apart along x), the first two
    keyframes densified with `n_points` each (default: the config's
    `points_first_frame`, the scripts' 30000), and every camera binned.
    Returns (mapper, batch, binned, intr4)."""
    from ..mapper.densify import add_frame
    from ..mapper.mapper import GaussianMapper
    from ..mapper.train import KeyframeBatch, bin_stack
    mapper = GaussianMapper(cfg, device=device)
    mapper.H, mapper.W = height, width
    rng = np.random.default_rng(seed)
    dev = mapper.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    images = t(rng.uniform(0, 1, (k, 3, height, width)))
    depths = t(rng.uniform(2, 20, (k, 1, height, width)))
    w2cs = torch.eye(4, device=dev).repeat(k, 1, 1)
    w2cs[:, 0, 3] = torch.arange(k, device=dev) * 0.1
    batch = KeyframeBatch(
        images=images, depths=depths,
        depths_cov=torch.full((k, 1, height, width), 0.01, device=dev),
        w2cs=w2cs, global_kf_id=torch.arange(k, dtype=torch.int32,
                                             device=dev),
        n_valid=k)
    intr4 = (FOCAL, FOCAL, width / 2, height / 2)
    if n_points is None:
        n_points = int(cfg["mapper"]["points_first_frame"])
    for i in range(2):
        gumbel, quat = mapper._densify_draws(n_points)
        add_frame(mapper.state, mapper.opt, batch.w2cs[i], intr4,
                  batch.images[i], batch.depths[i], batch.global_kf_id[i],
                  height=height, width=width, gumbel=gumbel,
                  quat_noise=quat, n_points=n_points, first=True,
                  render_kwargs=mapper.render_kwargs)
    binned = bin_stack(mapper.state, batch, intr4, height, width,
                       **mapper.bin_kwargs)
    sync(dev)
    return mapper, batch, binned, intr4


def copy_state(state, opt):
    """Fresh copies of a map and its Adam moments (the train loop updates
    both in place; the JAX scripts copy before each donating call)."""
    from ..mapper.state import STATE_FIELDS, SparseAdamState
    st = dataclasses.replace(state, **{f: getattr(state, f).clone()
                                       for f in STATE_FIELDS})
    op = SparseAdamState(m={k: v.clone() for k, v in opt.m.items()},
                         v={k: v.clone() for k, v in opt.v.items()},
                         step=opt.step)
    return st, op


def window_train(mapper, batch, binned, intr4, iters, height=H, width=W):
    """A function running `iters` train iterations on copies of the
    window's map, named `train_loop` in a trace, and the call's
    (args, kwargs) for FLOP counting."""
    from ..mapper.train import draw_kf_schedule, train_loop
    sched = draw_kf_schedule(torch.Generator().manual_seed(0),
                             iters, batch.n_valid)
    kw = dict(iters=iters, height=height, width=width, kf_schedule=sched,
              render_kwargs=mapper.render_kwargs)

    def run():
        st, op = copy_state(mapper.state, mapper.opt)
        with torch.profiler.record_function("train_loop"):
            return train_loop(st, op, batch, binned, intr4, **kw)
    return run, (mapper.state, mapper.opt, batch, binned, intr4), kw


def timed_ms(fn, device, n=3, warm=1):
    """Host ms per call of fn() over n calls after `warm` calls, the
    device synchronized before and after (the scripts' `timeit`)."""
    for _ in range(warm):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / n * 1e3


# ---- traces (`utils.profiling.trace` / `load_trace`) ----------------
def device_span_ms(events):
    """First device event's start to the last one's end, ms."""
    dev = [e for e in events if is_device(e)]
    if not dev:
        return 0.0
    return (max(float(e["ts"]) + float(e.get("dur", 0)) for e in dev)
            - min(float(e["ts"]) for e in dev)) / 1e3


def program_ms(events, names):
    """{program: (device ms, calls)} for each name in `names`: the device
    events inside the program's `gpu_user_annotation` ranges, on the same
    device (pid) and stream (tid); calls counts its host ranges
    (`user_annotation`). A program with no range at all did not run:
    (0.0, 0). One with host ranges but no device range raises: that is a
    trace that cannot say (no card, or ranges lost), not a program that
    took 0 ms."""
    host = defaultdict(int)
    ranges = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or e.get("name") not in names:
            continue
        if e.get("cat") == "user_annotation":
            host[e["name"]] += 1
        elif e.get("cat") == "gpu_user_annotation":
            ranges[e["name"]].append(e)
    missing = {n: host[n] for n in names if host.get(n)
               and not ranges.get(n)}
    if missing:
        raise RuntimeError(
            f"programs ran (host ranges {missing}) but the trace has no "
            f"device range for them: no card, or the ranges were lost")
    by_stream = defaultdict(list)
    for e in filter(is_device, events):
        by_stream[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), float(e.get("dur", 0))))
    index = {}
    for key, evs in by_stream.items():
        evs.sort()
        cum = np.concatenate([[0.0], np.cumsum([d for _, d in evs])])
        index[key] = ([s for s, _ in evs], cum)
    out = {}
    for name in names:
        us = 0.0
        for r in ranges.get(name, ()):
            starts, cum = index.get((r.get("pid"), r.get("tid")),
                                    ([], [0.0]))
            s = float(r["ts"])
            i0 = bisect.bisect_left(starts, s)
            i1 = bisect.bisect_right(starts, s + float(r.get("dur", 0)))
            us += cum[i1] - cum[i0]
        out[name] = (us / 1e3, host.get(name, 0))
    return out


def device_name(device):
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
