"""Whole-session checkpoint and resume, in the JAX package's file layout, so
that a session written by either package loads in the other:

  video.npz         the tracker's device buffers (every VideoBuffers field)
  save_buffers.npz  the keyframes rolled out to the host save buffers
  graph.npz         the edge stores' GRU state, context, targets and weights
                    (the correlation pyramids are not stored: they are
                    rebuilt from the saved feature maps)
  host.pkl          the host counters and edge lists, the frontend's window,
                    the mapper's history and the inertial layer's state
  mapper.npz        the Gaussian map (`GaussianMapper.save_ckpt`)

Not stored, as in the JAX package: the mapper's Adam moments, its sky
sphere and its random stream, and the motion filter's skip count; a
resumed run starts them afresh.

The port writes its arrays uncompressed (`np.savez`; the JAX package
compresses them): `np.load` reads either, and zlib would take seconds per
session at full width, which a checkpoint every N frames must not cost the
run. npz cannot store bf16, so a buffer kept in bf16 is written as f32 and cast
back to the buffer's dtype on load. `host.pkl` is read by an unpickler that
refuses any `jax` or `jaxlib` global and maps the JAX package's numpy-only
host classes (the inertial layer's factors and states) to the port's copies
of them, so loading imports nothing of either."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

VIDEO = "video.npz"
SAVE_BUFFERS = "save_buffers.npz"
GRAPH = "graph.npz"
HOST = "host.pkl"
MAPPER = "mapper.npz"

GRAPH_HOST = ("ii", "jj", "age", "slot", "free_slots", "ii_inac", "jj_inac",
              "slot_inac", "free_inac", "ii_bad", "jj_bad")
FRONTEND_HOST = ("t0", "t1", "is_initialized", "count", "new_frame_added")
SAVED = ("tstamp", "images", "poses", "disps", "disps_up", "depths_cov",
         "depths_cov_up")
EDGE_SAVED = ("net", "inp", "target", "weight")
JAX_PACKAGE = "vings_mono_tpu"
PORT_PACKAGE = "vings_mono_tpu_torch"


def _host(t: torch.Tensor):
    """A tensor as a numpy array npz can store (bf16 widened to f32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _like(arr, ref: torch.Tensor, what):
    """A saved array as a tensor of `ref`'s shape, dtype and device."""
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"session {what} has shape {arr.shape}, the "
                         f"tracker's {tuple(ref.shape)}: the session was "
                         f"written with another configuration")
    return torch.as_tensor(arr).to(ref.device, ref.dtype)


def save_session(path, tracker, mapper, inertial=None):
    os.makedirs(path, exist_ok=True)
    video = tracker.video
    bufs = video.bufs
    np.savez(os.path.join(path, VIDEO),
             **{f: _host(getattr(bufs, f)) for f in bufs.fields()})
    n = video.count_save
    np.savez(os.path.join(path, SAVE_BUFFERS),
             **{k: getattr(video, f"{k}_save")[:n] for k in SAVED})

    g = tracker.graph
    np.savez(
        os.path.join(path, GRAPH),
        **{k: _host(getattr(g.edges, k)) for k in EDGE_SAVED},
        inac_target=_host(g.inac.target), inac_weight=_host(g.inac.weight))

    host = {
        "counter": video.counter, "count_save": video.count_save,
        "tstamps_host": list(video.tstamps_host),
        "imu_enabled": video.imu_enabled,
        "visual_only_init": video.visual_only_init,
        "graph": {k: getattr(g, k) for k in GRAPH_HOST},
        "frontend": {k: getattr(tracker.frontend, k) for k in FRONTEND_HOST},
        "mapper": {"history": mapper.history, "time_idx": mapper.time_idx,
                   "initialized": mapper.initialized},
        "local_to_global_bias": tracker.local_to_global_bias,
    }
    if inertial is not None:
        host["inertial"] = {
            "states": [(s.R, s.p, s.v, s.b) for s in inertial.states],
            "preints": [(p.bg, p.ba, p.meas) for p in inertial.preints],
            "imu_enabled": inertial.imu_enabled,
            "vi_init_t1": inertial.vi_init_t1,
            "last_t0": inertial.last_t0, "last_t1": inertial.last_t1,
            # the marginal and anchor priors and the geo-reference: without
            # them a resumed VIO session is unanchored
            "marg_prior": inertial.marg_prior,
            "prior_factors": inertial.prior_factors,
            "gnss_init_t1": inertial.gnss_init_t1,
            "ten0": inertial.ten0,
            "vi_init_time": inertial.vi_init_time,
            "cur_ii": inertial.cur_ii, "cur_jj": inertial.cur_jj,
            "cur_valid": inertial.cur_valid,
        }
    with open(os.path.join(path, HOST), "wb") as f:
        pickle.dump(host, f)

    mapper.save_ckpt(os.path.join(path, MAPPER))


class HostUnpickler(pickle.Unpickler):
    """Unpickles a session's host state of either package without importing
    JAX or the JAX package: a `jax` / `jaxlib` global is refused, and the
    JAX package's classes resolve to the port's numpy copies."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"{HOST} names {module}.{name}: a session's host state must "
                f"hold numpy and Python values only, no JAX object")
        if root == JAX_PACKAGE:
            module = PORT_PACKAGE + module[len(root):]
        return super().find_class(module, name)


def load_host(path):
    with open(os.path.join(path, HOST), "rb") as f:
        return HostUnpickler(f).load()


@torch.no_grad()
def load_session(path, tracker, mapper, inertial=None):
    """Restore a session into a freshly built tracker, mapper and inertial
    layer of the configuration the session was written with."""
    host = load_host(path)
    video = tracker.video
    bufs = video.bufs
    with np.load(os.path.join(path, VIDEO)) as z:
        for f in bufs.fields():
            setattr(bufs, f, _like(z[f], getattr(bufs, f), f"video {f}"))
    with np.load(os.path.join(path, SAVE_BUFFERS)) as s:
        n = len(s["tstamp"])
        video._pending_spills = []
        video.count_save = n
        for k in SAVED:
            getattr(video, f"_{k}_save")[:n] = s[k]

    video.counter = host["counter"]
    video.tstamps_host = list(host["tstamps_host"])
    video.imu_enabled = host["imu_enabled"]
    video.visual_only_init = host["visual_only_init"]
    tracker.local_to_global_bias = host["local_to_global_bias"]
    fe = tracker.frontend
    for k, v in host["frontend"].items():
        setattr(fe, k, v)
    fe._kf_dist_prefetch = None

    g = tracker.graph
    for k, v in host["graph"].items():
        setattr(g, k, list(v) if k.startswith("free") else
                np.asarray(v, np.int64))
    g._prox_prefetch = None
    with np.load(os.path.join(path, GRAPH)) as gz:
        saved = {k: _like(gz[k], getattr(g.edges, k), f"edge {k}")
                 for k in EDGE_SAVED}
        g.inac.target = _like(gz["inac_target"], g.inac.target,
                              "inactive target")
        g.inac.weight = _like(gz["inac_weight"], g.inac.weight,
                              "inactive weight")
    _rebuild_pyramids(g)
    # the kernel also reset the GRU state, targets and weights: the saved
    # ones go back
    for k, v in saved.items():
        setattr(g.edges, k, v)

    # the motion filter compares the next frame with the last keyframe
    c = video.counter - 1
    if c >= 0:
        f = tracker.filter
        f.fmap = bufs.fmaps[c][None].clone()
        f.net = bufs.nets[c][None].clone()
        f.inp = bufs.inps[c][None].clone()

    mapper.load_ckpt(os.path.join(path, MAPPER))    # drops the bin caches
    mapper.history = host["mapper"]["history"]
    mapper.time_idx = host["mapper"]["time_idx"]
    mapper.initialized = host["mapper"]["initialized"]

    if inertial is not None and "inertial" in host:
        _load_inertial(inertial, host["inertial"])


def _rebuild_pyramids(g):
    """Correlation pyramids of every live edge from the saved feature maps,
    `edge_batch` edges at a time, as `add_factors` builds them."""
    from ..tracker.graph import _add_edges_kernel
    if not len(g.ii):
        return
    dev = g._upload(g.slot, g.ii, g.jj).reshape(3, len(g.ii))
    for s0 in range(0, len(g.ii), g.edge_batch):
        sl = slice(s0, s0 + g.edge_batch)
        _add_edges_kernel(g.edges, g.video.bufs, dev[0, sl], dev[1, sl],
                          dev[2, sl])


def _load_inertial(inertial, hi):
    """The inertial layer's state; the preintegrations are integrated anew
    from their logged measurements at their saved biases."""
    from ..tracker import factor_graph as fg
    from ..tracker.imu import Preintegration
    inertial.states = [fg.FrameState(R, p, v, b)
                       for R, p, v, b in hi["states"]]
    inertial.preints = []
    for bg, ba, meas in hi["preints"]:
        pre = Preintegration(inertial.params, bg=bg, ba=ba)
        for acc, gyro, dt in meas:
            pre.integrate(acc, gyro, dt)
        inertial.preints.append(pre)
    inertial.imu_enabled = hi["imu_enabled"]
    inertial.vi_init_t1 = hi["vi_init_t1"]
    inertial.last_t0 = hi["last_t0"]
    inertial.last_t1 = hi["last_t1"]
    inertial.gnss_meas = [None] * len(inertial.states)
    inertial.odo_meas = [None] * len(inertial.states)
    for k in ("marg_prior", "prior_factors", "gnss_init_t1", "ten0",
              "vi_init_time", "cur_ii", "cur_jj", "cur_valid"):
        if k in hi:
            setattr(inertial, k, hi[k])
