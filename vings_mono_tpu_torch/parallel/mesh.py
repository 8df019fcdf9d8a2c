"""Data parallelism over the mapper's keyframe window, and image rows split
within a keyframe, one process per rank.

The counterpart of the JAX package's `parallel/mesh.py`. There one process
drives a mesh of devices and `shard_map` runs the train loop's body on each;
here every dp rank is a process with its own host thread, because the port
is bound by the host's launch rate and one thread could not feed N devices.

The caller's process is rank 0, the *leader*: it runs the tracker, the
runner and the mapper as before. `make_dp_mesh` starts ranks 1..N-1, the
*followers*, with the `spawn` method; all join one `torch.distributed`
process group through a `file://` store in a temporary directory, so no TCP
port is needed. A follower waits on its command queue (no collective is
pending between calls, so an idle follower never times out) and keeps
nothing between calls but the group.

A dp call (`DPGroup.call`) runs the same body on every rank, as `shard_map`
runs its body on every device: the leader puts the call's name and static
arguments on each follower's queue, then every rank runs the body, whose
collectives move the tensors. A body starts by broadcasting what JAX
replicates (`replicate`, JAX's `put_replicated`: the Gaussian state, its Adam
moments, the sky's) and scattering what JAX shards over `dp` (`put_dp`: rank
r gets window slots [r K/dp, (r+1) K/dp)), so whatever the leader changed
between calls (densify, prune, paging, rectification, refinement) reaches
every rank. After a train call every rank holds the same state, bit for bit;
`verify` checks that after every call.

Backends: NCCL for CUDA ranks on distinct cards; Gloo for CPU ranks and for
several ranks on one card, with CUDA tensors staged through the host. There
is no fallback: a CUDA group that names more cards than the machine has
raises, where JAX's `make_dp_mesh` falls back to the CPU's virtual devices.

`make_mesh` builds JAX's (dp, sp) mesh as one group of dp x sp ranks, rank
(d, s) = d sp + s. `sharded_train_step` runs one mapper step over it: rank
(d, s) renders keyframes [d K/dp, (d+1) K/dp) over row band s, whole 16-row
tile rows plus a halo of one tile row each side (`row_bands`,
`shard_batch`), through render's `rows`: the band's visibility, depth order
and tile pair lists are the whole image's. Every term of the mapper loss
is a sum over pixels divided by a sum that does not depend on the
parameters: one SUM of the bands' divisors, then each rank differentiates
its own rows' sums over those divisors, and the SUM of those gradients is
the gradient of the mean loss, through the halo rows too. Where JAX lets
XLA partition the step by rows, here the split is written out. The
mapper's own dp calls take a group with sp = 1.
"""

from __future__ import annotations

import datetime
import hashlib
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback
from types import SimpleNamespace

import torch
import torch.distributed as dist

from ..mapper.cameras import make_camera
from ..mapper.losses import (TERMS, combine_parts, mapper_loss,
                             mapper_loss_parts, surrogate_weights)
from ..mapper.state import (PARAM_FIELDS, STATE_FIELDS, GaussianState,
                            SparseAdamState, sparse_adam_step)
from ..mapper.train import KeyframeBatch, bin_rows, train_loop
from ..ops.rasterizer import TILE, BinnedScene, render
from ..ops.rasterizer import tile_kernel
from ..ops.rasterizer.render import IMPLS, band_camera
from ..utils.device import read_deterministic, write_deterministic

DEFAULT_TIMEOUT_S = 600.0   # bound of one collective and of the group's start
POLL_S = 0.2                # liveness polling period while waiting
BIN_FIELDS = ("xyz", "log_scale", "quat", "logit_opacity", "rgb", "alive")
KERNELS = (tile_kernel.rasterize_forward, tile_kernel.rasterize_backward)
_ALIGN = 8                  # byte alignment of each tensor in a packed buffer


# ---- placement ------------------------------------------------------------
def dp_placement(dp, platform=None, devices=None, backend=None):
    """(devices, backend) of a dp group, the checks of `make_dp_mesh`.

    devices default to cuda:0 .. cuda:N-1, or N times cpu with platform
    "cpu"; backend defaults to nccl for CUDA and gloo for the CPU. Raises
    RuntimeError when the CUDA devices named are not all present (no
    fallback to the CPU) and ValueError for a device list NCCL cannot
    serve."""
    dp = int(dp)
    if dp < 1:
        raise ValueError(f"parallel.dp must be >= 1, got {dp}")
    if devices is None:
        plat = {"gpu": "cuda"}.get(platform, platform or "cuda")
        if plat not in ("cpu", "cuda"):
            raise ValueError(f"parallel.platform {platform!r}: the port "
                             "runs ranks on 'cpu' or 'cuda'")
        devices = ["cpu"] * dp if plat == "cpu" else [
            f"cuda:{i}" for i in range(dp)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != dp:
        raise ValueError(f"parallel.devices names {len(devices)} devices "
                         f"for dp = {dp}")
    devices = [torch.device("cuda", d.index or 0) if d.type == "cuda"
               else d for d in devices]
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"parallel.devices must all be cpu or all cuda: "
                         f"{[str(d) for d in devices]}")
    cuda = devices[0].type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"parallel.backend {backend!r}: nccl or gloo")
    if not cuda and backend == "nccl":
        raise ValueError("NCCL needs CUDA ranks; CPU ranks use backend: "
                         "gloo")
    if cuda:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = max(d.index for d in devices) + 1
        if have < need:
            raise RuntimeError(
                f"parallel: dp = {dp} on {[str(d) for d in devices]}, but "
                f"this machine has {have} CUDA device(s). The port does not "
                "fall back to the CPU: set parallel.platform: cpu, or put "
                "several ranks on one card with backend: gloo, devices: "
                "[cuda:0, cuda:0]")
        if backend == "nccl" and len(set(devices)) < dp:
            raise ValueError(
                f"NCCL cannot run two ranks on one device "
                f"({[str(d) for d in devices]}): use `backend: gloo`")
    return devices, backend


# ---- packing: one flat byte buffer per collective --------------------------
def tensor_meta(tensors):
    """(shape, dtype) of each tensor, None for None: what a receiving rank
    needs to unpack a buffer."""
    return [None if t is None else (tuple(t.shape), t.dtype)
            for t in tensors]


def _nbytes(meta):
    """(bytes, bytes padded to _ALIGN) of a tensor described by meta."""
    shape, dtype = meta
    n = torch.empty(0, dtype=dtype).element_size()
    for s in shape:
        n *= s
    return n, -(-n // _ALIGN) * _ALIGN


def pack(tensors, device):
    """The tensors' bytes, each padded to 8 bytes, in one uint8 tensor."""
    parts = []
    for t in tensors:
        if t is None:
            continue
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        pad = -b.numel() % _ALIGN
        if pad:
            parts.append(b.new_zeros(pad))
    if not parts:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    return torch.cat(parts)


def unpack(buf, metas):
    """Inverse of `pack`: views into buf."""
    out, off = [], 0
    for m in metas:
        if m is None:
            out.append(None)
            continue
        size, padded = _nbytes(m)
        out.append(buf[off:off + size].view(m[1]).view(m[0]))
        off += padded
    return out


def digest(tensors):
    """blake2b of the tensors' bytes (the bitwise equality check of the
    replicated state across ranks)."""
    h = hashlib.blake2b(digest_size=16)
    for t in tensors:
        if t is None:
            h.update(b"none")
            continue
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy())
    return h.hexdigest()


def _launch_counts():
    return {k.__name__: k.launches for k in KERNELS}


def _numeric_mode():
    """The process-wide settings a follower copies from the leader: TF32,
    the deterministic algorithms (`utils.device.reproducible`), threads."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, read_deterministic(),
            torch.get_num_threads())


def _set_numeric_mode(mode):
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     deterministic, threads) = mode
    write_deterministic(deterministic)
    torch.set_num_threads(threads)


# ---- the group -------------------------------------------------------------
class DPGroup:
    """One rank's handle of the dp process group; the leader's also owns
    the followers. The collectives are SPMD: every rank calls the same one
    in the same order, the leader with the data, followers with metas."""

    def __init__(self, rank, world, device, backend, timeout_s, sp=1):
        self.rank, self.world = int(rank), int(world)
        self.sp = int(sp)
        self.dp = self.world // self.sp
        self.device = torch.device(device)
        self.backend = backend
        self.timeout_s = float(timeout_s)
        # Gloo moves CUDA tensors through the host; doing it here keeps
        # one code path for CPU and CUDA ranks
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.comm_device = torch.device("cpu") if self.staged \
            else self.device
        self._pinned = {}         # (numel, dtype) -> pinned staging buffer
        self.verify = False       # compare state digests after every call
        self.comm_s = 0.0         # host seconds in collectives (this rank)
        self.comm_calls = 0
        self.calls = 0
        # leader only: the followers and what they report
        self._procs, self._cmd_qs, self._reply_q = [], [], None
        self._tmpdir = None
        self._in_call = False
        self.launches = {}        # follower rank -> {kernel: launches}
        self.peak_bytes = {}      # follower rank -> peak device bytes
        self.closed = False

    @property
    def shape(self):
        """{"dp": dp, "sp": sp}, as a JAX mesh's shape."""
        return {"dp": self.dp, "sp": self.sp}

    @property
    def coords(self):
        """(d, s) of this rank: rank = d sp + s."""
        return divmod(self.rank, self.sp)

    # -- start / stop (leader) --
    @classmethod
    def start(cls, devices, backend, sp=1):
        """Spawn ranks 1..N-1 on devices[1:], join the group as rank 0."""
        if dist.is_initialized():
            raise RuntimeError("a process group is already open in this "
                               "process: close the other dp group first")
        devices = [torch.device(d) for d in devices]
        g = cls(0, len(devices), devices[0], backend, DEFAULT_TIMEOUT_S, sp)
        g._tmpdir = tempfile.mkdtemp(prefix="vings_dp_")
        init = "file://" + os.path.join(g._tmpdir, "store")
        ctx = mp.get_context("spawn")
        g._reply_q = ctx.Queue()
        try:
            for r in range(1, g.world):
                q = ctx.Queue()
                p = ctx.Process(
                    target=_follower_main, name=f"vings-dp-rank{r}",
                    args=(r, g.world, init, str(devices[r]), backend,
                          g.timeout_s, q, g._reply_q, _numeric_mode(), sp),
                    daemon=True)
                p.start()
                g._cmd_qs.append(q)
                g._procs.append(p)
            g._join(init)
        except BaseException:
            g._in_call = True     # followers may sit in the rendezvous
            g.close()
            raise
        return g

    def _join(self, init):
        """init_process_group as rank 0, watching the followers: one that
        dies before it joins raises here instead of a wait to the
        timeout."""
        err = []

        def target():
            try:
                _init_process_group(self, init)
            except BaseException as e:   # re-raised below
                err.append(e)
        t = threading.Thread(target=target, daemon=True)
        t.start()
        while t.is_alive():
            t.join(POLL_S)
            if t.is_alive():
                self._check_followers()
        if err:
            raise err[0]

    def close(self, timeout_s=30.0):
        """Stop and join the followers (terminating any that do not exit
        in time) and leave the process group. Idempotent."""
        if self.closed:
            return
        self.closed = True
        if self.rank == 0:
            if not self._in_call:
                for q in self._cmd_qs:
                    q.put(None)
            else:
                # after a failed call followers may wait in a collective
                for p in self._procs:
                    p.terminate()
            deadline = time.monotonic() + timeout_s
            while any(p.is_alive() for p in self._procs) and \
                    time.monotonic() < deadline:
                self._drain()     # a full queue would block its writer
                for p in self._procs:
                    p.join(POLL_S)
            for p in self._procs:
                if p.is_alive():
                    p.kill()
                p.join()
            self._drain()
            for q in self._cmd_qs + [self._reply_q]:
                if q is not None:
                    q.close()
                    q.cancel_join_thread()
            if self._tmpdir:
                shutil.rmtree(self._tmpdir, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()

    def alive_followers(self):
        return [p for p in self._procs if p.is_alive()]

    # -- follower health (leader) --
    def _drain(self):
        out = []
        while self._reply_q is not None:
            try:
                out.append(self._reply_q.get_nowait())
            except (queue.Empty, OSError, ValueError):
                break
        return out

    def _raise_errors(self, msgs, cause=None):
        for rank, kind, payload in msgs:
            if kind == "error":
                raise RuntimeError(f"dp rank {rank} failed:\n{payload}") \
                    from cause

    def _check_followers(self, cause=None):
        self._raise_errors(self._drain(), cause)
        dead = [(i + 1, p.exitcode) for i, p in enumerate(self._procs)
                if not p.is_alive()]
        if dead:
            raise RuntimeError(f"dp follower(s) exited (rank, exit code): "
                               f"{dead}") from cause

    def _collect(self):
        """The followers' reports of the call that just ran on this rank."""
        reports = {}
        deadline = time.monotonic() + self.timeout_s
        while len(reports) < self.world - 1:
            try:
                rank, kind, payload = self._reply_q.get(timeout=POLL_S)
            except queue.Empty:
                self._check_followers()
                if time.monotonic() > deadline:
                    raise RuntimeError(f"dp followers did not report in "
                                       f"{self.timeout_s} s")
                continue
            if kind == "error":
                raise RuntimeError(f"dp rank {rank} failed:\n{payload}")
            reports[rank] = payload
        return reports

    # -- calls --
    def call(self, name, static, payload):
        """Run body `name` on every rank: the followers get (name,
        static), the leader runs it with `payload` too. Returns the
        leader's result. A follower's exception, or its death, is raised
        here."""
        if self.closed:
            raise RuntimeError("the dp group is closed")
        self._check_followers()
        static = dict(static, verify=self.verify)
        for q in self._cmd_qs:
            q.put((name, static))
        self._in_call = True
        try:
            out, replicated = BODIES[name](self, static, payload)
        except BaseException as e:
            # a follower's failure is the usual cause of a failed
            # collective here: give its report time to arrive
            deadline = time.monotonic() + min(self.timeout_s, 10.0)
            while time.monotonic() < deadline:
                self._raise_errors(self._drain(), e)
                if any(not p.is_alive() for p in self._procs):
                    self._check_followers(e)
                time.sleep(POLL_S)
            raise
        mine = digest(replicated) if self.verify else None
        reports = self._collect()
        self._in_call = False
        self.calls += 1
        for rank, rep in reports.items():
            acc = self.launches.setdefault(rank, dict.fromkeys(
                rep["launches"], 0))
            for k, n in rep["launches"].items():
                acc[k] += n
            self.peak_bytes[rank] = max(self.peak_bytes.get(rank, 0),
                                        rep["peak_bytes"])
            if self.verify and rep["digest"] != mine:
                raise RuntimeError(f"dp rank {rank}'s state after {name} "
                                   f"differs from rank 0's")
        return out

    # -- collectives (every rank, same order) --
    def _timed(self, fn):
        if self.staged:
            # the host copy waits for the device anyway; start the clock
            # after the work queued before the collective
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        self.comm_s += time.perf_counter() - t0
        self.comm_calls += 1
        return out

    def _empty(self, metas):
        n = sum(_nbytes(m)[1] for m in metas if m is not None)
        return torch.empty(n, dtype=torch.uint8, device=self.comm_device)

    def replicate(self, tensors, metas):
        """Broadcast from rank 0 (JAX's `put_replicated` / `replicate`).
        The leader passes the tensors and gets them back as they are;
        a follower passes None and gets views of one received buffer."""
        def run():
            if self.rank == 0:
                buf = pack(tensors, self.device).to(self.comm_device)
            else:
                buf = self._empty(metas)
            dist.broadcast(buf, src=0)
            return buf
        buf = self._timed(run)
        if self.rank == 0:
            return list(tensors)
        return unpack(buf.to(self.device), metas)

    def scatter(self, parts, metas):
        """Rank r gets parts[r], a list of tensors (None for none) whose
        (shape, dtype) metas[r] gives: the leader passes parts, followers
        None; every rank passes metas. The ranks' buffers are padded to
        the largest (Gloo scatters equal sizes)."""
        size = max(sum(_nbytes(m)[1] for m in ms if m is not None)
                   for ms in metas)

        def run():
            out = torch.empty(size, dtype=torch.uint8,
                              device=self.comm_device)
            bufs = None
            if self.rank == 0:
                bufs = []
                for p in parts:
                    b = pack(p, self.device)
                    bufs.append(torch.cat([b, b.new_zeros(size - b.numel())])
                                .to(self.comm_device))
            dist.scatter(out, scatter_list=bufs, src=0)
            return out
        out = self._timed(run)
        if self.rank == 0:
            return list(parts[0])
        return unpack(out.to(self.device), metas[self.rank])

    def put_dp(self, tensors, metas):
        """Scatter slot slices over dp (JAX's `put_dp`): every tensor has K
        rows on the leader and rank (d, s) gets rows [d K/dp, (d+1) K/dp).
        `metas` are the local slices' (shape, dtype)."""
        parts = None
        if self.rank == 0:
            k = next(t.shape[0] for t in tensors if t is not None)
            kl = k // self.dp
            parts = [[None if t is None else
                      t[r // self.sp * kl:(r // self.sp + 1) * kl]
                      for t in tensors] for r in range(self.world)]
        return self.scatter(parts, [metas] * self.world)

    def gather_dp(self, tensors):
        """Inverse of put_dp: the ranks' rows stacked in rank order on the
        leader (None elsewhere). Every rank passes tensors of the same
        shapes."""
        metas = tensor_meta(tensors)

        def run():
            buf = pack(tensors, self.device).to(self.comm_device)
            bufs = [torch.empty_like(buf) for _ in range(self.world)] \
                if self.rank == 0 else None
            dist.gather(buf, gather_list=bufs, dst=0)
            return bufs
        bufs = self._timed(run)
        if self.rank != 0:
            return None
        parts = [list(tensors)] + [unpack(b.to(self.device), metas)
                                   for b in bufs[1:]]
        return [None if xs[0] is None else torch.cat(xs)
                for xs in zip(*parts)]

    def all_reduce(self, buf, op):
        """all_reduce of one flat tensor (op: "sum" or "max"). Staged
        through a pinned host buffer kept per size: the train loop's
        reductions repeat every iteration at the same sizes."""
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def run():
            if not self.staged:
                dist.all_reduce(buf, op=rop)
                return buf
            key = (buf.numel(), buf.dtype)
            if key not in self._pinned:
                self._pinned[key] = torch.empty(
                    buf.shape, dtype=buf.dtype, pin_memory=True)
            host = self._pinned[key]
            host.copy_(buf)
            dist.all_reduce(host, op=rop)
            # a synchronous copy: the buffer is free again on return
            return host.to(self.device)
        return self._timed(run)


def _init_process_group(group, init):
    dist.init_process_group(
        group.backend, init_method=init, rank=group.rank,
        world_size=group.world,
        timeout=datetime.timedelta(seconds=group.timeout_s))


def _follower_main(rank, world, init, device, backend, timeout_s, cmd_q,
                   reply_q, mode, sp):
    """A follower's process: join the group, then run the leader's calls
    until it sends None or exits. An exception goes back on reply_q and
    ends the follower (its collectives are out of step after it)."""
    try:
        _set_numeric_mode(mode)
        group = DPGroup(rank, world, device, backend, timeout_s, sp)
        if group.device.type == "cuda":
            torch.cuda.set_device(group.device)
        _init_process_group(group, init)
    except BaseException:   # reported to the leader, which raises it
        reply_q.put((rank, "error", traceback.format_exc()))
        return
    parent = mp.parent_process()
    try:
        while True:
            try:
                msg = cmd_q.get(timeout=POLL_S)
            except queue.Empty:
                if parent is not None and not parent.is_alive():
                    return
                continue
            if msg is None:
                return
            name, static = msg
            try:
                before = _launch_counts()
                _, replicated = BODIES[name](group, static, None)
                after = _launch_counts()
                rep = {"launches": {k: after[k] - before[k] for k in after},
                       "peak_bytes": torch.cuda.max_memory_allocated(
                           group.device) if group.device.type == "cuda"
                       else 0,
                       "digest": digest(replicated) if static["verify"]
                       else None}
            except BaseException:   # reported to the leader, which raises
                reply_q.put((rank, "error", traceback.format_exc()))
                return
            reply_q.put((rank, "ok", rep))
    finally:
        dist.destroy_process_group()


def make_dp_mesh(dp, platform=None, devices=None, backend=None):
    """Start a dp group of `dp` ranks (JAX's `make_dp_mesh`; see
    `dp_placement` for the defaults and the refusals). The caller is
    rank 0 and must `close()` it."""
    devices, backend = dp_placement(dp, platform, devices, backend)
    return DPGroup.start(devices, backend)


def make_mesh(n_devices=None, devices=None, dp=None, backend=None):
    """JAX's (dp, sp) `make_mesh`: n devices (default: every CUDA device),
    dp = n when n <= 4 else n // 2, sp = n // dp, one group of n ranks,
    rank (d, s) = d sp + s on devices[rank]. `backend` as in
    `make_dp_mesh` (gloo for several ranks on one card). The caller is
    rank 0 and must `close()` it."""
    if devices is None:
        if n_devices is None:
            n_devices = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n_devices)]
    devices = list(devices)
    n = len(devices)
    if dp is None:
        dp = n if n <= 4 else n // 2
    if dp < 1 or n % dp:
        raise ValueError(f"{n} devices do not form a (dp = {dp}, sp) mesh")
    devices, backend = dp_placement(n, devices=devices, backend=backend)
    return DPGroup.start(devices, backend, sp=n // dp)


# ---- row bands --------------------------------------------------------------
def row_bands(height, sp):
    """(r0, r1, h0, h1) of each of sp row bands of an image: rows r0..r1-1
    are the band's own, whole 16-row tile rows split as evenly as they go
    (the first bands take one more), and h0..h1-1 add a halo of one tile
    row each side, clipped at the image's edges. The halo covers what a
    band's own rows read of their neighbours: SSIM's window (5 rows) and
    the normals' central differences (1 row). Raises when sp exceeds the
    tile rows."""
    n = -(-int(height) // TILE)
    if not 1 <= sp <= n:
        raise ValueError(f"sp = {sp} row bands of a {height}-row image, "
                         f"which has {n} tile rows of {TILE}")
    out, t0 = [], 0
    for s in range(sp):
        t1 = t0 + n // sp + (s < n % sp)
        r0, r1 = t0 * TILE, min(t1 * TILE, height)
        out.append((r0, r1, max(r0 - TILE, 0), min(r1 + TILE, height)))
        t0 = t1
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(group, tree):
    """JAX's `shard_batch`, split on the leader: the tree each rank gets,
    in rank order. Tensors of 3 or more dimensions lead with K keyframes
    and end with (rows, columns): rank (d, s) gets slots [d K/dp, (d+1)
    K/dp) and the rows h0..h1-1 of band s (`row_bands`). Tensors of 1 or 2
    dimensions go over dp when K divides by dp and are replicated
    otherwise; anything else is replicated."""
    dp, sp = group.dp, group.sp

    def part(x, r):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        d, s = divmod(r, sp)
        kl = x.shape[0] // dp
        if x.ndim >= 3:
            _check_divides(x.shape[0], dp)
            _, _, h0, h1 = row_bands(x.shape[-2], sp)[s]
            return x[d * kl:(d + 1) * kl, ..., h0:h1, :]
        return x[d * kl:(d + 1) * kl] if x.shape[0] % dp == 0 else x
    return [_tree_map(lambda x: part(x, r), tree) for r in range(group.world)]


# ---- the mapper's dp calls ------------------------------------------------
def _check_divides(k, dp):
    if k % dp:
        raise ValueError(f"kf_capacity {k} must divide by parallel.dp {dp}")


def _check_dp_only(group):
    if group.sp != 1:
        raise ValueError(f"the mapper's dp calls shard keyframes only; this "
                         f"group is {group.shape}: start one with "
                         f"make_dp_mesh")


def dp_bin_stack(group, state, batch, intr4, height, width, **bin_kwargs):
    """Bin every window camera, each rank its own K/dp cameras against the
    replicated state (JAX's `dp_bin_stack`); the rows are gathered on the
    leader, which returns the whole window's BinnedScene (its other
    readers: refinement, storage control and the pair-bucket stats)."""
    _check_dp_only(group)
    _check_divides(batch.w2cs.shape[0], group.world)
    rep = [getattr(state, f) for f in BIN_FIELDS]
    local = [batch.w2cs[:batch.w2cs.shape[0] // group.world]]
    static = {"rep_meta": tensor_meta(rep), "shard_meta": tensor_meta(local),
              "intr4": tuple(intr4), "height": int(height),
              "width": int(width), "bin_kwargs": dict(bin_kwargs)}
    return group.call("bin", static, (rep, [batch.w2cs]))


def _bin_body(group, st, payload):
    rep, shard = payload if group.rank == 0 else (None, None)
    geom = SimpleNamespace(**dict(zip(
        BIN_FIELDS, group.replicate(rep, st["rep_meta"]))))
    (w2cs,) = group.put_dp(shard, st["shard_meta"])
    part = bin_rows(geom, w2cs, st["intr4"], st["height"], st["width"],
                    **st["bin_kwargs"])
    rows = group.gather_dp(list(part))
    return (None if rows is None else BinnedScene(*rows)), []


def _opt_tensors(opt):
    return [opt.m[k] for k in PARAM_FIELDS] + [opt.v[k] for k in
                                               PARAM_FIELDS]


def _rebuild(tensors, step):
    state = GaussianState(**dict(zip(STATE_FIELDS, tensors)))
    n = len(STATE_FIELDS)
    mv = tensors[n:n + 2 * len(PARAM_FIELDS)]
    opt = SparseAdamState(m=dict(zip(PARAM_FIELDS, mv[:len(PARAM_FIELDS)])),
                          v=dict(zip(PARAM_FIELDS, mv[len(PARAM_FIELDS):])),
                          step=step)
    return state, opt


def _window(batch, binned, sky):
    out = [batch.images, batch.depths, batch.depths_cov, batch.w2cs,
           batch.global_kf_id, batch.pixel_mask, *binned]
    if sky is not None:
        # with impl naive the sphere has no binning
        out += [sky[2], *(sky[3] or [None] * len(BinnedScene._fields))]
    return out


def dp_train_loop(group, state, opt, batch, binned_stack, intr4, *, iters,
                  height, width, kf_schedule, weights=None, lrs=None,
                  render_kwargs=(), sky=None):
    """The mapper's train loop over the dp group (JAX's `dp_train_loop`):
    the leader's arguments as `mapper.train.train_loop` takes them, but
    kf_schedule is (iters, dp), the window slot each rank renders at each
    iteration (rank r's slots counted within its own K/dp). The state,
    moments and sky are replicated, the window, its binning and the sky's
    are sharded, and the ranks combine their results every iteration as
    `train_loop(group=...)` says. Updates the leader's state and opt in
    place and returns (state, opt, metrics) as train_loop does."""
    _check_dp_only(group)
    k = batch.images.shape[0]
    _check_divides(k, group.world)
    sched = [[int(x) for x in row] for row in kf_schedule]
    if len(sched) != iters or any(len(r) != group.world for r in sched):
        raise ValueError(f"kf_schedule must be ({iters}, {group.world})")
    rep = [getattr(state, f) for f in STATE_FIELDS] + _opt_tensors(opt)
    if sky is not None:
        rep += [getattr(sky[0], f) for f in STATE_FIELDS] + \
            _opt_tensors(sky[1])
    shard = _window(batch, binned_stack, sky)
    kl = k // group.world
    static = {"rep_meta": tensor_meta(rep),
              "shard_meta": tensor_meta([None if t is None else t[:kl]
                                         for t in shard]),
              "intr4": tuple(float(x) for x in intr4),
              "iters": int(iters), "height": int(height),
              "width": int(width), "schedule": sched,
              "weights": None if weights is None else dict(weights),
              "lrs": None if lrs is None else dict(lrs),
              "render_kwargs": tuple(render_kwargs),
              "n_valid": int(batch.n_valid), "use_sky": sky is not None,
              "opt_step": opt.step,
              "sky_opt_step": None if sky is None else sky[1].step}
    return group.call("train", static, (rep, shard, state, opt, sky))


def _train_body(group, st, payload):
    if group.rank == 0:
        rep, shard, state, opt, sky = payload
    else:
        rep = shard = None
    rep = group.replicate(rep, st["rep_meta"])
    loc = group.put_dp(shard, st["shard_meta"])
    if group.rank != 0:
        n = len(STATE_FIELDS) + 2 * len(PARAM_FIELDS)
        state, opt = _rebuild(rep[:n], st["opt_step"])
        sky = None
        if st["use_sky"]:
            sky = _rebuild(rep[n:], st["sky_opt_step"])
    nb = len(BinnedScene._fields)
    batch = KeyframeBatch(*loc[:5], n_valid=st["n_valid"],
                          pixel_mask=loc[5])
    binned = BinnedScene(*loc[6:6 + nb])
    lsky = None
    if st["use_sky"]:
        sbin = BinnedScene(*loc[7 + nb:])
        lsky = (sky[0], sky[1], loc[6 + nb],
                None if sbin.sel is None else sbin)
    _, _, metrics = train_loop(
        state, opt, batch, binned, st["intr4"], iters=st["iters"],
        height=st["height"], width=st["width"],
        kf_schedule=[row[group.rank] for row in st["schedule"]],
        weights=st["weights"], lrs=st["lrs"],
        render_kwargs=st["render_kwargs"], sky=lsky, group=group)
    out = [getattr(state, f) for f in STATE_FIELDS] + _opt_tensors(opt) \
        + [torch.tensor(opt.step)]
    if lsky is not None:
        out += [getattr(sky[0], f) for f in STATE_FIELDS] + \
            _opt_tensors(sky[1]) + [torch.tensor(sky[1].step)]
    return (state, opt, metrics), out + list(metrics.values())


# ---- the mapper step over a (dp, sp) group ----------------------------------
def _step_call(group, state, opt, images, depths, covs, w2cs, intr4, *,
               height, width, impl, p_cap, chunk, step):
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: one of {IMPLS}")
    k = images.shape[0]
    _check_divides(k, group.dp)
    if tuple(images.shape[-2:]) != (height, width):
        raise ValueError(f"images are {tuple(images.shape[-2:])}, the "
                         f"camera {height}x{width}")
    bands = row_bands(height, group.sp)
    rep = [getattr(state, f) for f in PARAM_FIELDS + ("alive", "stable")]
    if step:
        rep += _opt_tensors(opt)
    # the poses as (K, 16): 2-D, so they go over dp without a row band
    parts = shard_batch(group, [images, depths, covs, w2cs.reshape(k, 16)])
    static = {"rep_meta": tensor_meta(rep),
              "shard_metas": [tensor_meta(p) for p in parts], "k": k,
              "bands": bands, "intr4": tuple(float(x) for x in intr4),
              "height": int(height), "width": int(width), "impl": impl,
              "p_cap": int(p_cap), "chunk": int(chunk), "step": step,
              "opt_step": opt.step,
              # a tile's pair gradients are split between the bands that
              # render it: bf16 partials do not add up to the bf16 whole
              "grad_reduce": "f32" if group.sp > 1 else "bf16"}
    return group.call("step", static, (rep, parts, state, opt))


def local_grads(params, alive, images, depths, covs, w2cs, intr4, height,
                width, p_cap, chunk, impl="tile", grad_reduce="bf16"):
    """Gradients of the mean mapper loss over these keyframes, each
    rendered whole in this process; (grads, visibility, loss)."""
    params = {k: p.detach().requires_grad_() for k, p in params.items()}
    totals, vis = [], None
    for i in range(images.shape[0]):
        cam = make_camera(w2cs[i], intr4, height, width)
        rets = render(params["xyz"], params["log_scale"], params["quat"],
                      params["logit_opacity"], params["rgb"], cam,
                      alive=alive, p_cap=p_cap, chunk=chunk, impl=impl,
                      grad_reduce=grad_reduce)
        total, _ = mapper_loss(rets, images[i], depths[i], covs[i], cam)
        totals.append(total)
        vis = rets["visible"] if vis is None else vis | rets["visible"]
    loss = torch.stack(totals).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), vis, loss.detach()


def _band_grads(group, st, params, alive, images, depths, covs, w2cs):
    """This rank's share of the step: gradients of the sum over its
    keyframes t of sum_k c_k num[t, k] / max(den[t, k], 1) / K, num over
    its band's own rows and den over the whole image (one SUM of the
    bands'), then one SUM over the group: the mean loss's gradients, its
    value from the summed numerators, and the OR of the visibility."""
    k, kl = st["k"], images.shape[0]
    d, s = group.coords
    r0, r1, h0, h1 = st["bands"][s]
    params = {n: p.detach().requires_grad_() for n, p in params.items()}
    nums, dens, vis = [], [], None
    for i in range(kl):
        cam = make_camera(w2cs[i].reshape(4, 4), st["intr4"], st["height"],
                          st["width"])
        rets = render(params["xyz"], params["log_scale"], params["quat"],
                      params["logit_opacity"], params["rgb"], cam,
                      alive=alive, p_cap=st["p_cap"], chunk=st["chunk"],
                      impl=st["impl"], grad_reduce=st["grad_reduce"],
                      rows=(h0, h1))
        num, den = mapper_loss_parts(rets, images[i], depths[i], covs[i],
                                     band_camera(cam, h0, h1),
                                     rows=(r0 - h0, r1 - h0))
        nums.append(num)
        dens.append(den)
        vis = rets["visible"] if vis is None else vis | rets["visible"]
    mine = slice(d * kl, (d + 1) * kl)
    nums = torch.stack(nums)
    den_all = nums.new_zeros((k, len(TERMS)))
    den_all[mine] = torch.stack(dens)
    den_all = group.all_reduce(den_all.reshape(-1), "sum").view(k, -1)
    coef = surrogate_weights().to(nums.device)
    surrogate = torch.sum(nums / torch.clamp(den_all[mine], min=1.0)
                          * coef) / k
    grads = torch.autograd.grad(surrogate, list(params.values()))
    num_all = nums.new_zeros((k, len(TERMS)))
    num_all[mine] = nums.detach()
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [num_all.reshape(-1), vis.to(torch.float32)])
    flat = group.all_reduce(flat, "sum")
    out, off = {}, 0
    for n, g in zip(params, grads):
        out[n] = flat[off:off + g.numel()].view(g.shape)
        off += g.numel()
    num_all = flat[off:off + num_all.numel()].view(k, -1)
    loss = torch.stack([combine_parts(num_all[t], den_all[t])[0]
                        for t in range(k)]).mean()
    return out, flat[off + num_all.numel():] > 0, loss


def _step_body(group, st, payload):
    if group.rank == 0:
        rep, parts, state, opt = payload
    else:
        rep = parts = None
    rep = group.replicate(rep, st["rep_meta"])
    images, depths, covs, w2cs = group.scatter(parts, st["shard_metas"])
    fields = PARAM_FIELDS + ("alive", "stable")
    geom = dict(zip(fields, rep[:len(fields)]))
    grads, vis, loss = _band_grads(
        group, st, {k: geom[k] for k in PARAM_FIELDS}, geom["alive"], images,
        depths, covs, w2cs)
    if not st["step"]:
        return (grads, vis, loss), [*grads.values(), vis, loss]
    if group.rank != 0:
        state = SimpleNamespace(params=lambda: {k: geom[k]
                                                for k in PARAM_FIELDS})
        mv = rep[len(fields):]
        opt = SparseAdamState(m=dict(zip(PARAM_FIELDS, mv[:5])),
                              v=dict(zip(PARAM_FIELDS, mv[5:])),
                              step=st["opt_step"])
    sparse_adam_step(state, grads, opt, vis & geom["alive"] & ~geom["stable"])
    tensors = list(state.params().values()) + _opt_tensors(opt)
    return (state, opt, loss), tensors + [loss]


def sharded_grads(group, state, opt, images, depths, covs, w2cs, intr4, *,
                  height, width, impl, p_cap=4096, chunk=128):
    """Gradients, visibility and loss of the mean mapper loss over the
    keyframes (no step): rank (d, s) renders its K/dp keyframes over row
    band s (`_band_grads`). Every rank gets the same. With sp > 1 the tile
    path reduces its per-pair gradients in f32 (render's grad_reduce):
    a tile that two bands render has its pair gradients split between
    them, and the sum of bf16-rounded parts is not the bf16-rounded sum
    (1-2 % of the largest gradient apart at 32x32 and 64x48)."""
    return _step_call(group, state, opt, images, depths, covs, w2cs, intr4,
                      height=height, width=width, impl=impl, p_cap=p_cap,
                      chunk=chunk, step=False)


def sharded_tile_grads(group, state, opt, images, depths, covs, w2cs, intr4,
                       *, height, width, p_cap=4096, chunk=128):
    """JAX's `sharded_tile_grads`: `sharded_grads` through the tile
    kernels. On a (dp, 1) group each rank renders its keyframes whole."""
    return sharded_grads(group, state, opt, images, depths, covs, w2cs,
                         intr4, height=height, width=width, impl="tile",
                         p_cap=p_cap, chunk=chunk)


def sharded_tile_train_step(group, state, opt, images, depths, covs, w2cs,
                            intr4, *, height, width, p_cap=4096, chunk=128):
    """`sharded_tile_grads` followed by the masked sparse-Adam step on
    visible, alive, unstable rows, on every rank (JAX's
    `sharded_tile_train_step`); updates the leader's state and opt in
    place and returns (state, opt, loss)."""
    return _step_call(group, state, opt, images, depths, covs, w2cs, intr4,
                      height=height, width=width, impl="tile", p_cap=p_cap,
                      chunk=chunk, step=True)


def sharded_train_step(state, opt, images, depths, covs, w2cs, intr4, *,
                       height, width, impl="naive", group=None, p_cap=4096,
                       chunk=64):
    """JAX's `sharded_train_step`: one mapper step, the mean loss over the
    K keyframes, its gradients and the masked sparse-Adam step, updating
    state and opt in place; returns (state, opt, loss). impl "naive" (the
    default, as in JAX) or "tile"; p_cap and chunk (JAX's fixed 4096 and
    64) size the tile binning. With a group from `make_mesh`, rank (d, s)
    renders its K/dp keyframes over row band s; without one every keyframe
    is rendered whole here."""
    if group is not None:
        return _step_call(group, state, opt, images, depths, covs, w2cs,
                          intr4, height=height, width=width, impl=impl,
                          p_cap=p_cap, chunk=chunk, step=True)
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: one of {IMPLS}")
    grads, vis, loss = local_grads(
        state.params(), state.alive, images, depths, covs, w2cs, intr4,
        height, width, p_cap, chunk, impl)
    sparse_adam_step(state, grads, opt, vis & state.alive & ~state.stable)
    return state, opt, loss


BODIES = {"bin": _bin_body, "train": _train_body, "step": _step_body}
