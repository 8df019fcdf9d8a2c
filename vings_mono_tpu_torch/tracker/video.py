"""DepthVideo — the tracker's central keyframe store.

Fixed-capacity device buffers for everything per-keyframe (poses w2c tq7,
1/8-res disparities, features, GRU states, upsampled maps), plus host-side
(numpy) "save" buffers that receive keyframes as they scroll out of the
optimization window. The tracker is single-threaded host code driving
device work on one stream.

Mutating ops write the buffers in place; the window `counter` lives on the
host so Python can branch on it (warmup, rollup, keyframe removal).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import lie, projective as pops
from ..utils.device import resolve_device


@dataclasses.dataclass
class VideoBuffers:
    tstamp: torch.Tensor       # (B,)
    images: torch.Tensor       # (B, H, W, 3) float32 [0,1] RGB
    poses: torch.Tensor        # (B, 7) w2c lietorch layout
    disps: torch.Tensor        # (B, h, w) 1/8-res inverse depth
    disps_sens: torch.Tensor   # (B, h, w) metric-prior disparity (0 = none)
    disps_up: torch.Tensor     # (B, H, W)
    depths_cov: torch.Tensor   # (B, h, w)
    depths_cov_up: torch.Tensor  # (B, H, W)
    intrinsics: torch.Tensor   # (B, 4) [fx fy cx cy] at 1/8 res
    fmaps: torch.Tensor        # (B, h, w, 128)
    nets: torch.Tensor         # (B, h, w, 128)
    inps: torch.Tensor         # (B, h, w, 128)
    damping: torch.Tensor      # (B, h, w) BA damping from GraphAgg

    def fields(self):
        return [f.name for f in dataclasses.fields(self)]


def empty_buffers(buf: int, height: int, width: int,
                  device="cpu") -> VideoBuffers:
    h, w = height // 8, width // 8

    def z(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return VideoBuffers(
        tstamp=z((buf,)),  # full-precision copies live on host
        images=z((buf, height, width, 3)),
        poses=lie.se3_identity((buf,), device=device),
        disps=ones((buf, h, w)),
        disps_sens=z((buf, h, w)),
        disps_up=z((buf, height, width)),
        depths_cov=ones((buf, h, w)),
        depths_cov_up=ones((buf, height, width)),
        intrinsics=z((buf, 4)),
        fmaps=z((buf, h, w, 128)),
        nets=z((buf, h, w, 128)),
        inps=z((buf, h, w, 128)),
        damping=torch.full((buf, h, w), 1e-6, dtype=torch.float32,
                           device=device),
    )


def _shift_left(bufs: VideoBuffers, ix):
    """Drop keyframe ix: copy slot k+1 -> k for k >= ix; the last slot takes
    slot 0's rows (a dead slot: it is re-seeded before it is used). The
    source rows are cloned first: an in-place copy between overlapping
    slices of one tensor is undefined."""
    for name in bufs.fields():
        x = getattr(bufs, name)
        tail = x[ix + 1:].clone()
        x[-1] = x[0]
        x[ix:-1] = tail


def _roll(bufs: VideoBuffers, n):
    """Window rollup: shift all buffers left by n; the dropped rows wrap
    into the (dead) tail slots."""
    for name in bufs.fields():
        setattr(bufs, name, torch.roll(getattr(bufs, name), -n, dims=0))


class HostPull:
    """A device result on its way to the host. On CUDA the copy into pinned
    memory is enqueued without blocking and `numpy()` waits on its event;
    on the CPU the tensor is already there."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            # the copy runs on t's card, which need not be the current one
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t.clone()
            self._event = None

    def numpy(self):
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy()


_SPILLED = ("images", "poses", "disps", "disps_up", "depths_cov",
            "depths_cov_up")


class DepthVideo:
    """Host wrapper: device buffers + python counter + numpy save buffers."""

    def __init__(self, cfg, height, width, device=None):
        self.cfg = cfg
        fe = cfg["frontend"]
        self.device = resolve_device(device or cfg["device"]["tracker"])
        self.buf = int(fe["buffer"])
        self.ht, self.wd = height, width
        self.bufs = empty_buffers(self.buf, height, width, self.device)
        self.counter = 0
        self.imu_enabled = False
        self.visual_only_init = False
        self.tstamps_host = []   # float64-precision timestamps

        # save buffers for marginalized/rolled-out keyframes (host memory).
        # Rollup spills do not block: the device-to-host copies are enqueued
        # before the roll and only materialized into the numpy arrays when a
        # reader touches a *_save property.
        ns = int(fe.get("save_buffer", 4096))
        h, w = height // 8, width // 8
        self.count_save = 0
        self._pending_spills = []
        self._tstamp_save = np.zeros(ns, np.float64)
        self._images_save = np.zeros((ns, height, width, 3), np.float32)
        self._poses_save = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0],
                                            np.float32), (ns, 1))
        self._disps_save = np.zeros((ns, h, w), np.float32)
        self._disps_up_save = np.zeros((ns, height, width), np.float32)
        self._depths_cov_save = np.zeros((ns, h, w), np.float32)
        self._depths_cov_up_save = np.zeros((ns, height, width), np.float32)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def append(self, tstamp, image, pose, disp, disp_sens, intrinsics,
               fmap, net, inp):
        """intrinsics: full-res [fx fy cx cy]; stored at 1/8. pose/disp may
        be None to keep the slot's current value (the frontend pre-seeds the
        next slot each update)."""
        if self.counter >= self.buf:
            raise RuntimeError("video buffer full — rollup should fire first")
        b, k = self.bufs, self.counter
        b.tstamp[k] = float(tstamp)
        b.images[k] = image
        b.disps_sens[k] = disp_sens
        b.intrinsics[k] = torch.as_tensor(
            intrinsics, dtype=torch.float32, device=self.device) / 8.0
        b.fmaps[k] = fmap
        b.nets[k] = net
        b.inps[k] = inp
        if pose is not None:
            b.poses[k] = pose
        if disp is not None:
            b.disps[k] = disp
        self.tstamps_host.append(float(tstamp))
        self.counter += 1

    @torch.no_grad()
    def rm_keyframe(self, ix):
        _shift_left(self.bufs, ix)
        del self.tstamps_host[ix]
        self.counter -= 1

    @torch.no_grad()
    def rollup(self, n):
        """Spill the oldest n keyframes to the host save buffers, then shift
        the device window left by n. The copies of the first n rows are
        enqueued before the roll (stream order keeps them ahead of it);
        readers of the *_save properties drain them."""
        spill = {name: HostPull(getattr(self.bufs, name)[:n])
                 for name in _SPILLED}
        s = self.count_save
        e = s + n
        self._tstamp_save[s:e] = np.asarray(self.tstamps_host[:n])
        self._pending_spills.append((s, n, spill))
        self.count_save = e
        _roll(self.bufs, n)
        self.tstamps_host = self.tstamps_host[n:]
        self.counter -= n

    def _drain_spills(self):
        pending, self._pending_spills = self._pending_spills, []
        for s, n, spill in pending:
            for name in _SPILLED:
                getattr(self, f"_{name}_save")[s:s + n] = spill[name].numpy()

    @property
    def tstamp_save(self):
        return self._tstamp_save  # written synchronously in rollup

    @property
    def images_save(self):
        self._drain_spills()
        return self._images_save

    @property
    def poses_save(self):
        self._drain_spills()
        return self._poses_save

    @property
    def disps_save(self):
        self._drain_spills()
        return self._disps_save

    @property
    def disps_up_save(self):
        self._drain_spills()
        return self._disps_up_save

    @property
    def depths_cov_save(self):
        self._drain_spills()
        return self._depths_cov_save

    @property
    def depths_cov_up_save(self):
        self._drain_spills()
        return self._depths_cov_up_save

    # ------------------------------------------------------------------
    def _index(self, ii, jj):
        """One host-to-device upload for both index lists."""
        pair = np.stack([np.asarray(ii, np.int64).reshape(-1),
                         np.asarray(jj, np.int64).reshape(-1)])
        pair = torch.from_numpy(pair).to(self.device, non_blocking=True)
        return pair[0], pair[1]

    @torch.no_grad()
    def reproject(self, ii, jj):
        ii, jj = self._index(ii, jj)
        coords, _ = pops.projective_transform(
            self.bufs.poses, self.bufs.disps, self.bufs.intrinsics, ii, jj)
        return coords

    @torch.no_grad()
    def distance_async(self, ii, jj, beta=0.3, bidirectional=False):
        """Enqueue the frame-distance computation and its copy to the host
        and return a `HostPull` WITHOUT blocking — the caller pulls it
        later. The values are those of the poses and disparities at the
        moment of this call."""
        ii, jj = self._index(ii, jj)
        b = self.bufs
        d = pops.frame_distance(b.poses, b.disps, b.intrinsics, ii, jj,
                                beta=float(beta))
        if bidirectional:
            d = 0.5 * (d + pops.frame_distance(
                b.poses, b.disps, b.intrinsics, jj, ii, beta=float(beta)))
        return HostPull(d)

    def distance(self, ii, jj, beta=0.3, bidirectional=False):
        return self.distance_async(ii, jj, beta=beta,
                                   bidirectional=bidirectional).numpy()

    @torch.no_grad()
    def c2w_matrices(self, upto=None):
        n = self.counter if upto is None else upto
        return lie.se3_matrix(lie.se3_inv(self.bufs.poses[:n])).cpu().numpy()
