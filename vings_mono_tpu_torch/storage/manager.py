"""Device <-> host paging of the Gaussian map by keyframe distance:
keyframes farther than `storage_manager.distance_threshold` from the current
camera have their Gaussians evicted to host memory; keyframes the camera
comes back to page them in again.

The mapper's tensors are capacity-capped with an alive mask, so eviction is
a boolean gather per field, ONE copy of all the gathered rows (packed as
bytes) into pinned host memory, and `kill_rows` (the slots recycle); page-in
is the reverse: ONE host-to-device copy, `write_rows` into dead slots with
fresh Adam moments, the rows' lifecycle fields restored, and the binning
cache dropped, so that the next render sees them. The host store is numpy,
one array per field of FIELDS. A round trip is bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mapper.densify import dead_slots
from ..mapper.state import kill_rows, write_rows
from ..ops import lie

FIELDS = ("xyz", "rgb", "log_scale", "quat", "logit_opacity",
          "stable", "local_scores", "global_scores", "globalkf_id",
          "globalkf_max_scores")
PARAMS = ("xyz", "rgb", "log_scale", "quat", "logit_opacity")
LIFECYCLE = ("stable", "local_scores", "global_scores",
             "globalkf_max_scores")


def _pack_rows(tensors):
    """(n, row bytes) uint8 of several (n, ...) tensors, side by side."""
    n = tensors[0].shape[0]
    return torch.cat([t.contiguous().view(torch.uint8).reshape(n, -1)
                      for t in tensors], dim=1)


class StorageManager:
    def __init__(self, cfg):
        self.cfg = cfg
        self.threshold = float(cfg["storage_manager"]["distance_threshold"])
        self.host = {f: None for f in FIELDS}
        self.n_host = 0
        # 0 = host, 1 = device; grows with the global keyframe count
        self.place = np.zeros(0, np.float32)
        # cumulative paging stats (rows and bytes moved, events)
        self.pages_out = 0
        self.pages_in = 0
        self.evict_events = 0
        self.pagein_events = 0
        self.bytes_out = 0
        self.bytes_in = 0

    def _ensure_host(self, state):
        if self.host["xyz"] is None:
            for f in FIELDS:
                t = getattr(state, f)
                dtype = torch.empty((), dtype=t.dtype).numpy().dtype
                self.host[f] = np.zeros((0,) + tuple(t.shape[1:]), dtype)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(self, tracker, mapper, viz_out):
        if viz_out is None or not mapper.initialized:
            return
        gids = viz_out.get("global_kf_id_host")
        if gids is None:
            gids = viz_out["global_kf_id"]
        last_gid = int(np.asarray(gids)[-1])
        if last_gid <= 0:
            return
        # distances of all historical keyframes to the current camera
        video = tracker.video
        w2c = torch.from_numpy(np.asarray(video.poses_save[:last_gid],
                                          np.float32))
        c2ws = lie.se3_matrix(lie.se3_inv(w2c)).numpy().copy()
        # live-window keyframes beyond the save buffer
        n_live = last_gid - video.count_save
        if n_live > 0:
            live = video.c2w_matrices()
            c2ws[video.count_save:last_gid] = live[:n_live][
                :last_gid - video.count_save]
        cur = viz_out["poses"][-1]
        cur_c2w = cur.cpu().numpy() if isinstance(cur, torch.Tensor) \
            else np.asarray(cur)
        rel = np.linalg.inv(cur_c2w)[None] @ c2ws
        dist = np.linalg.norm(rel[:, :3, 3], axis=-1)

        grow = last_gid - len(self.place)
        if grow > 0:
            self.place = np.concatenate([self.place,
                                         np.ones(grow, np.float32)])

        self.cpu2gpu(mapper, dist)
        self.gpu2cpu(mapper, dist)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def gpu2cpu(self, mapper, dist):
        far_kf = np.where((self.place[:len(dist)] == 1)
                          & (dist > self.threshold))[0]
        if len(far_kf) == 0:
            return
        state = mapper.state
        far = torch.from_numpy(far_kf).to(state.xyz.device)
        m = state.alive & torch.isin(state.globalkf_id.long(), far)
        n = int(m.sum())
        if n == 0:
            self.place[far_kf] = 0
            return
        self._ensure_host(state)
        rows = _pack_rows([getattr(state, f)[m] for f in FIELDS])
        host = torch.empty(rows.shape, dtype=torch.uint8,
                           pin_memory=rows.is_cuda)
        host.copy_(rows)
        host = host.numpy()
        col = 0
        for f in FIELDS:
            arr = self.host[f]
            width = arr.dtype.itemsize * int(np.prod(arr.shape[1:]))
            part = np.ascontiguousarray(host[:, col:col + width])
            col += width
            self.host[f] = np.concatenate(
                [arr, part.view(arr.dtype).reshape((n,) + arr.shape[1:])])
        self.n_host = len(self.host["xyz"])
        kill_rows(state, m)
        self.place[far_kf] = 0
        self.pages_out += n
        self.bytes_out += host.nbytes
        self.evict_events += 1

    @torch.no_grad()
    def cpu2gpu(self, mapper, dist):
        near_kf = np.where((self.place[:len(dist)] == 0)
                           & (dist < self.threshold))[0]
        if len(near_kf) == 0 or self.n_host == 0:
            return
        m = np.isin(self.host["globalkf_id"], near_kf)
        n = int(m.sum())
        if n == 0:
            self.place[near_kf] = 1
            return
        state = mapper.state
        device = state.xyz.device
        slots, ok = dead_slots(state, n)
        valid_t = ok
        valid = ok.cpu().numpy()

        # ONE host-to-device copy of the rows, as bytes
        packed = np.concatenate(
            [np.ascontiguousarray(self.host[f][m]).view(np.uint8)
             .reshape(n, -1) for f in FIELDS], axis=1)
        src = torch.from_numpy(packed)
        if device.type == "cuda":
            src = src.pin_memory()
        rows = src.to(device, non_blocking=True)
        dev, col = {}, 0
        for f in FIELDS:
            t = getattr(state, f)
            width = t.element_size() * int(np.prod(t.shape[1:]))
            dev[f] = rows[:, col:col + width].contiguous().view(
                t.dtype).reshape((n,) + tuple(t.shape[1:]))
            col += width
        write_rows(state, mapper.opt, slots, valid_t,
                   {f: dev[f] for f in PARAMS}, dev["globalkf_id"])
        # restore lifecycle state for the rows that fit
        idx = slots[valid_t].long()
        for f in LIFECYCLE:
            getattr(state, f)[idx] = dev[f][valid_t]
        # drop paged-in rows from the host store (overflow rows stay)
        kept = ~m
        if not valid.all():
            unfit = np.where(m)[0][~valid[:n]]
            kept[unfit] = True
        for f in FIELDS:
            self.host[f] = self.host[f][kept]
        self.n_host = len(self.host["xyz"])
        self.place[near_kf] = 1
        self.pages_in += int(valid[:n].sum())
        self.bytes_in += packed.nbytes
        self.pagein_events += 1
        # paged-in rows exist in no cached binning row: they would not
        # render until the round-robin cache cycles past them
        mapper.invalidate_binning()
