"""Global bundle adjustment — the terminate/backend pass.

After the online run, rebuild a covisibility graph over EVERY keyframe
(host save buffers + live window), re-run the GRU flow/weight updates with
correlation volumes computed on the fly in chunks (the "lowmem" trick: the
all-pairs volumes for thousands of edges never coexist in memory), and
solve one global dense-depth BA so the final trajectory loses the online
drift the sliding window could not remove.

Design:
  * features of every keyframe are re-encoded from the saved images in
    batches with the f32 network, straight into preallocated device
    stacks (the fmaps in bf16: the correlation pyramids are bf16 anyway);
  * each GRU round runs over fixed-size edge chunks; each chunk builds its
    own bf16 correlation pyramid and drops it, so peak memory is
    O(chunk * hw^2) whatever the trajectory's length; the chunk writes its
    targets, weights and per-frame damping / upsampling masks into
    preallocated tensors by slice;
  * the solve is `ops.ba.ba_global_banded` (block-band pose system, PCG),
    or `ba_global` (dense) with `backend.dense_solve`;
  * edge selection is host numpy: all-pairs frame distance within a band
    (computed on the device in chunks), threshold + greedy NMS,
    consecutive-frame edges always in, per-frame out-degree capped so the
    adjacency list stays rectangular, accepted loop pairs injected.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..models.droid_net import normalize_image
from ..ops import ba as ba_ops
from ..ops import corr as corr_ops
from ..ops import projective as pops
from ..ops.upsample import upsample_disp
from ..utils.device import f32_matmul

DIST_CHUNK = 8192   # frame pairs per device distance call


@torch.no_grad()
def _encode_batch(model, images):
    """images (B, H, W, 3) in [0, 1] -> fmaps, nets, inps at 1/8 res."""
    x = normalize_image(images)
    net, inp = model.context(x)
    return model.fnet(x), net, inp


@torch.no_grad()
def _distance_chunk(poses, disps, intrinsics, ii, jj):
    return pops.frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3)


@torch.no_grad()
def _gru_chunk(update, fmaps, inps, poses, disps, intrinsics, ii, jj, valid,
               offset, nets_e, target_full, weight_full, eta_full,
               upmask_full, t_cap):
    """One GRU round over one edge chunk, in place.

    ii/jj/valid (ce,) this chunk's edges, `offset` its start in the edge
    arrays. nets_e (ce, h, w, 128) the chunk's per-edge GRU states (a view
    into the persistent stack; overwritten). target/weight_full (E_cap, 2,
    h, w) are written at the chunk's slice; eta/upmask_full (t_cap, ...)
    rows of frames that are the source of a valid edge in this chunk are
    overwritten (GraphAgg's per-source-frame outputs)."""
    ce = ii.shape[0]
    h, w = disps.shape[1:3]
    coords0 = pops.coords_grid(h, w, device=disps.device)
    pyr = corr_ops.build_pyramid(fmaps[ii], fmaps[jj], dtype=torch.bfloat16)
    coords1, _ = pops.projective_transform(poses, disps, intrinsics, ii, jj)
    corr = corr_ops.lookup(pyr, coords1)
    sl = slice(offset, offset + ce)
    tgt_old = target_full[sl].movedim(1, -1)
    motn = torch.cat([coords1 - coords0, tgt_old - coords1], dim=-1)
    motn = motn.clamp(-64.0, 64.0)

    # GraphAgg over t_cap + 1 segments: dead edges land in the last one
    seg = torch.where(valid, ii, torch.full_like(ii, t_cap))
    net_new, delta, weight, eta, upmask = update(
        nets_e, inps[ii], corr, motn, seg, t_cap + 1, True)
    nets_e.copy_(net_new)
    weight = weight * valid[:, None, None, None].to(weight.dtype)
    target_full[sl] = (coords1 + delta).movedim(-1, 1)
    weight_full[sl] = weight.movedim(-1, 1)

    has_edge = torch.zeros(t_cap + 1, dtype=torch.bool,
                           device=ii.device).index_fill_(0, seg, True)[:t_cap]
    eta_full.copy_(torch.where(has_edge[:, None, None], eta[:t_cap],
                               eta_full))
    upmask_full.copy_(torch.where(has_edge[:, None, None, None],
                                  upmask[:t_cap], upmask_full))


class GlobalBA:
    """End-of-run global BA over save + live keyframe buffers.

    The network comes from `tracker.model` (f32: `fnet`, `context`,
    `update`). `target_fn`, a callable (ii, jj) -> (E, 2, h, w), replaces
    the seed targets (the current reprojection, zero initial motion): a
    test seam. `timer`, a StageTimer, times the pass's parts as stages
    `encode`, `edges`, `gru` and `solve` when set."""

    def __init__(self, tracker, cfg=None, extra_edges=None):
        self.tracker = tracker
        # accepted online loop closures (cand_gid, cur_gid): re-measured
        # visually here so the revisit constraint anchors the global solve
        # (the banded proposal does not reach them by distance)
        self.extra_edges = [(int(a), int(b)) for a, b in
                            (extra_edges or [])]
        be = ((cfg or tracker.cfg).get("backend") or {})
        self.steps = int(be.get("steps", 6))
        self.gn_iters = int(be.get("iters", 2))
        self.thresh = float(be.get("thresh", 25.0))
        self.nms = int(be.get("nms", 2))
        self.radius = int(be.get("radius", 2))
        self.d_cap = int(be.get("degree_cap", 8))
        self.chunk = int(be.get("chunk", 32))
        self.enc_batch = int(be.get("encode_batch", 8))
        # edge-proposal band (|i-j| <= band); the banded pose solve uses
        # 2*band block bandwidth (Schur fill-in doubles it)
        self.band = int(be.get("band", 64))
        # dense (T*6)^2 solve only for tiny trajectories / tests; the
        # banded PCG path is the product solver
        self.dense_solve = bool(be.get("dense_solve", False))
        self.cg_iters = int(be.get("cg_iters", 128))
        self.target_fn = None
        self.timer = None
        self.cg_iters_used = []    # per Gauss-Newton step, after run()

    def _stage(self, name):
        return self.timer(name) if self.timer is not None \
            else contextlib.nullcontext()

    # ------------------------------------------------------------------
    def _gather(self):
        """Stack save + live buffers into host arrays (T real frames)."""
        v = self.tracker.video
        ns, nl = v.count_save, v.counter
        T = ns + nl
        b = v.bufs
        poses = np.concatenate([v.poses_save[:ns],
                                b.poses[:nl].cpu().numpy()], axis=0)
        disps = np.concatenate([v.disps_save[:ns],
                                b.disps[:nl].cpu().numpy()], axis=0)
        images = np.concatenate([v.images_save[:ns],
                                 b.images[:nl].cpu().numpy()], axis=0)
        intr8 = b.intrinsics[0].cpu().numpy().astype(np.float32)
        return T, poses, disps, images, intr8

    def _device(self):
        return self.tracker.video.device

    def _build_edges(self, T, poses, disps, intr8, t_cap):
        """Edge proposal: distance threshold + greedy NMS + consecutive
        edges, both directions, capped out-degree.

        Banded throughout: candidate pairs, the distance matrix and the NMS
        suppression mask live in (T, 2*band+1) arrays, so memory is
        O(T*band); the only Python loop is the sequential greedy NMS over
        thresholded candidates. Distances are computed on the device in
        chunks of DIST_CHUNK pairs."""
        band = self.band
        offs = np.concatenate([np.arange(-band, 0), np.arange(1, band + 1)])
        I = np.repeat(np.arange(T), len(offs))
        J = I + np.tile(offs, T)
        m = (J >= 0) & (J < T)
        pi_r = I[m].astype(np.int64)
        pj_r = J[m].astype(np.int64)
        n_pairs = len(pi_r)

        dev = self._device()
        dev_poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
        dev_disps = torch.as_tensor(disps, dtype=torch.float32, device=dev)
        dev_intr = torch.as_tensor(intr8, dtype=torch.float32,
                                   device=dev)[None].expand(T, 4)
        d = np.empty(n_pairs, np.float32)
        for s in range(0, n_pairs, DIST_CHUNK):
            e = min(n_pairs, s + DIST_CHUNK)
            pair = torch.from_numpy(np.stack([pi_r[s:e], pj_r[s:e]])).to(dev)
            d[s:e] = _distance_chunk(dev_poses, dev_disps, dev_intr,
                                     pair[0], pair[1]).cpu().numpy()

        # banded distance matrix: column c holds j = i + c - band
        W = 2 * band + 1
        dband = np.full((T, W), np.inf, np.float32)
        dband[pi_r, pj_r - pi_r + band] = d

        deg = np.zeros(T, np.int64)
        sel = set()

        def try_add(i, j):
            if (i, j) in sel or deg[i] >= self.d_cap or deg[j] >= self.d_cap:
                return
            sel.add((i, j))
            sel.add((j, i))
            deg[i] += 1
            deg[j] += 1

        for i in range(T - 1):            # consecutive edges always in
            try_add(i, i + 1)

        # accepted loop closures enter unconditionally (before the
        # degree-capped distance fill): the revisit pairs are the only
        # long-range anchors, and the banded solver widens to cover them
        for a, b in self.extra_edges:
            if 0 <= a < T and 0 <= b < T and a != b:
                try_add(min(a, b), max(a, b))

        # symmetric mean distance over the upper band j - i in [radius,
        # band], thresholded, then sorted (dd, i, j) lexicographically
        o = np.arange(max(self.radius, 0), band + 1)
        if len(o):
            rows = np.arange(T)[:, None]
            jgrid = rows + o[None, :]
            ok = jgrid < T
            dd_f = dband[:, band + o]
            dd_b = np.full_like(dd_f, np.inf)
            jj_ok = jgrid[ok]
            oo_ok = np.broadcast_to(o[None, :], dd_f.shape)[ok]
            dd_b[ok] = dband[jj_ok, band - oo_ok]         # d[j, i]
            dd = 0.5 * (dd_f + dd_b)
            cmask = ok & np.isfinite(dd) & (dd < self.thresh)
            ci, co = np.nonzero(cmask)
            cj = ci + o[co]
            cd = dd[ci, co]
            order = np.lexsort((cj, ci, cd))
        else:
            ci = cj = cd = np.zeros(0, np.int64)
            order = ci

        sup = np.zeros((T, W), bool)                      # banded NMS mask
        nms = self.nms
        for k in order:
            i, j = int(ci[k]), int(cj[k])
            if sup[i, j - i + band]:
                continue
            before = len(sel)
            try_add(i, j)
            if len(sel) > before:
                for r in range(max(0, i - nms), min(T, i + nms + 1)):
                    c0 = max(j - nms - r + band, 0)
                    c1 = min(j + nms + 1 - r + band, W)
                    if c1 > c0:
                        sup[r, c0:c1] = True

        ii = np.asarray([e[0] for e in sorted(sel)], np.int32)
        jj = np.asarray([e[1] for e in sorted(sel)], np.int32)
        return ii, jj

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(self):
        """Run the global BA; writes rectified poses/disps back into the
        save buffers and the live window. Returns a stats dict."""
        v = self.tracker.video
        dev = self._device()
        model = self.tracker.model
        self.cg_iters_used = []
        with self._stage("encode"):
            T, poses_np, disps_np, images, intr8 = self._gather()
            if T < 3:
                return {"frames": T, "edges": 0, "skipped": True}
            h, w = disps_np.shape[1:3]
            # bucket to a multiple of 64
            t_cap = (T + 63) // 64 * 64

            # ---- re-encode features for every frame ----------------------
            fmaps = torch.zeros((t_cap, h, w, 128), dtype=torch.bfloat16,
                                device=dev)
            nets0 = torch.zeros((t_cap, h, w, 128), device=dev)
            inps = torch.zeros((t_cap, h, w, 128), device=dev)
            B = self.enc_batch
            for s in range(0, T, B):
                e = min(T, s + B)
                imgs = torch.as_tensor(images[s:e], dtype=torch.float32,
                                       device=dev)
                fm, nt, ip = _encode_batch(model, imgs)
                fmaps[s:e] = fm.to(torch.bfloat16)
                nets0[s:e] = nt
                inps[s:e] = ip

        # ---- edges -----------------------------------------------------
        with self._stage("edges"):
            ii, jj = self._build_edges(T, poses_np, disps_np, intr8, t_cap)
        E = len(ii)
        if E == 0:
            return {"frames": T, "edges": 0, "skipped": True}
        ce = self.chunk
        e_cap = ((E + ce - 1) // ce) * ce
        ii_p = np.zeros(e_cap, np.int64)
        jj_p = np.zeros(e_cap, np.int64)
        val_p = np.zeros(e_cap, bool)
        ii_p[:E], jj_p[:E], val_p[:E] = ii, jj, True

        # capped adjacency (group by source frame)
        gi = np.zeros((t_cap, self.d_cap), np.int64)
        gv = np.zeros((t_cap, self.d_cap), bool)
        fill = np.zeros(t_cap, np.int64)
        for e in range(E):
            m = ii[e]
            k = fill[m]
            assert k < self.d_cap, "edge selection must respect degree cap"
            gi[m, k] = e
            gv[m, k] = True
            fill[m] += 1

        # ---- device state ------------------------------------------------
        pad_pose = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1.0], np.float32),
                           (t_cap, 1))
        pad_pose[:T] = poses_np
        poses = torch.as_tensor(pad_pose, device=dev)
        disps = torch.as_tensor(np.concatenate(
            [disps_np, np.ones((t_cap - T, h, w), np.float32)]), device=dev)
        intr = torch.as_tensor(intr8, device=dev)[None].expand(t_cap, 4)
        ii_d, jj_d, valid_d, gi_d, gv_d = (
            torch.as_tensor(x, device=dev)
            for x in (ii_p, jj_p, val_p, gi, gv))
        weight = torch.zeros((e_cap, 2, h, w), device=dev)
        eta = torch.full((t_cap, h, w), 1e-4, device=dev)
        upmask = torch.zeros((t_cap, h, w, 576), device=dev)
        nets_e = nets0[ii_d]                           # (e_cap, h, w, 128)
        del nets0
        frame = torch.arange(t_cap, device=dev)
        free = (frame < T) & (frame >= 1)              # pin frame 0 + pads

        # seed targets with the current reprojection: motion starts at 0
        if self.target_fn is not None:
            target = torch.as_tensor(
                np.asarray(self.target_fn(ii_p, jj_p)), dtype=torch.float32,
                device=dev).clone()
        else:
            coords1, _ = pops.projective_transform(poses, disps, intr, ii_d,
                                                   jj_d)
            target = coords1.movedim(-1, 1).contiguous()

        # the banded pose system must cover the LONGEST edge proposed (a
        # loop edge beyond the proposal band would otherwise drop out of
        # it); widening to t_cap-1 degenerates to the full matrix
        max_span = int(np.max(np.abs(ii_p[:E] - jj_p[:E])))
        band = min(max(2 * self.band, 2 * max_span), t_cap - 1)
        stats = {}
        with f32_matmul():
            for _ in range(self.steps):
                with self._stage("gru"):
                    for s in range(0, e_cap, ce):
                        sl = slice(s, s + ce)
                        _gru_chunk(model.update, fmaps, inps, poses, disps,
                                   intr, ii_d[sl], jj_d[sl], valid_d[sl], s,
                                   nets_e[sl], target, weight, eta, upmask,
                                   t_cap)
                with self._stage("solve"):
                    if self.dense_solve:
                        poses, disps = ba_ops.ba_global(
                            target, weight, eta, poses, disps, intr, ii_d,
                            jj_d, valid_d, gi_d, gv_d, free,
                            iters=self.gn_iters)
                    else:
                        poses, disps = ba_ops.ba_global_banded(
                            target, weight, eta, poses, disps, intr, ii_d,
                            jj_d, valid_d, gi_d, gv_d, free,
                            iters=self.gn_iters, band=band,
                            cg_iters=self.cg_iters, stats=stats)

            # ---- write back ----------------------------------------------
            disps_up = upsample_disp(disps[:T], upmask[:T])
        poses_h = poses[:T].cpu().numpy()
        disps_h = disps[:T].cpu().numpy()
        disps_up_h = disps_up.cpu().numpy()
        used = stats.get("cg_iters_used")
        self.cg_iters_used = torch.stack(used).tolist() if used else []
        ns, nl = v.count_save, v.counter
        v.poses_save[:ns] = poses_h[:ns]
        v.disps_save[:ns] = disps_h[:ns]
        v.disps_up_save[:ns] = disps_up_h[:ns]
        if nl > 0:
            b = v.bufs
            b.poses[:nl] = poses[ns:T]
            b.disps[:nl] = disps[ns:T]
            b.disps_up[:nl] = disps_up[ns:]
        return {"frames": T, "edges": E, "skipped": False}
