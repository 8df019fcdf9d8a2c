"""Covisible factor graph over fixed-capacity device edge slots.

Split of responsibilities:
  * tiny, shape-changing bookkeeping (edge lists ii/jj, ages, NMS edge
    proposal, slot allocation) stays on the HOST as numpy — it is O(max
    factors) integers per frame,
  * every per-edge tensor (GRU state, correlation pyramids, targets,
    weights) lives in fixed-capacity device tensors indexed by slot, and the
    hot loop (reproject -> corr lookup -> GRU -> weight tricks -> dense BA
    -> convex upsample) runs over the sliding window.

The stores keep their fixed capacity (`edge_capacity`, `inactive_capacity`),
but each update indexes them with the LIVE slots only: the GRU and the BA
run over the live edges. A dead slot contributes nothing to either (zero
weight in the BA, its own segment in the aggregation), so the results equal
those of a program that runs over the padded capacity.

The BA runs over a fixed-size window of `ba_window` frames ending at the
newest keyframe; edges whose frames fall out of that window are masked out.

With an inertial layer attached and initialized (`video.imu_enabled`), an
update runs the GRU and the weight tricks here, hands the assembled BA
inputs to `InertialFusion.multi_sensor_ba` (device Hessian, host factor
graph, device retraction) and then writes the window back
(`_finish_update`). That branch computes no depth covariance, as the JAX
package's does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import ba as ba_ops
from ..ops import corr as corr_ops
from ..ops import lie
from ..ops import projective as pops
from ..ops.upsample import upsample_disp
from ..utils.mfu import shape_sig
from .video import DepthVideo, VideoBuffers


@dataclasses.dataclass
class EdgeStore:
    net: torch.Tensor       # (E, h, w, 128) GRU hidden per edge
    inp: torch.Tensor       # (E, h, w, 128) context per edge
    target: torch.Tensor    # (E, h, w, 2)
    weight: torch.Tensor    # (E, h, w, 2)
    corr1: torch.Tensor     # (E, hw, h, w)      pyramid level 0
    corr2: torch.Tensor     # (E, hw, h/2, w/2)
    corr3: torch.Tensor     # (E, hw, h/4, w/4)
    corr4: torch.Tensor     # (E, hw, h/8, w/8)


@dataclasses.dataclass
class InactiveStore:
    target: torch.Tensor    # (I, h, w, 2)
    weight: torch.Tensor    # (I, h, w, 2)


def empty_edges(e_cap, h, w, device="cpu"):
    """Corr pyramids live in bf16: halves the dominant memory+traffic
    cost."""
    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    bf = torch.bfloat16
    return EdgeStore(
        net=z((e_cap, h, w, 128)),
        inp=z((e_cap, h, w, 128)),
        target=z((e_cap, h, w, 2)),
        weight=z((e_cap, h, w, 2)),
        corr1=z((e_cap, h * w, h, w), bf),
        corr2=z((e_cap, h * w, h // 2, w // 2), bf),
        corr3=z((e_cap, h * w, h // 4, w // 4), bf),
        corr4=z((e_cap, h * w, h // 8, w // 8), bf),
    )


def empty_inactive(i_cap, h, w, device="cpu"):
    return InactiveStore(
        target=torch.zeros((i_cap, h, w, 2), device=device),
        weight=torch.zeros((i_cap, h, w, 2), device=device))


def _add_edges_kernel(edges: EdgeStore, bufs: VideoBuffers, slots, ii, jj):
    """Fill edge slots: corr pyramid (fmap_i x fmap_j), GRU state from the
    source frame, target from current reprojection, zero weight."""
    pyr = corr_ops.build_pyramid(bufs.fmaps[ii], bufs.fmaps[jj],
                                 dtype=torch.bfloat16)
    coords, _ = pops.projective_transform(bufs.poses, bufs.disps,
                                          bufs.intrinsics, ii, jj)
    edges.net[slots] = bufs.nets[ii]
    edges.inp[slots] = bufs.inps[ii]
    edges.target[slots] = coords
    edges.weight[slots] = 0.0
    edges.corr1[slots] = pyr.levels[0]
    edges.corr2[slots] = pyr.levels[1]
    edges.corr3[slots] = pyr.levels[2]
    edges.corr4[slots] = pyr.levels[3]


def _reseed_targets_kernel(bufs, edges: EdgeStore, inac: InactiveStore,
                           e_slots, e_ii, e_jj, i_slots, i_ii, i_jj):
    """Overwrite stored edge targets with the plain reprojection under the
    CURRENT poses/disps."""
    coords, _ = pops.projective_transform(
        bufs.poses, bufs.disps, bufs.intrinsics,
        torch.cat([e_ii, i_ii]), torch.cat([e_jj, i_jj]))
    ne = e_slots.shape[0]
    edges.target[e_slots] = coords[:ne]
    inac.target[i_slots] = coords[ne:]


def _store_inactive_kernel(inac: InactiveStore, edges: EdgeStore,
                           e_slots, i_slots):
    inac.target[i_slots] = edges.target[e_slots]
    inac.weight[i_slots] = edges.weight[e_slots]


def _fused_update(update, bufs: VideoBuffers, edges: EdgeStore,
                  inac: InactiveStore, packed, *, n_act: int, n_inac: int,
                  base: int, t0: int, ii_max: int, jj_max: int,
                  imu_enabled: bool, visual_only: bool, w_ba: int,
                  iters: int, far_threshold: float = -1.0,
                  mask_threshold: float = -1.0, compute_cov: bool = False,
                  bf16: bool = True, do_ba: bool = True):
    """One GRU+BA update over the active graph, written into bufs and edges
    in place. With do_ba False (the inertial branch) the BA is not run:
    the assembled BA inputs are returned instead, for
    InertialFusion.multi_sensor_ba and then `_finish_update`.

    `packed` is ONE integer host upload carrying the per-call index lists,
    live entries only: [slots | ii | jj] of the n_act active edges, then
    [slots | ii | jj] of the n_inac inactive edges the BA keeps. The scalars
    (base: first frame of the BA window; t0: first free pose; the largest ii
    and jj) are host integers. Nothing in here reads a device value back.
    """
    a, b = n_act, n_inac
    slots, ii, jj = packed[0:a], packed[a:2 * a], packed[2 * a:3 * a]
    o = 3 * a
    inac_slots, inac_ii, inac_jj = packed[o:o + b], packed[o + b:o + 2 * b], \
        packed[o + 2 * b:o + 3 * b]
    h, w = bufs.disps.shape[1:3]
    device = bufs.disps.device
    coords0 = pops.coords_grid(h, w, device=device)

    # ---- reproject + corr lookup + GRU ------------------------------
    coords1, _ = pops.projective_transform(bufs.poses, bufs.disps,
                                           bufs.intrinsics, ii, jj)
    motn = torch.cat([coords1 - coords0, edges.target[slots] - coords1],
                     dim=-1)
    motn = motn.clamp(-64.0, 64.0)

    pyr = corr_ops.CorrPyramid(levels=[edges.corr1[slots],
                                       edges.corr2[slots],
                                       edges.corr3[slots],
                                       edges.corr4[slots]])
    corr = corr_ops.lookup(pyr, coords1)

    # GraphAgg aggregates per *window-relative* source frame
    ii_rel = (ii - base).clamp(0, w_ba - 1)
    # with bf16 on, `update` holds bf16 parameters: the activations are cast
    # at this boundary and the outputs return to f32 before the BA solve
    # (which needs f32 conditioning)
    gdt = torch.bfloat16 if bf16 else torch.float32
    net_new, delta, weight, eta, upmask = update(
        edges.net[slots].to(gdt), edges.inp[slots].to(gdt), corr.to(gdt),
        motn.to(gdt), ii_rel, w_ba + 1, True)
    net_new, delta, weight, eta, upmask = (
        x.float() for x in (net_new, delta, weight, eta, upmask))

    target = coords1 + delta
    edges.net[slots] = net_new
    edges.target[slots] = target
    edges.weight[slots] = weight

    # damping: update rows of frames that have edges (unique(ii))
    has_edge = torch.zeros(w_ba, dtype=torch.bool, device=device)
    has_edge[ii_rel] = True
    win = slice(base, base + w_ba)
    damping_win = torch.where(has_edge[:, None, None], eta[:w_ba],
                              bufs.damping[win])
    bufs.damping[win] = damping_win

    # ---- weight tricks ------------------------------------------------
    if far_threshold > 0 and (imu_enabled or visual_only):
        far_mask = (bufs.disps[ii] < far_threshold)[..., None]
        weight = torch.where(far_mask, weight / 1000.0, weight)
    if mask_threshold > 0 and (imu_enabled or visual_only):
        rel = lie.se3_mul(bufs.poses[ii], lie.se3_inv(bufs.poses[jj]))
        small_t = torch.linalg.norm(rel[:, :3], dim=-1) < mask_threshold
        weight = torch.where(small_t[:, None, None, None], weight / 1000.0,
                             weight)
    weight = torch.where((ii == ii_max)[:, None, None, None], weight / 10.0,
                         weight)
    weight = torch.where((jj == jj_max)[:, None, None, None], weight / 4.0,
                         weight)

    # ---- assemble BA inputs over the window ---------------------------
    poses_win = bufs.poses[win]
    disps_win = bufs.disps[win]
    dsens_win = bufs.disps_sens[win]
    intr_win = bufs.intrinsics[win]
    eta_ba = 0.2 * damping_win + 1e-7

    def in_window(x):
        return (x >= base) & (x < base + w_ba)

    jj_rel = (jj - base).clamp(0, w_ba - 1)
    ev_act = in_window(ii) & in_window(jj)
    # the host already gated the inactive edges by t0 - inac_range
    i_ii = (inac_ii - base).clamp(0, w_ba - 1)
    i_jj = (inac_jj - base).clamp(0, w_ba - 1)
    ev_in = in_window(inac_ii) & in_window(inac_jj)

    all_ii = torch.cat([ii_rel, i_ii])
    all_jj = torch.cat([jj_rel, i_jj])
    all_valid = torch.cat([ev_act, ev_in])
    tgt = torch.cat([target, inac.target[inac_slots]]).movedim(-1, 1)
    wgt = torch.cat([weight, inac.weight[inac_slots]]).movedim(-1, 1)

    up_mask = upmask[:w_ba]
    if not do_ba:
        return (tgt, wgt, eta_ba, all_ii, all_jj, all_valid, poses_win,
                disps_win, dsens_win, intr_win, up_mask, has_edge)

    t0_rel = t0 - base
    poses_win, disps_win = ba_ops.ba_window(
        tgt, wgt, eta_ba, poses_win, disps_win, intr_win, all_ii, all_jj,
        all_valid, t0_rel, iters=iters)

    # honor metric-depth priors: where disps_sens > 0 keep it pinned
    disps_win = torch.where(dsens_win > 0, dsens_win, disps_win)

    if compute_cov:
        # depth covariance at the final linearization, upsampled with the
        # same convex mask as the disparities
        H_, v_, E_, C_, w_ = ba_ops.build_system(
            tgt, wgt, eta_ba, poses_win, disps_win, intr_win, all_ii,
            all_jj, all_valid, fixedp=0)
        S_, _, Q_ = ba_ops.schur_reduce(H_, v_, E_, C_, w_)
        free = torch.arange(w_ba, device=device) >= t0_rel
        cov = ba_ops.depth_covariance(S_, E_, Q_, disps_win, free_mask=free)
        cov = cov.clamp(1e-6, 1e6)
        cov = torch.where(has_edge[:, None, None], cov, bufs.depths_cov[win])
        cov_up = upsample_disp(cov, up_mask).clamp(1e-6, 1e6)
        bufs.depths_cov[win] = cov
        bufs.depths_cov_up[win] = cov_up

    _writeback_window(bufs, win, poses_win, disps_win, up_mask, has_edge)


def _writeback_window(bufs, win, poses_win, disps_win, up_mask, has_edge):
    bufs.poses[win] = poses_win
    bufs.disps[win] = disps_win
    up = upsample_disp(disps_win, up_mask)
    bufs.disps_up[win] = torch.where(has_edge[:, None, None], up,
                                     bufs.disps_up[win])


def _finish_update(bufs, base, poses_win, disps_win, dsens_win, up_mask,
                   has_edge):
    """The inertial branch's end of an update: re-pin the metric-depth
    priors, write the window back, upsample."""
    disps_win = torch.where(dsens_win > 0, dsens_win, disps_win)
    _writeback_window(bufs, slice(base, base + poses_win.shape[0]),
                      poses_win, disps_win, up_mask, has_edge)


class CovisibleGraph:
    """Host-side graph bookkeeping over device edge slots."""

    def __init__(self, video: DepthVideo, update, cfg):
        """update: the UpdateModule to run (bf16 parameters when
        `frontend.bf16_gru` is on)."""
        self.video = video
        self.update_module = update
        self.device = video.device
        fe = cfg["frontend"]
        self.max_factors = int(fe["max_factors"])
        self.edge_batch = int(fe.get("edge_batch", 16))
        self.e_cap = int(fe.get("edge_capacity", 2 * self.max_factors))
        self.i_cap = int(fe.get("inactive_capacity", 4 * self.max_factors))
        self.w_ba = int(fe.get("ba_window", 34))
        if self.w_ba > video.buf:
            raise ValueError(f"frontend.ba_window {self.w_ba} exceeds "
                             f"frontend.buffer {video.buf}")
        self.far_threshold = float(fe.get("far_threshold", -1.0))
        self.inac_range = int(fe.get("inac_range", 9))
        self.mask_threshold = float(fe.get("mask_threshold", -1.0))
        self.skip_edge = fe.get("skip_edge", False)
        self.frontend_window = int(fe.get("frontend_window", 25))
        self.bf16_gru = bool(fe.get("bf16_gru", True))
        self.inertial = None
        self._next_update_cov = False
        self._prox_prefetch = None
        self._prox_hits = 0
        self._mfu_sig = None

        h, w = video.ht // 8, video.wd // 8
        self.h, self.w = h, w
        self.edges = empty_edges(self.e_cap, h, w, self.device)
        self.inac = empty_inactive(self.i_cap, h, w, self.device)

        # host-side edge lists
        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)
        self.slot = np.zeros(0, np.int64)
        self.free_slots = list(range(self.e_cap))

        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.slot_inac = np.zeros(0, np.int64)
        self.free_inac = list(range(self.i_cap))

        self.ii_bad = np.zeros(0, np.int64)
        self.jj_bad = np.zeros(0, np.int64)

    # ------------------------------------------------------------------
    def _upload(self, *lists):
        """ONE host-to-device copy for several integer lists; returns the
        device tensor of their concatenation."""
        packed = np.concatenate([np.asarray(x, np.int64).reshape(-1)
                                 for x in lists])
        return torch.from_numpy(packed).to(self.device, non_blocking=True)

    def _edge_set(self):
        return set(zip(self.ii.tolist(), self.jj.tolist())) | \
            set(zip(self.ii_inac.tolist(), self.jj_inac.tolist()))

    @torch.no_grad()
    def add_factors(self, ii, jj, remove=False):
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        eset = self._edge_set()
        keep = [k for k in range(len(ii))
                if (ii[k], jj[k]) not in eset]
        # also dedupe within the batch
        seen = set()
        keep2 = []
        for k in keep:
            if (ii[k], jj[k]) not in seen:
                seen.add((ii[k], jj[k]))
                keep2.append(k)
        ii, jj = ii[keep2], jj[keep2]
        if len(ii) == 0:
            return

        if (self.max_factors > 0 and remove
                and len(self.ii) + len(ii) > self.max_factors):
            n_drop = len(self.ii) + len(ii) - self.max_factors
            order = np.argsort(-self.age)        # oldest first
            drop = np.zeros(len(self.ii), bool)
            drop[order[:n_drop]] = True
            self.rm_factors(drop, store=True)

        n_room = min(len(ii), len(self.free_slots))
        ii, jj = ii[:n_room], jj[:n_room]
        if n_room == 0:
            return
        slots = np.asarray([self.free_slots.pop(0) for _ in range(n_room)],
                           np.int64)
        # in batches: a batch's f32 correlation volume exists only until
        # it is stored as bf16
        B = self.edge_batch
        dev = self._upload(slots, ii, jj).reshape(3, n_room)
        for s0 in range(0, n_room, B):
            sl = slice(s0, s0 + B)
            _add_edges_kernel(self.edges, self.video.bufs, dev[0, sl],
                              dev[1, sl], dev[2, sl])
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(len(ii), np.int64)])
        self.slot = np.concatenate([self.slot, slots])

    @torch.no_grad()
    def rm_factors(self, mask, store=False):
        mask = np.asarray(mask, bool)
        if mask.sum() == 0:
            return
        if store:
            e_slots = self.slot[mask]
            n_room = min(len(e_slots), len(self.free_inac))
            i_slots = np.asarray([self.free_inac.pop(0)
                                  for _ in range(n_room)], np.int64)
            if n_room > 0:
                dev = self._upload(e_slots[:n_room], i_slots).reshape(
                    2, n_room)
                _store_inactive_kernel(self.inac, self.edges, dev[0], dev[1])
                self.ii_inac = np.concatenate([self.ii_inac,
                                               self.ii[mask][:n_room]])
                self.jj_inac = np.concatenate([self.jj_inac,
                                               self.jj[mask][:n_room]])
                self.slot_inac = np.concatenate([self.slot_inac, i_slots])
        self.free_slots.extend(self.slot[mask].tolist())
        self.ii = self.ii[~mask]
        self.jj = self.jj[~mask]
        self.age = self.age[~mask]
        self.slot = self.slot[~mask]

    def _drop_inactive(self, mask):
        self.free_inac.extend(self.slot_inac[mask].tolist())
        self.ii_inac = self.ii_inac[~mask]
        self.jj_inac = self.jj_inac[~mask]
        self.slot_inac = self.slot_inac[~mask]

    def rm_keyframe(self, ix):
        self.video.rm_keyframe(ix)
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac[self.ii_inac >= ix] -= 1
        self.jj_inac[self.jj_inac >= ix] -= 1
        if m.any():
            self._drop_inactive(m)
        m = (self.ii == ix) | (self.jj == ix)
        self.ii[self.ii >= ix] -= 1
        self.jj[self.jj >= ix] -= 1
        self.rm_factors(m, store=False)

    def shift_indices(self, n):
        """After a video rollup of n frames, rebase edge indices; edges that
        reference spilled frames are dropped."""
        m = (self.ii < n) | (self.jj < n)
        self.rm_factors(m, store=False)
        self.ii -= n
        self.jj -= n
        mi = (self.ii_inac < n) | (self.jj_inac < n)
        self._drop_inactive(mi)
        self.ii_inac -= n
        self.jj_inac -= n

    @torch.no_grad()
    def filter_edges(self):
        """Remove long-range edges whose learned confidence collapsed (one
        device-to-host pull of the per-edge mean weights)."""
        if len(self.ii) == 0:
            return
        wmean = self.edges.weight[self._upload(self.slot)].mean(
            dim=(1, 2, 3)).cpu().numpy()
        mask = (np.abs(self.ii - self.jj) > 2) & (wmean < 0.001)
        self.ii_bad = np.concatenate([self.ii_bad, self.ii[mask]])
        self.jj_bad = np.concatenate([self.jj_bad, self.jj[mask]])
        self.rm_factors(mask, store=False)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def update(self, t0=None, t1=None, iters=2, use_inactive=True):
        if len(self.ii) == 0:
            return
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        if t1 is None:
            t1 = max(int(self.ii.max()), int(self.jj.max())) + 1
        base = max(0, t1 - self.w_ba)

        if use_inactive and len(self.ii_inac) > 0:
            m = (self.ii_inac >= t0 - self.inac_range) & \
                (self.jj_inac >= t0 - self.inac_range)
        else:
            m = np.zeros(len(self.ii_inac), bool)

        # ONE packed upload for all per-call index lists (see
        # _fused_update's docstring)
        packed = self._upload(self.slot, self.ii, self.jj,
                              self.slot_inac[m], self.ii_inac[m],
                              self.jj_inac[m])
        compute_cov = self._next_update_cov
        self._next_update_cov = False
        inertial = self.inertial is not None and self.video.imu_enabled
        args = (self.update_module, self.video.bufs, self.edges, self.inac,
                packed)
        kw = dict(n_act=len(self.ii), n_inac=int(m.sum()), base=base,
                  t0=t0, ii_max=int(self.ii.max()),
                  jj_max=int(self.jj.max()),
                  imu_enabled=self.video.imu_enabled,
                  visual_only=self.video.visual_only_init, w_ba=self.w_ba,
                  iters=iters, far_threshold=self.far_threshold,
                  mask_threshold=self.mask_threshold, bf16=self.bf16_gru)
        # shape-only signature for MFU accounting (utils/mfu.py)
        self._mfu_sig = (shape_sig(args), dict(kw, do_ba=True))
        out = _fused_update(*args, **kw, compute_cov=compute_cov,
                            do_ba=not inertial)
        bufs = self.video.bufs
        if inertial:
            # GRU on the device, pose fusion on the host factor graph
            (tgt, wgt, eta_ba, all_ii, all_jj, all_valid, poses_win,
             disps_win, dsens_win, intr_win, up_mask, has_edge) = out
            poses_win, disps_win = self.inertial.multi_sensor_ba(
                tgt, wgt, eta_ba, all_ii, all_jj, all_valid,
                self._window_edges(base, m), base, t1, poses_win,
                disps_win, intr_win)
            _finish_update(bufs, base, poses_win, disps_win, dsens_win,
                           up_mask, has_edge)
        self.age += 1

    def _window_edges(self, base, m):
        """Host copy of the BA edge list `_fused_update` assembles on the
        device: window-relative (ii, jj) and in-window validity of the
        active edges, then of the inactive ones selected by `m`."""
        def rel(x):
            return np.clip(x - base, 0, self.w_ba - 1)

        def inw(x):
            return (x >= base) & (x < base + self.w_ba)

        ii = np.concatenate([self.ii, self.ii_inac[m]])
        jj = np.concatenate([self.jj, self.jj_inac[m]])
        return rel(ii), rel(jj), inw(ii) & inw(jj)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def reseed_targets(self):
        """Re-seed every stored edge target (active + inactive) to the
        reprojection under the CURRENT poses/disps. Needed after the live
        window is bent non-rigidly (a loop rectification): stored targets
        are pseudo-measurements of the OLD relative geometry. Weights are
        kept — the confidence structure of each measurement is still
        valid."""
        na, ni = len(self.ii), len(self.ii_inac)
        p = self._upload(self.slot, self.ii, self.jj, self.slot_inac,
                         self.ii_inac, self.jj_inac)
        o = 3 * na
        _reseed_targets_kernel(
            self.video.bufs, self.edges, self.inac, p[0:na], p[na:2 * na],
            p[2 * na:o], p[o:o + ni], p[o + ni:o + 2 * ni],
            p[o + 2 * ni:o + 3 * ni])

    # ------------------------------------------------------------------
    # edge proposal (host logic, device distances)
    def add_neighborhood_factors(self, t0, t1, r=3):
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def _proximity_pairs(self, t0, t1, t):
        """Candidate (ii, jj) grid for a proximity proposal at frame count
        `t`, plus the grid size cc (skip_edge candidates append after cc).
        Deterministic in (t0, t1, t) — shared by the live proposal and the
        end-of-frame prefetch so both query identical pairs."""
        ix = np.arange(t0, t)
        jx = np.arange(t1, t)
        if len(ix) == 0 or len(jx) == 0:
            return None, None, 0
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        cc = ii.shape[0]
        if self.skip_edge:
            if ii.max() - ii.min() == self.frontend_window - 1:
                jj_add = ii.min() + np.asarray(self.skip_edge, np.int64)
                jj_add = jj_add[jj_add > 0]
                ii_add = np.full_like(jj_add, ii.max())
                jj = np.concatenate([jj, jj_add])
                ii = np.concatenate([ii, ii_add])
        return ii, jj, cc

    def prefetch_proximity(self, t0, t1, beta):
        """Enqueue the NEXT frame's proximity-distance query now (end of the
        current update, when every input — poses, disps after the final BA —
        is already final; the motion filter's append only touches
        image/fmap/net/inp, which the distance never reads) and start its
        copy to the host, so the next proposal does not wait for the device.
        Correct regardless of motion-filter skips: t0/t1/counter only
        advance when a frame IS appended, so the key still matches at
        whichever frame triggers the next update."""
        t = self.video.counter + 1
        ii, jj, cc = self._proximity_pairs(t0, t1, t)
        if ii is None:
            self._prox_prefetch = None
            return
        d = self.video.distance_async(ii, jj, beta=beta)
        self._prox_prefetch = ((t0, t1, t, float(beta)), len(ii), d)

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False):
        t = self.video.counter
        ii, jj, cc = self._proximity_pairs(t0, t1, t)
        if ii is None:
            return

        pref = self._prox_prefetch
        self._prox_prefetch = None
        if pref is not None and pref[0] == (t0, t1, t, float(beta)) \
                and pref[1] == len(ii):
            self._prox_hits += 1
            d = pref[2].numpy()
        else:
            d = self.video.distance(ii, jj, beta=beta)
        d = np.array(d, np.float64)
        d[ii - rad < jj] = np.inf
        d[d > 100] = np.inf

        def suppress(i, j):
            for di in range(-nms, nms + 1):
                for dj in range(-nms, nms + 1):
                    if abs(di) + abs(dj) <= max(min(abs(i - j) - 2, nms), 0):
                        i1, j1 = i + di, j + dj
                        if (t0 <= i1 < t) and (t1 <= j1 < t):
                            k = (i1 - t0) * (t - t1) + (j1 - t1)
                            if 0 <= k < cc:
                                d[k] = np.inf

        for i, j in zip(np.concatenate([self.ii, self.ii_bad,
                                        self.ii_inac]),
                        np.concatenate([self.jj, self.jj_bad,
                                        self.jj_inac])):
            suppress(int(i), int(j))

        es = []
        for i in range(t0, t):
            for j in range(max(i - rad - 1, 0), i):
                es.append((i, j))
                es.append((j, i))
                k = (i - t0) * (t - t1) + (j - t1)
                if k >= 0 and k < cc:
                    d[k] = np.inf

        for k in np.argsort(d):
            if k >= cc or d[k] > thresh:
                continue
            if len(es) > self.max_factors:
                break
            i, j = int(ii[k]), int(jj[k])
            es.append((i, j))
            es.append((j, i))
            suppress(i, j)

        if ii.shape[0] > cc:
            sk = np.argsort(d[cc:ii.shape[0]])
            if d[cc + sk[0]] < thresh and d[cc + sk[0]] > 0:
                es.append((int(ii[cc + sk[0]]), int(jj[cc + sk[0]])))
                es.append((int(jj[cc + sk[0]]), int(ii[cc + sk[0]])))

        if es:
            a, b = np.asarray(es, np.int64).T
            self.add_factors(a, b, remove)
