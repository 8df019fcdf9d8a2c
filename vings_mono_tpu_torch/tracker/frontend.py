"""Sliding-window SLAM frontend (visual-only path).

per new keyframe (`_update`):
  * age out stale edges into the inactive store,
  * propose proximity edges (distance-ranked with NMS),
  * iters1 GRU+BA updates,
  * window rollup when t1 > rollup_at (spill the oldest rollup_n keyframes
    to the host save buffers),
  * keyframe test: if the (t1-3, t1-2) flow distance is below threshold,
    remove keyframe t1-2, else run iters2 more updates,
  * seed pose/disp of the next incoming slot.

An inertial layer (tracker/vio.py, `attach_inertial`) hooks in at frame
arrival (IMU prediction), keyframe removal (interval merge), rollup
(rekeying) and after the keyframe decision (VI and GNSS initialization);
both distance prefetches are off while one is attached, since the IMU
prediction between frames moves the poses they would measure. The live
monitor is not ported: `frontend.show_plot` raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie
from .graph import CovisibleGraph
from .video import DepthVideo


def _seed_next_kernel(bufs, t1, init_flag, cv_alpha):
    """Seed slot t1 for the incoming frame: pose from a damped constant-
    velocity motion model (cv_alpha in [0,1]; 0 = identity-motion seeding),
    disps[t1] = mean of recent disps. t1 and init_flag are host values.

    With cv_alpha > 0 the seed is exp(alpha*log(rel)) ahead of the last
    pose, rel being the last inter-frame motion: the BA is then left only
    the deviation from constant velocity."""
    prev = bufs.poses[t1 - 1]
    seed = prev
    if cv_alpha > 0.0 and not init_flag and t1 >= 2:
        prev2 = bufs.poses[max(t1 - 2, 0)]
        rel = lie.se3_mul(prev, lie.se3_inv(prev2))    # w2c: X_k ~ rel*X_{k-1}
        xi = lie.se3_log(rel)
        pred = lie.se3_mul(lie.se3_exp(xi * cv_alpha), prev)
        seed = torch.where(torch.isfinite(pred).all(), pred, prev)
    if init_flag:
        s = max(t1 - 4, 0)
        mean = bufs.disps[s:s + 4].mean()
    else:
        mean = bufs.disps[t1 - 1].mean()
    bufs.poses[t1] = seed
    bufs.disps[t1] = mean


def _disp_prior_kernel(bufs, ix):
    bufs.disps[ix] = torch.where(bufs.disps_sens[ix] > 0,
                                 bufs.disps_sens[ix], bufs.disps[ix])


class Frontend:
    def __init__(self, video: DepthVideo, graph: CovisibleGraph, cfg):
        self.video = video
        self.graph = graph
        fe = cfg["frontend"]
        self.t0 = 0
        self.t1 = 0
        self.is_initialized = False
        self.count = 0
        self.warmup = int(fe.get("warm_up", fe.get("warmup", 8)))
        self.beta = float(fe.get("beta", 0.3))
        self.frontend_nms = int(fe.get("frontend_nms", 1))
        self.keyframe_thresh = float(fe.get("keyframe_thresh", 3.5))
        self.frontend_window = int(fe.get("frontend_window", 25))
        self.frontend_thresh = float(fe.get("frontend_thresh", 17.5))
        self.frontend_radius = int(fe.get("frontend_radius", 2))
        self.active_window = int(fe.get("active_window", 12))
        self.max_age = int(fe.get("max_age", 25))
        # constant-velocity seeding strength. Default 0 = identity-motion
        # seeding (the reference's VO behavior)
        self.cv_alpha = float(fe.get("motion_model_alpha", 0.0))
        # 'vo_nerfslam' runs on the VO tracker with per-frame depth
        # covariance
        self.visual_only = cfg.get("mode", "vo") in ("vo", "vo_nerfslam")
        if self.visual_only:
            self.iters1 = int(fe.get("iters1", 4))
            self.iters2 = int(fe.get("iters2", 2))
            self.video.visual_only_init = True
        else:
            self.iters1 = int(fe.get("iters1", 2))
            self.iters2 = int(fe.get("iters2", 1))
        self.rollup_at = int(fe.get("rollup_at", 65))
        self.rollup_n = int(fe.get("rollup_n", 30))
        self.new_frame_added = False
        self.did_rollup = False
        self._kf_dist_prefetch = None
        self._kf_dist_hits = 0
        self.inertial = None
        if fe.get("show_plot", False):
            raise NotImplementedError(
                "frontend.show_plot (the live monitor) is not ported yet")

    def attach_inertial(self, inertial):
        self.inertial = inertial
        self.graph.inertial = inertial

    # ------------------------------------------------------------------
    def __call__(self):
        if not self.is_initialized and self.video.counter == self.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()

    # ------------------------------------------------------------------
    def _initialize(self):
        self.t0, self.t1 = 0, self.video.counter
        self.graph.add_neighborhood_factors(self.t0, self.t1, r=3)
        if self.inertial is not None:
            self.inertial.init_states()
        for _ in range(8):
            self.graph.update(1, use_inactive=True)
        self.graph.add_proximity_factors(0, 0, rad=2, nms=2,
                                         thresh=self.frontend_thresh,
                                         remove=False)
        for _ in range(16):
            self.graph.update(1, use_inactive=True)

        self._seed_next(init=True)
        self.is_initialized = True
        self.graph.rm_factors(self.graph.ii < self.warmup - 4, store=True)
        self._prefetch_proximity()

    # ------------------------------------------------------------------
    def _update(self):
        self.new_frame_added = False
        self.did_rollup = False
        self.count += 1
        self.t1 += 1

        if self.inertial is not None:
            self.inertial.on_new_frame(self.t1)

        # age out edges
        if len(self.graph.ii) > 0:
            stale = (self.graph.ii < self.t1 - self.active_window) | \
                (self.graph.jj < self.t1 - self.active_window)
            if self.visual_only:
                mask = (self.graph.age > self.max_age) & stale
            else:
                mask = (self.graph.age > self.max_age) | stale
            self.graph.rm_factors(mask, store=True)

        self.graph.add_proximity_factors(
            self.t1 - 5, max(self.t1 - self.frontend_window, 0),
            rad=self.frontend_radius, nms=self.frontend_nms,
            thresh=self.frontend_thresh, beta=self.beta, remove=True)

        # seed new disparity with the metric prior where available
        self._apply_disp_prior(self.t1 - 1)

        for _ in range(self.iters1):
            self.graph.update(None, None, iters=2, use_inactive=True)

        if self.t1 > self.rollup_at:
            self._rollup(self.rollup_n)
            self.did_rollup = True

        # keyframe decision. thresh <= 0 keeps every keyframe, so the
        # distance pull (a wait for the queued GRU+BA updates) is skipped,
        # the same shortcut the motion filter takes for filter_thresh < 0
        if self.keyframe_thresh <= 0.0:
            d = float("inf")
        else:
            pref = self._kf_dist_prefetch
            self._kf_dist_prefetch = None
            if pref is not None and pref[0] == (self.t1 - 3, self.t1 - 2):
                self._kf_dist_hits += 1
                # enqueued at the end of the previous frame (as
                # prefetch_proximity is). The distance is one BA-refinement
                # stale: measured from poses/disps before this frame's
                # iters1. That staleness is part of the gate's definition:
                # a distance taken here instead would decide differently
                d = float(pref[1].numpy()[0])
            else:
                d = float(self.video.distance(
                    [self.t1 - 3], [self.t1 - 2], beta=self.beta,
                    bidirectional=True)[0])
        if d < self.keyframe_thresh:
            self.graph.rm_keyframe(self.t1 - 2)
            if self.inertial is not None:
                self.inertial.on_rm_keyframe(self.t1 - 2)
            self.t1 -= 1
        else:
            for k in range(self.iters2):
                if k == self.iters2 - 1:
                    # depth covariance on the frame's final solve, consumed
                    # by the middleware's uncertainty weighting
                    self.graph._next_update_cov = True
                self.graph.update(None, None, iters=2, use_inactive=True)
            self.new_frame_added = True

        if self.inertial is not None:
            self.inertial.maybe_initialize(self.t1)
            # GNSS geo-referencing once IMU fusion is live, with one more
            # update in the new frame
            if self.inertial.maybe_init_gnss(self.t1):
                self.graph.update(None, None, iters=2, use_inactive=True)

        self._seed_next()
        self._prefetch_proximity()

    def _prefetch_proximity(self):
        """Enqueue the next frame's proximity distances now (all inputs are
        final after _seed_next), and the next frame's keyframe decision
        distance: its pair (t1'-3, t1'-2) is (t1-2, t1-1) in this frame's
        numbering — both already in the window. A rollup shifts that key
        (see _rollup). Neither runs with an inertial layer attached: its
        IMU prediction moves the next frame's pose before the query."""
        if self.inertial is not None:
            return
        self.graph.prefetch_proximity(
            self.t1 - 4, max(self.t1 + 1 - self.frontend_window, 0),
            beta=self.beta)
        if self.keyframe_thresh > 0.0 and self.t1 >= 2:
            d = self.video.distance_async(
                [self.t1 - 2], [self.t1 - 1], beta=self.beta,
                bidirectional=True)
            self._kf_dist_prefetch = ((self.t1 - 2, self.t1 - 1), d)

    # ------------------------------------------------------------------
    def _rollup(self, n):
        if self._kf_dist_prefetch is not None:
            # the prefetched distance itself is index-free; only its key
            # (frame indices) shifts with the window
            key, d = self._kf_dist_prefetch
            self._kf_dist_prefetch = ((key[0] - n, key[1] - n), d)
        self.video.rollup(n)
        self.graph.shift_indices(n)
        self.graph.ii_bad = np.maximum(self.graph.ii_bad - n, -1)
        self.graph.jj_bad = np.maximum(self.graph.jj_bad - n, -1)
        self.t0 = max(0, self.t0 - n)
        self.t1 -= n
        if self.inertial is not None:
            self.inertial.on_rollup(n)

    @torch.no_grad()
    def _apply_disp_prior(self, ix):
        _disp_prior_kernel(self.video.bufs, ix)

    @torch.no_grad()
    def _seed_next(self, init=False):
        _seed_next_kernel(self.video.bufs, self.t1, init, self.cv_alpha)
