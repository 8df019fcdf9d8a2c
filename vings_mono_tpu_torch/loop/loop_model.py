"""Loop-closure orchestration: candidate search by 3D distance over the
global keyframe history with NMS skipping, the acceptance policy (enough
history, no nested/too-recent loops), detect -> drift gate -> rectify ->
re-anchor -> optional retrain."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie
from ..utils.vis import host_array
from .detect import LoopDetector
from .rectify import (rectify_gaussians, rectify_poses, rectify_tracker,
                      retrain_gaussians)


class LoopModel:
    def __init__(self, cfg, detector=None, device="cpu"):
        self.cfg = cfg
        lcfg = cfg.get("looper", {})
        self.detector = detector if detector is not None else \
            LoopDetector(cfg, lcfg.get("superpoint_weights"),
                         lg_params_path=lcfg.get("lightglue_weights"),
                         device=device)
        self.min_history = int(lcfg.get("min_history", 35))
        self.min_gap = int(lcfg.get("min_gap_from_last", 20))
        self.search_radius = float(lcfg.get("search_radius", 10.0))
        self.nms = int(lcfg.get("candidate_nms", 5))
        self.closed_at = []          # global kf ids of accepted loops
        self.loop_traces = []        # closure diagnostics (gated ones too)
        self.min_inliers = int(lcfg.get("min_inliers", 30))
        # drift-aware correction gate (run()): monocular drift grows with
        # distance traveled, so the endpoint teleport a closure applies is
        # bounded by drift_frac x the path length of the cand..cur chain;
        # a larger one is misassociation
        self.drift_frac = float(lcfg.get("drift_frac", 0.8))
        self.max_correction = lcfg.get("max_correction")  # optional abs cap
        # "track": express the measured translation magnitude in the
        # chain's own gauge (see run()); "none": trust PnP magnitude
        self.rescale_t = str(lcfg.get("rescale_t", "track"))
        # GPS/manual candidate pairs [(cur_gid, cand_gid), ...]
        self.manual_candidates = list(lcfg.get("manual_candidates", []))

    # ------------------------------------------------------------------
    @staticmethod
    def _history(tracker):
        """Global keyframe c2w history (N, 4, 4): save buffers + live."""
        video = tracker.video
        n_save = video.count_save
        c2ws = []
        if n_save > 0:
            w2c = torch.as_tensor(video.poses_save[:n_save],
                                  dtype=torch.float32)
            c2ws.append(lie.se3_matrix(lie.se3_inv(w2c)).numpy())
        if video.counter > 0:
            c2ws.append(video.c2w_matrices())
        return np.concatenate(c2ws)

    @staticmethod
    def _image(tracker, gid):
        """The keyframe image of global id `gid` from the CLEAN history
        buffers (save or live), on the host."""
        video = tracker.video
        if gid < video.count_save:
            return video.images_save[gid]
        return video.bufs.images[gid - video.count_save].cpu().numpy()

    def accept_candidate(self, cur_gid, cand_gid):
        """History long enough, candidate far enough in time, no loop
        accepted too recently."""
        if cur_gid < self.min_history:
            return False
        if cur_gid - cand_gid < self.min_history:
            return False
        for g in self.closed_at:
            if abs(cur_gid - g) < self.min_gap:
                return False
        return True

    def find_candidates(self, c2ws, cur_gid, k=3):
        """Distance-ranked history candidates with index-NMS."""
        pos = c2ws[:cur_gid, :3, 3]
        cur = c2ws[cur_gid, :3, 3]
        d = np.linalg.norm(pos - cur, axis=-1)
        order = np.argsort(d)
        out = []
        for i in order:
            if d[i] > self.search_radius:
                break
            if not self.accept_candidate(cur_gid, i):
                continue
            if any(abs(int(i) - int(j)) < self.nms for j in out):
                continue
            out.append(int(i))
            if len(out) >= k:
                break
        return out

    # ------------------------------------------------------------------
    def run(self, mapper, tracker, viz_out, frame_idx):
        """Returns True if a loop was closed."""
        if viz_out is None:
            return False
        cur_gid = int(host_array(viz_out.get(
            "global_kf_id_host", viz_out["global_kf_id"]))[-1])
        c2ws = self._history(tracker)
        if cur_gid >= len(c2ws):
            return False
        cands = [c for g, c in self.manual_candidates
                 if abs(g - cur_gid) <= 1] or \
            self.find_candidates(c2ws, cur_gid)
        if not cands:
            return False

        # current image from the CLEAN history buffers, NOT viz_out: the
        # middleware blacks out depth-filtered pixels, and SuperPoint then
        # keys on the hole boundaries instead of the scene
        cur_img = self._image(tracker, cur_gid)
        cur_depth = host_array(viz_out["depths"][-1])[..., 0]
        cur_c2w = host_array(viz_out["poses"][-1])
        intr = viz_out["intrinsic"]

        for cand in cands:
            new_hist_c2w = self.detector.detect(
                mapper, cur_img, cur_depth, cur_c2w,
                self._image(tracker, cand), c2ws[cand], intr,
                min_inliers=self.min_inliers)
            if new_hist_c2w is None:
                continue
            # the history pose is trusted; the target for the current
            # frame comes from the relative pose PnP measured
            rel_meas = np.linalg.inv(new_hist_c2w) @ cur_c2w
            rel_track = np.linalg.inv(c2ws[cand]) @ cur_c2w
            # Sim3-style gauge repair (monocular): the PnP translation
            # magnitude lives in the DEPTH gauge, the stored chain in the
            # POSITION gauge; rotation and bearing transfer gauge-free, so
            # the closure corrects those and takes the magnitude from the
            # chain's own gauge
            if self.rescale_t == "track":
                nm = float(np.linalg.norm(rel_meas[:3, 3]))
                nt = float(np.linalg.norm(rel_track[:3, 3]))
                rel_used = rel_meas.copy()
                if nm > 1e-9:
                    rel_used[:3, 3] *= nt / nm
                else:
                    rel_used[:3, 3] = rel_track[:3, 3]
            else:
                rel_used = rel_meas
            target_cur = c2ws[cand] @ rel_used
            corr = target_cur @ np.linalg.inv(cur_c2w)
            disp_t = float(np.linalg.norm(target_cur[:3, 3] -
                                          cur_c2w[:3, 3]))
            rot_deg = float(np.degrees(np.arccos(np.clip(
                (np.trace(corr[:3, :3]) - 1) / 2, -1, 1))))
            trace = {"cur_gid": int(cur_gid), "cand_gid": int(cand),
                     "corr_t": float(np.linalg.norm(corr[:3, 3])),
                     "disp_t": disp_t, "corr_rot_deg": rot_deg,
                     # cand->cur relative pose as MEASURED by PnP and as
                     # the TRACKER stores it
                     "rel_meas": rel_meas.tolist(),
                     "rel_track": rel_track.tolist()}
            # correction-magnitude gate: PnP on ambiguous structure can
            # pass RANSAC *and* render-verify with a wildly wrong pose; the
            # allowed endpoint teleport scales with the cand..cur path
            seg = c2ws[cand:cur_gid + 1, :3, 3]
            path_len = float(np.linalg.norm(np.diff(seg, axis=0),
                                            axis=-1).sum())
            gate = self.drift_frac * path_len
            if self.max_correction is not None:
                gate = min(gate, float(self.max_correction))
            trace["path_len"] = path_len
            trace["corr_gate"] = gate
            if disp_t > gate:
                trace["rejected"] = "max_correction"
                self.loop_traces.append(trace)
                continue
            self.loop_traces.append(trace)
            old_c2ws = c2ws.copy()
            # bend ONLY the newly drifted segment: start at the previous
            # closure's endpoint, end at the BA window's base, and carry
            # the live window RIGIDLY to the endpoint target (a relative-
            # pose change inside the active window is a pseudo-measurement
            # conflict the next BA updates fight)
            base_g = tracker.video.count_save + \
                max(0, tracker.frontend.t1 - tracker.graph.w_ba)
            a_bend = max(cand, self.closed_at[-1]) if self.closed_at \
                else cand
            b_bend = base_g - 1 if cand + 1 < base_g <= cur_gid else cur_gid
            corr_end = target_cur @ np.linalg.inv(c2ws[cur_gid])
            if a_bend < b_bend:
                new_c2ws = rectify_poses(c2ws, a_bend, b_bend,
                                         corr_end @ c2ws[b_bend])
            else:
                # nothing left to bend (all new drift sits inside the
                # rigid live window): carry everything after a_bend
                new_c2ws = c2ws.copy()
                new_c2ws[a_bend + 1:] = corr_end[None] @ c2ws[a_bend + 1:]
            rectify_gaussians(mapper, old_c2ws[:len(new_c2ws)], new_c2ws)
            # depth writeback over the rectified span keeps saved
            # disparities consistent with the re-anchored map
            wd = self.cfg.get("looper", {}).get("depth_writeback", True)
            rectify_tracker(tracker, new_c2ws,
                            mapper=mapper if wd else None,
                            intrinsic=intr if wd else None,
                            loop_start=cand, loop_end=cur_gid)
            if self.cfg.get("looper", {}).get("retrain"):
                retrain_gaussians(mapper, tracker.video, intr,
                                  loop_start=cand, loop_end=cur_gid)
            self.closed_at.append(cur_gid)
            return True
        return False
