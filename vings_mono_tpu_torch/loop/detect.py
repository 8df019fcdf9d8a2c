"""Loop detection: SuperPoint features on 512-wide grayscale crops,
descriptor matching (LightGlue when its weights are given, else mutual-NN),
PnP from the current frame's keypoints + depths to recover the history
pose, then render-based verification against the history image.

The nets and the renders run on the device; `cv2.resize`,
`cv2.solvePnPRansac` and `solvePnPRefineLM` stay on the host. Tensors
cross to the host once per stage (a frame's features, a match, a
render), not once per element.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.superpoint import extract, load_superpoint, \
    mutual_nearest_match
from ..utils.vis import host_array

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def map_render(mapper, c2w, intr, max_dist):
    """rgb (H, W, 3), depth and accum (H, W) of the map at c2w, culled to
    `max_dist` around the camera, on the host in one copy."""
    rets = mapper.render_at(np.linalg.inv(c2w), intr, max_dist=max_dist)
    hwc = torch.cat([rets["rgb"], rets["depth"], rets["accum"]])
    hwc = host_array(hwc.movedim(0, -1))
    return hwc[..., :3], hwc[..., 3], hwc[..., 4]


class LoopDetector:
    def __init__(self, cfg, sp_params_path=None, max_kp=512,
                 lg_params_path=None, device="cpu"):
        """Without `sp_params_path`, SuperPoint's weights are random from
        the config's `seed`."""
        self.cfg = cfg
        self.device = torch.device(device)
        # per-attempt diagnostics: the stage the attempt died at + stats
        self.traces = []
        self.model = load_superpoint(
            sp_params_path, device=self.device,
            generator=torch.Generator().manual_seed(int(cfg.get("seed",
                                                                0))))
        self.max_kp = max_kp
        self.lg = None
        if lg_params_path:
            from ..models.lightglue import load_lightglue
            self.lg = load_lightglue(lg_params_path, device=self.device)

    # ------------------------------------------------------------------
    def extract(self, rgb):
        """rgb (H, W, 3) float [0,1] -> keypoints in pixel coords of the
        ORIGINAL image + descriptors, as host arrays."""
        H, W = rgb.shape[:2]
        scale = 512.0 / W
        hh = int(round(H * scale / 8)) * 8
        ww = 512
        gray = np.asarray(rgb) @ np.asarray([0.299, 0.587, 0.114])
        if cv2 is not None:
            gray_r = cv2.resize(gray.astype(np.float32), (ww, hh))
        else:
            gray_r = gray[:hh, :ww].astype(np.float32)
        xy, score, valid, desc = extract(
            self.model, torch.as_tensor(gray_r, device=self.device),
            self.max_kp)
        # one copy of the stage's four outputs
        out = torch.cat([xy, score[:, None], valid[:, None].float(), desc],
                        dim=1).cpu().numpy()
        xy = out[:, :2] * np.asarray([W / ww, H / hh])
        return xy, out[:, 2], out[:, 3] > 0, out[:, 4:]

    @torch.no_grad()
    def match(self, feat_a, feat_b, img_hw=None):
        xy_a, _, va, da = feat_a
        xy_b, _, vb, db = feat_b

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        va_d, vb_d = dev(va, torch.bool), dev(vb, torch.bool)
        if self.lg is not None and img_hw is not None:
            from ..models.lightglue import (extract_matches,
                                            normalize_keypoints)
            k0 = normalize_keypoints(dev(xy_a), img_hw)
            k1 = normalize_keypoints(dev(xy_b), img_hw)
            scores, _, _ = self.lg(dev(da), dev(db), k0, k1, va_d, vb_d)
            idx, ok = extract_matches(scores, va_d, vb_d)
        else:
            idx, ok = mutual_nearest_match(dev(da), dev(db), va_d, vb_d)
        idx, ok = torch.stack([idx, ok.long()]).cpu().numpy()
        ok = ok.astype(bool)
        return xy_a[ok], xy_b[idx[ok]]

    # ------------------------------------------------------------------
    def pnp_history_pose(self, kp_cur, kp_hist, depth_cur, cur_c2w, intr4,
                         trace=None, min_inliers=10):
        """World points from the current frame's keypoints+depth, solved
        against the history frame's 2D keypoints. Returns history c2w or
        None."""
        if cv2 is None or len(kp_cur) < 12:
            return None
        fx, fy, cx, cy = [float(v) for v in intr4]
        H, W = depth_cur.shape
        u = np.clip(kp_cur[:, 0].astype(int), 0, W - 1)
        v = np.clip(kp_cur[:, 1].astype(int), 0, H - 1)
        z = np.asarray(depth_cur)[v, u]
        good = (z > 0.1) & (z < 100.0)
        if good.sum() < 12:
            return None
        x = (kp_cur[good, 0] - cx) / fx * z[good]
        y = (kp_cur[good, 1] - cy) / fy * z[good]
        pts_cam = np.stack([x, y, z[good]], -1)
        pts_w = pts_cam @ np.asarray(cur_c2w)[:3, :3].T + \
            np.asarray(cur_c2w)[:3, 3]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        pw = pts_w.astype(np.float64)
        ph = kp_hist[good].astype(np.float64).reshape(-1, 1, 2)
        okf, rvec, tvec, inl = cv2.solvePnPRansac(
            pw, ph, K, None, reprojectionError=4.0, iterationsCount=100)
        if trace is not None:
            trace["pnp_inliers"] = 0 if inl is None else int(len(inl))
        if not okf or inl is None or len(inl) < min_inliers:
            return None
        # LM refinement on the consensus set: the RANSAC minimal-set pose
        # alone is noisy, and a loop correction built from it injects that
        # noise into the whole rectified segment
        inl = inl[:, 0]
        rvec, tvec = cv2.solvePnPRefineLM(pw[inl], ph[inl], K, None,
                                          rvec, tvec)
        R, _ = cv2.Rodrigues(rvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = tvec[:, 0]
        return np.linalg.inv(w2c)

    # ------------------------------------------------------------------
    def detect(self, mapper, cur_img, cur_depth, cur_c2w, hist_img,
               hist_c2w_guess, intr, min_matches=40, min_inliers=30,
               sanity_dist=15.0, verify_thresh=0.15, verify_distance=60.0):
        """Full detect pipeline; returns rectified history c2w or None."""
        tr = {"stage": "match", "matches": 0, "pnp_inliers": 0,
              "rend_frac": None, "sanity_d": None, "verify_px": 0,
              "verify_err": None}
        self.traces.append(tr)
        feat_cur = self.extract(cur_img)
        feat_hist = self.extract(hist_img)
        kp_c, kp_h = self.match(feat_cur, feat_hist,
                                img_hw=cur_img.shape[:2])
        tr["matches"] = int(len(kp_c))
        if len(kp_c) < min_matches:
            return None
        tr["stage"] = "pnp"
        intr4 = np.asarray([intr["fv"], intr["fu"], intr["cv"],
                            intr["cu"]])
        # PnP depth from the RENDERED map where opacity is saturated: per-
        # frame tracked disparity is too noisy for RANSAC consensus, the
        # Gaussian map's depth is multi-view-consistent
        pnp_depth = cur_depth
        if mapper is not None:
            rgb_c, dep_c, acc_c = map_render(mapper, cur_c2w, intr,
                                          verify_distance)
            use_rend = (acc_c > 0.9) & (dep_c > 0.05)
            tr["rend_frac"] = float(use_rend.mean())
            # gauge repair: a briefly-trained map's rendered depth is
            # contracted toward the camera, which would shrink the PnP
            # translation by the same factor; its SHAPE is consistent, its
            # SCALE comes from the tracker's own depth
            both = use_rend & (cur_depth > 0.05)
            if both.sum() > 100:
                s_med = float(np.median(cur_depth[both] / dep_c[both]))
                tr["depth_ratio_med"] = s_med
                pnp_depth = np.where(use_rend, dep_c * s_med, cur_depth)
            else:
                pnp_depth = np.where(use_rend, dep_c, cur_depth)
            # noise floor for the photometric verify gate: how well the
            # map explains the CURRENT image from the trusted tracked pose
            m_self = (acc_c > 0.95) & (dep_c < 15.0)
            if m_self.sum() > 500:
                err_self = np.abs(rgb_c - np.asarray(cur_img)).mean(-1)
                tr["verify_floor"] = float(err_self[m_self].mean())
        new_c2w = self.pnp_history_pose(kp_c, kp_h, pnp_depth, cur_c2w,
                                        intr4, trace=tr,
                                        min_inliers=min_inliers)
        if new_c2w is None:
            return None
        tr["stage"] = "sanity"
        tr["sanity_d"] = float(np.linalg.norm(
            new_c2w[:3, 3] - np.asarray(hist_c2w_guess)[:3, 3]))
        if tr["sanity_d"] > sanity_dist:
            return None
        # render-verify: the map seen from the recovered pose must
        # photometrically match the history image; distance-culled, so far
        # geometry cannot pollute the check
        tr["stage"] = "verify"
        pred, dep, acc = map_render(mapper, new_c2w, intr, verify_distance)
        m = (acc > 0.95) & (dep < 15.0)
        tr["verify_px"] = int(m.sum())
        if m.sum() < 500:
            return None
        err = np.abs(pred - np.asarray(hist_img)).mean(-1)
        tr["verify_err"] = float(err[m].mean())
        # self-calibrating gate: absolute threshold, relaxed to 1.5x the
        # map's own render error at the trusted current pose
        gate = verify_thresh
        if tr.get("verify_floor") is not None:
            gate = max(gate, 1.5 * tr["verify_floor"])
        tr["verify_gate"] = float(gate)
        if tr["verify_err"] > gate:
            return None
        tr["stage"] = "ok"
        return new_c2w
