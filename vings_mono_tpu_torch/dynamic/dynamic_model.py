"""Dynamic-object masking: segments whose pixels overlap the top-10%
render-error region by >= 20% are masked out of mapping.

Backends for the segmenter (`dynamic.backend`; the configuration files
are shared with the JAX package, so the names are its names):
  * 'cc' (default) — cv2 connected components over the high-error region
    (a weights-free stand-in for FastSAM's segment-everything);
  * 'precomputed' — per-frame segment label maps from disk
    (`dynamic.ann_root/*.np*`);
  * 'flax' — the learned segmenter: the YOLOv8-seg graph of
    `models/fastsam.py` in torch, with the JAX package's `.npz` weights
    from `dynamic.weights` (random from `seed` without them).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..utils.vis import host_array

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


class DynamicModel:
    def __init__(self, cfg, device="cpu"):
        dcfg = cfg.get("dynamic", {}) or {}
        self.backend = dcfg.get("backend", "cc")
        self.err_quantile = float(dcfg.get("err_quantile", 0.9))
        self.overlap = float(dcfg.get("overlap", 0.2))
        self.ann_files = []
        self.idx = 0
        self.n_masked = 0          # dynamic pixels written, over the run
        if self.backend == "precomputed":
            root = dcfg.get("ann_root", "")
            self.ann_files = sorted(glob.glob(os.path.join(root, "*.np*")))
        elif self.backend == "flax":
            from ..models.fastsam import load_fastsam
            self._seg_model = load_fastsam(
                dcfg.get("weights") or None,
                width=float(dcfg.get("width", 0.25)),
                depth=float(dcfg.get("depth", 0.34)), device=device,
                generator=torch.Generator().manual_seed(
                    int(cfg.get("seed", 0))))

    def _segments(self, rgb, err_mask):
        """Returns a list of boolean segment masks."""
        if self.backend == "precomputed" and self.idx < len(self.ann_files):
            z = np.load(self.ann_files[self.idx])
            self.idx += 1
            segs = z[z.files[0]] if hasattr(z, "files") else z
            return [segs == k for k in np.unique(segs) if k > 0]
        if self.backend == "flax":
            from ..models.fastsam import segment_everything
            return segment_everything(self._seg_model, rgb)
        if cv2 is None:
            return []
        n, labels = cv2.connectedComponents(
            err_mask.astype(np.uint8), connectivity=8)
        return [labels == k for k in range(1, n)]

    @torch.no_grad()
    def apply_to_viz_out(self, viz_out, mapper):
        """Mask the newest keyframe's dynamic pixels out of the mapper loss.

        Renders the current map at the new keyframe's pose, segments the
        high-error regions, and returns a copy of viz_out whose
        `pixel_mask[kf]` is ~dynamic. The middleware hands out one cached
        all-ones mask for every window, so the mask is cloned before the
        write. No-op until the map exists."""
        if not mapper.initialized:
            return viz_out
        kf = int(viz_out["n_valid"]) - 1
        w2c = np.linalg.inv(host_array(viz_out["poses"][kf]).astype(
            np.float64))
        rets = mapper.render_at(w2c, viz_out["intrinsic"])
        pred_rgb = np.moveaxis(host_array(rets["rgb"]), 0, -1)
        gt_rgb = np.asarray(host_array(viz_out["images"][kf]), np.float32)
        dyn = self.get_dynamic_mask(gt_rgb, pred_rgb)
        if not dyn.any():
            return viz_out
        self.n_masked += int(dyn.sum())
        pm = torch.as_tensor(viz_out["pixel_mask"]).clone()
        pm[kf] = torch.from_numpy(~dyn).to(pm.device)
        return dict(viz_out, pixel_mask=pm)

    def get_dynamic_mask(self, gt_rgb, pred_rgb, pred_ssim=None):
        """gt/pred (H, W, 3) in [0,1] -> bool (H, W) mask of dynamic pixels
        (segments overlapping the top-decile L1[xSSIM] error by >= 20%)."""
        err = np.abs(np.asarray(gt_rgb) - np.asarray(pred_rgb)).mean(-1)
        if pred_ssim is not None:
            err = err * (1.0 - np.asarray(pred_ssim))
        thresh = max(float(np.quantile(err, self.err_quantile)), 0.05)
        hot = err >= thresh
        mask = np.zeros_like(hot)
        for seg in self._segments(gt_rgb, hot):
            inter = (seg & hot).sum()
            if seg.sum() > 0 and inter / seg.sum() >= self.overlap:
                mask |= seg
        return mask

