"""Monocular metric-depth prior, fed to the tracker as
`data_packet['depth']` -> `disps_sens`.

Backends (`metric.backend`; the configuration files are shared with the
JAX package, so the names are its names):
  * 'npz'  — precomputed per-frame depth maps `metric.root/*.np[yz]` in
             sorted order, one per call;
  * 'flax' — the DPT network of `models/dpt_depth.py` with the JAX
             package's flax weights (`metric.weights`);
  * 'none' — disabled.
Every depth is clipped to [0, metric.d_max].
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..utils.device import resolve_device


class MetricDepth:
    def __init__(self, cfg, device=None):
        mcfg = cfg.get("metric", {}) or {}
        self.backend = mcfg.get("backend", "npz")
        self.d_max = float(mcfg.get("d_max", 80.0))
        self.files = []
        self.idx = 0
        if self.backend == "npz":
            root = mcfg.get("root", "")
            self.files = sorted(glob.glob(os.path.join(root, "*.np[yz]")))
        elif self.backend == "flax":
            from .dpt_depth import load_dpt
            self.device = resolve_device(device or cfg["device"]["tracker"])
            self.model, self._predict = load_dpt(
                mcfg.get("weights"), device=self.device,
                generator=torch.Generator().manual_seed(
                    int(cfg.get("seed", 0))))

    def predict(self, rgb, intrinsic):
        """rgb (H, W, 3) in [0,1] (or uint8) -> metric depth (H, W) or None:
        a numpy array from the npz backend (None once its files run out),
        a tensor on the model's device from the flax backend."""
        H, W = rgb.shape[:2]
        if self.backend == "npz":
            if self.idx >= len(self.files):
                return None
            path = self.files[self.idx]
            self.idx += 1
            d = np.load(path)
            if hasattr(d, "files"):       # .npz: its first array
                with d:
                    d = d[d.files[0]]
            if d.shape != (H, W):
                import cv2
                d = cv2.resize(d.astype(np.float32), (W, H),
                               interpolation=cv2.INTER_NEAREST)
            return np.clip(d, 0, self.d_max).astype(np.float32)
        if self.backend == "flax":
            x = torch.as_tensor(rgb).to(self.device)
            x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
            return self._predict(x[None])[0].clamp(0, self.d_max)
        return None
