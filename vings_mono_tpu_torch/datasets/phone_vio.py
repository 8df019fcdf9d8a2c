"""Phone VIO recording loader — reference scripts/datasets/phone_vio.py:
frames in `rgb/` (jpg, falling back to png), per-frame metric depth in
`depth/*.npy`, frame-index timestamps."""

import glob
import os

import numpy as np

from .base import ImageFolderDataset


class PhoneVIODataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        files = sorted(glob.glob(os.path.join(root, "rgb", "*.jpg"))) or \
            sorted(glob.glob(os.path.join(root, "rgb", "*.png")))
        self.rgb_files = files
        self.timestamps = list(range(len(files)))
        self._depth_files = sorted(
            glob.glob(os.path.join(root, "depth", "*.npy")))

    def __getitem__(self, idx):
        pkt = super().__getitem__(idx)
        if idx < len(self._depth_files):
            pkt["depth"] = np.load(self._depth_files[idx])
        return pkt


def get_dataset(cfg):
    return PhoneVIODataset(cfg)
