"""RealSense VIO recording loader — reference
scripts/datasets/realsense_vio.py: dynamic-object-masked frames in
`image_00/data_nodyn`, per-frame metric depth as `image_00/depth/*.npy`,
camstamp/imu/c2i under `DBAF_format/`, gt in pose/<t>.txt."""

import glob
import os

import numpy as np

from .base import ImageFolderDataset


class RealSenseVIODataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        meta = np.loadtxt(os.path.join(root, "DBAF_format", "camstamp.txt"),
                          dtype=str)
        self.timestamps = [float(t) for t in meta[:, 0]]
        self.rgb_files = [os.path.join(root, "image_00", "data_nodyn", f)
                          for f in meta[:, 1]]
        self._depth_files = sorted(
            glob.glob(os.path.join(root, "image_00", "depth", "*.npy")))
        self.c2i = np.loadtxt(os.path.join(root, "DBAF_format", "c2i.txt"))

    def preload_imu(self):
        imu = np.loadtxt(os.path.join(self.cfg["dataset"]["root"],
                                      "DBAF_format", "imu.txt"))
        imu[:, 0] -= self.cfg["dataset"].get("imu_delay", 0.0)
        return imu

    def __getitem__(self, idx):
        pkt = super().__getitem__(idx)
        if idx < len(self._depth_files):
            pkt["depth"] = np.load(self._depth_files[idx])
        return pkt


def get_dataset(cfg):
    return RealSenseVIODataset(cfg)
