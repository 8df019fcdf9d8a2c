"""KITTI raw (synced) loader — reference scripts/datasets/kitti_sync.py:
image_02 frames, metadata/camstamp.txt timestamps, metadata/imu.txt with a
config-set time shift, metadata/c2i.txt extrinsic."""

import os

import numpy as np

from .base import ImageFolderDataset


class KITTISyncDataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        meta = np.loadtxt(os.path.join(root, "metadata", "camstamp.txt"),
                          dtype=str)
        self.timestamps = [float(t) for t in meta[:, 0]]
        self.rgb_files = [os.path.join(root, "image_02", "data", f)
                          for f in meta[:, 1]]
        self.c2i = np.loadtxt(os.path.join(root, "metadata", "c2i.txt"))

    def preload_imu(self):
        imu = np.loadtxt(os.path.join(self.cfg["dataset"]["root"],
                                      "metadata", "imu.txt"))
        imu[:, 0] -= self.cfg["dataset"].get("imu_delay", 0.0)
        return imu


def get_dataset(cfg):
    return KITTISyncDataset(cfg)
