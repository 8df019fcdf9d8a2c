"""KITTI-360 (unsynced) loader — reference scripts/datasets/
kitti360_unsync.py: fisheye-rectified image_00 frames via cv2.undistort,
IMU from the OXTS stream with a fixed -0.04 s shift."""

import glob
import os

import numpy as np

from .base import ImageFolderDataset, bgr_to_rgb01, read_bgr


class KITTI360UnsyncDataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        meta = np.loadtxt(os.path.join(root, "metadata", "camstamp.txt"),
                          dtype=str)
        self.timestamps = [float(t) for t in meta[:, 0]]
        self.rgb_files = [os.path.join(root, "image_00", "data_rect", f)
                          for f in meta[:, 1]]
        c2i_path = os.path.join(root, "metadata", "c2i.txt")
        if os.path.exists(c2i_path):
            self.c2i = np.loadtxt(c2i_path)
        dcfg = self.cfg["dataset"]
        self.K = np.asarray(dcfg.get("K")) if dcfg.get("K") else None
        self.dist = np.asarray(dcfg.get("distortion")) \
            if dcfg.get("distortion") else None

    def _load_rgb(self, idx):
        import cv2
        img = read_bgr(self.rgb_files[idx])
        if self.K is not None and self.dist is not None:
            img = cv2.undistort(img, self.K, self.dist)
        img = cv2.resize(img, (self.w, self.h))
        return bgr_to_rgb01(img)

    def preload_imu(self):
        imu = np.loadtxt(os.path.join(self.cfg["dataset"]["root"],
                                      "metadata", "imu.txt"))
        imu[:, 0] -= self.cfg["dataset"].get("imu_delay", 0.04)
        return imu


def get_dataset(cfg):
    return KITTI360UnsyncDataset(cfg)
