"""Offline mobile recording loader — reference
scripts/datasets/mobile_offline.py: frames in `pic/` named by nanosecond
timestamps, rotated 90° CCW; `imu.txt` CSV (header row) with a config
time shift and an x<->y axis swap for both gyro and accel (the phone's
sensor frame); `c2i.txt` extrinsic; gt in pose/<t>.txt."""

import os

import numpy as np

from .base import ImageFolderDataset


def _ns_stem_to_seconds(name):
    ns = name.split(".")[0]
    return float(ns[:-9] + "." + ns[-9:])


class MobileOfflineDataset(ImageFolderDataset):
    rotate_ccw = True

    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        rgb_dir = os.path.join(root, "pic")
        names = sorted(os.listdir(rgb_dir))
        self.rgb_files = [os.path.join(rgb_dir, n) for n in names]
        self.timestamps = [_ns_stem_to_seconds(n) for n in names]
        self.c2i = np.loadtxt(os.path.join(root, "c2i.txt"))

    def preload_imu(self):
        imu = np.loadtxt(os.path.join(self.cfg["dataset"]["root"],
                                      "imu.txt"), delimiter=",", skiprows=1)
        imu[:, 0] -= self.cfg["dataset"].get("imu_delay", 0.0)
        imu[:, [1, 2]] = imu[:, [2, 1]]   # gyro x<->y
        imu[:, [4, 5]] = imu[:, [5, 4]]   # accel x<->y
        return imu


def get_dataset(cfg):
    return MobileOfflineDataset(cfg)
