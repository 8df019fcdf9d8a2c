"""Procedural synthetic sequence — lets every runner and the benchmark run
without any dataset files."""

import numpy as np


class SyntheticDataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.h = int(cfg["frontend"]["image_size"][0])
        self.w = int(cfg["frontend"]["image_size"][1])
        self.n = int(cfg["dataset"].get("n_frames", 60))
        f = float(cfg["dataset"].get("focal", 0.9 * self.w))
        self.intr = np.asarray([f, f, self.w / 2, self.h / 2], np.float32)
        self.c2i = np.eye(4)
        ys, xs = np.meshgrid(np.arange(self.h), np.arange(self.w),
                             indexing="ij")
        self._ys, self._xs = ys, xs

    def __len__(self):
        return self.n

    def __getitem__(self, k):
        xs, ys = self._xs, self._ys
        img = 0.5 + 0.3 * np.sin(0.05 * (xs + 4.0 * k)) * \
            np.cos(0.04 * (ys + 2.0 * k)) + \
            0.2 * np.sin(0.13 * xs + 0.1 * k)
        rgb = np.stack([img, img * 0.8,
                        np.abs(np.sin(0.02 * xs + 0.2 * k))],
                       -1).astype(np.float32)
        return {"timestamp": float(k), "rgb": np.clip(rgb, 0, 1),
                "intrinsic": self.intr}

    def preload_camtimestamp(self):
        return np.arange(self.n, dtype=np.float64)[:, None]

    def preload_imu(self):
        # gravity-consistent static IMU at 100 Hz ([t, gyro deg/s, acc]):
        # zero rotation, accelerometer reading +g upward — enough for the
        # inertial plumbing (preintegration, gap handling, VI-init attempt)
        # to run end-to-end without excitation
        m = self.n * 100
        imu = np.zeros((m, 7))
        imu[:, 0] = np.arange(m) / 100.0
        imu[:, 6] = 9.81
        return imu

    def load_gt_dict(self):
        return None


def get_dataset(cfg):
    return SyntheticDataset(cfg)
