"""TUM RGB-D loader (rgb.txt / depth.txt association, depth scale 5000)."""

import os

import numpy as np

from .base import ImageFolderDataset


def _read_list(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, p = line.split()[:2]
            out.append((float(t), p))
    return out


class TUMRGBDDataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        rgb = _read_list(os.path.join(root, "rgb.txt"))
        self.timestamps = [t for t, _ in rgb]
        self.rgb_files = [os.path.join(root, p) for _, p in rgb]
        dep_path = os.path.join(root, "depth.txt")
        if os.path.exists(dep_path) and self.cfg["dataset"].get("use_depth",
                                                                False):
            dep = _read_list(dep_path)
            dts = np.asarray([t for t, _ in dep])
            self.depth_files = []
            for t, _ in rgb:
                k = int(np.argmin(np.abs(dts - t)))
                self.depth_files.append(os.path.join(root, dep[k][1]))
            self.depth_scale = 5000.0

    def load_gt_dict(self):
        root = self.cfg["dataset"]["root"]
        gt_path = os.path.join(root, "groundtruth.txt")
        if not os.path.exists(gt_path):
            return None
        data = np.loadtxt(gt_path, comments="#")
        ts = data[:, 0]
        from scipy.spatial.transform import Rotation
        c2ws = np.tile(np.eye(4), (len(ts), 1, 1))
        c2ws[:, :3, :3] = Rotation.from_quat(data[:, 4:8]).as_matrix()
        c2ws[:, :3, 3] = data[:, 1:4]
        return {"timestamps": ts, "c2ws": c2ws}


def get_dataset(cfg):
    return TUMRGBDDataset(cfg)
