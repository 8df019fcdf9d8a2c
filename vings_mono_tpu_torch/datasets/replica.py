"""Replica loader (results/frame*.jpg + depth*.png, scale 6553.5)."""

import glob
import os

from .base import ImageFolderDataset


class ReplicaDataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        self.rgb_files = sorted(glob.glob(
            os.path.join(root, "results", "frame*.jpg")))
        self.timestamps = list(range(len(self.rgb_files)))
        if self.cfg["dataset"].get("use_depth", False):
            self.depth_files = sorted(glob.glob(
                os.path.join(root, "results", "depth*.png")))
            self.depth_scale = 6553.5


def get_dataset(cfg):
    return ReplicaDataset(cfg)
