"""ScanNet v1 loader: color/*.jpg frames, optional depth/*.png (mm)."""

import glob
import os

from .base import ImageFolderDataset


class ScanNetV1Dataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        self.rgb_files = sorted(
            glob.glob(os.path.join(root, "color", "*.jpg")),
            key=lambda p: int(os.path.basename(p).split(".")[0]))
        self.timestamps = list(range(len(self.rgb_files)))
        if self.cfg["dataset"].get("use_depth", False):
            self.depth_files = sorted(
                glob.glob(os.path.join(root, "depth", "*.png")),
                key=lambda p: int(os.path.basename(p).split(".")[0]))
            self.depth_scale = 1000.0


def get_dataset(cfg):
    return ScanNetV1Dataset(cfg)
