"""BundleFusion sequence loader — reference
scripts/datasets/bundlefusion.py: flat `frame-XXXXXX.color.jpg` files at
the root, temporally strided by cfg dataset.rgb_strip; gt in sibling
`frame-XXXXXX.pose.txt` files."""

import glob
import os

import numpy as np

from .base import ImageFolderDataset


class BundleFusionDataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        stride = int(self.cfg["dataset"].get("rgb_strip", 1))
        files = sorted(glob.glob(os.path.join(root, "*.color.jpg")))
        self.rgb_files = files[::stride]
        self.timestamps = list(range(len(files)))[::stride]

    def load_gt_dict(self):
        root = self.cfg["dataset"]["root"]
        ts, c2ws = [], []
        for f in sorted(glob.glob(os.path.join(root, "*.pose.txt"))):
            m = np.loadtxt(f)
            if m.shape != (4, 4):  # reference skips malformed pose files
                continue
            ts.append(float(os.path.basename(f).split(".")[0]
                            .replace("frame-", "")))
            c2ws.append(m)
        if not ts:
            return None
        order = np.argsort(ts)
        return {"timestamps": np.asarray(ts)[order],
                "c2ws": np.stack(c2ws)[order]}


def get_dataset(cfg):
    return BundleFusionDataset(cfg)
