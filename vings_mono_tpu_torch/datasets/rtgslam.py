"""RTG-SLAM (Hotel) loader — reference scripts/datasets/rtgslam.py: jpgs in
`nosky_color/`, frame-index timestamps, identity camera-IMU extrinsic."""

import glob
import os

from .base import ImageFolderDataset, bgr_to_rgb01, read_bgr


class RTGSLAMDataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        files = sorted(glob.glob(os.path.join(root, "nosky_color", "*.jpg")),
                       key=lambda x: int(os.path.basename(x).split(".")[0]))
        self.rgb_files = files
        self.timestamps = list(range(len(files)))
        self.crop = 15  # reference crops 15px borders (rtgslam.py:61)

    def _load_rgb(self, idx):
        import cv2
        img = read_bgr(self.rgb_files[idx])
        img = img[self.crop:-self.crop, self.crop:-self.crop]
        img = cv2.resize(img, (self.w, self.h))
        return bgr_to_rgb01(img)


def get_dataset(cfg):
    return RTGSLAMDataset(cfg)
