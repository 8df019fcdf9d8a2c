"""UrbanScene3D drone loader — reference scripts/datasets/urbanscene3d.py:
DJI captures in `rgb_downsample/DJI_<n>.JPG`, ordered by shot number;
gt pose files share the DJI_<n> stems."""

import os

from .base import GlobVODataset, load_pose_dir_gt


def _dji_number(path):
    return int(os.path.basename(path).split(".")[0].replace("DJI_", ""))


class UrbanScene3DDataset(GlobVODataset):
    subdir = "rgb_downsample"
    pattern = "*.JPG"
    sort_key = staticmethod(_dji_number)

    def load_gt_dict(self):
        pose_dir = os.path.join(self.cfg["dataset"]["root"], "pose")
        return load_pose_dir_gt(
            pose_dir, stem=lambda f: f.split(".")[0].replace("DJI_", ""))


def get_dataset(cfg):
    return UrbanScene3DDataset(cfg)
