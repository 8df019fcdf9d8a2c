"""Live mobile capture loader — reference scripts/datasets/mobile.py:
pngs appear in `cam0/` while SLAM runs; portrait captures are rotated
90° CCW; unbounded length with polling."""

from .base import LiveFolderDataset


class MobileDataset(LiveFolderDataset):
    subdir = "cam0"
    pattern = "*.png"


def get_dataset(cfg):
    return MobileDataset(cfg)
