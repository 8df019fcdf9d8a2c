"""Live phone capture loader — reference scripts/datasets/phone.py: same
live-folder contract as mobile.py (cam0/*.png, 90° CCW rotation,
unbounded length with polling)."""

from .base import LiveFolderDataset


class PhoneDataset(LiveFolderDataset):
    subdir = "cam0"
    pattern = "*.png"


def get_dataset(cfg):
    return PhoneDataset(cfg)
