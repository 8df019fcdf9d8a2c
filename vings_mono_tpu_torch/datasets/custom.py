"""User-supplied sequence loader — reference scripts/datasets/custom.py:
pngs in `rgb/`, frame-index timestamps (visual-only)."""

from .base import GlobVODataset


class CustomDataset(GlobVODataset):
    subdir = "rgb"
    pattern = "*.png"


def get_dataset(cfg):
    return CustomDataset(cfg)
