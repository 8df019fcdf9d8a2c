"""Waymo frame-dump loader — reference scripts/datasets/waymo.py: jpgs in
`color/`, frame-index timestamps (visual-only), gt in pose/<t>.txt."""

from .base import GlobVODataset


class WaymoDataset(GlobVODataset):
    subdir = "color"
    pattern = "*.jpg"


def get_dataset(cfg):
    return WaymoDataset(cfg)
