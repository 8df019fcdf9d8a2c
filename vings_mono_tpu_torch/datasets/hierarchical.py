"""Hierarchical-3DGS scenes loader — reference
scripts/datasets/hierarchical.py: pngs in `color/`, frame-index
timestamps (visual-only)."""

from .base import GlobVODataset


class HierarchicalDataset(GlobVODataset):
    subdir = "color"
    pattern = "*.png"


def get_dataset(cfg):
    return HierarchicalDataset(cfg)
