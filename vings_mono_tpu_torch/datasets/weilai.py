"""Weilai drive loader — reference scripts/datasets/weilai.py: sky-removed
pngs in `nosky_color/`, frame-index timestamps (visual-only)."""

from .base import GlobVODataset


class WeilaiDataset(GlobVODataset):
    subdir = "nosky_color"
    pattern = "*.png"


def get_dataset(cfg):
    return WeilaiDataset(cfg)
