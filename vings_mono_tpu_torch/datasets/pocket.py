"""Pocket-camera capture loader — reference scripts/datasets/pocket.py:
jpgs in `color/`, frame-index timestamps (visual-only)."""

from .base import GlobVODataset


class PocketDataset(GlobVODataset):
    subdir = "color"
    pattern = "*.jpg"


def get_dataset(cfg):
    return PocketDataset(cfg)
