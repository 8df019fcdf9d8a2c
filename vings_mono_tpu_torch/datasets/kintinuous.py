"""Kintinuous sequence loader — reference scripts/datasets/kintinuous.py:
sky-removed pngs in `nosky_color/`, frame-index timestamps."""

from .base import GlobVODataset


class KintinuousDataset(GlobVODataset):
    subdir = "nosky_color"
    pattern = "*.png"


def get_dataset(cfg):
    return KintinuousDataset(cfg)
