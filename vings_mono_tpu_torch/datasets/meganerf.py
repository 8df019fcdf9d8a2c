"""Mega-NeRF aerial scenes loader — reference scripts/datasets/meganerf.py:
4x-downsampled jpgs in `rgbs_4/`, frame-index timestamps."""

from .base import GlobVODataset


class MegaNeRFDataset(GlobVODataset):
    subdir = "rgbs_4"
    pattern = "*.jpg"


def get_dataset(cfg):
    return MegaNeRFDataset(cfg)
