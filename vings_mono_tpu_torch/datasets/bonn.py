"""Bonn dynamic RGB-D loader (TUM-format rgb.txt association)."""

from .tumrgbd import TUMRGBDDataset


class BonnDataset(TUMRGBDDataset):
    pass


def get_dataset(cfg):
    return BonnDataset(cfg)
