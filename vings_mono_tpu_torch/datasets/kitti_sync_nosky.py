"""KITTI raw (synced) with sky-removed frames — reference
scripts/datasets/kitti_sync_nosky.py: identical to kitti_sync but frames
come from image_02/data_nosky."""

import os

from .kitti_sync import KITTISyncDataset


class KITTISyncNoSkyDataset(KITTISyncDataset):
    def _prepare(self):
        super()._prepare()
        self.rgb_files = [
            os.path.join(os.path.dirname(os.path.dirname(f)), "data_nosky",
                         os.path.basename(f)) for f in self.rgb_files]


def get_dataset(cfg):
    return KITTISyncNoSkyDataset(cfg)
