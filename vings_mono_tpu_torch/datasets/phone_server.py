"""Phone-over-network loader — reference scripts/datasets/phone_server.py:
frames arrive as decoded arrays from the websocket server
(server/server.py) instead of the filesystem; `load_rgb` turns one pushed
{'rgb', 'timestamp'} record into a standard data packet (90° CCW
rotation like the other phone loaders)."""

import numpy as np

from .base import ImageFolderDataset, bgr_to_rgb01


class PhoneServerDataset(ImageFolderDataset):
    def _prepare(self):
        self.timestamps = []
        self.rgb_files = []

    def __len__(self):
        return 1000000  # live stream

    def load_rgb(self, record, idx):
        """record {'rgb': (H, W, 3) BGR uint8, 'timestamp': float} ->
        data packet keyed by stream index."""
        import cv2
        raw = cv2.rotate(np.asarray(record["rgb"]),
                         cv2.ROTATE_90_COUNTERCLOCKWISE)
        img = cv2.resize(raw, (self.w, self.h))
        rgb = bgr_to_rgb01(img)
        self.timestamps.append(float(record["timestamp"]))
        return {"timestamp": float(idx), "rgb": rgb,
                "intrinsic": self._intrinsic()}

    def __getitem__(self, idx):
        raise RuntimeError("phone_server is push-driven: frames are "
                           "delivered by server.server via load_rgb()")


def get_dataset(cfg):
    return PhoneServerDataset(cfg)
