"""Dataset contract:

  get_dataset(cfg) -> dataset
  dataset[idx] -> data_packet {'timestamp': float,
                               'rgb': (H, W, 3) float32 RGB in [0,1],
                               'intrinsic': (4,) [fx, fy, cx, cy] at the
                                            resized resolution,
                               optional 'depth': (H, W) metric}
  dataset.preload_camtimestamp() -> (N, 1)
  dataset.c2i -> (4, 4) camera->IMU extrinsic
  dataset.load_gt_dict() -> {'timestamps', 'c2ws'} when ground truth exists

Packets are channel-last float [0,1]; the tracker normalizes internally.
Ported so far: the two procedural datasets and the keyframe replay; the
image-folder datasets are not.
"""

from __future__ import annotations

import importlib

PORTED = ("synthetic", "synthetic3d", "replay")


def get_dataset(cfg):
    """importlib dispatch on `dataset.module` inside this package."""
    module = cfg["dataset"]["module"]
    if module not in PORTED:
        raise NotImplementedError(
            f"dataset.module {module!r} is not ported yet (ported: "
            f"{', '.join(PORTED)})")
    mod = importlib.import_module(f"{__package__}.{module}")
    return mod.get_dataset(cfg)
