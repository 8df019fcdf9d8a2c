"""Dataset contract:

  get_dataset(cfg) -> dataset
  dataset[idx] -> data_packet {'timestamp': float,
                               'rgb': (H, W, 3) float32 RGB in [0,1],
                               'intrinsic': (4,) [fx, fy, cx, cy] at the
                                            resized resolution,
                               optional 'depth': (H, W) metric}
  dataset.preload_imu() -> (M, 7) [t, gyro_xyz(deg/s), acc_xyz] (zeros for VO)
  dataset.preload_camtimestamp() -> (N, 1)
  dataset.c2i -> (4, 4) camera->IMU extrinsic
  dataset.load_gt_dict() -> {'timestamps', 'c2ws'} when ground truth exists

Packets are channel-last float [0,1] numpy arrays; the tracker uploads and
normalizes them. The image-folder loaders read and resize with OpenCV,
imported where a frame is read: a loader raises ImportError without it.
"""

from __future__ import annotations

import glob
import importlib
import os
import time

import numpy as np


def get_dataset(cfg):
    """importlib dispatch on `dataset.module` inside this package."""
    module = cfg["dataset"]["module"]
    mod = importlib.import_module(f"{__package__}.{module}")
    return mod.get_dataset(cfg)


def bgr_to_rgb01(img):
    """cv2's (H, W, 3) uint8 BGR -> float32 RGB in [0, 1]."""
    return np.ascontiguousarray(img[..., ::-1]).astype(np.float32) / 255.0


def scaled_intrinsic(ic, h, w):
    """[fx, fy, cx, cy] of the config's `intrinsic` block at an (h, w)
    image. The block names rows u and columns v (fu, cu along H; fv, cv
    along W), so fx is fv scaled by the width and fy is fu scaled by the
    height."""
    u_scale = h / ic["H"]
    v_scale = w / ic["W"]
    return np.asarray([ic["fv"] * v_scale, ic["fu"] * u_scale,
                       ic["cv"] * v_scale, ic["cu"] * u_scale], np.float32)


def read_bgr(path):
    """cv2.imread that raises FileNotFoundError where it cannot decode."""
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cv2 could not read {path}")
    return img


def load_rgb(path, resized_hw):
    import cv2
    h, w = resized_hw
    return bgr_to_rgb01(cv2.resize(read_bgr(path), (w, h)))


class ImageFolderDataset:
    """Common scaffolding: a list of (timestamp, rgb path [, depth path])."""

    rotate_ccw = False  # phone/mobile captures are landscape-rotated

    def __init__(self, cfg):
        self.cfg = cfg
        self.h, self.w = (int(cfg["frontend"]["image_size"][0]),
                          int(cfg["frontend"]["image_size"][1]))
        self.c2i = np.eye(4)
        self.depth_scale = 1.0
        self.timestamps = []
        self.rgb_files = []
        self.depth_files = None
        self._prepare()

    def _prepare(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.rgb_files)

    def _intrinsic(self):
        return scaled_intrinsic(self.cfg["intrinsic"], self.h, self.w)

    def _load_rgb(self, idx):
        if self.rotate_ccw:
            import cv2
            img = cv2.rotate(read_bgr(self.rgb_files[idx]),
                             cv2.ROTATE_90_COUNTERCLOCKWISE)
            return bgr_to_rgb01(cv2.resize(img, (self.w, self.h)))
        return load_rgb(self.rgb_files[idx], (self.h, self.w))

    def __getitem__(self, idx):
        pkt = {
            "timestamp": float(self.timestamps[idx]),
            "rgb": self._load_rgb(idx),
            "intrinsic": self._intrinsic(),
        }
        if self.depth_files is not None:
            pkt["depth"] = self._load_depth(self.depth_files[idx])
        return pkt

    def _read_depth(self, path):
        import cv2
        return cv2.imread(path, cv2.IMREAD_UNCHANGED)

    def _load_depth(self, path):
        import cv2
        d = cv2.resize(self._read_depth(path).astype(np.float32),
                       (self.w, self.h), interpolation=cv2.INTER_NEAREST)
        return d / self.depth_scale

    def preload_camtimestamp(self):
        return np.asarray(self.timestamps, np.float64)[:, None]

    def preload_imu(self):
        imu = np.zeros((len(self.timestamps), 7))
        imu[:, 0] = np.asarray(self.timestamps)
        return imu

    def load_gt_dict(self):
        root = self.cfg["dataset"]["root"]
        return load_pose_dir_gt(os.path.join(root, "pose"))


def load_pose_dir_gt(pose_dir, stem=lambda f: f.replace(".txt", "")):
    """gt layout shared by most reference loaders: pose/<t>.txt 4x4 c2ws."""
    if not os.path.isdir(pose_dir):
        return None
    files = sorted(os.listdir(pose_dir))
    c2ws = np.asarray([np.loadtxt(os.path.join(pose_dir, f))
                       for f in files])
    ts = np.asarray([float(stem(f)) for f in files])
    order = np.argsort(ts)
    return {"timestamps": ts[order], "c2ws": c2ws[order]}


class GlobVODataset(ImageFolderDataset):
    """Folder-of-frames visual-only dataset, the shape shared by most of
    the VO loaders (waymo, hierarchical, pocket, meganerf, ...): frames
    from one glob pattern, frame-index timestamps, zero IMU, identity
    extrinsic, gt in pose/<t>.txt.

    Subclasses set `subdir` / `pattern` (and optionally `sort_key`)."""

    subdir = "color"
    pattern = "*.jpg"
    sort_key = None  # default lexicographic

    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        files = glob.glob(os.path.join(root, self.subdir, self.pattern))
        self.rgb_files = sorted(files, key=self.sort_key)
        self.timestamps = list(range(len(self.rgb_files)))


class LiveFolderDataset(GlobVODataset):
    """Live capture folder that keeps growing while SLAM runs (the phone
    and mobile loaders): unbounded length, re-scan the folder on every
    fetch and poll until the requested frame lands on disk and decodes
    (a frame still being written is read again at the next poll)."""

    subdir = "cam0"
    pattern = "*.png"
    rotate_ccw = True
    poll_s = 0.1

    def __len__(self):
        return 1000000  # live stream: bounded only by the run

    def __getitem__(self, idx):
        while True:
            self._prepare()
            if idx < len(self.rgb_files):
                try:
                    return super().__getitem__(idx)
                except FileNotFoundError:
                    pass
            time.sleep(self.poll_s)
