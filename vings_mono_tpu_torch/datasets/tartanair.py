"""TartanAir loader: SLAM streaming (data contract like the other loaders)
plus the DROID *training* side — covisibility frame-graph sampling like the
reference's RGBD training datasets (frontend/data_readers/base.py:19-155,
tartan.py:18-108)."""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import ImageFolderDataset


class TartanAirDataset(ImageFolderDataset):
    def _prepare(self):
        root = self.cfg["dataset"]["root"]
        self.rgb_files = sorted(glob.glob(
            os.path.join(root, "image_left", "*.png")))
        self.timestamps = list(range(len(self.rgb_files)))
        self.depth_dir = os.path.join(root, "depth_left")
        if os.path.isdir(self.depth_dir) and \
                self.cfg["dataset"].get("use_depth", False):
            self.depth_files = sorted(glob.glob(
                os.path.join(self.depth_dir, "*.npy")))

    def _read_depth(self, path):
        # depth_left/ holds .npy arrays, which cv2.imread cannot read
        return np.load(path)

    def load_gt_dict(self):
        root = self.cfg["dataset"]["root"]
        pose_path = os.path.join(root, "pose_left.txt")
        if not os.path.exists(pose_path):
            return None
        data = np.loadtxt(pose_path)   # NED [x y z qx qy qz qw]
        from scipy.spatial.transform import Rotation
        n = len(data)
        c2ws = np.tile(np.eye(4), (n, 1, 1))
        # NED -> camera convention remap (the standard TartanAir transform)
        P = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)
        for i, row in enumerate(data):
            R = Rotation.from_quat(row[3:7]).as_matrix()
            c2ws[i, :3, :3] = P @ R @ P.T
            c2ws[i, :3, 3] = P @ row[0:3]
        return {"timestamps": np.arange(n, dtype=np.float64), "c2ws": c2ws}


def get_dataset(cfg):
    return TartanAirDataset(cfg)


# ---------------------------------------------------------------------------
# training-side covisibility graph sampling (data_readers/base.py:19-155)

def build_frame_graph(poses_w2c, disps, intrinsics, max_flow=256.0,
                      stride=8):
    """Mean induced-flow distance matrix between all frame pairs -> edges
    with distance < max_flow. poses (P,7), disps (P,h,w) subsampled."""
    import torch
    from ..ops import projective as pops
    P = poses_w2c.shape[0]
    d_small = disps[:, ::stride // 4 or 1, ::stride // 4 or 1]
    intr = intrinsics / (stride // 4 or 1)
    ii, jj = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    m = ii.reshape(-1) != jj.reshape(-1)

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32)
    d = pops.frame_distance(f32(poses_w2c), f32(d_small), f32(intr),
                            torch.as_tensor(ii.reshape(-1)[m]),
                            torch.as_tensor(jj.reshape(-1)[m]), beta=1.0)
    D = np.full((P, P), np.inf)
    D[ii.reshape(-1)[m], jj.reshape(-1)[m]] = d.numpy()
    return D


def sample_covisible_clip(D, n_frames=7, thresh=24.0, rng=None):
    """Random walk over the covisibility graph: each next frame is a random
    neighbor within flow distance `thresh` (base.py __getitem__ sampling)."""
    rng = rng or np.random.default_rng()
    P = D.shape[0]
    cur = int(rng.integers(0, P))
    out = [cur]
    for _ in range(n_frames - 1):
        nbr = np.where(D[cur] < thresh)[0]
        nbr = nbr[~np.isin(nbr, out)]
        if len(nbr) == 0:
            nbr = np.asarray([min(cur + 1, P - 1)])
        cur = int(rng.choice(nbr))
        out.append(cur)
    return np.asarray(out)


def augment_rgb(rng, rgb, brightness=0.2, contrast=0.2, saturation=0.2):
    """Photometric augmentation (data_readers/augmentation.py:7)."""
    out = np.asarray(rgb, np.float32)
    out = out * (1 + (rng.random() * 2 - 1) * contrast)
    out = out + (rng.random() * 2 - 1) * brightness
    mean = out.mean(axis=-1, keepdims=True)
    out = mean + (out - mean) * (1 + (rng.random() * 2 - 1) * saturation)
    return np.clip(out, 0, 1)
