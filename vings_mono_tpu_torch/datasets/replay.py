"""viz_out replay loader — the counterpart of the reference's
record/replay mapping harness (scripts/datasets/pth.py + run_mapping.py):
streams recorded viz_out windows (.npz, one per keyframe event) back into
the mapper, decoupled from the tracker."""

import glob
import os

import numpy as np


class ReplayDataset:
    def __init__(self, cfg):
        self.cfg = cfg
        self.files = sorted(glob.glob(
            os.path.join(cfg["dataset"]["root"], "vizout_*.npz")))
        self.c2i = np.eye(4)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        z = np.load(self.files[idx])
        intr = z["intrinsic"]
        return {
            "images": z["images"],
            "depths": z["depths"],
            "depths_cov": z["depths_cov"],
            "poses": z["poses"],
            "viz_out_idx_to_f_idx": z["viz_out_idx_to_f_idx"],
            "intrinsic": {"fu": float(intr[0]), "fv": float(intr[1]),
                          "cu": float(intr[2]), "cv": float(intr[3]),
                          "H": int(intr[4]), "W": int(intr[5])},
            "pixel_mask": z["pixel_mask"] if "pixel_mask" in z else
            np.ones(z["depths"].shape[:3], bool),
            "global_kf_id": z["global_kf_id"],
        }


def save_viz_out(path, viz_out):
    """Write one viz_out window as .npz (debug_mode recorder); padded
    windows are trimmed to their valid keyframes."""
    intr = viz_out["intrinsic"]
    K = int(viz_out.get("n_valid",
                        np.asarray(viz_out["images"]).shape[0]))
    np.savez_compressed(
        path,
        images=np.asarray(viz_out["images"], np.float32)[:K],
        depths=np.asarray(viz_out["depths"], np.float32)[:K],
        depths_cov=np.asarray(viz_out["depths_cov"], np.float32)[:K],
        poses=np.asarray(viz_out["poses"], np.float32)[:K],
        viz_out_idx_to_f_idx=np.asarray(
            viz_out["viz_out_idx_to_f_idx"])[:K],
        intrinsic=np.asarray([intr["fu"], intr["fv"], intr["cu"],
                              intr["cv"], intr["H"], intr["W"]], np.float64),
        pixel_mask=np.asarray(viz_out["pixel_mask"], bool)[:K],
        global_kf_id=np.asarray(viz_out["global_kf_id"], np.int64)[:K],
    )


def get_dataset(cfg):
    return ReplayDataset(cfg)
