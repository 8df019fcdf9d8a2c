"""Evaluation harness: ATE rmse against the dataset's ground truth and
render PSNR over saved keyframes (Umeyama-aligned monocular ATE; PSNR over
the keyframes' valid-depth pixels, as the mapper's online PSNR).

Usage: python -m vings_mono_tpu_torch.runners.evaluate <config.yaml>
           <run_dir>
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch


def eval_trajectory(run_dir, dataset):
    """ATE rmse of the trajectory `run_dir/droid_c2w/*.txt` (one c2w per
    keyframe, named by timestamp) against `dataset.load_gt_dict()`; None
    without ground truth or with fewer than 3 keyframes."""
    from ..utils.trajectory import ate_rmse
    files = sorted(glob.glob(os.path.join(run_dir, "droid_c2w", "*.txt")))
    ts = [float(os.path.basename(f)[:-4]) for f in files]
    c2ws = [np.loadtxt(f) for f in files]
    gt = dataset.load_gt_dict()
    if gt is None or len(ts) < 3:
        return None
    return ate_rmse(ts, c2ws, gt["timestamps"], gt["c2ws"])


@torch.no_grad()
def eval_psnr(mapper, tracker, n_eval=10):
    """Mean render PSNR over n_eval evenly spaced keyframes of the save
    buffer (the live window when nothing has rolled out yet), each rendered
    through `mapper.render_at` at its tracked pose; None without
    keyframes."""
    from ..mapper.losses import psnr
    from ..ops import lie
    video = tracker.video
    n = video.count_save
    if n > 0:
        poses = torch.from_numpy(video.poses_save[:n])
        images = torch.from_numpy(video.images_save[:n])
        disps_up = torch.from_numpy(video.disps_up_save[:n])
    else:
        n = video.counter
        if n == 0:
            return None
        poses, images, disps_up = (x[:n] for x in (
            video.bufs.poses, video.bufs.images, video.bufs.disps_up))
    idx = np.linspace(0, n - 1, min(n_eval, n)).astype(int)
    # the JAX package's index map: the intrinsic dicts' fu/cu are the row
    # axis, so fu takes fy and cu takes cy
    intr = video.bufs.intrinsics[0].cpu().numpy() * 8.0
    intr_d = {"fu": float(intr[1]), "fv": float(intr[0]),
              "cu": float(intr[3]), "cv": float(intr[2]),
              "H": video.ht, "W": video.wd}
    dev = mapper.device
    vals = []
    for i in idx:
        w2c = lie.se3_matrix(poses[i].to(dev, torch.float32))
        rets = mapper.render_at(w2c, intr_d)
        gt = images[i].to(dev).movedim(-1, 0)
        vals.append(psnr(rets["rgb"], gt, disps_up[i].to(dev) > 0))
    return float(torch.stack(vals).mean())


def main(argv=None):
    from ..datasets.base import get_dataset
    from ..utils.config import load_config
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("run_dir")
    args = p.parse_args(argv)
    dataset = get_dataset(load_config(args.config))
    ate = eval_trajectory(args.run_dir, dataset)
    print(json.dumps({"ate_rmse_m": ate}))


if __name__ == "__main__":
    main()
