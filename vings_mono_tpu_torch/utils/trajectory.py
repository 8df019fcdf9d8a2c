"""Trajectory export in the reference's format: one c2w 4x4 txt per
keyframe under droid_c2w/, named by timestamp, plus keyframelist.txt."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import lie


def tracker_c2ws(tracker):
    """All keyframe (timestamp, c2w) pairs: host save buffers + live
    window."""
    video = tracker.video
    out_ts, out_c2w = [], []
    n = video.count_save
    if n > 0:
        w2c = torch.from_numpy(video.poses_save[:n])
        c2w = lie.se3_matrix(lie.se3_inv(w2c)).numpy()
        out_ts.extend(video.tstamp_save[:n].tolist())
        out_c2w.extend(list(c2w))
    live = video.c2w_matrices()
    out_ts.extend(video.tstamps_host)
    out_c2w.extend(list(live))
    return out_ts, out_c2w


def save_trajectory(tracker, save_dir):
    d = os.path.join(save_dir, "droid_c2w")
    os.makedirs(d, exist_ok=True)
    ts, c2ws = tracker_c2ws(tracker)
    for t, m in zip(ts, c2ws):
        np.savetxt(os.path.join(d, f"{t:.6f}.txt"), m)
    with open(os.path.join(save_dir, "keyframelist.txt"), "w") as f:
        for t in ts:
            f.write(f"{t:.6f}\n")
    return len(ts)


def ate_rmse(est_ts, est_c2ws, gt_ts, gt_c2ws, scale_align=True):
    """Umeyama-aligned absolute trajectory error (monocular: with scale)."""
    gt_ts = np.asarray(gt_ts)
    pairs = []
    for t, m in zip(est_ts, est_c2ws):
        k = int(np.argmin(np.abs(gt_ts - t)))
        if abs(gt_ts[k] - t) < 0.1:
            pairs.append((m[:3, 3], np.asarray(gt_c2ws[k])[:3, 3]))
    if len(pairs) < 3:
        return None
    P = np.asarray([p for p, _ in pairs]).T     # (3, N) est
    Q = np.asarray([q for _, q in pairs]).T     # (3, N) gt
    mp, mq = P.mean(1, keepdims=True), Q.mean(1, keepdims=True)
    Pc, Qc = P - mp, Q - mq
    U, S, Vt = np.linalg.svd(Qc @ Pc.T)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = (S * D.diagonal()).sum() / (Pc * Pc).sum() if scale_align else 1.0
    t = mq - s * R @ mp
    res = Q - (s * R @ P + t)
    return float(np.sqrt((res ** 2).sum(0).mean()))
