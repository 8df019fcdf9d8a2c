"""Loop rectification:

* `rectify_poses` — per-edge 3-vector translation scales over the drifted
  chain, optimized with scipy L-BFGS-B on the host under a loop-endpoint
  constraint + smoothness, then the chain is re-composed. Rotations are
  corrected by distributing the residual rotation along the chain.
* `rectify_gaussians` — rigid re-anchoring of every Gaussian by its
  attributed keyframe's pose correction, on the device, with low-score
  pruning.
* `rectify_tracker` — write corrected poses into the save buffers and the
  live window, optionally with depth rendered off the corrected map.
* `retrain_gaussians` — photometric refinement of the re-anchored map on
  the saved keyframes at their corrected poses.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mapper.state import kill_rows
from ..ops import lie, quat_wxyz
from ..tracker.imu import so3_exp, so3_log


def rectify_poses(c2ws, idx_hist, idx_cur, target_c2w, smooth=1.0,
                  anchor=100.0):
    """c2ws (N,4,4) drifted; frames idx_hist..idx_cur form the loop chain;
    target_c2w is the PnP-recovered pose for idx_cur. Returns corrected
    (N,4,4) — frames before idx_hist stay fixed; frames after idx_cur get
    the endpoint correction rigidly. Host f64."""
    from scipy.optimize import minimize

    c2ws = np.asarray(c2ws, np.float64)
    a, b = int(idx_hist), int(idx_cur)
    n_edges = b - a
    if n_edges < 1:
        return c2ws.copy()

    # chain of local deltas
    rel = [np.linalg.inv(c2ws[i]) @ c2ws[i + 1] for i in range(a, b)]
    rel_t = np.stack([r[:3, 3] for r in rel])
    rel_R = [r[:3, :3] for r in rel]

    # distribute the rotation residual uniformly along the chain
    R_end_cur = c2ws[b][:3, :3]
    R_end_tgt = np.asarray(target_c2w)[:3, :3]
    dphi = so3_log(R_end_cur.T @ R_end_tgt)
    rel_R = [R @ so3_exp(dphi / n_edges) for R in rel_R]

    def compose(alphas):
        out = [c2ws[a]]
        for k in range(n_edges):
            d = np.eye(4)
            d[:3, :3] = rel_R[k]
            d[:3, 3] = rel_t[k] * alphas[k]
            out.append(out[-1] @ d)
        return out

    tgt_t = np.asarray(target_c2w)[:3, 3]

    def cost(x):
        al = x.reshape(n_edges, 3)
        end = compose(al)[-1]
        c = anchor * np.sum((end[:3, 3] - tgt_t) ** 2)
        c += smooth * np.sum((al[1:] - al[:-1]) ** 2) if n_edges > 1 else 0
        c += 0.01 * np.sum((al - 1.0) ** 2)
        return c

    res = minimize(cost, np.ones(n_edges * 3), method="L-BFGS-B",
                   options={"maxiter": 200})
    chain = compose(res.x.reshape(n_edges, 3))

    out = c2ws.copy()
    for k, i in enumerate(range(a, b + 1)):
        out[i] = chain[k]
    # rigidly carry the endpoint correction to any later frames
    corr = chain[-1] @ np.linalg.inv(c2ws[b])
    for i in range(b + 1, len(c2ws)):
        out[i] = corr @ c2ws[i]
    return out


@torch.no_grad()
def _transform_gaussians(xyz, quat, globalkf_id, old_c2ws, new_c2ws):
    """Per-Gaussian rigid transform T_k = new_c2w[k] @ inv(old_c2w[k]) of
    its attributed keyframe (f32, on the Gaussians' device)."""
    T = new_c2ws @ torch.linalg.inv(old_c2ws)          # (K, 4, 4)
    gid = globalkf_id.long().clamp(0, T.shape[0] - 1)
    R, t = T[:, :3, :3], T[:, :3, 3]
    xyz_new = torch.einsum("nij,nj->ni", R[gid], xyz) + t[gid]
    q_rot = quat_wxyz.from_xyzw(lie.matrix_to_quat(R))[gid]
    quat_new = quat_wxyz.mul(q_rot, quat_wxyz.normalize(quat))
    return xyz_new, quat_new


@torch.no_grad()
def rectify_gaussians(mapper, old_c2ws, new_c2ws, score_prune=0.1):
    """Re-anchor the map after a loop closure, in place; prunes Gaussians
    with tiny accumulated importance. Returns the number pruned."""
    s = mapper.state

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=s.xyz.device)

    xyz, quat = _transform_gaussians(s.xyz, s.quat, s.globalkf_id,
                                     dev(old_c2ws), dev(new_c2ws))
    s.xyz.copy_(xyz)
    s.quat.copy_(quat)
    kill = s.alive & (s.globalkf_max_scores < score_prune)
    mapper.state = kill_rows(s, kill)
    # the teleport invalidates every cached tile assignment: the binning
    # stores them by Gaussian index, so stale rows would rasterize moved
    # Gaussians in their OLD tiles
    mapper.invalidate_binning()
    return int(kill.sum())


@torch.no_grad()
def rectify_tracker(tracker, new_c2ws, mapper=None, intrinsic=None,
                    loop_start=0, loop_end=None):
    """Write the corrected keyframe poses back: save buffers (host) + live
    window (device). new_c2ws covers global kf ids [0, len).

    When `mapper` (+ `intrinsic`) is given, also rewrite the saved
    disparities over the rectified loop span [loop_start, loop_end]: depth
    rendered from the corrected map replaces disps_up_save where covered,
    and the 8x8-block center 2x2 mean pools it into disps_save. The span's
    renders stay on the device and cross to the host in one copy. The live
    rows inside the span are then synced from the save buffers."""
    video = tracker.video
    n_save = video.count_save
    n_total = len(new_c2ws)
    w2cs = np.linalg.inv(np.asarray(new_c2ws))
    tq = lie.se3_from_matrix(torch.as_tensor(w2cs,
                                             dtype=torch.float32)).numpy()
    video.poses_save[:min(n_save, n_total)] = tq[:min(n_save, n_total)]

    if mapper is not None and intrinsic is not None:
        # the save arrays are indexed by global kf id with headroom, so the
        # rewrite spans live-range ids too
        cap = len(video.poses_save)
        end = min(n_total, cap) if loop_end is None \
            else min(loop_end + 1, n_total, cap)
        span = range(int(loop_start), end)
        if len(span):
            depth = torch.stack([mapper.render_at(w2cs[g], intrinsic)[
                "depth"][0] for g in span]).cpu().numpy()
            for k, g in enumerate(span):
                disp = np.where(depth[k] > 0,
                                1.0 / np.clip(depth[k], 1e-6, None),
                                video.disps_up_save[g])
                video.disps_up_save[g] = disp
                H, W = disp.shape
                blocks = disp.reshape(H // 8, 8, W // 8, 8).transpose(
                    0, 2, 1, 3)
                video.disps_save[g] = blocks[..., 3:5, 3:5].reshape(
                    H // 8, W // 8, -1).mean(-1)

    n_live = min(video.counter, n_total - n_save)
    if n_live > 0:
        b = video.bufs
        b.poses[:n_live] = torch.as_tensor(tq[n_save:n_save + n_live],
                                           device=b.poses.device)
        if mapper is not None and intrinsic is not None and \
                loop_end is not None and loop_end >= n_save:
            # live rows inside the rectified span get the rewritten depths
            s, e = n_save, min(loop_end + 1, n_save + n_live)
            if e > s:
                b.disps[:e - s] = torch.as_tensor(video.disps_save[s:e],
                                                  device=b.disps.device)
                b.disps_up[:e - s] = torch.as_tensor(
                    video.disps_up_save[s:e], device=b.disps.device)
        # the bend changed live relative poses: stored edge targets now
        # encode the OLD geometry and would drag BA back
        if getattr(tracker, "graph", None) is not None:
            tracker.graph.reseed_targets()
        # the prefetched keyframe-decision distance was computed from
        # PRE-rectification poses; a post-closure keyframe decision must
        # not consume it
        if getattr(tracker, "frontend", None) is not None:
            tracker.frontend._kf_dist_prefetch = None


def retrain_gaussians(mapper, video, intrinsic, loop_start=0,
                      loop_end=None):
    """Post-rectification map refinement over the saved keyframes: train
    the re-anchored Gaussians against the saved images at the CORRECTED
    poses, photometric-only (depth-loss weight 0: saved depths are
    scale-drifted around a loop), through `train_on_window`, 2 iterations
    per keyframe in the span (at least 4), in kf_capacity-sized windows.
    Returns the number of keyframes trained on."""
    ns = video.count_save
    if loop_end is None:
        loop_end = ns - 1
    loop_end = min(loop_end, ns - 1)
    if loop_end < loop_start:
        return 0
    ta = dict(mapper.cfg["training_args"])
    weights = {**ta["loss_weights"], "depth_loss": 0.0}
    kc = mapper.kf_capacity
    n_done = 0
    ids = list(range(int(loop_start), int(loop_end) + 1))
    for s in range(0, len(ids), kc):
        win = ids[s:s + kc]
        depths = (1.0 / (video.disps_up_save[win] + 1e-4))[..., None]
        depths[depths > float(mapper.cfg["middleware"]["max_depth"])] = 0.0
        w2cs = lie.se3_matrix(torch.as_tensor(video.poses_save[win],
                                              dtype=torch.float32)).numpy()
        viz = {
            "images": video.images_save[win],
            "depths": depths,
            "depths_cov": video.depths_cov_up_save[win][..., None],
            "poses": np.linalg.inv(w2cs),
            "viz_out_idx_to_f_idx": video.tstamp_save[win],
            "intrinsic": intrinsic,
            "global_kf_id": np.asarray(win, np.int64),
        }
        mapper.train_on_window(viz, iters=max(2 * len(win), 4),
                               weights=weights)
        n_done += len(win)
    return n_done
