"""Tracker -> mapper data contract: `judge_and_package`.

Produces the `viz_out` dict: images (K,H,W,3 in [0,1]), depths, depths_cov
(K,H,W,1), poses (K,4,4 c2w), viz_out_idx_to_f_idx (timestamps), intrinsic
dict, pixel_mask, global_kf_id — padded to a FIXED window capacity (cfg
mapper.kf_capacity) with `n_valid`. The tensors stay on the tracker's
device: the mapper takes them as they are.

Variants:
  * v3 (default) — the covisible-window packaging: frames >= t0 that source
    an edge, minus the newest;
  * nerfslam (mode: vo_nerfslam or middleware.variant: nerfslam) — same
    gating math as v3 (depth > max_depth OR cov > cov_times*median, rgb
    zeroed with depth), but a different SELECTION: every keyframe of the
    current BA window, INCLUDING the newest frame;
  * v0_kitti360 (middleware.variant) — the save-buffer + sky-crop
    packaging: the last 8 keyframes the window has rolled out (their depths
    are final), only the bottom `new_H` rows, `cu` re-centred. It reads the
    host save buffers, so its arrays are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import lie


def _median(x):
    """Median over the last axis that averages the two middle values of an
    even count (torch.median returns the lower one)."""
    n = x.shape[-1]
    lo = torch.kthvalue(x, (n - 1) // 2 + 1, dim=-1).values
    hi = torch.kthvalue(x, n // 2 + 1, dim=-1).values
    return 0.5 * (lo + hi)


def _package_kernel(bufs, sel, *, k_cap, max_depth, cov_times):
    rgbs = bufs.images[sel]                              # (K, H, W, 3)
    depths = (1.0 / (bufs.disps_up[sel] + 1e-6))[..., None]
    covs = bufs.depths_cov_up[sel][..., None]
    K = k_cap
    cov_med = _median(covs.reshape(K, -1))[:, None, None, None]
    zero = (depths > max_depth) | (covs > cov_times * cov_med)
    depths = torch.where(zero, torch.zeros_like(depths), depths)
    cov_fill = torch.where(depths > 0, covs, torch.zeros_like(covs)).max()
    covs = torch.where(depths == 0, cov_fill, covs)
    rgbs = torch.where(depths == 0, torch.zeros_like(rgbs), rgbs)
    c2ws = lie.se3_matrix(lie.se3_inv(bufs.poses[sel]))
    return rgbs, depths, covs, c2ws


@torch.no_grad()
def _package(tracker, cfg, valid_localkf):
    """The viz_out dict for the selected local keyframes."""
    video = tracker.video
    k_cap = int(cfg["mapper"]["kf_capacity"])
    if len(valid_localkf) > k_cap:
        valid_localkf = valid_localkf[-k_cap:]
    K = len(valid_localkf)
    sel = np.full(k_cap, valid_localkf[-1], np.int64)
    sel[:K] = valid_localkf

    # the save buffers hold exactly the rolled-out keyframes, so global id =
    # count_save + local index
    tracker.local_to_global_bias = video.count_save
    global_kf_id = sel + video.count_save

    # one upload: the selection and the global ids
    dev = torch.from_numpy(np.stack([sel, global_kf_id])).to(
        video.device, non_blocking=True)
    mw = cfg["middleware"]
    rgbs, depths, covs, c2ws = _package_kernel(
        video.bufs, dev[0], k_cap=k_cap,
        max_depth=float(mw["max_depth"]), cov_times=float(mw["cov_times"]))

    H, W = video.ht, video.wd
    # intrinsics are constant per run — the device-to-host pull is cached
    intrinsic = getattr(tracker, "_intr_cache", None)
    if intrinsic is None:
        intr = video.bufs.intrinsics[0].cpu().numpy() * 8.0
        # buffer intrinsics are [fx fy cx cy]; the viz_out dict uses the
        # reference's row-major fu/cu naming (fu = fy)
        intrinsic = {"fu": float(intr[1]), "fv": float(intr[0]),
                     "cu": float(intr[3]), "cv": float(intr[2]),
                     "H": int(H), "W": int(W)}
        tracker._intr_cache = intrinsic
    tstamps = np.asarray([video.tstamps_host[i] for i in sel])

    mask = getattr(tracker, "_pixel_mask_cache", None)
    if mask is None or mask.shape != (k_cap, H, W):
        mask = torch.ones((k_cap, H, W), dtype=torch.bool,
                          device=video.device)
        tracker._pixel_mask_cache = mask
    return {
        "images": rgbs,
        "depths": depths,
        "depths_cov": covs,
        "poses": c2ws,
        "viz_out_idx_to_f_idx": tstamps[:K],
        "intrinsic": intrinsic,
        "pixel_mask": mask,
        "global_kf_id": dev[1].to(torch.int32),
        # host copy: the mapper's bookkeeping needs these on the host
        "global_kf_id_host": global_kf_id,
        "valid_localkf_id": valid_localkf,
        "n_valid": K,
    }


def judge_and_package_nerfslam(tracker, cfg):
    """Dirty-window packaging: ALL keyframes of the current BA window,
    newest frame included, so the mapper refreshes poses/depths for
    keyframes that moved, not only newly-settled ones. Selection differs
    from v3; the per-pixel gating is shared."""
    fe = tracker.frontend
    graph = tracker.graph
    if not fe.new_frame_added or len(graph.ii) == 0:
        return None
    lo = max(0, int(graph.ii.min()))
    valid_localkf = np.arange(lo, fe.t1)
    if len(valid_localkf) == 0:
        return None
    return _package(tracker, cfg, valid_localkf)


def judge_and_package_v0_kitti360(tracker, cfg=None):
    """KITTI-360 packaging variant: the mapper trains on the last 8
    *marginalized* keyframes from the host save buffers (their depths are
    final: no longer being optimized), and the sky band is cropped off:
    only the bottom `new_H` rows are packaged, with cu re-centered.
    new_H = image_size[0] * (intrinsic.new_H / intrinsic.H), rounded down
    to a multiple of 8."""
    cfg = cfg if cfg is not None else tracker.cfg
    video = tracker.video
    if not tracker.frontend.new_frame_added:
        return None
    ns = video.count_save
    k_cap = int(cfg["mapper"]["kf_capacity"])
    sel = np.arange(max(ns - 8, 0), ns)
    if len(sel) == 0:
        return None
    K = min(len(sel), k_cap)
    sel = sel[-K:]

    H, W = video.ht, video.wd
    ic = cfg["intrinsic"]
    u_scale = float(ic.get("new_H", ic["H"])) / float(ic["H"])
    new_H = int(u_scale * H) // 8 * 8
    new_cu = new_H / 2.0

    depths = (1.0 / (video.disps_up_save[sel] + 1e-6))[..., None]
    covs = video.depths_cov_up_save[sel][..., None]
    cov_med = np.median(covs.reshape(K, -1), axis=1)[:, None, None, None]
    mw = cfg["middleware"]
    zero = (depths > float(mw["max_depth"])) | \
        (covs > float(mw["cov_times"]) * cov_med)
    depths = np.where(zero, 0.0, depths)
    rgbs = np.where(depths == 0, 0.0, video.images_save[sel])
    c2ws = lie.se3_matrix(lie.se3_inv(
        torch.from_numpy(video.poses_save[sel]))).numpy()

    intr = video.bufs.intrinsics[0].cpu().numpy() * 8.0
    intrinsic = {"fu": float(intr[1]), "fv": float(intr[0]),
                 "cu": float(new_cu), "cv": float(intr[2]),
                 "H": int(new_H), "W": int(W)}

    def pad(x):
        if x.shape[0] == k_cap:
            return x
        reps = [k_cap - x.shape[0]] + [1] * (x.ndim - 1)
        return np.concatenate([x, np.tile(x[-1:], reps)], axis=0)

    global_kf_id = pad(np.asarray(sel, np.int64))
    return {
        "images": pad(rgbs[:, -new_H:]),
        "depths": pad(depths[:, -new_H:]),
        "depths_cov": pad(covs[:, -new_H:]),
        "poses": pad(c2ws),
        "viz_out_idx_to_f_idx": video.tstamp_save[sel],
        "intrinsic": intrinsic,
        "pixel_mask": np.ones((k_cap, new_H, W), bool),
        "global_kf_id": global_kf_id,
        "global_kf_id_host": global_kf_id,
        "valid_localkf_id": sel,
        "n_valid": K,
    }


def judge_and_package(tracker, cfg=None):
    cfg = cfg if cfg is not None else tracker.cfg
    variant = cfg.get("middleware", {}).get("variant")
    if variant == "v0_kitti360":
        return judge_and_package_v0_kitti360(tracker, cfg)
    if variant == "nerfslam" or cfg.get("mode") == "vo_nerfslam":
        return judge_and_package_nerfslam(tracker, cfg)
    fe = tracker.frontend
    graph = tracker.graph
    if not fe.new_frame_added or len(graph.ii) == 0:
        return None

    t0 = max(1, int(graph.ii.min()) + 1)
    m = (graph.ii_inac >= t0 - graph.inac_range) & \
        (graph.jj_inac >= t0 - graph.inac_range)
    ii = np.concatenate([graph.ii_inac[m], graph.ii])
    cand = np.unique(ii[ii >= t0])
    valid_localkf = cand[:-1] if len(cand) > 1 else cand
    if len(valid_localkf) == 0:
        return None
    return _package(tracker, cfg, valid_localkf)


def to_host(viz_out):
    """A copy of a viz_out dict with every tensor copied to a numpy array on
    the host: what crosses a thread's queue, so that the tracker may go on
    writing its buffers while the mapper reads the window (the mapper
    uploads it again)."""
    return {k: v.detach().to("cpu", copy=True).numpy()
            if isinstance(v, torch.Tensor) else v
            for k, v in viz_out.items()}


@torch.no_grad()
def retrieve_to_tracker(viz_out, new_poses, tracker):
    """Write mapper-refined c2w poses back into the tracker window."""
    K = viz_out.get("n_valid", len(viz_out["valid_localkf_id"]))
    device = tracker.video.device
    sel = torch.as_tensor(np.asarray(viz_out["valid_localkf_id"][:K]),
                          device=device)
    new_poses = torch.as_tensor(new_poses, dtype=torch.float32,
                                device=device)
    w2c = torch.linalg.inv(new_poses[:K])
    tracker.video.bufs.poses[sel] = lie.se3_from_matrix(w2c)
