"""Visualization outputs: the rgbdnua 2x4 debug panel, whole-map BEV renders
with a time-colored trajectory, and the follow-cam BEV. Drawing is numpy
(and cv2 where it imports) on the host; rendering is the mapper's normal
device path.

Every function returns its uint8 image. Files are written only where cv2
imports, and `colorize` falls back to grayscale without matplotlib.
"""

from __future__ import annotations

import os

import numpy as np
import torch

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

# host-paged Gaussians per render of `vis_map`'s composite
HOST_CHUNK = 1 << 17


def host_array(x):
    """A tensor (wherever it lies) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def colorize(x, vmin=None, vmax=None, cmap="magma"):
    """(H, W) -> (H, W, 3) uint8 via a matplotlib colormap (grayscale
    fallback)."""
    x = np.asarray(host_array(x), np.float32)
    vmin = np.nanmin(x) if vmin is None else vmin
    vmax = np.nanmax(x) if vmax is None else vmax
    t = np.clip((x - vmin) / max(vmax - vmin, 1e-8), 0, 1)
    try:
        rgba = __import__("matplotlib").colormaps[cmap](t)
        return (rgba[..., :3] * 255).astype(np.uint8)
    except Exception:
        g = (t * 255).astype(np.uint8)
        return np.stack([g, g, g], -1)


def _chw_to_img(x):
    return np.clip(np.moveaxis(host_array(x), 0, -1), 0, 1)


def write_image(path, img):
    """Write an RGB uint8 image where cv2 imports; returns the path."""
    if cv2 is not None and path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]))
    return path


def rgbdnua_panel(pred, gt_rgb, gt_depth, gt_cov=None):
    """2x4 panel: [gt rgb | pred rgb | gt depth | pred depth] over
    [rendered normal | distortion | uncertainty | accum].
    pred: render() rets dict; gt_* channel-first arrays. Returns uint8
    image."""
    gt_rgb_i = (_chw_to_img(gt_rgb) * 255).astype(np.uint8)
    pred_rgb_i = (_chw_to_img(pred["rgb"]) * 255).astype(np.uint8)
    gt_depth = host_array(gt_depth)
    dmax = max(float(np.max(gt_depth)), 1e-3)
    gt_d = colorize(gt_depth[0], 0, dmax)
    pr_d = colorize(host_array(pred["depth"])[0], 0, dmax)
    nrm = ((np.moveaxis(host_array(pred["normal"]), 0, -1) * 0.5 + 0.5)
           * 255).astype(np.uint8)
    acc = colorize(host_array(pred["accum"])[0], 0, 1, "viridis")
    if gt_cov is not None:
        unc = colorize(host_array(gt_cov)[0], cmap="viridis")
    else:
        unc = np.zeros_like(gt_rgb_i)
    dist = colorize(host_array(pred["dist"])[0], cmap="viridis")
    top = np.concatenate([gt_rgb_i, pred_rgb_i, gt_d, pr_d], axis=1)
    bottom = np.concatenate([nrm, dist, unc, acc], axis=1)
    return np.concatenate([top, bottom], axis=0)


def save_rgbdnua(save_dir, frame_id, pred, gt_rgb, gt_depth, gt_cov=None):
    """The rgbdnua panel, written to rgbdnua/{frame_id:.6f}.png under
    save_dir; returns the panel."""
    panel = rgbdnua_panel(pred, gt_rgb, gt_depth, gt_cov)
    write_image(os.path.join(save_dir, "rgbdnua",
                             f"{float(frame_id):.6f}.png"), panel)
    return panel


def get_bev_c2w(c2ws, height_scale=1.5, min_height=10.0):
    """Bird's-eye camera above the trajectory centroid looking down,
    framing the whole path."""
    c2ws = np.asarray(c2ws)
    pos = c2ws[:, :3, 3]
    center = pos.mean(0)
    extent = float(np.max(pos.max(0) - pos.min(0))) if len(pos) > 1 else 1.0
    h = max(extent * height_scale, min_height)
    # the camera looks along its +z at the scene: place it "above" along
    # the first camera's up direction (-y)
    up_w = -c2ws[0][:3, 1]
    eye = center + up_w * h
    z = center - eye
    z = z / np.linalg.norm(z)
    x_ref = c2ws[0][:3, 0]
    x = x_ref - (x_ref @ z) * z
    x = x / max(np.linalg.norm(x), 1e-8)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def draw_trajectory(img, c2ws, bev_w2c, intr4, color_by_time=True):
    """Project camera centers into the BEV image and draw time-colored
    dots (cv2 only; without it the image is returned as it is)."""
    if cv2 is None or len(c2ws) == 0:
        return img
    fx, fy, cx, cy = intr4
    pos = np.asarray(c2ws)[:, :3, 3]
    bev_w2c = np.asarray(bev_w2c)
    pc = (bev_w2c[:3, :3] @ pos.T).T + bev_w2c[:3, 3]
    n = len(pos)
    for k, p in enumerate(pc):
        if not np.all(np.isfinite(p)) or p[2] <= 0.1:
            continue
        u = int(fx * p[0] / p[2] + cx)
        v = int(fy * p[1] / p[2] + cy)
        if 0 <= u < img.shape[1] and 0 <= v < img.shape[0]:
            t = k / max(n - 1, 1)
            col = (int(255 * (1 - t)), 64, int(255 * t))
            cv2.circle(img, (u, v), 2, col, -1)
    return img


def map_camera(c2ws, size):
    """`vis_map`'s camera: (w2c, intrinsic dict) of the bird's-eye view
    over the whole trajectory at size (H, W)."""
    H, W = size
    f = 0.7 * W
    return (np.linalg.inv(get_bev_c2w(c2ws)),
            {"fu": f, "fv": f, "cu": H / 2, "cv": W / 2, "H": H, "W": W})


def follow_camera(cur_c2w, size, height=12.0):
    """`vis_bev`'s camera: (w2c, intrinsic dict) `height` above the pose
    cur_c2w (along its -y), looking down, at size (H, W)."""
    H, W = size
    c2w = np.asarray(host_array(cur_c2w)).copy()
    eye = c2w[:3, 3] - c2w[:3, 1] * height
    z = c2w[:3, 3] - eye
    z = z / np.linalg.norm(z)
    x = c2w[:3, 0] - (c2w[:3, 0] @ z) * z
    x /= max(np.linalg.norm(x), 1e-8)
    y = np.cross(z, x)
    bev = np.eye(4)
    bev[:3, 0], bev[:3, 1], bev[:3, 2], bev[:3, 3] = x, y, z, eye
    f = 0.8 * W
    return (np.linalg.inv(bev),
            {"fu": f, "fv": f, "cu": H / 2, "cv": W / 2, "H": H, "W": W})


@torch.no_grad()
def vis_map(mapper, c2ws, save_path, size=(480, 640), storage=None):
    """Whole-map BEV render + trajectory overlay. With a storage manager,
    host-paged Gaussians are rendered in chunks of HOST_CHUNK and composited
    by max alpha."""
    from ..mapper.cameras import camera_from_intrinsic
    from ..ops.rasterizer import render as raw_render
    w2c, intr = map_camera(c2ws, size)
    rets = mapper.render_at(w2c, intr)
    rgb = rets["rgb"]
    alpha = rets["accum"]

    if storage is not None and storage.n_host > 0:
        dev = rgb.device
        cam = camera_from_intrinsic(
            torch.as_tensor(w2c, dtype=torch.float32, device=dev), intr)
        for s0 in range(0, storage.n_host, HOST_CHUNK):
            e0 = min(s0 + HOST_CHUNK, storage.n_host)
            r = raw_render(*(torch.as_tensor(storage.host[k][s0:e0],
                                             dtype=torch.float32, device=dev)
                             for k in ("xyz", "log_scale", "quat",
                                       "logit_opacity", "rgb")),
                           cam, **dict(mapper.render_kwargs))
            take = r["accum"] > alpha
            rgb = torch.where(take, r["rgb"], rgb)
            alpha = torch.where(take, r["accum"], alpha)

    img = (np.clip(np.moveaxis(host_array(rgb), 0, -1), 0, 1) * 255).astype(
        np.uint8)
    img = np.ascontiguousarray(img)
    draw_trajectory(img, c2ws, w2c,
                    (intr["fu"], intr["fv"], intr["cv"], intr["cu"]))
    write_image(save_path, img)
    return img


@torch.no_grad()
def vis_bev(mapper, cur_c2w, save_path, size=(320, 320), height=12.0):
    """Follow-cam BEV above the current pose."""
    rets = mapper.render_at(*follow_camera(cur_c2w, size, height))
    img = (np.clip(np.moveaxis(host_array(rets["rgb"]), 0, -1), 0, 1)
           * 255).astype(np.uint8)
    write_image(save_path, img)
    return img
