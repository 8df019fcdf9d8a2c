"""Mapper training loss — rebuild of the reference's get_loss: masked
L1+SSIM rgb, depth-covariance-weighted L1 depth, normal consistency vs
depth-propagated normals, sky alpha suppression, and the 2DGS distortion
regularizer."""

from __future__ import annotations

import torch

from ..ops.ssim import ssim
from .cameras import Camera, depth_to_normal

DEFAULT_WEIGHTS = {
    "rgb_loss": 1.0,
    "depth_loss": 0.1,
    "normal_loss": 0.05,
    "alpha_loss": 0.1,
    "dist_loss": 100.0,
}


def _nonzero_count(mask, times=1):
    return torch.clamp(torch.sum(mask) * times, min=1.0)


def masked_l1(pred, gt, mask):
    m = mask.to(pred.dtype)
    return torch.sum(torch.abs(pred - gt) * m[None]) / _nonzero_count(
        m, pred.shape[0])


def weighted_masked_l1(pred, gt, mask, weight):
    m = mask.to(pred.dtype) * weight
    return torch.sum(torch.abs(pred - gt) * m) / _nonzero_count(m)


def mapper_loss(pred, gt_rgb, gt_depth, gt_depth_cov, camera: Camera,
                weights=None, sky_rgb=None, pixel_mask=None):
    """pred: render() dict (camera-frame normals); gt_rgb (3,H,W) in [0,1],
    gt_depth/cov (1,H,W). Returns (total, metrics dict).

    Sky pixels are where gt_rgb sums to 0 (the middleware zeroes rgb at
    invalid depth); valid = not sky and depth > 0; depth is weighted by
    1/cov. sky_rgb (3,H,W), the sky-inclusive ground truth, switches the
    photometric term to the whole image (sky mode: pred is the map fused
    with the sky sphere). pixel_mask (H,W) bool excludes dynamic-object
    pixels from every term."""
    weights = {**DEFAULT_WEIGHTS, **(weights or {})}
    sky = torch.sum(gt_rgb, dim=0) == 0.0          # (H, W)
    valid = (~sky) & (gt_depth[0] > 0.0)
    if pixel_mask is not None:
        valid &= pixel_mask
        sky &= pixel_mask

    if sky_rgb is not None:
        ones = torch.ones_like(valid) if pixel_mask is None else pixel_mask
        l1 = masked_l1(pred["rgb"], sky_rgb, ones)
        ssim_val = ssim(pred["rgb"], sky_rgb, ones)
    else:
        l1 = masked_l1(pred["rgb"], gt_rgb, valid)
        ssim_val = ssim(pred["rgb"], gt_rgb, valid)
    rgb_loss = 0.8 * l1 + 0.2 * (1.0 - ssim_val)

    # normal consistency: rendered normal vs normals from the rendered depth
    # (both camera frame; the dot product is rotation invariant)
    surf_n = depth_to_normal(pred["depth"][0], camera)          # (H, W, 3)
    rend_n = torch.movedim(pred["normal"], 0, -1)               # (H, W, 3)
    normal_loss = torch.sum((1.0 - torch.sum(rend_n * surf_n, dim=-1))
                            * valid) / _nonzero_count(valid)

    alpha_loss = torch.sum(pred["accum"][0] * sky) / _nonzero_count(sky)

    inv_cov = 1.0 / torch.clamp(gt_depth_cov, min=1e-8)
    depth_loss = weighted_masked_l1(pred["depth"], gt_depth, valid[None],
                                    inv_cov)

    dist_loss = torch.sum(pred["dist"][0] * valid) / _nonzero_count(valid)

    total = (weights["rgb_loss"] * rgb_loss
             + weights["normal_loss"] * normal_loss
             + weights["alpha_loss"] * alpha_loss
             + weights["depth_loss"] * depth_loss
             + weights["dist_loss"] * dist_loss)
    metrics = {"rgb": rgb_loss, "l1": l1, "ssim": ssim_val,
               "normal": normal_loss, "alpha": alpha_loss,
               "depth": depth_loss, "dist": dist_loss, "total": total}
    return total, metrics


def psnr(pred_rgb, gt_rgb, mask=None):
    """Matches the reference's calc_psnr."""
    if mask is None:
        mse = torch.mean((pred_rgb - gt_rgb) ** 2)
    else:
        m = mask.to(pred_rgb.dtype)
        mse = torch.sum(((pred_rgb - gt_rgb) ** 2) * m[None]) / \
            _nonzero_count(m, pred_rgb.shape[0])
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
