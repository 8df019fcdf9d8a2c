"""Mapper training loss — rebuild of the reference's get_loss: masked
L1+SSIM rgb, depth-covariance-weighted L1 depth, normal consistency vs
depth-propagated normals, sky alpha suppression, and the 2DGS distortion
regularizer."""

from __future__ import annotations

import torch

from ..ops.ssim import ssim_map
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


TERMS = ("l1", "ssim", "normal", "alpha", "depth", "dist")


def mapper_loss_parts(pred, gt_rgb, gt_depth, gt_depth_cov, camera: Camera,
                      sky_rgb=None, pixel_mask=None, rows=None):
    """Numerators and denominators of mapper_loss's terms, two (6,) f32
    tensors in TERMS order: each term is num / max(den, 1), and no
    denominator depends on the rendered maps.

    rows = (a, b) counts only rows a..b-1 of the inputs in both, so the
    parts of row bands that tile the image add up to the whole image's.
    The rows around a band feed its SSIM window (5 rows) and its normals'
    central differences (1 row); SSIM's zero padding and the normals' zero
    border sit at the inputs' first and last rows, where they belong only
    if those are the image's."""
    sky = torch.sum(gt_rgb, dim=0) == 0.0          # (H, W)
    valid = (~sky) & (gt_depth[0] > 0.0)
    if pixel_mask is not None:
        valid &= pixel_mask
        sky &= pixel_mask
    if sky_rgb is not None:
        # sky mode: the photometric terms over the whole image
        ph_gt = sky_rgb
        ph_mask = torch.ones_like(valid) if pixel_mask is None \
            else pixel_mask
    else:
        ph_gt, ph_mask = gt_rgb, valid
    band = slice(None) if rows is None else slice(*rows)

    def total(x):
        return torch.sum(x[..., band, :])

    def count(mask, times=1):
        return total(mask.to(torch.float32)) * times

    m = ph_mask.to(pred["rgb"].dtype)
    ch = pred["rgb"].shape[0]
    # normal consistency: rendered normal vs normals from the rendered depth
    # (both camera frame; the dot product is rotation invariant)
    surf_n = depth_to_normal(pred["depth"][0], camera)          # (H, W, 3)
    rend_n = torch.movedim(pred["normal"], 0, -1)               # (H, W, 3)
    inv_cov = 1.0 / torch.clamp(gt_depth_cov, min=1e-8)
    mw = valid[None].to(pred["depth"].dtype) * inv_cov
    nums = torch.stack([
        total(torch.abs(pred["rgb"] - ph_gt) * m[None]),
        total(ssim_map(pred["rgb"], ph_gt) * m[None]),
        total((1.0 - torch.sum(rend_n * surf_n, dim=-1)) * valid),
        total(pred["accum"][0] * sky),
        total(torch.abs(pred["depth"] - gt_depth) * mw),
        total(pred["dist"][0] * valid)])
    dens = torch.stack([count(m, ch), count(m, ch), count(valid),
                        count(sky), total(mw), count(valid)])
    return nums, dens


def combine_parts(nums, dens, weights=None):
    """mapper_loss's (total, metrics) from its terms' parts."""
    weights = {**DEFAULT_WEIGHTS, **(weights or {})}
    t = dict(zip(TERMS, nums / torch.clamp(dens, min=1.0)))
    rgb_loss = 0.8 * t["l1"] + 0.2 * (1.0 - t["ssim"])
    total = (weights["rgb_loss"] * rgb_loss
             + weights["normal_loss"] * t["normal"]
             + weights["alpha_loss"] * t["alpha"]
             + weights["depth_loss"] * t["depth"]
             + weights["dist_loss"] * t["dist"])
    metrics = {"rgb": rgb_loss, **t, "total": total}
    return total, metrics


def surrogate_weights(weights=None):
    """(6,) c with sum(c * nums / max(dens, 1)) equal to the total up to a
    constant: the gradient of the total, term by term."""
    w = {**DEFAULT_WEIGHTS, **(weights or {})}
    return torch.tensor([0.8 * w["rgb_loss"], -0.2 * w["rgb_loss"],
                         w["normal_loss"], w["alpha_loss"], w["depth_loss"],
                         w["dist_loss"]], dtype=torch.float32)


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
    return combine_parts(*mapper_loss_parts(
        pred, gt_rgb, gt_depth, gt_depth_cov, camera, sky_rgb=sky_rgb,
        pixel_mask=pixel_mask), weights)


def psnr(pred_rgb, gt_rgb, mask=None):
    """Matches the reference's calc_psnr."""
    if mask is None:
        mse = torch.mean((pred_rgb - gt_rgb) ** 2)
    else:
        m = mask.to(pred_rgb.dtype)
        mse = torch.sum(((pred_rgb - gt_rgb) ** 2) * m[None]) / \
            _nonzero_count(m, pred_rgb.shape[0])
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
