"""SSIM (11x11 separable Gaussian window), matching the reference's
ssim_loss / ssim_img closely enough for loss parity.

The blur is two banded-matrix products (the band matrix of a SAME-padded
1-D convolution) in full f32: matmuls keep f32 on the GPU by default, where
a cuDNN convolution would run in TF32."""

from __future__ import annotations

import functools

import numpy as np
import torch

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


@functools.lru_cache()
def _band_matrix(n, device, size=11, sigma=1.5):
    """Banded Toeplitz blur matrix (n, n) == SAME-padded 1-D conv, built
    once per size and device (callers only read it)."""
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    M = np.zeros((n, n), np.float32)
    r = size // 2
    for k in range(size):
        off = k - r
        M += np.diag(np.full(n - abs(off), g[k], np.float32), off)
    return torch.tensor(M, device=device)


def _blur(img, size=11):
    """Separable Gaussian blur; img (C, H, W), SAME (zero) padding."""
    _, H, W = img.shape
    Mh = _band_matrix(H, img.device, size)
    Mw = _band_matrix(W, img.device, size)
    return torch.matmul(torch.matmul(Mh, img), Mw)


def ssim_map(img1, img2):
    """Per-pixel SSIM, images (C, H, W) in [0, 1]. Returns (C, H, W)."""
    mu1 = _blur(img1)
    mu2 = _blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img1 * img1) - mu1_sq
    s2 = _blur(img2 * img2) - mu2_sq
    s12 = _blur(img1 * img2) - mu12
    return ((2 * mu12 + _C1) * (2 * s12 + _C2)
            / ((mu1_sq + mu2_sq + _C1) * (s1 + s2 + _C2)))


def ssim(img1, img2, mask=None):
    """Mean SSIM; optional (H, W) mask."""
    m = ssim_map(img1, img2)
    if mask is None:
        return torch.mean(m)
    mask = mask.to(m.dtype)
    return torch.sum(m * mask[None]) / torch.clamp(
        torch.sum(mask) * m.shape[0], min=1.0)
