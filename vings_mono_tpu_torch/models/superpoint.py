"""SuperPoint keypoint detector + descriptor.

The standard public architecture: a shared VGG encoder (64-64-128-128 with
3 pools to 1/8), a detector head (65-channel cell softmax, depth-to-space
heatmap) and a descriptor head (256 channels, L2-normalized). NCHW inside;
the functions take and return the channels-last layout of the JAX package
(`image (B, H, W, 1)` in, `heat (B, H, W)` and `desc (B, H/8, W/8, 256)`
out).

Weights: the JAX package's self-trained flat `.npz`, the public
superpoint_v1.pth, or its `.onnx` export (`load_superpoint`); without a
path, random weights from a generator.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import true_f32
from .flax_weights import lecun_init_, state_dict_from_flax

_LAYERS = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
           ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
           ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
           ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
           ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
           ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))
NAMES = tuple(n for n, *_ in _LAYERS)


class SuperPoint(nn.Module):
    """Runs in true f32 (no TF32) wherever it is called."""

    def __init__(self, generator=None):
        super().__init__()
        for name, cin, cout, k in _LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2))
        if generator is not None:
            lecun_init_(self, generator)

    @true_f32()
    def forward(self, image, with_logits=False):
        """image (B, H, W, 1) grayscale in [0,1] -> (heat (B, H, W),
        desc_map (B, H/8, W/8, 256) L2-normalized)[, logits (B, h, w,
        65)]."""
        x = image.permute(0, 3, 1, 2)
        for blk in ("1", "2", "3"):
            x = F.relu(getattr(self, f"conv{blk}a")(x))
            x = F.relu(getattr(self, f"conv{blk}b")(x))
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv4a(x))
        x = F.relu(self.conv4b(x))

        logits = self.convPb(F.relu(self.convPa(x)))      # (B, 65, h, w)
        prob = torch.softmax(logits, dim=1)[:, :64]
        # depth-to-space: channel 8r+s -> pixel (8y+r, 8x+s)
        heat = F.pixel_shuffle(prob, 8)[:, 0]

        desc = self.convDb(F.relu(self.convDa(x)))
        desc = desc / torch.linalg.norm(desc, dim=1,
                                        keepdim=True).clamp(min=1e-8)
        desc = desc.permute(0, 2, 3, 1)
        if with_logits:
            return heat, desc, logits.permute(0, 2, 3, 1)
        return heat, desc


def nms_keypoints(heat, max_kp=512, nms_radius=4, threshold=0.005):
    """Top-K keypoints after local-max suppression.

    heat (H, W) -> (xy (max_kp, 2) float, score (max_kp,), valid)."""
    H, W = heat.shape
    k = 2 * nms_radius + 1
    # SAME window max with a -inf border (max_pool2d pads with -inf)
    m = F.max_pool2d(heat[None, None], k, stride=1, padding=nms_radius)[0, 0]
    keep = (heat == m) & (heat > threshold)
    flat = torch.where(keep, heat, torch.zeros_like(heat)).reshape(-1)
    score, idx = torch.topk(flat, max_kp)
    xy = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    return xy, score, score > 0


def sample_descriptors(xy, desc_map, img_hw):
    """Bilinear descriptor sampling at pixel coords (N, 2); desc_map
    (h, w, 256) at 1/8 resolution."""
    h, w, _ = desc_map.shape
    gx = xy[:, 0] / 8.0 - 0.5
    gy = xy[:, 1] / 8.0 - 0.5
    x0 = torch.floor(gx).long().clamp(0, w - 2)
    y0 = torch.floor(gy).long().clamp(0, h - 2)
    fx = (gx - x0).clamp(0, 1)[:, None]
    fy = (gy - y0).clamp(0, 1)[:, None]
    d = (1 - fy) * ((1 - fx) * desc_map[y0, x0] + fx * desc_map[y0, x0 + 1]) \
        + fy * ((1 - fx) * desc_map[y0 + 1, x0]
                + fx * desc_map[y0 + 1, x0 + 1])
    return d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-8)


def mutual_nearest_match(desc1, desc2, valid1, valid2, ratio=0.95,
                         min_score=0.2):
    """Mutual-NN descriptor matching with a distance-ratio check — the
    matching backend when no LightGlue weights are available.

    Returns (idx2_for_1 (N1,), match_valid (N1,))."""
    sim = desc1 @ desc2.T                           # cosine (unit descs)
    sim = torch.where(valid1[:, None] & valid2[None, :], sim,
                      torch.full_like(sim, -1e9))
    s1, best12 = sim.max(dim=1)
    best21 = sim.argmax(dim=0)
    rows = torch.arange(desc1.shape[0], device=sim.device)
    mutual = rows == best21[best12]
    # ratio: best vs second best
    s2 = sim.index_put((rows, best12), sim.new_tensor(-1e9)).max(dim=1)[0]
    ok = mutual & (s1 > min_score) & (s2 < s1 * (2 - ratio)) & valid1
    return best12, ok


# ---------------------------------------------------------------------------

def convert_superpoint_checkpoint(sd):
    """Public superpoint_v1.pth state_dict (or its .onnx initializers, same
    names) -> a SuperPoint state_dict: the torch layout already."""
    return {f"{n}.{leaf}": torch.as_tensor(sd[f"{n}.{leaf}"]).float()
            for n in NAMES for leaf in ("weight", "bias")}


def load_superpoint(path=None, device="cpu", generator=None):
    """SuperPoint in eval mode on `device`, its weights from `path` (the
    JAX package's flat `.npz`, an `.onnx` or a `.pth`), or random from
    `generator` (seed 0 when None) without a path."""
    if path is None:
        model = SuperPoint(generator if generator is not None
                           else torch.Generator().manual_seed(0))
    else:
        p = str(path)
        if p.endswith(".npz"):
            import numpy as np
            with np.load(p) as z:
                sd = state_dict_from_flax({k: z[k] for k in z.files})
        elif p.endswith(".onnx"):
            from ..utils.onnx_weights import load_onnx_initializers
            sd = convert_superpoint_checkpoint(load_onnx_initializers(p))
        else:
            sd = convert_superpoint_checkpoint(torch.load(
                p, map_location="cpu", weights_only=True))
        model = SuperPoint()
        model.load_state_dict(sd)
    return model.to(device).eval().requires_grad_(False)


@torch.no_grad()
def extract(model, gray, max_kp=512):
    """The detector's device stage: gray (hh, ww) -> (xy, score, valid,
    desc) at max_kp keypoints."""
    hh, ww = gray.shape
    heat, desc_map = model(gray[None, :, :, None])
    xy, score, valid = nms_keypoints(heat[0], max_kp)
    return xy, score, valid, sample_descriptors(xy, desc_map[0], (hh, ww))
