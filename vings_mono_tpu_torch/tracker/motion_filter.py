"""Per-frame motion gate: extract features for every incoming frame, run one
GRU step against the last keyframe, and append a new keyframe only when the
predicted flow magnitude exceeds the threshold.
"""

from __future__ import annotations

import torch

from ..models.droid_net import normalize_image
from ..ops import corr as corr_ops
from ..ops import lie, projective as pops
from .video import DepthVideo


def _features(model, image):
    dt = next(model.parameters()).dtype
    return model.fnet(normalize_image(image[None]).to(dt)).float()


def _context(model, image):
    dt = next(model.parameters()).dtype
    net, inp = model.context(normalize_image(image[None]).to(dt))
    return net.float(), inp.float()


def _features_and_gate(model, image, fmap_kf, net, inp):
    """fnet + 1-step GRU flow gate. With a bf16 model the feature maps, the
    correlation volume and the lookup's output are bf16 values, as the
    activations between them are."""
    dt = next(model.parameters()).dtype
    fmap = model.fnet(normalize_image(image[None]).to(dt))
    h, w = fmap.shape[1:3]
    pyr = corr_ops.build_pyramid(fmap_kf.to(dt), fmap, dtype=dt)
    coords0 = pops.coords_grid(h, w, device=fmap.device)[None]
    corr = corr_ops.lookup(pyr, coords0)
    _, delta, _, _, _ = model.update(net.to(dt), inp.to(dt), corr.to(dt))
    delta = delta.float()
    return fmap.float(), torch.linalg.norm(delta, dim=-1).mean()


class MotionFilter:
    def __init__(self, model, video: DepthVideo, thresh=2.5):
        """model: the DroidNet to run (bf16 parameters when
        `frontend.bf16_gru` is on)."""
        self.model = model
        self.video = video
        self.thresh = thresh
        self.count = 0
        self.fmap = None
        self.net = None
        self.inp = None

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None):
        """image (H, W, 3) float32 RGB in [0,1]; depth (H, W) metric or
        None; intrinsics [fx, fy, cx, cy] at full res."""
        if depth is not None:
            d8 = depth[3::8, 3::8]
            disp_sens = torch.where(d8 > 0, 1.0 / d8.clamp(min=1e-6),
                                    torch.zeros_like(d8))
        else:
            disp_sens = torch.zeros((image.shape[0] // 8,
                                     image.shape[1] // 8),
                                    dtype=torch.float32, device=image.device)

        if self.video.counter == 0:
            fmap = _features(self.model, image)
            _, net, inp = self._full_context(image, fmap)
            self.video.append(tstamp, image,
                              lie.se3_identity(device=image.device),
                              torch.ones_like(disp_sens), disp_sens,
                              intrinsics, fmap[0], net[0], inp[0])
            return True

        if self.thresh < 0:
            # gate disabled (every frame is a keyframe): skip the flow
            # magnitude entirely — float(mag) is a device sync the host
            # would otherwise pay every frame
            fmap = _features(self.model, image)
            mag = float("inf")
        else:
            fmap, mag_dev = _features_and_gate(
                self.model, image, self.fmap, self.net, self.inp)
            mag = float(mag_dev)   # the frame's one wait for the device
        if mag > self.thresh:
            self.count = 0
            _, net, inp = self._full_context(image, fmap)
            self.video.append(tstamp, image, None, None, disp_sens,
                              intrinsics, fmap[0], net[0], inp[0])
            return True
        self.count += 1
        return False

    def _full_context(self, image, fmap):
        net, inp = _context(self.model, image)
        self.fmap, self.net, self.inp = fmap, net, inp
        return fmap, net, inp
