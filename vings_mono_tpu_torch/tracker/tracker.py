"""Top-level tracker: owns the DroidNet weights, the keyframe video, the
motion filter, and the frontend; exposes `track()` and the save-buffer
surface the middleware reads. The tracker never differentiates: every entry
point runs under `torch.no_grad()`."""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..models.droid_net import DroidNet, load_droid_weights
from ..models.flax_weights import state_dict_from_flax
from ..utils.device import resolve_device, true_f32
from .frontend import Frontend
from .graph import CovisibleGraph
from .motion_filter import MotionFilter
from .video import DepthVideo


class Tracker:
    def __init__(self, cfg, height, width, params=None, weights_path=None,
                 device=None, generator=None):
        """params: a DroidNet state_dict, or flax parameters as a flat dict
        of numpy arrays keyed `params/.../{kernel,bias}`. Without `params`
        and `weights_path` the network is initialised at random from
        `generator` (default: seed 0)."""
        self.cfg = cfg
        self.device = resolve_device(device or cfg["device"]["tracker"])
        if params is None and weights_path is not None:
            params = load_droid_weights(weights_path)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.model = DroidNet(generator=generator)
        else:
            if not all(isinstance(v, torch.Tensor) for v in params.values()):
                params = state_dict_from_flax(params)
            self.model = DroidNet()
            self.model.load_state_dict(params)
        self.model.to(self.device).eval().requires_grad_(False)
        # with bf16_gru the networks run on a bf16 copy of the parameters;
        # their inputs are cast at the call and their outputs return to f32
        self.bf16 = bool(cfg["frontend"].get("bf16_gru", True))
        self.model_run = copy.deepcopy(self.model).to(torch.bfloat16) \
            if self.bf16 else self.model

        self.video = DepthVideo(cfg, height, width, device=self.device)
        self.graph = CovisibleGraph(self.video, self.model_run.update, cfg)
        self.filter = MotionFilter(
            self.model_run, self.video,
            thresh=float(cfg["frontend"]["filter_thresh"]))
        self.frontend = Frontend(self.video, self.graph, cfg)
        self.local_to_global_bias = 0

    @torch.no_grad()
    def track(self, data_packet):
        """data_packet: {'timestamp', 'rgb' (H,W,3) f32 [0,1] or uint8,
        'intrinsic' [fx,fy,cx,cy], optional 'depth' (H,W) metric}."""
        ts = float(data_packet["timestamp"])
        rgb = torch.as_tensor(data_packet["rgb"])
        if rgb.dtype == torch.uint8:
            # upload the 8-bit frame and convert on the device: a quarter
            # of the f32 frame's bytes cross the bus
            rgb = rgb.to(self.device).float() / 255.0
        else:
            rgb = rgb.to(self.device, torch.float32)
        intr = torch.as_tensor(np.asarray(data_packet["intrinsic"]),
                               dtype=torch.float32)
        depth = data_packet.get("depth")
        if depth is not None:
            depth = torch.as_tensor(depth).to(self.device, torch.float32)
        # f32 networks (bf16_gru off) and the BA in true f32, as on the CPU
        with true_f32():
            self.filter.track(ts, rgb, depth, intr)
            self.frontend()

    @property
    def new_frame_added(self):
        return self.frontend.new_frame_added
