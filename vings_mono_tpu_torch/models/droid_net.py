"""DROID-SLAM RAFT-GRU network as torch modules.

Same architecture and parameter names as the reference, so pretrained
`droid.pth` weights and the flax `.npz` weights of the JAX package both
convert 1:1:
  * fnet: BasicEncoder(output 128, instance norm), 1/8 resolution
  * cnet: BasicEncoder(output 256, no norm) -> tanh(net 128) / relu(inp 128)
  * UpdateModule: corr encoder (4*49 -> 128), flow encoder (4 -> 64),
    ConvGRU with global context, delta/weight heads (2ch, sigmoid weight),
    GraphAgg (scatter-mean over source frame -> damping eta + 8x8x9 upmask)

Layout: every public tensor is channels-last, (N, h, w, C), like the rest of
the tracker. Inside, a module hands `F.conv2d` the (N, C, h, w) *view* of
that tensor (a permute, no copy), which is torch's channels_last memory
format, and permutes the result back.

The modules carry no autograd state of their own; the tracker calls them
under `torch.no_grad()`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .flax_weights import flax_from_state_dict, state_dict_from_flax

DIM = 32


class Conv(nn.Conv2d):
    """Conv2d on channels-last tensors, symmetric padding k//2."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2)

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def instance_norm(x):
    """InstanceNorm2d(affine=False) on (N, h, w, C): normalize over h, w per
    channel, biased variance, eps 1e-5."""
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def _norm(norm_fn):
    if norm_fn == "instance":
        return instance_norm
    if norm_fn == "none":
        return lambda x: x
    raise NotImplementedError(norm_fn)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.norm = _norm(norm_fn)
        self.conv1 = Conv(in_planes, planes, 3, stride)
        self.conv2 = Conv(planes, planes, 3)
        self.downsample = Conv(in_planes, planes, 1, stride) \
            if stride != 1 else None

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = F.relu(self.norm(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim=128, norm_fn="instance"):
        super().__init__()
        self.norm = _norm(norm_fn)
        self.conv1 = Conv(3, DIM, 7, 2)
        cin = DIM
        for i, (dim, stride) in enumerate([(DIM, 1), (2 * DIM, 2),
                                           (4 * DIM, 2)]):
            setattr(self, f"layer{i + 1}_0",
                    ResidualBlock(cin, dim, norm_fn, stride))
            setattr(self, f"layer{i + 1}_1",
                    ResidualBlock(dim, dim, norm_fn, 1))
            cin = dim
        self.conv2 = Conv(cin, output_dim, 1)

    def forward(self, x):
        """x (B, H, W, 3) normalized RGB -> (B, H/8, W/8, output_dim)."""
        x = F.relu(self.norm(self.conv1(x)))
        for i in (1, 2, 3):
            x = getattr(self, f"layer{i}_0")(x)
            x = getattr(self, f"layer{i}_1")(x)
        return self.conv2(x)


class ConvGRU(nn.Module):
    """RAFT ConvGRU with a global-context gate."""

    def __init__(self, h_planes=128, i_planes=128):
        super().__init__()
        self.w = Conv(h_planes, h_planes, 1)
        self.convz = Conv(h_planes + i_planes, h_planes, 3)
        self.convr = Conv(h_planes + i_planes, h_planes, 3)
        self.convq = Conv(h_planes + i_planes, h_planes, 3)
        self.convz_glo = Conv(h_planes, h_planes, 1)
        self.convr_glo = Conv(h_planes, h_planes, 1)
        self.convq_glo = Conv(h_planes, h_planes, 1)

    def forward(self, net, inp):
        net_inp = torch.cat([net, inp], dim=-1)
        glo = torch.sigmoid(self.w(net)) * net
        glo = glo.mean(dim=(1, 2), keepdim=True)
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=-1))
                       + self.convq_glo(glo))
        return (1 - z) * net + z * q


class GraphAgg(nn.Module):
    """Frame-level aggregation: scatter-mean the GRU state over edges with
    the same source frame, then predict damping + upsample mask."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(128, 128, 3)
        self.conv2 = Conv(128, 128, 3)
        self.eta = Conv(128, 1, 3)
        self.upmask = Conv(128, 8 * 8 * 9, 1)

    def forward(self, net, ii, num_frames):
        x = F.relu(self.conv1(net))
        ii = ii.long()
        counts = torch.zeros(num_frames, dtype=torch.float32,
                             device=x.device).index_add_(
            0, ii, torch.ones_like(ii, dtype=torch.float32))
        summed = x.new_zeros((num_frames,) + x.shape[1:]).index_add_(
            0, ii, x)
        mean = summed / counts.clamp(min=1.0).to(x.dtype)[:, None, None,
                                                          None]
        x = F.relu(self.conv2(mean))
        eta = F.softplus(self.eta(x))
        return 0.01 * eta[..., 0], self.upmask(x)


class UpdateModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.corr_enc1 = Conv(196, 128, 1)
        self.corr_enc2 = Conv(128, 128, 3)
        self.flow_enc1 = Conv(4, 128, 7)
        self.flow_enc2 = Conv(128, 64, 3)
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.delta1 = Conv(128, 128, 3)
        self.delta2 = Conv(128, 2, 3)
        self.weight1 = Conv(128, 128, 3)
        self.weight2 = Conv(128, 2, 3)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow=None, ii=None, num_frames=0,
                upsample=False):
        """net/inp (N, h, w, 128), corr (N, h, w, 196), flow (N, h, w, 4).

        Returns (net, delta (N,h,w,2), weight (N,h,w,2), eta, upmask); the
        last two are None unless `ii` is given and `upsample` is set."""
        if flow is None:
            flow = net.new_zeros(net.shape[:3] + (4,))
        c = F.relu(self.corr_enc1(corr))
        c = F.relu(self.corr_enc2(c))
        f = F.relu(self.flow_enc1(flow))
        f = F.relu(self.flow_enc2(f))
        net = self.gru(net, torch.cat([inp, c, f], dim=-1))
        delta = self.delta2(F.relu(self.delta1(net)))
        weight = torch.sigmoid(self.weight2(F.relu(self.weight1(net))))
        if ii is not None and upsample:
            eta, upmask = self.agg(net, ii, num_frames)
            return net, delta, weight, eta, upmask
        return net, delta, weight, None, None


class DroidNet(nn.Module):
    """fnet + cnet + update. `generator` seeds the random initialisation
    (uniform in +-1/sqrt(fan_in)); real weights come through
    `load_state_dict(load_droid_weights(path))`."""

    def __init__(self, generator=None):
        super().__init__()
        self.fnet = BasicEncoder(128, "instance")
        self.cnet = BasicEncoder(256, "none")
        self.update = UpdateModule()
        if generator is not None:
            with torch.no_grad():
                for m in self.modules():
                    if isinstance(m, nn.Conv2d):
                        fan_in = m.weight[0].numel()
                        b = 1.0 / fan_in ** 0.5
                        m.weight.uniform_(-b, b, generator=generator)
                        m.bias.uniform_(-b, b, generator=generator)

    def extract_features(self, images):
        """images (B, H, W, 3) *normalized* RGB -> fmap, net, inp (1/8)."""
        fmap = self.fnet(images)
        net, inp = self.context(images)
        return fmap, net, inp

    def context(self, images):
        net, inp = self.cnet(images).chunk(2, dim=-1)
        return torch.tanh(net), F.relu(inp)

    def run_update(self, net, inp, corr, flow=None, ii=None, num_frames=0,
                   upsample=False):
        return self.update(net, inp, corr, flow, ii, num_frames, upsample)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(rgb01):
    """(..., H, W, 3) RGB in [0,1] -> ImageNet-normalized."""
    return (rgb01 - rgb01.new_tensor(IMAGENET_MEAN)) \
        / rgb01.new_tensor(IMAGENET_STD)


# ---------------------------------------------------------------------------
# weights carried across: flax .npz and the reference droid.pth
# ---------------------------------------------------------------------------

def convert_droid_checkpoint(state_dict):
    """A reference droid.pth state_dict ('module.' prefix or not) -> a
    DroidNet state_dict. The delta and weight heads are trimmed to their
    first 2 output channels, as the reference loader does. Entries the
    checkpoint lacks are left out (partial checkpoints load with
    strict=False)."""
    src = {k.replace("module.", ""): torch.as_tensor(np.asarray(v)).float()
           for k, v in state_dict.items()}
    out = {}

    def conv(dst, name, trim_out=None):
        for leaf in ("weight", "bias"):
            t = src.get(f"{name}.{leaf}")
            if t is not None:
                out[f"{dst}.{leaf}"] = t if trim_out is None \
                    else t[:trim_out].clone()

    for enc in ("fnet", "cnet"):
        conv(f"{enc}.conv1", f"{enc}.conv1")
        conv(f"{enc}.conv2", f"{enc}.conv2")
        for layer in (1, 2, 3):
            for blk in (0, 1):
                base = f"{enc}.layer{layer}.{blk}"
                dst = f"{enc}.layer{layer}_{blk}"
                conv(f"{dst}.conv1", f"{base}.conv1")
                conv(f"{dst}.conv2", f"{base}.conv2")
                conv(f"{dst}.downsample", f"{base}.downsample.0")
    u = "update"
    conv(f"{u}.corr_enc1", f"{u}.corr_encoder.0")
    conv(f"{u}.corr_enc2", f"{u}.corr_encoder.2")
    conv(f"{u}.flow_enc1", f"{u}.flow_encoder.0")
    conv(f"{u}.flow_enc2", f"{u}.flow_encoder.2")
    conv(f"{u}.weight1", f"{u}.weight.0")
    conv(f"{u}.weight2", f"{u}.weight.2", trim_out=2)
    conv(f"{u}.delta1", f"{u}.delta.0")
    conv(f"{u}.delta2", f"{u}.delta.2", trim_out=2)
    for g in ("convz", "convr", "convq", "convz_glo", "convr_glo",
              "convq_glo", "w"):
        conv(f"{u}.gru.{g}", f"{u}.gru.{g}")
    conv(f"{u}.agg.conv1", f"{u}.agg.conv1")
    conv(f"{u}.agg.conv2", f"{u}.agg.conv2")
    conv(f"{u}.agg.eta", f"{u}.agg.eta.0")
    conv(f"{u}.agg.upmask", f"{u}.agg.upmask.0")
    return out


def load_droid_weights(path):
    """DroidNet state_dict from a flax `.npz` of the JAX package (f16
    storage, cast to f32) or from a reference droid.pth."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return state_dict_from_flax({k: z[k] for k in z.files})
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return convert_droid_checkpoint({k: v.numpy() for k, v in sd.items()})


def save_droid_weights(path, model):
    """Write a DroidNet's parameters as the flat flax `.npz` that
    `load_droid_weights` here and the JAX package's `load_flax_weights`
    read. Stored in f32, so a load gives back the same bits (the
    repository's self-trained file stores f16)."""
    np.savez_compressed(path, **flax_from_state_dict(model.state_dict()))
