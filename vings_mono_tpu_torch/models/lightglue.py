"""LightGlue feature matcher: L transformer layers of self-attention (2D
rotary position encoding on the keypoint locations) and cross-attention,
then per-point matchability and the double-softmax partial assignment.

The attention is plain `einsum` and `softmax` in f32, as in the JAX
package (no hand-written kernel: at 512 keypoints and 4 heads it is a few
small matmuls). Module names follow the flax tree, so the JAX package's
self-trained `.npz` loads by name (`load_lightglue`); flax's defaults are
kept: LayerNorm epsilon 1e-6 and the tanh approximation of GELU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import true_f32
from .flax_weights import (lecun_init_, load_pickled_params,
                           state_dict_from_flax)

DIM = 256
HEADS = 4
LAYERS = 9


def rotary_embed(kpts, dim=DIM // HEADS):
    """2D rotary frequencies from normalized keypoint coords (N, 2) ->
    (N, dim/2) angles used to rotate query/key pairs."""
    n_freq = dim // 4
    freqs = 2.0 ** torch.arange(n_freq, dtype=kpts.dtype,
                                device=kpts.device) * math.pi
    ang = kpts[..., :, None, :] * freqs[None, :, None]   # (N, f, 2)
    return ang.reshape(kpts.shape[0], -1)                # (N, dim/2)


def apply_rotary(x, ang):
    """x (N, H, d); rotate feature pairs by per-point angles."""
    d = x.shape[-1]
    ang = ang[:, None, :d // 2]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                       dim=-1).reshape(x.shape)


class Attention(nn.Module):
    def __init__(self):
        super().__init__()
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, nn.Linear(DIM, DIM))
        self.ffn1 = nn.Linear(2 * DIM, 2 * DIM)
        self.ffn_norm = nn.LayerNorm(2 * DIM, eps=1e-6)
        self.ffn2 = nn.Linear(2 * DIM, DIM)

    def forward(self, x, source, ang_x=None, ang_s=None, mask=None):
        """x (N, DIM) attends to source (M, DIM)."""
        d = DIM // HEADS
        q = self.to_q(x).reshape(-1, HEADS, d)
        k = self.to_k(source).reshape(-1, HEADS, d)
        v = self.to_v(source).reshape(-1, HEADS, d)
        if ang_x is not None:
            q = apply_rotary(q, ang_x)
            k = apply_rotary(k, ang_s if ang_s is not None else ang_x)
        att = torch.einsum("nhd,mhd->hnm", q, k) / math.sqrt(d)
        if mask is not None:
            att = torch.where(mask[None, None, :], att,
                              att.new_tensor(-1e9))
        att = torch.softmax(att, dim=-1)
        out = torch.einsum("hnm,mhd->nhd", att, v).reshape(-1, DIM)
        y = torch.cat([x, self.to_out(out)], dim=-1)
        y = F.gelu(self.ffn_norm(self.ffn1(y)), approximate="tanh")
        return x + self.ffn2(y)


class LightGlue(nn.Module):
    """Runs in true f32 (no TF32) wherever it is called."""

    def __init__(self, layers=LAYERS, generator=None):
        super().__init__()
        self.layers = int(layers)
        for name in ("input_proj0", "input_proj1", "final_proj0",
                     "final_proj1"):
            setattr(self, name, nn.Linear(DIM, DIM))
        self.match0 = nn.Linear(DIM, 1)
        self.match1 = nn.Linear(DIM, 1)
        for i in range(self.layers):
            for kind in ("self", "cross"):
                for side in (0, 1):
                    setattr(self, f"{kind}{i}_{side}", Attention())
        if generator is not None:
            lecun_init_(self, generator)

    @true_f32()
    def forward(self, desc0, desc1, kpts0, kpts1, valid0, valid1):
        """descs (N/M, 256) L2-normalized, kpts normalized to [-1, 1].

        Returns (scores (N, M) log-assignment, matchability0 (N,),
        matchability1 (M,))."""
        x0 = self.input_proj0(desc0)
        x1 = self.input_proj1(desc1)
        a0 = rotary_embed(kpts0)
        a1 = rotary_embed(kpts1)
        for i in range(self.layers):
            x0 = getattr(self, f"self{i}_0")(x0, x0, a0, a0, valid0)
            x1 = getattr(self, f"self{i}_1")(x1, x1, a1, a1, valid1)
            y0 = getattr(self, f"cross{i}_0")(x0, x1, None, None, valid1)
            y1 = getattr(self, f"cross{i}_1")(x1, x0, None, None, valid0)
            x0, x1 = y0, y1
        sim = torch.einsum("nd,md->nm", self.final_proj0(x0),
                           self.final_proj1(x1)) / math.sqrt(DIM)
        sim = torch.where(valid0[:, None] & valid1[None, :], sim,
                          sim.new_tensor(-1e9))
        z0 = torch.sigmoid(self.match0(x0))[:, 0]
        z1 = torch.sigmoid(self.match1(x1))[:, 0]
        # double-softmax partial assignment (LightGlue eq. 9)
        scores = (torch.log_softmax(sim, dim=1)
                  + torch.log_softmax(sim, dim=0)
                  + torch.log(z0.clamp(min=1e-9))[:, None]
                  + torch.log(z1.clamp(min=1e-9))[None, :])
        return scores, z0, z1


def extract_matches(scores, valid0, valid1, threshold=0.1):
    """Mutual argmax over the log-assignment. Returns (idx1_for_0, ok)."""
    smax, best01 = scores.max(dim=1)
    best10 = scores.argmax(dim=0)
    mutual = torch.arange(scores.shape[0],
                          device=scores.device) == best10[best01]
    ok = mutual & (torch.exp(smax) > threshold) & valid0
    return best01, ok


def normalize_keypoints(xy, hw):
    h, w = hw
    size = xy.new_tensor([w, h])
    return (xy - size / 2.0) / (max(w, h) / 2.0)


def convert_lightglue_checkpoint(sd, layers=LAYERS):
    """The public LightGlue torch checkpoint (superpoint_lightglue.pth
    naming: transformers.{i}.self_attn/cross_attn..., log_assignment...)
    -> a LightGlue state_dict (torch layout: no transposes)."""
    def t(name):
        return torch.as_tensor(np.asarray(sd[name])).float()

    out = {}

    def dense(dst, src):
        out[f"{dst}.weight"] = t(src + ".weight")
        out[f"{dst}.bias"] = t(src + ".bias")

    for side in (0, 1):
        dense(f"input_proj{side}", "input_proj")
        dense(f"final_proj{side}", "log_assignment.final_proj")
        dense(f"match{side}", "log_assignment.matchability")
    qkv = {"self": ("Wqkv_q", "Wqkv_k", "Wqkv_v"),
           "cross": ("Wq", "Wk", "Wv")}
    for i in range(layers):
        for kind, names in qkv.items():
            base = f"transformers.{i}.{kind}_attn"
            for side in (0, 1):
                dst = f"{kind}{i}_{side}"
                for to, src in zip(("to_q", "to_k", "to_v"), names):
                    dense(f"{dst}.{to}", f"{base}.{src}")
                dense(f"{dst}.to_out", f"{base}.out_proj")
                dense(f"{dst}.ffn1", f"{base}.ffn.0")
                dense(f"{dst}.ffn_norm", f"{base}.ffn.1")
                dense(f"{dst}.ffn2", f"{base}.ffn.3")
    return out


def load_lightglue(path, device="cpu"):
    """LightGlue in eval mode on `device` from the JAX package's `.npz`
    (pickled `params` tree, `arch: {layers}`), an `.onnx` or a `.pth` of
    the public checkpoint (9 layers)."""
    p = str(path)
    if p.endswith(".npz"):
        params, arch = load_pickled_params(p)
        model = LightGlue(layers=int(arch.get("layers", LAYERS)))
        model.load_state_dict(state_dict_from_flax(
            params, renames={"scale": "weight"}))
    else:
        if p.endswith(".onnx"):
            from ..utils.onnx_weights import load_onnx_initializers
            sd = load_onnx_initializers(p)
        else:
            sd = torch.load(p, map_location="cpu", weights_only=True)
        model = LightGlue()
        model.load_state_dict(convert_lightglue_checkpoint(sd))
    return model.to(device).eval().requires_grad_(False)
