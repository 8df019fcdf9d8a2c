"""DPT-style ViT monocular depth network: patch-16 ViT encoder, reassembly
of the tapped blocks, top-down fusion decoder and a softplus metric head.
NCHW inside; `DPTDepth` takes and returns the channels-last layout of the
JAX package (`rgb (B, H, W, 3)` in [0,1] in, depth `(B, H, W)` out).

Weights: the JAX package's flax `.npz` (a pickled `params` tree and its
`arch` entry: dim, depth, taps and the canonical input size `hw`), read by
`load_dpt`. The learned position embedding fixes the patch grid, so the
predict function resizes the input to `hw` and the depth back, as the JAX
package does. Without a path the ViT-S default is drawn at random from a
generator on a 4x4 patch grid (64x64 inputs), the grid the JAX package
initialises it on.

Flax's conventions kept here: LayerNorm eps 1e-6, the tanh GELU, attention
scaled by 1/sqrt(head_dim), and `jax.image.resize`'s bilinear, which
antialiases when it downsamples (`F.interpolate(..., antialias=True)`;
upsampling is written as gathers, `resize`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device, true_f32
from .flax_weights import (flax_tree_from_state_dict, lecun_init_,
                           load_pickled_params, state_dict_from_flax)

ATTN = "MultiHeadDotProductAttention_0"


class ViTBlock(nn.Module):
    def __init__(self, dim=384, heads=6):
        super().__init__()
        self.heads = heads
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-6)
        attn = nn.Module()
        for name in ("query", "key", "value", "out"):
            setattr(attn, name, nn.Linear(dim, dim))
        setattr(self, ATTN, attn)
        self.Dense_0 = nn.Linear(dim, 4 * dim)
        self.Dense_1 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        hd = D // self.heads
        attn = getattr(self, ATTN)
        y = self.LayerNorm_0(x)

        def split(lin):
            return lin(y).reshape(B, N, self.heads, hd).transpose(1, 2)

        q, k, v = split(attn.query), split(attn.key), split(attn.value)
        w = torch.softmax((q / hd ** 0.5) @ k.transpose(-1, -2), dim=-1)
        y = attn.out((w @ v).transpose(1, 2).reshape(B, N, D))
        x = x + y
        y = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)),
                                approximate="tanh"))
        return x + y


class DPTDepth(nn.Module):
    """Runs in true f32 (no TF32) wherever it is called."""

    def __init__(self, dim=384, depth=12, taps=(2, 5, 8, 11), grid=(4, 4),
                 generator=None):
        super().__init__()
        self.dim, self.taps, self.grid = dim, tuple(taps), tuple(grid)
        self.patch = nn.Conv2d(3, dim, 16, stride=16)
        self.pos = nn.Parameter(torch.zeros(1, grid[0] * grid[1], dim))
        for i in range(depth):
            setattr(self, f"block{i}", ViTBlock(dim))
        self.depth = depth
        for k in range(len(self.taps)):
            setattr(self, f"reassemble{k}", nn.Conv2d(dim, 128, 3,
                                                      padding=1))
            setattr(self, f"fuse{k}", nn.Conv2d(128, 128, 3, padding=1))
        self.head1 = nn.Conv2d(128, 64, 3, padding=1)
        self.head2 = nn.Conv2d(64, 1, 1)
        if generator is not None:
            lecun_init_(self, generator)
            with torch.no_grad():
                self.pos.normal_(0.0, 0.02, generator=generator)

    @true_f32()
    def forward(self, rgb):
        """rgb (B, H, W, 3) in [0,1], H and W multiples of 16 -> depth
        (B, H, W)."""
        B, H, W, _ = rgb.shape
        x = self.patch(rgb.permute(0, 3, 1, 2))          # (B, dim, h, w)
        h, w = x.shape[2:]
        x = x.flatten(2).transpose(1, 2) + self.pos       # (B, h*w, dim)
        feats = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
            if i in self.taps:
                feats.append(x.transpose(1, 2).reshape(B, self.dim, h, w))
        y = None
        for k, f in enumerate(reversed(feats)):
            f = getattr(self, f"reassemble{k}")(f)
            y = f if y is None else f + y
            y = F.relu(getattr(self, f"fuse{k}")(y))
        y = resize(y, (H, W))
        y = F.relu(self.head1(y))
        return F.softplus(self.head2(y))[:, 0]


def _upsample_axis(x, dim, n):
    """Axis `dim` of x linearly resampled to n >= its size at half-pixel
    centres, clamped at the edges, as two gathers (interpolate's and
    grid_sample's backward have no deterministic CUDA form; a gather's
    has)."""
    n_in = x.shape[dim]
    src = ((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5)
           * (n_in / n) - 0.5).clamp(min=0.0)
    i0 = src.long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    shape = [1] * x.ndim
    shape[dim] = n
    lam = (src - i0).reshape(shape)
    return (x.index_select(dim, i0) * (1.0 - lam)
            + x.index_select(dim, i1) * lam)


def resize(x, size):
    """`jax.image.resize(..., "bilinear")` over the last two axes of an
    NCHW tensor: half-pixel centres, antialiased when it downsamples (as
    `F.interpolate`, forward only), by gathers when it upsamples, so that
    the trainer differentiates it deterministically."""
    if size[0] < x.shape[-2] or size[1] < x.shape[-1]:
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False, antialias=True)
    return _upsample_axis(_upsample_axis(x, x.ndim - 1, size[1]),
                          x.ndim - 2, size[0])


def dpt_state_dict(params):
    """A flax DPTDepth params tree -> the torch module's state_dict. The
    attention kernels are (dim, heads, head_dim) for query, key and value
    and (heads, head_dim, dim) for out; they become dense (in, out)
    kernels first."""
    tree = {}
    for name, sub in params.items():
        if name.startswith("block"):
            sub = dict(sub)
            attn = {}
            for k, leaf in sub[ATTN].items():
                kern = np.asarray(leaf["kernel"])
                kern = kern.reshape(-1, kern.shape[-1]) if k == "out" \
                    else kern.reshape(kern.shape[0], -1)
                attn[k] = {"kernel": kern,
                           "bias": np.asarray(leaf["bias"]).reshape(-1)}
            sub[ATTN] = attn
        tree[name] = sub
    return state_dict_from_flax(tree, renames={"scale": "weight"})


def dpt_flax_tree(model, sd=None):
    """The inverse of `dpt_state_dict`: the module's parameters (or `sd`,
    tensors by the same names, its gradients say) as the flax DPTDepth
    params tree, the attention's dense kernels reshaped to (dim, heads,
    head_dim) for query, key and value and (heads, head_dim, dim) for
    out, their biases to (heads, head_dim) and (dim,)."""
    tree = flax_tree_from_state_dict(model.state_dict() if sd is None
                                     else sd)
    for i in range(model.depth):
        heads = getattr(model, f"block{i}").heads
        for k, leaf in tree[f"block{i}"][ATTN].items():
            kern = leaf["kernel"]
            if k == "out":
                leaf["kernel"] = kern.reshape(heads, -1, kern.shape[-1])
            else:
                leaf["kernel"] = kern.reshape(kern.shape[0], heads, -1)
                leaf["bias"] = leaf["bias"].reshape(heads, -1)
    return tree


def load_dpt(weights_path=None, device=None, generator=None):
    """(model, predict) on `device` (CUDA unless asked otherwise).
    predict(rgb (B, H, W, 3)) -> depth (B, H, W), resized to the
    checkpoint's `hw` and back when the input has another size."""
    device = resolve_device(device)
    hw = None
    if weights_path is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        model = DPTDepth(generator=generator)
    else:
        params, arch = load_pickled_params(weights_path)
        kw = {}
        if arch:
            kw = dict(dim=int(arch["dim"]), depth=int(arch["depth"]),
                      taps=tuple(int(t) for t in arch["taps"]))
            if "hw" in arch:
                hw = tuple(int(v) for v in arch["hw"])
        n_pos = np.asarray(params["pos"]).shape[1]
        grid = (hw[0] // 16, hw[1] // 16) if hw else (int(n_pos ** 0.5),) * 2
        model = DPTDepth(grid=grid, **kw)
        model.load_state_dict(dpt_state_dict(params))
    model.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def predict(x):
        H, W = x.shape[1], x.shape[2]
        if hw is not None and (H, W) != hw:
            xi = resize(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)
            return resize(model(xi)[:, None], (H, W))[:, 0]
        return model(x)

    return model, predict
