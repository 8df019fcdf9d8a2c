"""Flax parameter trees (the JAX package's `.npz` weights) -> torch
state_dicts.

The JAX package stores its self-trained nets either flat, one array per
`params/<module>/.../<leaf>` key, or as one pickled nested `params` tree.
Both become dotted torch names. Leaves named `kernel` become `weight`,
transposed: a conv's HWIO to OIHW, a dense layer's (in, out) to
(out, in). Other leaves keep their name unless `renames` maps it (flax
LayerNorm's `scale` is torch's `weight`)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def flatten_tree(tree, prefix=()):
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def state_dict_from_flax(tree, renames=None) -> Dict[str, torch.Tensor]:
    """A nested flax tree, or a flat dict keyed `params/.../<leaf>`, -> a
    torch state_dict of f32 tensors."""
    renames = renames or {}
    if all(isinstance(k, str) and "/" in k for k in tree):
        flat = {tuple(k.split("/")): v for k, v in tree.items()}
    else:
        flat = flatten_tree(tree)
    sd = {}
    for path, v in flat.items():
        if path[0] == "params":
            path = path[1:]
        v = np.array(v, np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
            leaf = "weight"
        else:
            leaf = renames.get(leaf, leaf)
        sd[".".join(path[:-1] + (leaf,))] = torch.from_numpy(
            np.ascontiguousarray(v))
    return sd


def flax_from_state_dict(sd) -> Dict[str, np.ndarray]:
    """The inverse of `state_dict_from_flax` for conv and dense layers: a
    torch state_dict -> a flat dict keyed `params/<module>/.../<leaf>` of
    f32 numpy arrays, `weight` as flax's `kernel` (OIHW to HWIO, (out, in)
    to (in, out))."""
    flat = {}
    for name, t in sd.items():
        path = name.split(".")
        v = t.detach().to("cpu", torch.float32).numpy()
        if path[-1] == "weight":
            v = np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 else v.T
            path[-1] = "kernel"
        flat["/".join(["params"] + path)] = np.ascontiguousarray(v)
    return flat


def flax_tree_from_state_dict(sd):
    """The inverse of `state_dict_from_flax` for a nested `params` tree:
    a torch state_dict -> a nested dict of f32 numpy arrays, `weight` as
    flax's `kernel` (transposed as in `flax_from_state_dict`) and a 1-D
    `weight` (a LayerNorm's) as flax's `scale`."""
    tree = {}
    for key, v in flax_from_state_dict(sd).items():
        path = key.split("/")[1:]
        if path[-1] == "kernel" and v.ndim == 1:
            path[-1] = "scale"
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def save_pickled_params(path, tree, arch=None):
    """Write a nested `params` tree, and an `arch` dict when given, as the
    JAX package's object-pickled `.npz` (what its trainers write and
    `load_pickled_params` reads)."""
    extra = {} if arch is None else {"arch": np.asarray(arch, dtype=object)}
    np.savez(path, params=np.asarray(tree, dtype=object), **extra)


def load_pickled_params(path):
    """The pickled `params` tree of a JAX package `.npz` and its `arch`
    entry ({} when absent), as numpy arrays."""
    with np.load(path, allow_pickle=True) as z:
        params = z["params"].item()
        arch = z["arch"].item() if "arch" in z.files else {}
    return params, arch


@torch.no_grad()
def lecun_init_(module, generator):
    """Flax's default initialisation, drawn from `generator`: every conv
    and dense kernel from a normal truncated at 2 sigma with variance
    1/fan_in (flax's `lecun_normal`), biases zero. The JAX package draws
    its random weights from PRNGKey(0), which torch cannot reproduce: the
    distribution is the same, the values are not."""
    for m in module.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            fan_in = m.weight[0].numel()
            # the std of a unit normal truncated at +-2 is 0.8796
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                        2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
