"""MFU (model FLOP utilization) accounting: achieved FLOP/s over the H100's
dense bf16 peak (`profiling.H100_PEAK_FLOPS`).

The two dominant programs record a shape-only signature at their real call
sites: the mapper's train loop (`GaussianMapper.run`, `_mfu_sig`) and the
graph's fused GRU+BA update (`CovisibleGraph.update`, `_mfu_sig`). After the
measured section, `bench_mfu` builds zero-filled inputs of those shapes
(copies: the live state is never touched) and counts one call of each under
`torch.utils.flop_counter.FlopCounterMode`.

What is counted: matmuls, convolutions and attention, forward and backward
(the GRU's convolutions, the BA's batched products, the mapper's projection
products and SSIM convolutions). Elementwise ops, reductions, gathers,
sorts and the tile kernels count 0; the rasterizer gets JAX's analytic term
instead. XLA's cost analysis in the JAX package also counts elementwise
ops, so both counts are lower bounds on the executed FLOPs, and they are not
equal. Binning, add_frame, storage control and host glue are excluded.
"""

from __future__ import annotations

import dataclasses

import torch

from .profiling import H100_PEAK_FLOPS, count_flops


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def shape_sig(tree):
    """The tree with every tensor replaced by its TensorSpec; dataclasses,
    named tuples, tuples, lists and dicts are walked, other leaves kept."""
    return _map(tree, lambda t: TensorSpec(tuple(t.shape), t.dtype,
                                           t.device), torch.Tensor)


def materialize(sig):
    """Zero-filled tensors of a shape_sig's shapes."""
    return _map(sig, lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                           device=s.device), TensorSpec)


def _map(tree, fn, leaf_type):
    if isinstance(tree, leaf_type):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), fn, leaf_type)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(x, fn, leaf_type) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(x, fn, leaf_type) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn, leaf_type) for k, v in tree.items()}
    return tree


def raster_flops(p_cap, iters):
    """The JAX package's analytic count of the tile rasterizer per train
    loop: p_cap pairs x 256 pixels x 45 ops x 3.5 (forward + backward)
    per iteration."""
    return p_cap * 256 * 45 * 3.5 * iters


def train_loop_flops(sig):
    """FLOPs of the mapper's train loop at a recorded signature (args,
    kwargs, iters): one iteration counted, times iters; 0.0 when the loop
    never ran."""
    if sig is None:
        return 0.0
    from ..mapper.train import train_loop
    args, kw, iters = sig
    kw = dict(materialize(kw), iters=1, kf_schedule=[0])
    flops = count_flops(train_loop, *materialize(args), **kw)
    return float(flops) * iters


def fused_update_flops(sig):
    """FLOPs of one graph update at a recorded signature (args, kwargs);
    0.0 when the graph never updated."""
    if sig is None:
        return 0.0
    from ..tracker.graph import _fused_update
    args, kw = sig
    with torch.no_grad():
        return float(count_flops(_fused_update, *materialize(args), **kw))


def bench_mfu(tracker, mapper, n_frames, n_kf, wall_s):
    """Achieved FLOP/s over the peak for a measured section of n_frames
    tracked frames and n_kf mapped keyframes in wall_s seconds. Call it
    after the section: it runs the counted programs once more."""
    sig = mapper._mfu_sig
    flops_train = train_loop_flops(sig)
    if sig is not None:
        flops_train += raster_flops(int(mapper.bin_kwargs["p_cap"]),
                                    int(sig[2]))
    flops_upd = fused_update_flops(tracker.graph._mfu_sig)
    upd_per_frame = int(tracker.cfg["frontend"].get("iters1", 2)) + \
        int(tracker.cfg["frontend"].get("iters2", 1))
    total = flops_train * n_kf + flops_upd * upd_per_frame * n_frames
    achieved = total / max(wall_s, 1e-9)
    return {
        "total_flops": total,
        "achieved_flops_per_s": achieved,
        "mfu": achieved / H100_PEAK_FLOPS,
        "flops_train_loop": flops_train,
        "flops_fused_update": flops_upd,
    }
