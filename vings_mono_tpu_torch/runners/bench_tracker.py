"""Timings of the pieces of the tracker's fused update at bench scale, the
counterpart of the JAX package's `scripts/bench_tracker.py`.

Usage: python -m vings_mono_tpu_torch.runners.bench_tracker
           [--device cuda|cpu]

At 240x432 (30x54 at 1/8) with 64 edges, a 16-frame BA window and 128
inactive edges, inputs drawn from numpy's generator 0 in the script's
order and a DroidNet with random weights (torch's generator 0): host ms
per call, the device synchronized, of the correlation pyramid's build,
its lookup, the GRU update, `ba_window` (2 iterations over 192 edges),
the reprojection of 64 edges and `depth_covariance`. The networks and
the BA run in true f32, as in the tracker. The last line is one JSON
record. Inside `utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .bench_common import device_name, timed_ms
from .eval_all import card_line
from .eval_common import add_device_flag

H, W = 240, 432
E, I, W_BA = 64, 128, 16


@torch.no_grad()
def measure(device, height=H, width=W):
    from ..models.droid_net import DroidNet
    from ..ops import ba as ba_ops
    from ..ops import corr as corr_ops
    from ..ops import lie
    from ..ops import projective as pops
    h, w = height // 8, width // 8
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    out = {}

    def timeit(name, fn, n=5):
        out[name] = timed_ms(fn, device, n=n)
        print(f"{name}: {out[name]:.1f} ms", flush=True)

    model = DroidNet(generator=torch.Generator().manual_seed(0)).to(device)
    fmaps = t(rng.normal(size=(E, h, w, 128)) * 0.1)
    pyr = corr_ops.build_pyramid(fmaps, fmaps)
    coords = t(rng.uniform(3, 20, size=(E, h, w, 2)))
    timeit("corr build (64 edges)",
           lambda: corr_ops.build_pyramid(fmaps, fmaps).levels[0])
    timeit("corr lookup", lambda: corr_ops.lookup(pyr, coords))

    net = t(rng.normal(size=(E, h, w, 128)) * 0.1)
    inp = t(rng.normal(size=(E, h, w, 128)) * 0.1)
    corr = t(rng.normal(size=(E, h, w, 196)) * 0.1)
    motn = torch.zeros((E, h, w, 4), device=device)
    ii = t(rng.integers(0, W_BA, size=E), torch.int32)
    timeit("GRU update (64 edges)", lambda: model.update(
        net, inp, corr, motn, ii, W_BA + 1, True)[1])

    n_all = E + I
    poses = lie.se3_identity((W_BA,), device=device)
    poses[:, 0] = torch.arange(W_BA, device=device) * 0.05
    disps = t(rng.uniform(0.05, 0.3, size=(W_BA, h, w)))
    intr = t(np.tile(np.asarray([27.5, 27.5, w / 2, h / 2])[None],
                     (W_BA, 1)))
    aii = t(rng.integers(0, W_BA - 1, size=n_all), torch.int32)
    ajj = t(rng.integers(0, W_BA - 1, size=n_all), torch.int32)
    tgt = t(rng.uniform(0, w, size=(n_all, 2, h, w)))
    wgt = t(rng.uniform(0, 1, size=(n_all, 2, h, w)))
    eta = torch.full((W_BA, h, w), 1e-2, device=device)
    ev = torch.ones((n_all,), dtype=torch.bool, device=device)
    timeit("ba_window iters=2", lambda: ba_ops.ba_window(
        tgt, wgt, eta, poses, disps, intr, aii, ajj, ev, 1, iters=2), n=3)
    timeit("reproject (64 edges)", lambda: pops.projective_transform(
        poses, disps, intr, aii[:E], ajj[:E])[0])
    Hs, v, Es, C, wv = ba_ops.build_system(tgt, wgt, eta, poses, disps,
                                           intr, aii, ajj, ev, fixedp=0)
    S, _, Q = ba_ops.schur_reduce(Hs, v, Es, C, wv)
    timeit("depth_covariance",
           lambda: ba_ops.depth_covariance(S, Es, Q, disps), n=3)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import reproducible, resolve_device, true_f32
    device = resolve_device(args.device)
    with reproducible(), true_f32():
        out = measure(device)
    print(json.dumps({"device": device_name(device), "card": card_line(),
                      "ms": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
