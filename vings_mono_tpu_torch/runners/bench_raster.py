"""Micro-bench of the tile rasterizer (binning, forward, forward +
backward), the counterpart of the JAX package's `scripts/bench_raster.py`.

Usage: python -m vings_mono_tpu_torch.runners.bench_raster
           [--device cuda|cpu]

2^18 surfels at 352x640 (`raster_scene`, numpy's generator 0 as the
script draws them), 2^21 pair slots, the identity camera at focal 300,
for (chunk, side) in (128, 5), (256, 5), (512, 5), (256, 4). For each:
the kernels' registers, resident blocks per SM and dynamic shared memory
at that chunk (on the card; the forward at chunk 512 needs ~100 KB, above
the 48 KB default, through the opt-in in `csrc/rasterizer.cu`), then the
pair count, host ms per call of the binning (5 calls), the forward (20)
and the forward + backward to every parameter (20), the device
synchronized, and whether the pairs overflowed. The last line is one
JSON record. Inside `utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .bench_common import device_name, timed_ms
from .eval_all import card_line
from .eval_common import add_device_flag

N = 1 << 18
H, W = 352, 640
P_CAP = 1 << 21
FOCAL = 300.0
COMBOS = ((128, 5), (256, 5), (512, 5), (256, 4))


def raster_scene(n=N, height=H, width=W, seed=0):
    """bench_raster.py's surfels as float32 numpy arrays (xyz, log_scale,
    quat, logit_opacity, rgb), drawn in the script's order."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 30.0, size=n).astype(np.float32)
    x = (rng.uniform(0, 1, size=n) - 0.5) * z * width / 300.0
    y = (rng.uniform(0, 1, size=n) - 0.5) * z * height / 300.0
    arrays = (np.stack([x, y, z], -1),
              np.log(rng.uniform(0.02, 0.3, size=(n, 2))),
              rng.normal(size=(n, 4)),
              rng.normal(size=(n, 1)) * 0.5,
              rng.uniform(0, 1, size=(n, 3)))
    return tuple(np.asarray(a, np.float32) for a in arrays)


def identity_camera(focal, height, width, device):
    from ..ops.rasterizer import Camera
    return Camera(w2c=torch.eye(4, device=device), fx=focal, fy=focal,
                  cx=width / 2, cy=height / 2, height=height, width=width)


def time_render(params, cam, kw, device, n_bin, n_fwd, alive=None,
                channels=("rgb", "depth")):
    """(binned, bin ms, forward ms, forward + backward ms) of one binning
    setting: kw holds the binning's p_cap, chunk, side (and v_cap); the
    loss sums the rendered `channels`, as the scripts' `fwd` does."""
    from ..ops.rasterizer import bin_for_camera, render

    def bin_():
        return bin_for_camera(*params, cam, alive=alive, **kw)
    binned = bin_()

    def loss(p):
        r = render(*p, cam, alive=alive, binned=binned, **kw)
        return sum(r[c].sum() for c in channels)

    def fwd():
        with torch.no_grad():
            return loss(params)

    leaves = [p.detach().requires_grad_() for p in params]

    def fwd_bwd():
        return torch.autograd.grad(loss(leaves), leaves)
    return (binned, timed_ms(bin_, device, n=n_bin),
            timed_ms(fwd, device, n=n_fwd), timed_ms(fwd_bwd, device,
                                                     n=n_fwd))


def kernel_line(chunk, device):
    """The built kernels' attributes at this chunk (needs the card);
    raises if a kernel cannot be resident at all."""
    if torch.device(device).type != "cuda":
        return "kernel attributes: no card"
    from ..ops.rasterizer import tile_kernel as tk
    attrs = tk.kernel_attributes(chunk)
    for name, a in attrs.items():
        if a["blocks_per_sm"] < 1:
            raise RuntimeError(f"{name} at chunk {chunk}: no block fits "
                               f"an SM ({a})")
    return "; ".join(f"{k} regs {a['registers']} blocks/SM "
                     f"{a['blocks_per_sm']} smem {a['smem_bytes']} B"
                     for k, a in attrs.items())


def main(argv=None, n=N, height=H, width=W, p_cap=P_CAP, combos=COMBOS,
         reps=(5, 20)):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    rows = []
    with reproducible():
        params = tuple(torch.as_tensor(a, device=device)
                       for a in raster_scene(n, height, width))
        cam = identity_camera(FOCAL, height, width, device)
        for chunk, side in combos:
            print(f"chunk={chunk}: {kernel_line(chunk, device)}",
                  flush=True)
            kw = dict(p_cap=p_cap, chunk=chunk, side=side)
            binned, t_bin, t_fwd, t_bwd = time_render(
                params, cam, kw, device, reps[0], reps[1])
            row = {"chunk": chunk, "side": side,
                   "pairs": int(binned.n_pairs), "bin_ms": t_bin,
                   "fwd_ms": t_fwd, "fwd_bwd_ms": t_bwd,
                   "overflow": bool(binned.overflow)}
            rows.append(row)
            print(f"chunk={chunk} side={side}: pairs={row['pairs']} "
                  f"bin={t_bin:.1f}ms fwd={t_fwd:.1f}ms "
                  f"fwd+bwd={t_bwd:.1f}ms overflow={row['overflow']}",
                  flush=True)
    print(json.dumps({"device": device_name(device), "card": card_line(),
                      "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
