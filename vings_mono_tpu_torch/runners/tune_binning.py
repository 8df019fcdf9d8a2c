"""Pair counts and binning / forward / backward times against the
binning's capacities, the counterpart of the JAX package's
`scripts/tune_binning.py`.

Usage: python -m vings_mono_tpu_torch.runners.tune_binning
           [--device cuda|cpu]

60000 alive surfels in a 2^18-row map at 240x432 (`binning_scene`,
numpy's generator 0 as the script draws them; dead rows zero), the
identity camera at focal 220, over the script's grid of (v_cap, p_cap,
chunk, side): (2^16, 2^18, 128, 3), (2^16, 2^18, 256, 3), (2^16, 2^17,
128, 3), (2^16, 2^17, 256, 3). For each: the pair count, whether it
overflowed, chunks used of p_cap / chunk, and host ms per call (10 calls,
the device synchronized) of the binning, the forward and the forward +
backward (the loss sums rgb, depth and dist). The last line is one JSON
record. Inside `utils.device.reproducible`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .bench_common import device_name
from .bench_raster import identity_camera, kernel_line, time_render
from .eval_all import card_line
from .eval_common import add_device_flag

H, W = 240, 432
N_CAP = 1 << 18
N_ALIVE = 60000
F = 220.0
GRID = ((1 << 16, 1 << 18, 128, 3), (1 << 16, 1 << 18, 256, 3),
        (1 << 16, 1 << 17, 128, 3), (1 << 16, 1 << 17, 256, 3))


def binning_scene(n_cap=N_CAP, n_alive=N_ALIVE, height=H, width=W,
                  focal=F, seed=0):
    """tune_binning.py's map as float32 numpy arrays (xyz, log_scale,
    quat, logit_opacity, rgb; the first n_alive rows drawn in the
    script's order, the rest zero) and its alive mask."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 30.0, size=n_alive).astype(np.float32)
    x = (rng.uniform(0, 1, size=n_alive) - 0.5) * z * width / focal
    y = (rng.uniform(0, 1, size=n_alive) - 0.5) * z * height / focal

    def full(a):
        out = np.zeros((n_cap,) + a.shape[1:], np.float32)
        out[:n_alive] = a
        return out
    params = (full(np.stack([x, y, z], -1)),
              full(np.log(rng.uniform(0.05, 0.4, size=(n_alive, 2)))),
              full(rng.normal(size=(n_alive, 4))),
              full(rng.normal(size=(n_alive, 1)) * 0.5 + 1.0),
              full(rng.uniform(0, 1, size=(n_alive, 3))))
    return params, np.arange(n_cap) < n_alive


def main(argv=None, scene=None, height=H, width=W, grid=GRID, reps=10):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    params, alive = scene or binning_scene()
    rows = []
    with reproducible():
        params = tuple(torch.as_tensor(a, device=device) for a in params)
        alive = torch.as_tensor(alive, device=device)
        cam = identity_camera(F, height, width, device)
        for v_cap, p_cap, chunk, side in grid:
            print(f"chunk={chunk}: {kernel_line(chunk, device)}",
                  flush=True)
            kw = dict(p_cap=p_cap, chunk=chunk, side=side, v_cap=v_cap)
            binned, t_bin, t_fwd, t_bwd = time_render(
                params, cam, kw, device, reps, reps, alive=alive,
                channels=("rgb", "depth", "dist"))
            row = dict(kw, pairs=int(binned.n_pairs),
                       chunks=int(binned.n_chunks),
                       overflow=bool(binned.overflow), bin_ms=t_bin,
                       fwd_ms=t_fwd, bwd_ms=t_bwd)
            rows.append(row)
            print(f"v{v_cap:>6} p{p_cap:>8} c{chunk:>3} side{side}: "
                  f"pairs {row['pairs']:>7} "
                  f"({'OVF' if row['overflow'] else 'ok '}) "
                  f"chunks {row['chunks']:>5}/{p_cap // chunk:>5} | "
                  f"bin {t_bin:6.1f} fwd {t_fwd:6.1f} bwd {t_bwd:6.1f} ms",
                  flush=True)
    print(json.dumps({"device": device_name(device), "card": card_line(),
                      "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
