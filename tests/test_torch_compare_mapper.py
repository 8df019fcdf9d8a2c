"""A comparison tool, run as a script (pytest collects no test here): the
JAX mapper and its PyTorch port side by side on the CPU over the
synthetic KITTI-like windows of chip_smoke.py, at a reduced image size,
with the JAX random draws replayed into the port, and print per-window
train PSNR, loss and Gaussian count of both.

    JAX_PLATFORMS=cpu python tests/test_torch_compare_mapper.py \
        [--height 64] [--width 208] [--keyframes 8] [--iters 100]

Capacities and point budgets of the KITTI 2011_09_30_drive_0028 config are
scaled by the pixel count; the JAX rasterizer runs its Pallas kernels in
interpret mode, the port its kernels' plain twins.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from vings_mono_tpu.mapper.mapper import GaussianMapper as JaxMapper  # noqa
from vings_mono_tpu.utils.config import load_config as jax_config  # noqa
from vings_mono_tpu_torch.datasets.replay import ReplayDataset  # noqa
from vings_mono_tpu_torch.mapper.mapper import GaussianMapper  # noqa
from vings_mono_tpu_torch.utils.config import load_config  # noqa


def replay_jax_draws(mapper, seed):
    """Feed the port the JAX mapper's key stream (mapper.py `_next_key`)."""
    key = [jax.random.PRNGKey(seed)]

    def next_key():
        key[0], k = jax.random.split(key[0])
        return k

    def densify(n_points):
        k = next_key()
        g = jax.random.gumbel(k, (mapper.H * mapper.W,))
        q = jax.random.normal(jax.random.fold_in(k, 1), (n_points, 4))
        return torch.tensor(np.asarray(g)), torch.tensor(np.asarray(q))

    def schedule(iters, n_valid):
        k, out = next_key(), []
        for _ in range(iters):
            k, k1 = jax.random.split(k)
            out.append(int(jax.random.randint(k1, (), 0, max(n_valid, 1))))
        return out

    mapper._densify_draws = densify
    mapper._kf_schedule = schedule


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=208)
    p.add_argument("--keyframes", type=int, default=8)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    h, w = args.height, args.width
    cs = chip_smoke
    cs.H, cs.W = h, w
    k = cs.KITTI
    cs.INTRINSIC = {"fu": k["fu"] * h / k["H"], "fv": k["fv"] * w / k["W"],
                    "cu": k["cu"] * h / k["H"], "cv": k["cv"] * w / k["W"],
                    "H": h, "W": w}
    root = ROOT / "output" / "port_compare" / "windows"
    n = cs.write_windows(root, args.keyframes, 16, args.seed)
    frac = h * w / (240 * 800)
    cap = int(524288 * frac) // 128 * 128
    over = {"mapper": {"capacity": cap, "pair_capacity": cap,
                       "visible_capacity": int(131072 * frac),
                       "points_per_frame": int(40000 * frac),
                       "points_first_frame": int(50000 * frac)},
            "training_args": {"iters": args.iters}, "seed": args.seed,
            "dataset": {"root": str(root)}}
    jm = JaxMapper(jax_config(str(cs.CONFIG), {
        **over, "mapper": {**over["mapper"], "interpret": True}}))
    tm = GaussianMapper(load_config(str(cs.CONFIG), over), device="cpu")
    replay_jax_draws(tm, args.seed)
    data = ReplayDataset(load_config(str(cs.CONFIG), over))
    print(f"{h}x{w}, capacity {cap}, {n} windows x {args.iters} iters")
    for i in range(n):
        t0 = time.perf_counter()
        jm.run(data[i])
        t1 = time.perf_counter()
        tm.run(data[i])
        t2 = time.perf_counter()
        a, b = jm.last_metrics, tm.last_metrics
        print(f"window {i}: jax psnr {a['psnr']:.3f} loss {a['total']:.4f} "
              f"n_alive {jm.n_alive} | port psnr {b['psnr']:.3f} loss "
              f"{b['total']:.4f} n_alive {tm.n_alive} "
              f"(cpu s: jax {t1 - t0:.0f}, port {t2 - t1:.0f})", flush=True)


if __name__ == "__main__":
    main()
