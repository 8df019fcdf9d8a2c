"""Mapping-only replay runner (reference scripts/run_mapping.py): feed
recorded viz_out windows (`vizout_*.npz` under `dataset.root`) straight
into the mapper.

    python -m vings_mono_tpu_torch.runners.run_mapping <config.yaml>
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch


def run(cfg, save_dir, max_windows=None, device=None):
    """Map every window; returns (mapper, records) with one record per
    window: wall ms, n_alive, the train PSNR of the first and the last
    iteration, the last iteration's loss, whether every iteration's loss
    was finite, and the pair bucket. The run is reproducible
    (`utils.device.reproducible`)."""
    from ..datasets.replay import ReplayDataset
    from ..mapper.mapper import GaussianMapper
    from ..utils.device import reproducible

    with reproducible():
        dataset = ReplayDataset(cfg)
        mapper = GaussianMapper(cfg, device=device)
        try:
            records = _map_windows(dataset, mapper, save_dir, max_windows)
        finally:
            mapper.close()
    return mapper, records


def _map_windows(dataset, mapper, save_dir, max_windows):
    n = len(dataset) if max_windows is None else min(len(dataset),
                                                     max_windows)
    os.makedirs(os.path.join(save_dir, "ply"), exist_ok=True)
    records = []
    for idx in range(n):
        window = dataset[idx]
        p_cap = mapper.bin_kwargs["p_cap"]
        t0 = time.perf_counter()
        mapper.run(window)
        if mapper.device.type == "cuda":
            torch.cuda.synchronize(mapper.device)
        ms = (time.perf_counter() - t0) * 1e3
        m = mapper.last_metrics
        losses = mapper.metrics.get("loss_per_iter")
        psnrs = mapper.metrics.get("psnr_per_iter")
        rec = {"window": idx, "ms": ms, "n_alive": mapper.n_alive,
               "psnr_start": math.nan if psnrs is None else float(psnrs[0]),
               "psnr": m.get("psnr", math.nan),
               "loss": m.get("total", math.nan),
               "losses_finite": bool(losses is not None
                                     and torch.isfinite(losses).all()),
               "p_cap": p_cap}
        records.append(rec)
        print(f"window {idx}: {ms:.1f} ms, n_alive {rec['n_alive']}, "
              f"psnr {rec['psnr_start']:.3f} -> {rec['psnr']:.3f}, loss {rec['loss']:.5f}, "
              f"p_cap {p_cap}", flush=True)
        if (idx + 1) % 50 == 0:
            mapper.save_ply(os.path.join(save_dir, "ply",
                                         f"map_{idx:06d}.ply"))
    mapper.save_ply(os.path.join(save_dir, "ply", "final_2dgs.ply"))
    print(f"mapped {n} windows, {mapper.n_alive} gaussians, "
          f"last metrics: {mapper.last_metrics}")
    return records


def main(argv=None):
    from ..utils.config import load_config, make_run_dir
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--prefix", default="")
    p.add_argument("--max-windows", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the config's, cuda)")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    save_dir = make_run_dir(cfg, args.prefix)
    run(cfg, save_dir, args.max_windows, device=args.device)


if __name__ == "__main__":
    main()
