"""Single-process mobile variant (reference scripts/run_mobile.py): the
flagship pipeline with a 3DGS .ply of the map every `--ply-every` frames
for on-device viewers.

Usage: python -m vings_mono_tpu_torch.runners.run_mobile <config.yaml>
           [--prefix NAME] [--ply-every N] [--max-frames N]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os


def run(cfg, save_dir, max_frames=None, ply_every=300, device=None):
    """`runners.run.run` that writes ply/map_<idx>_3dgs.ply after every
    `ply_every`-th frame once the map exists. Returns run's result. The
    run is reproducible (`utils.device.reproducible`, entered by
    `runners.run.run`)."""
    from .run import run as run_all

    def on_frame(idx, tracker, mapper, viz_out):
        if mapper.initialized and idx % ply_every == ply_every - 1:
            mapper.save_ply(os.path.join(save_dir, "ply",
                                         f"map_{idx:06d}_3dgs.ply"),
                            mode="3dgs")

    os.makedirs(os.path.join(save_dir, "ply"), exist_ok=True)
    return run_all(cfg, save_dir, max_frames, on_frame=on_frame,
                   device=device)


def main(argv=None):
    from ..utils.config import load_config, make_run_dir
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--prefix", default="mobile_")
    p.add_argument("--ply-every", type=int, default=300)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the config's, cuda)")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    save_dir = make_run_dir(cfg, args.prefix)
    run(cfg, save_dir, args.max_frames, args.ply_every, device=args.device)


if __name__ == "__main__":
    main()
