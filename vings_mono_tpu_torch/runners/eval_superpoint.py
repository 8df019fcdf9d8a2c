"""Evaluate the self-trained SuperPoint weights on held-out room pairs
against a random-init control, through the chain loop closure runs:
`LoopDetector.extract` -> `match` -> `pnp_history_pose`. Per net: mean
matches, PnP successes (position within 0.25 units of the truth) and the
median position error; `trained_beats_random` is lexicographic (more
successes, or on a tie a median error at least 20 % lower).

Usage: python -m vings_mono_tpu_torch.runners.eval_superpoint
           [--weights vings_mono_tpu/weights/superpoint_selftrained.npz]
           [--pairs 12] [--hw 240 320] [--out FILE] [--device cuda|cpu]

The random control draws SuperPoint's weights from a torch generator
seeded with the config's `seed` (0): a different random net from the one
the JAX package draws from its own PRNG.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..datasets.synthetic3d import render_room, texture_params
from .eval_common import SUPERPOINT_WEIGHTS, add_device_flag, emit

SEED = 20260817
PNP_OK = 0.25      # position error of a recovered pose, room units


def _pair(rng, h, w, room=4.0, sharp=1.0):
    """Two views of a textured room with a revisit's viewpoint change
    (~0.5 units of baseline, ~20 degrees of yaw): rgb, depth and c2w of
    each, and the intrinsics (fx, fy, cx, cy)."""
    f = rng.uniform(0.9, 1.1) * w * 0.75
    intr4 = np.asarray([f, f, w / 2, h / 2], np.float32)
    tex = texture_params(rng.integers(1 << 31), sharpness=sharp)

    def c2w_of(pos, yaw, pitch):
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        m = np.eye(4)
        m[:3, :3] = Ry @ Rx
        m[:3, 3] = pos
        return m

    pos = rng.uniform(-0.4, 0.4, 3) * room
    yaw, pitch = rng.uniform(-np.pi, np.pi), rng.uniform(-0.3, 0.3)
    a = c2w_of(pos, yaw, pitch)
    # a hard viewpoint change: near-identity pairs let even random
    # descriptors recover every pose, which tells the nets apart nowhere
    b = c2w_of(pos + rng.normal(size=3) * 0.55, yaw + rng.normal() * 0.35,
               np.clip(pitch + rng.normal() * 0.12, -0.4, 0.4))
    rgb_a, dep_a = render_room(a, intr4, h, w, room, tex=tex)
    rgb_b, dep_b = render_room(b, intr4, h, w, room, tex=tex)
    return rgb_a, dep_a, a, rgb_b, dep_b, b, intr4


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default=SUPERPOINT_WEIGHTS)
    p.add_argument("--pairs", type=int, default=12)
    p.add_argument("--hw", type=int, nargs=2, default=(240, 320))
    p.add_argument("--out", default=None)
    add_device_flag(p)
    args = p.parse_args(argv)

    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    with reproducible():
        out = evaluate(args, device)
    return emit(out, args.out)


def evaluate(args, device):
    from ..loop.detect import LoopDetector
    cfg = {}
    det_t = LoopDetector(cfg, args.weights, device=device)
    det_r = LoopDetector(cfg, None, device=device)    # random-init control

    h, w = args.hw
    rng = np.random.default_rng(SEED)
    stats = {"trained": {"matches": [], "pnp_ok": 0, "pos_err": []},
             "random": {"matches": [], "pnp_ok": 0, "pos_err": []}}
    for i in range(args.pairs):
        rgb_a, dep_a, c2w_a, rgb_b, dep_b, c2w_b, intr4 = _pair(rng, h, w)
        for name, det in (("trained", det_t), ("random", det_r)):
            fa = det.extract(rgb_a)
            fb = det.extract(rgb_b)
            kp_a, kp_b = det.match(fa, fb, img_hw=(h, w))
            stats[name]["matches"].append(int(len(kp_a)))
            c2w = det.pnp_history_pose(kp_a, kp_b, dep_a, c2w_a, intr4)
            if c2w is not None:
                err = float(np.linalg.norm(c2w[:3, 3] - c2w_b[:3, 3]))
                if err < PNP_OK:
                    stats[name]["pnp_ok"] += 1
                stats[name]["pos_err"].append(round(err, 4))
        print(f"pair {i + 1}/{args.pairs} done", file=sys.stderr)

    out = {}
    for name, s in stats.items():
        out[name] = {
            "mean_matches": float(np.mean(s["matches"])),
            "pnp_success": s["pnp_ok"],          # count out of `pairs`
            "pnp_success_rate": s["pnp_ok"] / args.pairs,
            "median_pos_err_m": (float(np.median(s["pos_err"]))
                                 if s["pos_err"] else None),
        }
    out["pairs"] = args.pairs
    t, r = out["trained"], out["random"]
    out["trained_beats_random"] = (
        t["pnp_success"] > r["pnp_success"]
        or (t["pnp_success"] == r["pnp_success"]
            and t["median_pos_err_m"] is not None
            and r["median_pos_err_m"] is not None
            and t["median_pos_err_m"] < 0.8 * r["median_pos_err_m"]))
    return out


if __name__ == "__main__":
    main()
