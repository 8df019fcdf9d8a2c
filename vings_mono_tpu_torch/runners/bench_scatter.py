"""Micro-bench of the backward's pair-gradient -> compact-row reduction,
the counterpart of the JAX package's `scripts/bench_scatter.py`.

Usage: python -m vings_mono_tpu_torch.runners.bench_scatter
           [--device cuda|cpu]

On the binning of `bench_common.synthetic_window`'s first camera (2^18
surfels, 2^18 pair slots, chunk 128, side 3 -> at most 9 pairs per
compact row), a (P, 24) f32 gradient table from numpy's generator 0 is
reduced into the (V + 1, 24) compact rows by
- A `index_add_` (what the port's f32 reduction runs);
- B a fixed fan-in gather: the (V + 1, 9) table of each row's pair slots
  (P for none) gathers rows of the table padded by a zero row, summed
  over the 9;
- C B with the table cast to bf16 (the port's default reduction);
- D C padded to 32 lanes;
- E the pairs permuted so that each row's are contiguous, a segmented
  Hillis-Steele scan (ceil(log2 9) passes), one gather at each row's last
  pair.
Each variant runs R = 50 times on an iteration-dependent input (g * (1 +
1e-6 i)) into an accumulator; host ms per run, the device synchronized.
JAX's `optimization_barrier` (which kept XLA from fusing the bf16 cast
into the gather) has no PyTorch counterpart: eager ops do not fuse. A is
timed inside `utils.device.reproducible` (deterministic `index_add_`, as
the runners run it) and again outside it (atomics). The errors of B-E
against A are relative to A's largest magnitude. The last line is one
JSON record.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .bench_common import (WINDOW_MAPPER, device_name, load, sync,
                           synthetic_window)
from .eval_all import card_line
from .eval_common import add_device_flag

C = 24
R = 50


def inverse_table(pair_idx, V, kmax):
    """(V + 1, kmax) int64: each compact row's first kmax pair slots in
    slot order, P where a row has fewer (the script's host loop)."""
    P = pair_idx.shape[0]
    slots = np.nonzero(pair_idx < V)[0]
    rows = pair_idx[slots]
    order = np.argsort(rows, kind="stable")
    rows, slots = rows[order], slots[order]
    first = np.searchsorted(rows, rows, side="left")
    rank = np.arange(len(rows)) - first
    keep = rank < kmax
    tbl = np.full((V + 1, kmax), P, np.int64)
    tbl[rows[keep], rank[keep]] = slots[keep]
    return tbl


def variants(pair_idx, V, kmax, device):
    """{name: fn(g (P, C) f32) -> (V + 1, C) f32} for pair_idx (P,) numpy
    (compact row per pair slot, V for none)."""
    tbl = torch.as_tensor(inverse_table(pair_idx, V, kmax), device=device)
    idx = torch.as_tensor(pair_idx.astype(np.int64), device=device)
    order_np = np.argsort(pair_idx, kind="stable")
    rid_np = pair_idx[order_np]
    P = pair_idx.shape[0]
    bounds = np.searchsorted(rid_np, np.arange(V + 1))
    order = torch.as_tensor(order_np, device=device)
    rid = torch.as_tensor(rid_np.astype(np.int64), device=device)
    mask = torch.as_tensor(bounds[1:] > bounds[:-1], device=device)
    last = torch.as_tensor(np.clip(bounds[1:] - 1, 0, P - 1),
                           device=device)
    nseg = int(math.ceil(math.log2(kmax)))

    def padded(g, lanes=None):
        gp = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        if lanes:
            gp = torch.nn.functional.pad(gp, (0, lanes - g.shape[1]))
        return gp

    def a(g):
        return g.new_zeros((V + 1, g.shape[1])).index_add_(0, idx, g)

    def b(g):
        return padded(g)[tbl].sum(dim=1)

    def c(g):
        return padded(g).to(torch.bfloat16)[tbl].float().sum(dim=1)

    def d(g):
        gp = padded(g, 32).to(torch.bfloat16)
        return gp[tbl].float().sum(dim=1)[:, :g.shape[1]]

    def e(g):
        s = g[order]
        shift = 1
        for _ in range(nseg):
            same = (rid[shift:] == rid[:-shift])[:, None]
            s = s + torch.cat([s.new_zeros((shift, s.shape[1])),
                               torch.where(same, s[:-shift], 0.0)])
            shift *= 2
        seg = s[last] * mask[:, None]
        return torch.cat([seg, g.new_zeros((1, g.shape[1]))])

    return {"A index_add_": a, "B table gather f32": b,
            "C table gather bf16": c, "D bf16 padded32": d,
            "E permute f32 + segscan": e}


def timed_reps(fn, g0, V, device, reps=R):
    """(ms per run, the accumulated result / reps)."""
    def reps_run():
        acc = g0.new_zeros((V + 1, g0.shape[1]))
        for i in range(reps):
            acc = acc + fn(g0 * (1.0 + 1e-6 * i))
        return acc
    reps_run()
    sync(device)
    t0 = time.perf_counter()
    out = reps_run()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps, out / reps


def rel_err(ref, x, V):
    return float((ref[:V] - x[:V]).abs().max()
                 / (ref[:V].abs().max() + 1e-9))


def main(argv=None, extra=None, height=240, width=432):
    p = argparse.ArgumentParser()
    add_device_flag(p)
    args = p.parse_args(argv)
    from ..utils.device import reproducible, resolve_device
    device = resolve_device(args.device)
    with reproducible():
        cfg = load({"mapper": dict(WINDOW_MAPPER)}, extra, device)
        mapper, _, binned, _ = synthetic_window(cfg, device, height, width)
        pair_idx = binned.pair_idx[0].cpu().numpy().astype(np.int64)
        V = int(binned.sel.shape[1])
        P = pair_idx.shape[0]
        kmax = int(mapper.bin_kwargs["side"]) ** 2
        deg = np.bincount(pair_idx[pair_idx < V], minlength=V)
        print(f"P={P} V={V} valid_pairs={int((pair_idx < V).sum())} "
              f"KMAX={kmax} max degree={int(deg.max())} mean="
              f"{deg.mean():.2f}", flush=True)
        g0 = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (P, C)), dtype=torch.float32, device=device)
        fns = variants(pair_idx, V, kmax, device)
        ms, res = {}, {}
        for name, fn in fns.items():
            ms[name], res[name] = timed_reps(fn, g0, V, device)
            print(f"{name:<40} {ms[name]:7.3f} ms", flush=True)
    name = "A index_add_ outside reproducible"
    ms[name], _ = timed_reps(fns["A index_add_"], g0, V, device)
    print(f"{name:<40} {ms[name]:7.3f} ms", flush=True)
    ref = res["A index_add_"]
    errs = {k[0]: rel_err(ref, v, V) for k, v in res.items()
            if k[0] != "A"}
    print("errs " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    out = {"device": device_name(device), "card": card_line(), "ms": ms,
           "rel_err": errs}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
