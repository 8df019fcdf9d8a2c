"""Run the measurement entry points at their scripts' sizes, one process
each, on the card, and keep each one's output: `<out-dir>/<name>.log`
(everything it printed) and `<out-dir>/<name>.json` (its last JSON line,
with a `run` record: the card's name and power limit from `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`, the commit, the
arguments, the process's wall seconds, its start-up and the kernels'
first build included).

Usage: python -m vings_mono_tpu_torch.runners.bench_all
           [--out-dir output/bench] [--commit TEXT]

`--commit` defaults to `git rev-parse HEAD` where the checkout has its
history. An entry point that fails is reported and the others still
run; the exit code is then 1. The loop is `eval_all.run_entry_points`.
"""

from __future__ import annotations

import argparse
import os
import sys

from .eval_all import run_entry_points

RUNS = ("bench", "profile_overlap", "bench_profile", "mfu",
        "profile_map_run", "profile_train", "bench_mapper", "bench_tracker",
        "bench_tracker_micro", "bench_raster", "tune_binning",
        "profile_host", "bench_scatter", "profile_train_map",
        "report_parity")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out-dir", default=os.path.join("output", "bench"))
    p.add_argument("--commit", default=None)
    args = p.parse_args(argv)
    if run_entry_points("bench_all", {n: n for n in RUNS}, args.out_dir,
                        args.commit):
        sys.exit(1)


if __name__ == "__main__":
    main()
