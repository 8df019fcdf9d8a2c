"""Run the five evaluation entry points at their scripts' defaults, one
process each, and write each result to `<out-dir>/<name>.json` with a
`run` record beside the script's keys: the card's name and power limit
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`), the
commit, the arguments, the process's wall seconds (its start-up
included) and, where it matters, a note on what the run used.

Usage: python -m vings_mono_tpu_torch.runners.eval_all
           [--out-dir eval/h100] [--commit TEXT]

Each entry point runs on CUDA. `--commit` defaults to `git rev-parse
HEAD` where the checkout has its history. An entry point that fails is
reported and the others still run; the exit code is then 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RUNS = {"superpoint": "eval_superpoint", "droid": "eval_droid",
        "track_long": "eval_track_long", "loop_e2e": "eval_loop_e2e",
        "long_run": "eval_long_run"}
NOTES = {"superpoint": "the random control is SuperPoint with weights "
                       "drawn from torch.Generator().manual_seed(0) (the "
                       "config's seed), not the JAX package's "
                       "PRNGKey(0) net"}


def _stdout(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out-dir", default=os.path.join("eval", "h100"))
    p.add_argument("--commit", default=None)
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    card = _stdout(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]) or "nvidia-smi: no output"
    commit = args.commit or _stdout(["git", "rev-parse", "HEAD"]) or \
        "unknown"
    failed = []
    for name, module in RUNS.items():
        out = os.path.join(args.out_dir, f"{name}.json")
        entry_argv = ["--out", out]
        cmd = [sys.executable, "-m",
               f"vings_mono_tpu_torch.runners.{module}"] + entry_argv
        print(f"eval_all: {' '.join(cmd)}", flush=True)
        t0 = time.perf_counter()
        rc = subprocess.run(cmd).returncode
        wall = time.perf_counter() - t0
        if rc != 0:
            print(f"eval_all: {name} exited {rc} after {wall:.1f} s",
                  flush=True)
            failed.append(name)
            continue
        with open(out) as f:
            res = json.load(f)
        res["run"] = {"card": card, "commit": commit,
                      "argv": [f"vings_mono_tpu_torch.runners.{module}"]
                      + entry_argv, "wall_s": wall}
        if name in NOTES:
            res["run"]["note"] = NOTES[name]
        with open(out, "w") as f:
            json.dump(res, f, indent=2)
        print(f"eval_all: {name} in {wall:.1f} s -> {out}", flush=True)
    if failed:
        print(f"eval_all: failed: {failed}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
