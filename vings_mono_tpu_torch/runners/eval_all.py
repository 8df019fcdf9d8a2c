"""Run the five evaluation entry points at their scripts' defaults, one
process each, and write each result to `<out-dir>/<name>.json` with a
`run` record beside the script's keys: the card's name and power limit
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`), the
commit, the arguments, the process's wall seconds (its start-up
included) and, where it matters, a note on what the run used; what each
printed goes to `<out-dir>/<name>.log`.

Usage: python -m vings_mono_tpu_torch.runners.eval_all
           [--out-dir eval/h100] [--commit TEXT]

Each entry point runs on CUDA. `--commit` defaults to `git rev-parse
HEAD` where the checkout has its history. An entry point that fails is
reported and the others still run; the exit code is then 1.
`run_entry_points` is the loop, shared with `bench_all`.
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
    """The lines `cmd` printed, or none where it could not run."""
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return []


def card_lines():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    lines, one a card, or a note that it gave none."""
    return _stdout(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]) or ["nvidia-smi: no output"]


def card_line():
    """The first card's line of `card_lines`."""
    return card_lines()[0]


def commit_of(commit=None):
    """`commit`, else `git rev-parse HEAD` where the checkout has its
    history, else "unknown"."""
    return commit or (_stdout(["git", "rev-parse", "HEAD"])
                      or ["unknown"])[0]


def last_json(text):
    """The last line of `text` that parses as a JSON object, or None."""
    for line in reversed(text.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


def run_entry_points(tag, runs, out_dir, commit=None, notes=None):
    """`python -m vings_mono_tpu_torch.runners.<module>` for each name ->
    module of `runs`, one process each, in order. What it printed goes to
    `<out_dir>/<name>.log`; its record, the last JSON object it printed,
    to `<out_dir>/<name>.json` with the `run` record beside its keys.
    Returns the names that failed (a non-zero exit, or no record)."""
    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    commit = commit_of(commit)
    failed = []
    for name, module in runs.items():
        module = f"vings_mono_tpu_torch.runners.{module}"
        cmd = [sys.executable, "-m", module]
        print(f"{tag}: {' '.join(cmd)}", flush=True)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
            f.write(proc.stdout)
            f.write(proc.stderr)
        rec = last_json(proc.stdout)
        if proc.returncode != 0 or rec is None:
            print(f"{tag}: {name} exited {proc.returncode} after "
                  f"{wall:.1f} s; its stderr ends:\n{proc.stderr[-3000:]}",
                  flush=True)
            failed.append(name)
            continue
        rec["run"] = {"card": card, "commit": commit, "argv": [module],
                      "wall_s": wall}
        if name in (notes or {}):
            rec["run"]["note"] = notes[name]
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(rec, f, indent=2)
        print(f"{tag}: {name} in {wall:.1f} s:\n{proc.stdout[-4000:]}",
              flush=True)
    if failed:
        print(f"{tag}: failed: {failed}", flush=True)
    return failed


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out-dir", default=os.path.join("eval", "h100"))
    p.add_argument("--commit", default=None)
    args = p.parse_args(argv)
    if run_entry_points("eval_all", RUNS, args.out_dir, args.commit, NOTES):
        sys.exit(1)


if __name__ == "__main__":
    main()
