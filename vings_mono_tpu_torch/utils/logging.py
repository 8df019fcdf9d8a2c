"""Experiment logging: to wandb where `use_wandb` is set and wandb imports,
and always to a local JSONL file `save_dir/metrics.jsonl` when a save dir
is given, so a headless run keeps its record."""

from __future__ import annotations

import json
import os
import time


class Logger:
    def __init__(self, cfg, run_name="run", save_dir=None):
        self.enabled_wandb = bool(cfg.get("use_wandb"))
        self.wandb = None
        if self.enabled_wandb:
            try:
                import wandb
            except ImportError:
                print("use_wandb is set but wandb does not import: logging "
                      "to metrics.jsonl only")
            else:
                self.wandb = wandb
                wandb.init(project=cfg.get("wandb_project", "vings_tpu"),
                           name=run_name, config=cfg)
        self.jsonl = None
        if save_dir:
            self.jsonl = open(os.path.join(save_dir, "metrics.jsonl"), "a")
        self._timers = {}

    def log_once(self, name, value, step=None):
        if self.wandb is not None:
            self.wandb.log({name: value}, step=step)
        if self.jsonl is not None:
            self.jsonl.write(json.dumps(
                {"t": time.time(), "name": name, "value": float(value),
                 "step": step}) + "\n")
            self.jsonl.flush()

    def log_time(self, name):
        """Paired calls: the first starts the timer `name`, the second logs
        `time/<name>_ms`."""
        now = time.perf_counter()
        if name in self._timers:
            self.log_once(f"time/{name}_ms",
                          (now - self._timers.pop(name)) * 1e3)
        else:
            self._timers[name] = now

    def close(self):
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None
