"""What `utils.device.reproducible` buys and costs on the card.

    python3 profile_reproducible.py [--source]

Needs a CUDA card. Without arguments (about 8 minutes on one H100: the
profiler's overhead) it runs chip_smoke.py's phase-4 replay (KITTI-0028's
mapper on 5 synthetic keyframes at 240x800) through
`runners.run_mapping.run` and then profiles one more keyframe, and
`runners.run_tracking.run` over 20 frames of a written kitti_sync folder
under torch.profiler, each twice with the mode and twice with it swapped
for a null context. Prints the keyframe and run times, and per device
kernel and per host op the time and count with the mode, without it, and
the difference (first run of each).

With --source (about 6 minutes) it looks for the source of the card's
run-to-run spread instead: chip_smoke.py phase 14's run (smoke.yaml with
use_metric, 30 frames) twice under each of four modes (no flag; PyTorch's
deterministic algorithms alone, without the NaN fill; cuDNN's
deterministic algorithms alone; the whole mode) and the largest gap
between the two runs' keyframe poses. cuBLAS's workspace is fixed in all
four: `resolve_device` sets it before the first cuBLAS call."""
import contextlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402


def ops(prof):
    dev, host = {}, {}
    for ev in prof.key_averages():
        if "CUDA" in str(getattr(ev, "device_type", "")):
            us = getattr(ev, "self_device_time_total", 0)
            dev[ev.key] = (us / 1e3, ev.count)
        else:
            host[ev.key] = (ev.self_cpu_time_total / 1e3, ev.count)
    return dev, host


def diff(tag, a, b, top=25):
    keys = set(a) | set(b)
    rows = sorted(((a.get(k, (0, 0))[0] - b.get(k, (0, 0))[0], k)
                   for k in keys), reverse=True)
    print(f"{tag}: total with {sum(v[0] for v in a.values()):.1f} ms "
          f"{sum(v[1] for v in a.values())} ops, without "
          f"{sum(v[0] for v in b.values()):.1f} ms "
          f"{sum(v[1] for v in b.values())} ops", flush=True)
    for d, k in rows[:top]:
        wa, wb = a.get(k, (0, 0)), b.get(k, (0, 0))
        print(f"  {d:+9.2f} ms  with {wa[0]:8.2f} ms {wa[1]:7d}x  without "
              f"{wb[0]:8.2f} ms {wb[1]:7d}x  {k[:100]}", flush=True)


def profiled(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, ops(prof), out


def source():
    """Phase 14's run twice under each mode: the pose gap of the two."""
    import tempfile
    import torch
    import yaml
    from vings_mono_tpu_torch.runners import run as run_mod
    from vings_mono_tpu_torch.utils import device as device_mod
    from vings_mono_tpu_torch.utils.config import load_config
    from vings_mono_tpu_torch.utils.device import resolve_device
    resolve_device("cuda")
    print(f"torch {torch.__version__} [{cs.nvidia_smi()}]", flush=True)
    root = cs.OUT / "source"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke_metric.yaml")
        with open(path, "w") as f:
            f.write(yaml.safe_dump(load_config(str(cs.SMOKE), overrides={
                **cs.METRIC_OVERRIDES, "output": {"save_dir": str(root)},
                "device": {"tracker": "cuda", "mapper": "cuda"}})))
        cfg = load_config(path)
    modes = {"none": (False, False, False, False, True),
             "algorithms": (True, False, False, False, False),
             "cudnn": (False, False, True, False, True),
             "all": device_mod.DETERMINISTIC}
    for name, flags in modes.items():
        @contextlib.contextmanager
        def mode():
            saved = device_mod.read_deterministic()
            device_mod.write_deterministic(flags)
            try:
                yield
            finally:
                device_mod.write_deterministic(saved)
        poses = []
        for k in range(2):
            t0 = time.perf_counter()
            with cs.replaced(device_mod, "reproducible", mode):
                tracker, mapper, _ = run_mod.run(cfg, str(root / name))
            torch.cuda.synchronize()
            poses.append(cs.poses_by_ts(tracker))
            print(f"source {name} run {k}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            del tracker, mapper
        a, b = poses
        common = sorted(set(a) & set(b))
        same = sorted(a) == sorted(b) and all(
            np.array_equal(a[t], b[t]) for t in a)
        dist, ang = cs.pose_gap(a, b, common)
        print(f"source {name} {flags}: keyframes {len(a)} / {len(b)}, "
              f"{'bitwise equal' if same else 'NOT equal'}, largest pose "
              f"gap over {len(common)} shared {dist:.4e} units / {ang:.4e} "
              f"deg", flush=True)


def main():
    if "--source" in sys.argv[1:]:
        return source()
    import torch
    from vings_mono_tpu_torch.utils.device import resolve_device
    from vings_mono_tpu_torch.utils import device as device_mod
    resolve_device("cuda")
    from vings_mono_tpu_torch.utils import cuda_build
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    from vings_mono_tpu_torch.utils.config import load_config
    from vings_mono_tpu_torch.runners import run_mapping, run_tracking
    from vings_mono_tpu_torch.datasets.replay import ReplayDataset
    print(f"torch {torch.__version__} [{cs.nvidia_smi()}]", flush=True)
    cuda_build.build()
    win_dir = cs.OUT / "windows"
    cfg = load_config(str(cs.CONFIG), overrides={
        "dataset": {"root": str(win_dir)},
        "output": {"save_dir": str(cs.OUT / "run")},
        "training_args": {"iters": 100}, "seed": 0,
        "device": {"mapper": "cuda"}})
    n = cs.write_windows(win_dir, 6, int(cfg["mapper"]["kf_capacity"]), 0)
    last = ReplayDataset(cfg)[n - 1]
    null = contextlib.nullcontext
    res = {}
    for tag, ctx in (("with", device_mod.reproducible), ("without", null),
                     ("with2", device_mod.reproducible), ("without2", null)):
        with cs.replaced(device_mod, "reproducible", ctx):
            mapper, records = run_mapping.run(cfg, str(cs.OUT / "run"))
        window = dict(last)
        st = np.asarray(window["viz_out_idx_to_f_idx"]).copy()
        st[-1] += 1
        window["viz_out_idx_to_f_idx"] = st
        with ctx():
            wall, (dev, host), _ = profiled(lambda: mapper.run(window))
        res[tag] = (dev, host)
        print(f"mapper {tag}: keyframes {[round(r['ms'], 1) for r in records]}"
              f" ms; profiled keyframe {wall:.1f} ms wall", flush=True)
        mapper.close()
        del mapper
    diff("mapper device", res["with"][0], res["without"][0])
    diff("mapper host", res["with"][1], res["without"][1])

    root = cs.OUT / "kitti"
    folder = root / "folder"
    kcfg = cs.kitti_cfg(folder, root)
    cs.write_kitti_sync(folder, 20, float(kcfg["dataset"]["imu_delay"]))
    res = {}
    for tag, ctx in (("with", device_mod.reproducible), ("without", null),
                     ("with2", device_mod.reproducible), ("without2", null)):
        with cs.replaced(device_mod, "reproducible", ctx):
            wall, (dev, host), _ = profiled(
                lambda: run_tracking.run(kcfg, str(root / tag)))
        res[tag] = (dev, host)
        print(f"tracker {tag}: 20 frames {wall:.1f} ms wall", flush=True)
    diff("tracker device", res["with"][0], res["without"][0])
    diff("tracker host", res["with"][1], res["without"][1])


if __name__ == "__main__":
    main()
