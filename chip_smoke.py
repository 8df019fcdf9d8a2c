"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--keyframes 10] [--iters 100]

Phases, each printing its own lines; any failure exits non-zero:
  1. build the CUDA kernels (csrc/*.cu) and print the build seconds;
  2. forward tile kernel against its plain PyTorch twin on a real binning
     of a mapper state at 240x800;
  3. backward tile kernel (f32 and bf16 output) against its plain twin on
     the same binning with a random cotangent;
  4. the mapping slice: `runners.run_mapping.run` over synthetic KITTI-like
     keyframes with the KITTI 2011_09_30_drive_0028 mapper settings,
     checking finite losses, rising PSNR, kernel launches on every train
     iteration and the final .ply;
  5. kernel and plain-twin times with CUDA events at the slice's shapes,
     beside each kernel's bound;
  6. one more keyframe under torch.profiler: device busy time, idle share
     and the largest device ops.
The second-to-last line is the card's name and power limit, the last line
a JSON summary. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG = ROOT / "configs/kitti/sync/kitti_2011_09_30_drive_0028.yaml"
OUT = ROOT / "output" / "chip_smoke"
DEVICE = "cuda"
H, W = 240, 800
# KITTI 2011_09_30 intrinsics (the config's, at 370x1226) scaled to 240x800
KITTI = {"fu": 707.0912, "fv": 707.0912, "cu": 183.1104, "cv": 601.8873,
         "H": 370, "W": 1226}
INTRINSIC = {"fu": KITTI["fu"] * H / KITTI["H"],
             "fv": KITTI["fv"] * W / KITTI["W"],
             "cu": KITTI["cu"] * H / KITTI["H"],
             "cv": KITTI["cv"] * W / KITTI["W"], "H": H, "W": W}
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# kernel-vs-plain tolerances: the sum orders differ (sequential per thread
# in the kernels, cumprod/einsum in the plain twins), and a tile's early
# termination at T < 1e-4 can land one pair apart, so the forward is held
# to 1e-4 of each channel group's largest magnitude (at least 1); the
# backward's per-pair sums over 256 pixels to 1e-3 of each row's largest
# entry in f32 and 1e-2 in bf16 (bf16 keeps 8 bits, 3.9e-3 relative)
FWD_TOL = 1e-4
BWD_TOL = {"f32": 1e-3, "bf16": 1e-2}
FWD_GROUPS = {"rgb": (0, 3), "depth": (3, 4), "alpha": (4, 5),
              "normal": (5, 8), "flow": (9, 11), "wm": (11, 13)}
ZERO_ROWS = [8, 13, 14, 15]


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


# ---------------------------------------------------------------------------
# synthetic KITTI-like windows
# ---------------------------------------------------------------------------

def _texture(a, b, phase):
    """Smooth stripes plus 1 m checker blocks in [0.1, 0.9]; a, b are the
    surface's two coordinates in meters."""
    checker = ((np.floor(a) + np.floor(b)) % 2) * 0.2
    waves = 0.15 * np.sin(2 * np.pi * a / 0.9 + phase) * np.cos(
        2 * np.pi * b / 1.7 + 2 * phase)
    return np.clip(0.35 + checker + waves, 0.1, 0.9)


def render_view(z_cam, max_depth=25.0):
    """Exact rgb and depth of a road plane and two facades seen from a
    camera at (0, 0, z_cam) looking down +z (x right, y down)."""
    fx, fy = INTRINSIC["fv"], INTRINSIC["fu"]
    cx, cy = INTRINSIC["cv"], INTRINSIC["cu"]
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    dx, dy = (xs - cx) / fx, (ys - cy) / fy          # ray (dx, dy, 1)
    cam_h, left, right, top = 1.65, -6.0, 7.0, -8.0
    inf = np.full((H, W), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_road = np.where(dy > 1e-6, cam_h / dy, inf)
        t_left = np.where(dx < -1e-6, left / dx, inf)
        t_right = np.where(dx > 1e-6, right / dx, inf)
    for t_wall in (t_left, t_right):
        y_hit = t_wall * dy
        t_wall[(y_hit < top) | (y_hit > cam_h)] = np.inf
    t = np.minimum(t_road, np.minimum(t_left, t_right))
    hit = np.isfinite(t)
    t_hit = np.where(hit, t, 0.0)
    xw, yw, zw = t_hit * dx, t_hit * dy, t_hit + z_cam
    rgb = np.zeros((H, W, 3))
    road = t == t_road
    for c, phase in enumerate((0.0, 1.3, 2.6)):
        rgb[..., c] = np.where(
            road, 0.6 * _texture(xw, zw, phase),
            _texture(zw, yw, phase + 0.7 * (xw > 0)))
    depth = np.where(hit & (t < max_depth), t_hit, 0.0)
    rgb[depth == 0] = 0.0
    return rgb.astype(np.float32), depth[..., None].astype(np.float32)


def write_windows(root, n_kf, kf_capacity, seed):
    """One viz_out window per keyframe event: the first holds keyframes
    0-1, each later one adds the next keyframe (0.5 m further)."""
    from vings_mono_tpu_torch.datasets.replay import save_viz_out
    rng = np.random.default_rng(seed)
    z = np.cumsum(np.r_[0.0, 0.5 + 0.05 * rng.uniform(-1, 1, n_kf - 1)])
    views = [render_view(zk) for zk in z]
    poses = []
    for zk in z:
        c2w = np.eye(4, dtype=np.float32)
        c2w[2, 3] = zk
        poses.append(c2w)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for w in range(1, n_kf):
        ks = list(range(max(0, w + 1 - kf_capacity), w + 1))
        save_viz_out(str(root / f"vizout_{w - 1:04d}.npz"), {
            "images": np.stack([views[k][0] for k in ks]),
            "depths": np.stack([views[k][1] for k in ks]),
            "depths_cov": np.full((len(ks), H, W, 1), 0.01, np.float32),
            "poses": np.stack([poses[k] for k in ks]),
            "viz_out_idx_to_f_idx": np.asarray(ks, np.float64) * 5,
            "intrinsic": INTRINSIC,
            "pixel_mask": np.ones((len(ks), H, W), bool),
            "global_kf_id": np.asarray(ks, np.int64),
        })
    return n_kf - 1


# ---------------------------------------------------------------------------
# kernel checks and timing
# ---------------------------------------------------------------------------

def pair_inputs(state, w2c, bin_kwargs, device):
    """The tile kernels' inputs for one camera: a fresh binning of `state`
    as the mapper makes it, gathered into the (24, P_CAP) pair block."""
    import torch
    from vings_mono_tpu_torch.mapper.cameras import camera_from_intrinsic
    from vings_mono_tpu_torch.ops.rasterizer import (bin_for_camera,
                                                     project_surfels)
    from vings_mono_tpu_torch.ops.rasterizer.render import camera_meta
    cam = camera_from_intrinsic(w2c, INTRINSIC)
    args = (state.xyz, state.log_scale, state.quat, state.logit_opacity,
            state.rgb, cam)
    with torch.no_grad():
        binned = bin_for_camera(*args, alive=state.alive, **bin_kwargs)
        packed = project_surfels(*args, alive=state.alive).packed
        compact = torch.cat([packed[binned.sel.long()],
                             packed.new_zeros((1, packed.shape[1]))])
        pair_data = compact[binned.pair_idx.long()].T.contiguous()
    return pair_data, binned, camera_meta(cam, device)


def check_kernels(label, pair_data, binned, meta, chunk, seed):
    """Phases 2 and 3 on one binning; returns the max abs errors."""
    import torch
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    tc = binned.tile_chunks
    out = tk.rasterize_forward(pair_data, tc, meta, chunk)
    ref, evals, hits = tk.forward_plain(pair_data, tc, meta, chunk)
    torch.cuda.synchronize()
    errs = {}
    for name, (a, b) in FWD_GROUPS.items():
        e = float((out[:, a:b] - ref[:, a:b]).abs().max())
        scale = max(1.0, float(ref[:, a:b].abs().max()))
        errs[name] = e
        check(e <= FWD_TOL * scale,
              f"{label} forward {name}: max abs err {e} > {FWD_TOL}*{scale}")
    check(float(out[:, ZERO_ROWS].abs().max()) == 0.0,
          f"{label} forward: padding rows not zero")
    fwd_err = max(errs.values())
    print(f"phase 2 forward kernel vs plain [{label}]: pairs "
          f"{int(binned.n_pairs)}, p_cap {pair_data.shape[1]}, live "
          f"(pair,pixel) {evals}, covered {int(hits)}, max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {FWD_TOL} x max(1, |ref|))", flush=True)

    gen = torch.Generator(device=out.device).manual_seed(seed)
    g = torch.randn(out.shape, generator=gen, device=out.device)
    bwd_err = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got = tk.rasterize_backward(pair_data, tc, meta, chunk, out, g,
                                    out_dtype=dtype).float()
        want = tk.backward_plain(pair_data, tc, meta, chunk, out, g)
        torch.cuda.synchronize()
        scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-12)
        rel = float(((got - want).abs() / scale).max())
        bwd_err[name] = float((got - want).abs().max())
        check(rel <= BWD_TOL[name],
              f"{label} backward {name}: rel err {rel} > {BWD_TOL[name]}")
        check(bool(torch.isfinite(got).all()),
              f"{label} backward {name}: non-finite grads")
        print(f"phase 3 backward kernel vs plain [{label}] {name}: max abs "
              f"err {bwd_err[name]:.3e}, max err / row max {rel:.3e} "
              f"(tol {BWD_TOL[name]}), score row max "
              f"{float(want[tk.GR_SCORE_IMP].abs().max()):.3f}", flush=True)
    return fwd_err, bwd_err, evals, int(hits)


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def profile_keyframe(mapper, window):
    """Phase 6: one more keyframe event (the last window again, its newest
    keyframe under a new timestamp) under torch.profiler — where a
    keyframe's time goes on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    window = dict(window)
    stamps = np.asarray(window["viz_out_idx_to_f_idx"]).copy()
    stamps[-1] = stamps[-1] + 1
    window["viz_out_idx_to_f_idx"] = stamps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper.run(window)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, memsets): the host ops
        # that launched them carry the same time again
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"phase 6 profile: keyframe {wall_ms:.1f} ms wall; device "
              f"time not measured (the profiler saw no device events)",
              flush=True)
        return
    print(f"phase 6 profile: keyframe {wall_ms:.1f} ms wall, device busy "
          f"{busy:.1f} ms (idle share {1 - busy / wall_ms:.3f}), "
          f"{sum(r[1] for r in rows)} device ops", flush=True)
    for ms, n, key in rows[:12]:
        print(f"phase 6   {ms:9.2f} ms {n:7d}x  {key[:90]}", flush=True)


# ---------------------------------------------------------------------------

def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--keyframes", type=int, default=10)
    p.add_argument("--iters", type=int, default=100)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    device = torch.device(DEVICE)
    from vings_mono_tpu_torch.utils import cuda_build
    from vings_mono_tpu_torch.utils.config import load_config
    from vings_mono_tpu_torch.mapper.state import adam_init, empty_state
    from vings_mono_tpu_torch.mapper.densify import add_frame, draw_densify
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    from vings_mono_tpu_torch.runners import run_mapping
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build
    t0 = time.perf_counter()
    built = cuda_build.build()
    for name, (lib, secs, report) in built.items():
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        print(f"phase 1 build {name}: {secs:.1f} s -> "
              f"{lib.relative_to(ROOT)}; ptxas: {' | '.join(regs)}",
              flush=True)
    print(f"phase 1 build total: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- the workload: config, windows, an initial map
    win_dir = OUT / "windows"
    cfg = load_config(str(CONFIG), overrides={
        "dataset": {"root": str(win_dir)},
        "output": {"save_dir": str(OUT / "run")},
        "training_args": {"iters": args.iters}, "seed": args.seed,
        "device": {"mapper": DEVICE}})
    mcfg = cfg["mapper"]
    t0 = time.perf_counter()
    n_windows = write_windows(win_dir, args.keyframes,
                              int(mcfg["kf_capacity"]), args.seed)
    print(f"windows: {n_windows} written in {time.perf_counter() - t0:.1f} s "
          f"({H}x{W}, {args.keyframes} keyframes)", flush=True)
    from vings_mono_tpu_torch.datasets.replay import ReplayDataset
    first = ReplayDataset(cfg)[0]
    bin_kwargs = {"p_cap": int(mcfg["pair_capacity"]),
                  "chunk": int(mcfg["chunk"]), "side": int(mcfg["side"]),
                  "v_cap": int(mcfg["visible_capacity"]), "tile_cap": 512}
    chunk = bin_kwargs["chunk"]
    intr4 = (INTRINSIC["fv"], INTRINSIC["fu"], INTRINSIC["cv"],
             INTRINSIC["cu"])
    state = empty_state(int(mcfg["capacity"]), device)
    opt = adam_init(state)
    gen = torch.Generator().manual_seed(args.seed)
    n0 = int(mcfg["points_first_frame"])
    for i in range(2):
        g, q = draw_densify(gen, H, W, n0, device)
        add_frame(state, opt, torch.linalg.inv(torch.as_tensor(
            first["poses"][i], device=device)), intr4,
            torch.as_tensor(first["images"][i], device=device).movedim(-1, 0),
            torch.as_tensor(first["depths"][i], device=device).movedim(-1, 0),
            i, height=H, width=W, gumbel=g, quat_noise=q, n_points=n0,
            first=True)
    w2c0 = torch.linalg.inv(torch.as_tensor(first["poses"][0],
                                            device=device))

    # ---- 2-3. kernels against their plain twins on the initial map
    pd, binned, meta = pair_inputs(state, w2c0, bin_kwargs, device)
    check_kernels("initial map", pd, binned, meta, chunk, args.seed)

    # ---- 4. the slice through its entry point
    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    t0 = time.perf_counter()
    mapper, records = run_mapping.run(cfg, str(OUT / "run"))
    slice_s = time.perf_counter() - t0
    launches = {"rasterize_forward": tk.rasterize_forward.launches,
                "rasterize_backward": tk.rasterize_backward.launches}
    for r in records:
        print(f"phase 4 keyframe {r['window']}: {r['ms']:.1f} ms, n_alive "
              f"{r['n_alive']}, train psnr {r['psnr_start']:.3f} (first "
              f"iter) -> {r['psnr']:.3f} (last), loss "
              f"{r['loss']:.5f}, pair bucket {r['p_cap']}", flush=True)
    train_iters = len(records) * args.iters
    print(f"phase 4 slice: {len(records)} keyframes x {args.iters} iters in "
          f"{slice_s:.1f} s; launches {launches} for {train_iters} train "
          f"iterations", flush=True)
    check(len(records) == n_windows, "not every window was mapped")
    check(all(r["losses_finite"] for r in records), "a loss is not finite")
    # the map's PSNR rises: the last keyframe's train PSNR against the
    # first keyframe's at its first iteration (the freshly seeded map)
    check(records[-1]["psnr"] >= records[0]["psnr_start"] + 3.0,
          f"PSNR did not rise 3 dB: {records[0]['psnr_start']:.3f} -> "
          f"{records[-1]['psnr']:.3f}")
    for name, n in launches.items():
        check(n >= train_iters, f"{name} launched {n} times for "
              f"{train_iters} train iterations")
    check((OUT / "run" / "ply" / "final_2dgs.ply").is_file(),
          "final .ply not written")

    # ---- 5. times at the slice's shapes (the trained map, the last
    # keyframe's camera, the mapper's final bucket), with a final check
    last = ReplayDataset(cfg)[n_windows - 1]
    w2c = torch.linalg.inv(torch.as_tensor(last["poses"][-1],
                                           device=device))
    kw = dict(bin_kwargs, p_cap=mapper.bin_kwargs["p_cap"])
    pd, binned, meta = pair_inputs(mapper.state, w2c, kw, device)
    fwd_err, bwd_err, evals, hits = check_kernels(
        "trained map", pd, binned, meta, chunk, args.seed + 1)
    tc = binned.tile_chunks
    out = tk.rasterize_forward(pd, tc, meta, chunk)
    g = torch.randn_like(out)
    T, P = out.shape[0], pd.shape[1]
    n_fwd = tk.rasterize_forward.launches
    n_bwd = tk.rasterize_backward.launches
    times = {
        "fwd": cuda_ms(lambda: tk.rasterize_forward(pd, tc, meta, chunk), 20),
        "fwd_plain": cuda_ms(lambda: tk.forward_plain(pd, tc, meta, chunk),
                             3, warmup=1),
        "bwd": cuda_ms(lambda: tk.rasterize_backward(
            pd, tc, meta, chunk, out, g, out_dtype=torch.bfloat16), 20),
        "bwd_plain": cuda_ms(lambda: tk.backward_plain(
            pd, tc, meta, chunk, out, g).to(torch.bfloat16), 3, warmup=1),
    }
    # timing launches are not the slice's
    tk.rasterize_forward.launches = n_fwd
    tk.rasterize_backward.launches = n_bwd
    in_bytes = pd.numel() * 4 + tc.numel() * 4 + meta.numel() * 4
    img_bytes = T * tk.CH_PAD * tk.PIX * 4
    fwd_bound = bound(evals * tk.OPS_COVERAGE + hits * tk.OPS_FWD_HIT,
                      in_bytes + img_bytes)
    bwd_bound = bound(evals * tk.OPS_COVERAGE + hits * tk.OPS_BWD_HIT,
                      in_bytes + 2 * img_bytes + tk.GR_PAD * P * 2)
    print(f"phase 5 times (tiles {T}, p_cap {P}, live (pair,pixel) {evals}, "
          f"covered {hits}): forward kernel {times['fwd']:.4f} ms, plain "
          f"{times['fwd_plain']:.4f} ms, bound {fwd_bound[0]:.4f} ms "
          f"({fwd_bound[1]}); backward bf16 kernel {times['bwd']:.4f} ms, "
          f"plain {times['bwd_plain']:.4f} ms, bound {bwd_bound[0]:.4f} ms "
          f"({bwd_bound[1]})", flush=True)
    profile_keyframe(mapper, last)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    kernels = [
        {"name": "rasterize_forward", "route": "cuda",
         "source": "vings_mono_tpu_torch/csrc/rasterizer.cu",
         "replaces": "vings_mono_tpu/ops/rasterizer/tile_kernel.py:263",
         "launches": launches["rasterize_forward"],
         "max_abs_err": fwd_err, "ms": times["fwd"],
         "plain_ms": times["fwd_plain"], "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1], "library_ms": None},
        {"name": "rasterize_backward", "route": "cuda",
         "source": "vings_mono_tpu_torch/csrc/rasterizer.cu",
         "replaces": "vings_mono_tpu/ops/rasterizer/tile_kernel.py:423",
         "launches": launches["rasterize_backward"],
         "max_abs_err": bwd_err["bf16"], "ms": times["bwd"],
         "plain_ms": times["bwd_plain"], "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
