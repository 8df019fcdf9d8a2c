"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--keyframes 10] [--iters 100]

Phases, each printing its own lines; any failure exits non-zero:
  1. build the CUDA kernels (csrc/*.cu) and print the build seconds, then
     check that the wrappers refuse what the kernels cannot stage;
  2. forward tile kernel against its plain PyTorch twin on a real binning
     of a mapper state at 240x800 and on an adversarial pair block (edge-on
     surfels, surfels behind and across the camera plane, opacities at the
     thresholds, huge and tiny surfels, centers far outside the tile), with
     the cull check: the kernel's covered count against the plain twin's
     and against the kernel built without the cull, which must also give
     the same bits, and `pair_pixel_bounds` / `pair_block_mask` holding
     every covered pixel and block;
  3. backward tile kernel (f32 and bf16 output) against its plain twin on
     the same blocks with a random cotangent, bitwise equal on a second
     launch and bitwise equal to the kernel built without the cull;
  4. the mapping slice: `runners.run_mapping.run` over synthetic KITTI-like
     keyframes with the KITTI 2011_09_30_drive_0028 mapper settings,
     checking finite losses, rising PSNR, kernel launches on every train
     iteration and the final .ply;
  5. kernel and plain-twin times with CUDA events at the slice's shapes,
     beside each kernel's bound, registers and resident blocks per SM;
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
# the kernels' coverage rounds as the plain twin's does, so the covered
# counts should agree; an evaluation within this relative distance of a
# coverage threshold is allowed to be decided otherwise
NEAR_REL = 1e-5
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


def adversarial_inputs(seed, chunk, device):
    """The adversarial pair block at 240x800, three chunks for every tile."""
    import torch
    from vings_mono_tpu_torch.mapper.cameras import camera_from_intrinsic
    from vings_mono_tpu_torch.ops.rasterizer.render import camera_meta
    from vings_mono_tpu_torch.ops.rasterizer.stress import adversarial_pairs
    cam = camera_from_intrinsic(torch.eye(4), INTRINSIC)
    pair_data, tile_chunks = adversarial_pairs(
        seed, cam, chunk, chunks_per_tile=3, per_class=512, device=device)
    return pair_data, tile_chunks, camera_meta(cam, device)


def check_bounds(label, pair_data, tc, meta, chunk):
    """The cull as PyTorch states it: `pair_pixel_bounds` holds every pixel
    at which `_coverage` gives alpha > 0 and `pair_block_mask` every 8x4
    block with such a pixel, for every pair of every chunk at every pixel
    of its tile. Returns the (pair, block) count the mask keeps."""
    import torch
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    n_chunks = int(tc[-1])
    ntx = int(meta[4])
    tiles = torch.repeat_interleave(
        torch.arange(tc.shape[0] - 1, device=tc.device),
        (tc[1:] - tc[:-1]).long())
    bounds = [b[:n_chunks * chunk].reshape(n_chunks, chunk, 1)
              for b in tk.pair_pixel_bounds(pair_data, meta)]
    data = pair_data[:, :n_chunks * chunk].reshape(tk.GR_PAD, n_chunks, chunk)
    # the eight 8x4 blocks of a tile, in the kernels' warp order
    w = torch.arange(8, device=tc.device)
    block_x, block_y = (w % 2 * 8).float(), (w // 2 * 4).float()
    covered = in_rect = outside = kept = missed = 0
    for lo in range(0, n_chunks, 256):
        sl = slice(lo, lo + 256)
        qx, qy, px, py = tk._pixel_rays(tiles[sl], ntx, meta)
        alpha, _, _ = tk._coverage(data[:, sl].permute(1, 2, 0), qx, qy, px,
                                   py)
        hit = alpha > 0
        x0, x1, y0, y1 = (b[sl] for b in bounds)
        inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
        covered += int(hit.sum())
        in_rect += int(inside.sum())
        outside += int((hit & ~inside).sum())
        bx = (tiles[sl] % ntx * tk.TILE).float()[:, None, None] + block_x
        by = (tiles[sl] // ntx * tk.TILE).float()[:, None, None] + block_y
        mask = tk.pair_block_mask(data[:, sl, :, None], meta, bx, bx + 7.0,
                                  by, by + 3.0)
        n = hit.shape[0]
        hit_blocks = hit.reshape(n, chunk, 4, 4, 2, 8).any(5).any(3).reshape(
            n, chunk, 8)
        kept += int(mask.sum())
        missed += int((hit_blocks & ~mask).sum())
    check(outside == 0, f"{label}: pair_pixel_bounds leaves out {outside} "
          f"covered (pair, pixel)")
    check(missed == 0, f"{label}: pair_block_mask leaves out {missed} "
          f"(pair, block) with a covered pixel")
    print(f"phase 2 cull bounds [{label}]: {n_chunks * chunk} pairs, "
          f"{covered} covered (pair, pixel) all inside their rectangles, "
          f"which hold {in_rect} of {n_chunks * chunk * tk.PIX} pixels; "
          f"every covered 8x4 block is among the {kept} of "
          f"{n_chunks * chunk * 8} that pair_block_mask keeps", flush=True)


def check_kernels(label, pair_data, tc, meta, chunk, seed, n_pairs):
    """Phases 2 and 3 on one pair block; returns the max abs errors, the
    plain twin's work counts and the kernel's cull counts."""
    import torch
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    counts = torch.zeros(3, dtype=torch.int64, device=pair_data.device)
    out = tk.rasterize_forward(pair_data, tc, meta, chunk, counters=counts)
    ref, evals, hits, near = tk.forward_plain(pair_data, tc, meta, chunk,
                                              near_rel=NEAR_REL)
    torch.cuda.synchronize()
    k_hits, k_visits, k_cand = (int(x) for x in counts)
    hits, near = int(hits), int(near)
    errs = {}
    for name, (a, b) in FWD_GROUPS.items():
        e = float((out[:, a:b] - ref[:, a:b]).abs().max())
        scale = max(1.0, float(ref[:, a:b].abs().max()))
        errs[name] = e
        check(e <= FWD_TOL * scale,
              f"{label} forward {name}: max abs err {e} > {FWD_TOL}*{scale}")
    check(float(out[:, ZERO_ROWS].abs().max()) == 0.0,
          f"{label} forward: padding rows not zero")
    check(bool(torch.isfinite(out).all()), f"{label} forward: not finite")
    fwd_err = max(errs.values())
    print(f"phase 2 forward kernel vs plain [{label}]: pairs "
          f"{n_pairs}, p_cap {pair_data.shape[1]}, live "
          f"(pair,pixel) {evals}, covered {hits}, max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {FWD_TOL} x max(1, |ref|))", flush=True)

    # the cull: same bits and same covered count as the kernel without it,
    # the plain twin's covered count up to the evaluations at a threshold
    counts0 = torch.zeros_like(counts)
    out0 = tk.rasterize_forward(pair_data, tc, meta, chunk, counters=counts0,
                                cull=False)
    torch.cuda.synchronize()
    check(torch.equal(out, out0), f"{label}: the cull changes the forward")
    check(int(counts0[0]) == k_hits, f"{label}: covered {k_hits} with the "
          f"cull, {int(counts0[0])} without")
    # a tile whose largest T lands on T_EPS may stop one chunk apart (the
    # twin multiplies the transmittance up in another order): at most two
    # chunks' evaluations may be blended by one side only, and only then
    # may the covered counts differ by more than the evaluations that sit
    # at a threshold
    apart = abs(k_cand * 32 - evals)
    check(apart <= 2 * chunk * tk.PIX, f"{label}: kernel blended {k_cand} "
          f"(pair, warp), the plain twin {evals} (pair, pixel)")
    check(abs(k_hits - hits) <= near + apart, f"{label}: kernel covered "
          f"{k_hits}, plain {hits}, only {near} evaluations at a threshold "
          f"and {apart} blended by one side only")
    print(f"phase 2 cull [{label}]: kernel covered {k_hits} with and without "
          f"the cull, bitwise equal output; plain covered {hits} "
          f"({near} within {NEAR_REL} of a threshold, {apart} evaluations "
          f"blended by one side only); (pair, warp) visits "
          f"{k_visits} of {k_cand}, the cull removed "
          f"{1 - k_visits / k_cand:.4f}", flush=True)
    check_bounds(label, pair_data, tc, meta, chunk)

    gen = torch.Generator(device=out.device).manual_seed(seed)
    g = torch.randn(out.shape, generator=gen, device=out.device)
    bwd_err = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        def launch(cull=True):
            return tk.rasterize_backward(pair_data, tc, meta, chunk, out, g,
                                         out_dtype=dtype, cull=cull)
        raw = launch()
        again = launch()
        raw0 = launch(cull=False)
        got = raw.float()
        want = tk.backward_plain(pair_data, tc, meta, chunk, out, g)
        torch.cuda.synchronize()
        check(torch.equal(raw, again), f"{label} backward {name}: two "
              f"launches differ")
        check(torch.equal(raw, raw0), f"{label} backward {name}: the cull "
              f"changes the gradients")
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
              f"{float(want[tk.GR_SCORE_IMP].abs().max()):.3f}; a second "
              f"launch and the kernel without the cull are bitwise equal",
              flush=True)
    return fwd_err, bwd_err, evals, hits, 1 - k_visits / k_cand


def check_refusals(chunk, device):
    """The CUDA wrappers raise on what the kernels cannot stage."""
    import torch
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    meta = torch.tensor([100.0, 100.0, 8.0, 8.0, 1.0, 0, 0, 0],
                        device=device)
    tc = torch.tensor([0, 1], dtype=torch.int32, device=device)
    for what, pd, ch in (
            ("chunk 6", torch.zeros((tk.GR_PAD, 6), device=device), 6),
            ("chunk 12", torch.zeros((tk.GR_PAD, 12), device=device), 12),
            ("pair_data not contiguous",
             torch.zeros((chunk, tk.GR_PAD), device=device).T, chunk)):
        for fn in (lambda: tk.rasterize_forward(pd, tc, meta, ch),
                   lambda: tk.rasterize_backward(
                       pd, tc, meta, ch,
                       torch.zeros((1, tk.CH_PAD, tk.PIX), device=device),
                       torch.zeros((1, tk.CH_PAD, tk.PIX), device=device))):
            try:
                fn()
            except ValueError:
                continue
            fail(f"the wrapper took {what}")
    print("phase 1 refusals: chunk % 8 != 0 and a pair_data that is not "
          "contiguous raise", flush=True)


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
    from vings_mono_tpu_torch.ops.rasterizer.projection import PK_DIM
    from vings_mono_tpu_torch.runners import run_mapping
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build
    t0 = time.perf_counter()
    for defines in ((), tk.NO_CULL):
        built = cuda_build.build(defines=defines)
        for name, (lib, secs, report) in built.items():
            regs = [ln.strip() for ln in report.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"phase 1 build {name} {' '.join(defines)}: {secs:.1f} s "
                  f"-> {lib.relative_to(ROOT)}; ptxas: {' | '.join(regs)}",
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

    check_refusals(chunk, device)

    # ---- 2-3. kernels against their plain twins on the initial map and
    # on the adversarial block
    pd, binned, meta = pair_inputs(state, w2c0, bin_kwargs, device)
    check_kernels("initial map", pd, binned.tile_chunks, meta, chunk,
                  args.seed, int(binned.n_pairs))
    pd, tc, meta = adversarial_inputs(args.seed, chunk, device)
    check_kernels("adversarial", pd, tc, meta, chunk, args.seed + 2,
                  pd.shape[1])

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
    kf_ms = [r["ms"] for r in records]
    print(f"phase 4 slice: {len(records)} keyframes x {args.iters} iters in "
          f"{slice_s:.1f} s, keyframe mean {np.mean(kf_ms):.1f} ms (min "
          f"{min(kf_ms):.1f}, max {max(kf_ms):.1f}); launches {launches} "
          f"for {train_iters} train iterations", flush=True)
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
    fwd_err, bwd_err, evals, hits, culled = check_kernels(
        "trained map", pd, binned.tile_chunks, meta, chunk, args.seed + 1,
        int(binned.n_pairs))
    tc = binned.tile_chunks
    out = tk.rasterize_forward(pd, tc, meta, chunk)
    g = torch.randn_like(out)
    T, P = out.shape[0], pd.shape[1]
    times = {}
    times["fwd"] = cuda_ms(
        lambda: tk.rasterize_forward(pd, tc, meta, chunk), 100, warmup=5)
    times["bwd"] = cuda_ms(lambda: tk.rasterize_backward(
        pd, tc, meta, chunk, out, g, out_dtype=torch.bfloat16), 100, warmup=5)
    times["fwd_plain"] = cuda_ms(
        lambda: tk.forward_plain(pd, tc, meta, chunk), 3, warmup=1)
    times["bwd_plain"] = cuda_ms(lambda: tk.backward_plain(
        pd, tc, meta, chunk, out, g).to(torch.bfloat16), 3, warmup=1)
    attrs = tk.kernel_attributes(chunk)
    # the work no implementation can avoid: the covered evaluations, and
    # the blended chunks' pair data (the rows in use, not the padding), the
    # images and the gradient rows once
    in_bytes = evals // tk.PIX * PK_DIM * 4 + tc.numel() * 4 \
        + meta.numel() * 4
    img_bytes = T * tk.CH_PAD * tk.PIX * 4
    fwd_bytes = in_bytes + img_bytes
    bwd_bytes = in_bytes + 2 * img_bytes + tk.GR_PAD * P * 2
    fwd_bound = bound(hits * (tk.OPS_COVERAGE + tk.OPS_FWD_HIT), fwd_bytes)
    bwd_bound = bound(hits * (tk.OPS_COVERAGE + tk.OPS_BWD_HIT), bwd_bytes)
    # the coverage at every pixel of the blended chunks, as an unculled
    # kernel runs it
    fwd_all = bound(evals * tk.OPS_COVERAGE + hits * tk.OPS_FWD_HIT,
                    fwd_bytes)
    bwd_all = bound(evals * tk.OPS_COVERAGE + hits * tk.OPS_BWD_HIT,
                    bwd_bytes)
    print(f"phase 5 times (tiles {T}, p_cap {P}, live (pair,pixel) {evals}, "
          f"covered {hits}, (pair, warp) visits culled {culled:.4f})",
          flush=True)
    for name, key, bnd, allpix, attr in (
            ("forward", "fwd", fwd_bound, fwd_all, "rasterize_forward"),
            ("backward bf16", "bwd", bwd_bound, bwd_all,
             "rasterize_backward_bf16")):
        a = attrs[attr]
        print(f"phase 5 {name} kernel {times[key]:.4f} ms, plain "
              f"{times[key + '_plain']:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), all-pixel bound {allpix[0]:.4f} ms "
              f"({allpix[1]}), registers {a['registers']}, resident blocks "
              f"per SM {a['blocks_per_sm']}, shared memory "
              f"{a['smem_bytes']} B", flush=True)
        check(times[key] >= bnd[0], f"{name} kernel is faster than its "
              f"bound: the bound's count is wrong")
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
