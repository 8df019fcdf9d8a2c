"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--keyframes 6] [--iters 100]
                          [--vo-frames 70] [--vio-frames 60]

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
     and the largest device ops;
  7. the VO slice at full width: `runners.run.run` on the procedural
     `synthetic3d` room at 240x800 with the KITTI 2011_09_30_drive_0028
     frontend, middleware, training and mapper settings and the DroidNet
     weights in the repository: camera frames in, poses and a map out. It
     checks finite poses, both gates taking both branches, a rollup, both
     prefetches consumed, the trajectory error against the dataset's ground
     truth, rising PSNR, kernel launches and the files written; then times
     the tracker's hot ops at the live graph's shapes and profiles one
     tracked frame and one packaged keyframe;
  8. the visual-inertial slice at full width: `runners.run.run` in `mode:
     vio` with `use_storage_manager` on the KITTI 2011_09_30_drive_0028
     configuration, on the same room at a 0.05 s frame period with a 100 Hz
     IMU stream derived from the room's analytic trajectory: VI init, the
     fused updates (device Hessian, host factor graph, device retraction),
     the mapper and storage paging every 10 frames. It checks VI init, the
     multi-sensor updates, finite states, the trajectory error, PSNR, pages
     out and in with a bit-exact round trip, and the VIO tracker on the card
     against the CPU on a small input; prints the inertial layer's device
     and host costs per frame, the storage stage, the synchronizing calls
     of a tracked frame and its profile; `use_vis` is on: the rgbdnua
     panel every keyframe, the map with the storage composite and the
     follow-cam BEV every tenth (arrays checked; no file is written where
     cv2 does not import), and both kernels against their plain twins on
     the first 131072 host-paged rows under the map's 480x640 camera, as
     `vis_map` renders them;
  9. `runners.run.run` on `configs/synthetic/smoke_vio.yaml` as committed
     (`mode: vio`, storage every 10 frames, `use_vis`, `use_global_ba`, 30
     frames at 240x432); prints the stage times, the global BA's stats and
     parts, the vis arrays, holds both kernels against their plain twins on
     the trained map under the run's own cameras (the newest keyframe's at
     240x432, the map's at 480x640, the follow-cam's at 320x320), and holds
     the global BA on the card against the same pass on the CPU from the
     same snapshot of the video's buffers;
 10. (run right after phase 7, on its tracker) GlobalBA with the backend
     defaults at 240x800: times of re-encode, edge proposal, GRU rounds
     and solve, edges, peak memory, synchronizing calls, ATE before and
     after; then `ba_global_banded` at T = 1024 keyframes of 30x100 with
     oracle targets against the dense `ba_global`, and alone at T = 8000
     (the KITTI-360 save_buffer) with GlobalBA's band and CG settings: ms
     per Gauss-Newton step, CG iterations, peak memory;
 11. phase 4's replay once each with `use_sky` and `coarse_frac` 0.5
     (its first 2 windows) and `use_refine` (all 5, one keyframe's pose
     perturbed by a known SE3):
     keyframe times against phase 4's, PSNR, both kernels against their
     plain twins on the sky sphere's pairs and at 120x400, and refine's
     gradient with respect to the pose through the kernels against the
     gradient through the plain twins;
 12. `runners.run.run` on `configs/synthetic/smoke.yaml` as committed
     (`mode: vo` with loop closure, dynamic masks, sky, refine, storage, vis
     and global BA, 30 frames at 240x432, random DroidNet and SuperPoint
     weights from the seed); prints the stage times (`loop` and `dynamic`
     among them), the loop attempts with the stage each reached, the
     closures accepted, the dynamic pixels masked and the kernels' launches,
     and holds both kernels against their plain twins on the loop path's own
     inputs (the verify render at the recovered pose, or the render at the
     current pose, culled to 60 m; the first retrain window when a closure
     was accepted);
 13. the learned nets and the rectification on the card against the CPU:
     self-trained SuperPoint + LightGlue (2 layers) on pairs of room views
     at 240x320 through extract, match and PnP (heat and descriptor error,
     match overlap, PnP error against the truth, ms per detect chain);
     self-trained FastSAM at 240x432 (raw-map error, mask IoU, ms per
     call); `rectify_poses`, `rectify_gaussians`, `rectify_tracker` with the
     depth write-back and `retrain_gaussians` on phase 12's end state with
     a known endpoint correction, from the same snapshot on both;
 14. metric depth, sessions and the evaluation
     harness. The self-trained DPT (`MetricDepth`, flax backend) on the
     card against the CPU on three room frames at 240x432; then
     `runners.run.run` on `configs/synthetic/smoke.yaml` with `use_metric`
     (that DPT) on the `synthetic3d` room (20 frames at 240x432), the
     overrides written to a temporary YAML, saving the session every 10
     frames: the stage times (`metric`, `checkpoint` among them), the share
     of positive `disps_sens` and the median prior depth, ATE
     (`eval_trajectory`), PSNR (`eval_psnr`), `bench_mfu`, the launches,
     the session's size and save ms; both kernels held against their
     plain twins on eval_psnr's render; the same run again, whose poses
     must equal the first run's bit for bit (every runner runs inside
     `utils.device.reproducible`); and `--resume` from the frame-10
     session to frame 20 (load ms, keyframe count, pose gap to the first
     run);
 15. the slice's main path: the image-folder datasets, the remaining
     runners and the trainer. (a) A `kitti_sync` folder of 30 frames of
     the synthetic3d room rendered at 370x1226 with KITTI-0028's
     intrinsics (image_02/data, metadata/camstamp.txt at 10 Hz,
     metadata/imu.txt from the room's analytic IMU at 100 Hz written
     `imu_delay` late, c2i.txt, pose/) through `runners.run.run` on
     configs/kitti/sync/kitti_2011_09_30_drive_0028.yaml as committed
     (`mode: vio`, storage, vis; only dataset.root and the DroidNet
     weights set): stage times, frames/s, host ms per `dataset[idx]`
     (370x1226 -> 240x800), ATE against pose/, launches, and both kernels
     against their plain twins on the final map under the newest
     keyframe's camera (what `reproducible` costs is measured by
     `profile_reproducible.py`); (b) `runners.run_tracking.run` on the
     folder,
     keyframes and pose gap against (a) as findings; (c)
     `runners.run_multiprocess.run`: frames/s beside (a), windows mapped
     and dropped, the tracker against (b), the .ply, the TF32 flags equal
     before and after; (d) the mobile workers of
     `run_multiprocess_mobile` behind the WebsocketServer
     (profile_configs.py's F8 at its fewest frames:
     configs/pocket/pocket_scene.yaml, the phone's 720x1280 JPEG frames
     with the EXIF time and IMU JSON rows sent over a websocket on
     127.0.0.1, or in process where `websockets` is missing): every frame
     decoded and tracked, one finite render per mapped window, the newest
     sent at each of the server's turns, the imu.csv rows, both kernels on
     every training iteration and against their plain twins on its final
     map; (e) the DROID
     trainer: one clip's loss and gradients card against CPU, 5 steps of
     `runners.train_droid`'s loop from the repository's weights (s/step,
     peak memory, losses) and the checkpoint loaded back bitwise; then
     the same for the self-training recipes of SuperPoint, LightGlue,
     FastSAM and the DPT metric-depth net (`runners.train_superpoint`,
     `train_lightglue`, `train_fastsam`, `train_metric_depth`) at their
     scripts' shapes from the shipped weights, and 3 steps of each on a
     fixed pool run twice, bitwise equal;
 16. data parallelism over the keyframe window, dp = 2 with both ranks on
     cuda:0 over Gloo (and over NCCL on cuda:0 + cuda:1 where the machine
     has two cards; else one line says that NCCL did not run): (a)
     `parallel.mesh.sharded_tile_grads` on tests/test_parallel.py's scene
     scaled to 240x800 (K = 8) against dp = 1 on the card and against the
     CPU plain path, both kernels against their twins on rank 1's inputs;
     (b) phase 4's first window through GaussianMapper with `parallel`, the
     ranks' state digests compared after every call: ms per keyframe and
     the collectives' host ms per iteration beside phase 4's, PSNR, peak
     memory and launches per rank; (c) smoke.yaml's first 20 frames
     through `runners.run.run` with the same block: frames/s, ATE, PSNR
     beside phase 12's, and no child process left when run returns;
 17. the mesh's sp row split and `mapper.impl: naive`: (a)
     `parallel.mesh.sharded_train_step(impl="tile")` at (dp, sp) = (1, 2),
     two ranks on cuda:0 over Gloo, on 16a's scene at 240x800 against
     the whole-image step (loss, visibility, gradients through
     `sharded_tile_grads`), ms per step at sp 2 and sp 1, the collectives'
     host ms, peak memory and launches per rank, both kernels against
     their twins on rank 1's band; (b) (dp, sp) = (2, 2), four ranks, on
     __graft_entry__.py's dryrun scene (32x32, K = 4) for naive and tile
     against the whole-image step; (c) GaussianMapper with `mapper.impl:
     naive` on three windows at 48x80, card against CPU per keyframe, no
     tile kernel launched;
 18. the evaluation entry points (`runners.eval_superpoint`, `eval_droid`,
     `eval_track_long`, `eval_loop_e2e`, `eval_long_run`) at reduced
     depth: 3 room pairs; 16 frames per lane; 16 frames at grid 2x1; 48
     frames of the loop and 32 of the long run, each without its no-loop
     baseline. Each result has its JAX script's keys and finite ATEs; the
     loop run's and the long run's tracker, mapper and detector sit on the
     card, the kernels launched on every training iteration, and both
     kernels are held against their plain twins on each run's final map
     under its last mapped keyframe's camera;
 19. the bench (`runners.bench.run`): both lanes at 240x432 with the
     warm-up cut to 10 + 2 frames and the measured passes to 2 frames
     (the gated lane keeps its 28 + 6 warm-up frames: with fewer its
     gate had keyframed nothing); the eight keys of the JAX package's
     bench.py, finite, both lanes mapped, on the card; both kernels
     against their plain twins on each lane's final map under its last
     keyframe's camera at the bench's chunk 256, and at chunk 512 on the
     same map (the forward's shared memory above the 48 KB default),
     with their times at both chunks;
 20. the shipped configuration families the card had not run, through
     their entry points at their committed configurations' full widths
     (profile_configs.py's writers and `run_family`): F1
     configs/waymo/nerfslam/Scene01.yaml (vo_nerfslam, 1280x1920 JPEGs ->
     344x616), F2 configs/kitti360/unsync/kitti360_2013_05_28_drive_0000.yaml
     (vio, v0_kitti360, storage, vis, save_buffer 8000; 512x1392 ->
     264x728), F3 configs/rtg/hotel.yaml (vo, vis; 720x1280 cropped ->
     360x640), F4 configs/hierarchical/smallcity.yaml (vo with the npz
     metric prior; 690x1024 -> 344x616), F5
     configs/kitti/sync/kitti_2011_10_03_drive_0027_LC.yaml (vio with loop
     closure; 376x1241 -> 344x616), F6 configs/waymo/Scene03.yaml (vo with
     the npz prior, pose refinement fed back to the tracker, vis;
     720x1280 -> 344x616), F7 configs/pocket/pocket_scene.yaml through
     `runners.run_mobile.run` (vo, storage, a .ply every 10 frames;
     720x1280 -> 344x616; F8, the same configuration through the live
     pipeline, is phase 15d), each on a
     folder of the synthetic3d room written in its dataset module's
     layout, at the fewest frames that map two windows (F2 needs two
     rollups; F5 runs to its first loop calls): two windows, both kernels
     on every training (and F6's every refinement) iteration, finite poses
     and map, both kernels against their plain twins on the final map
     under the newest mapped keyframe's camera whose depths were kept;
     F6's refinement holding each window's pose error, F7's two map
     .ply files. F5 makes no loop attempt here: its newest
     keyframe (~18) is younger than the looper's min_history (35), and
     over a run long enough (profile_configs.py, 96 frames) its VIO
     positions run away after VI init, whose alignment fails or
     mis-scales on these poses in both packages (ROADMAP.md's recorded
     divergences), so no keyframe falls within the search radius. The
     detector is called once directly on the final state instead
     (SuperPoint, LightGlue, the map render and PnP at 344x616), and the
     stage it reached is printed.
The profiled phases (6, 7, 8, 10) read device time through
`utils.profiling.device_time` (kernels, memcpy and memset only, busy as
a union over streams) and fail where busy exceeds wall.
Cuts of depth that keep the script inside its time with phase 20 (no
width changed): phase 19's measured passes 4 -> 2 frames; 16b's
replay 2 -> 1 window on one card (profile_multicard.py keeps 2); phase
14's run 30 -> 20 frames, its session resumed from frame 10, not 20;
phase 18's eval_long_run 48 -> 32 frames and eval_track_long 24 -> 16;
15e's trainer and recipe loops 10 -> 5 steps; 17a's timed steps 3 -> 2.
Phases 9, 18 and 20 run in a worker process (`--worker`, started after
phase 8 and joined after phase 15) beside phases 11-15, whose walls and
stage times hold its share of the card and the host; the profiled and
timed phases (5-8, 10, 16, 17, 19) run alone. Phase 20 writes the next
family's folder while the current one runs.
Every phase runs with PyTorch's default numeric flags: the port clears
TF32 where it computes in f32 (`utils.device.true_f32`), and its runners
and trainers enter `utils.device.reproducible` themselves.
The second-to-last line is the card's name and power limit, the last line
a JSON summary. Without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import pathlib
import shutil
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

def pair_inputs(state, w2c, bin_kwargs, device, intrinsic=None):
    """The tile kernels' inputs for one camera: a fresh binning of `state`
    as the mapper makes it, gathered into the (24, P_CAP) pair block.
    `intrinsic` defaults to the 240x800 camera."""
    import torch
    from vings_mono_tpu_torch.mapper.cameras import camera_from_intrinsic
    from vings_mono_tpu_torch.ops.rasterizer import (bin_for_camera,
                                                     project_surfels)
    from vings_mono_tpu_torch.ops.rasterizer.render import camera_meta
    cam = camera_from_intrinsic(w2c, intrinsic or INTRINSIC)
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
    plain twin's work counts, the kernel's cull counts and the largest
    errors relative to what they are held to (the forward's channel-group
    scale, the backward's row maximum)."""
    import torch
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    counts = torch.zeros(3, dtype=torch.int64, device=pair_data.device)
    out = tk.rasterize_forward(pair_data, tc, meta, chunk, counters=counts)
    ref, evals, hits, near = tk.forward_plain(pair_data, tc, meta, chunk,
                                              near_rel=NEAR_REL)
    torch.cuda.synchronize()
    k_hits, k_visits, k_cand = (int(x) for x in counts)
    hits, near = int(hits), int(near)
    errs, rel = {}, {"fwd": 0.0}
    for name, (a, b) in FWD_GROUPS.items():
        e = float((out[:, a:b] - ref[:, a:b]).abs().max())
        scale = max(1.0, float(ref[:, a:b].abs().max()))
        errs[name] = e
        rel["fwd"] = max(rel["fwd"], e / scale)
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
        rel[name] = float(((got - want).abs() / scale).max())
        bwd_err[name] = float((got - want).abs().max())
        check(rel[name] <= BWD_TOL[name], f"{label} backward {name}: rel "
              f"err {rel[name]} > {BWD_TOL[name]}")
        check(bool(torch.isfinite(got).all()),
              f"{label} backward {name}: non-finite grads")
        print(f"phase 3 backward kernel vs plain [{label}] {name}: max abs "
              f"err {bwd_err[name]:.3e}, max err / row max {rel[name]:.3e} "
              f"(tol {BWD_TOL[name]}), score row max "
              f"{float(want[tk.GR_SCORE_IMP].abs().max()):.3f}; a second "
              f"launch and the kernel without the cull are bitwise equal",
              flush=True)
    return fwd_err, bwd_err, evals, hits, 1 - k_visits / k_cand, rel


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
    window = dict(window)
    stamps = np.asarray(window["viz_out_idx_to_f_idx"]).copy()
    stamps[-1] = stamps[-1] + 1
    window["viz_out_idx_to_f_idx"] = stamps
    wall_ms, dev = profiled(lambda: mapper.run(window))
    print_profile("phase 6", "keyframe", wall_ms, dev)


# ---------------------------------------------------------------------------
# phase 7: the VO slice
# ---------------------------------------------------------------------------

WEIGHTS = ROOT / "vings_mono_tpu/weights/droid_selftrained.npz"
# what phase 7 changes in the KITTI 0028 configuration, and why
VO_CUTS = [
    ("mode", "vio -> vo", "this phase holds the visual-only tracker; phase 8 "
     "runs vio"),
    ("use_storage_manager", "true -> false", "phase 8 runs the storage "
     "manager"),
    ("use_vis", "true -> false", "phase 8 runs the vis outputs"),
    ("frontend.rollup_at", "65 -> 28", "the run is cut to 70 frames (~35 "
     "keyframes) to leave the script's time to phases 8-15; a rollup must "
     "still fire"),
    ("frontend.rollup_n", "30 -> 20", "a rollup at 28 keyframes leaves 8 "
     "in the window"),
    ("dataset", "kitti_sync -> synthetic3d (procedural room, seeded "
     "texture, ground-truth poses)", "no KITTI frames in the repository"),
    ("frontend.weight", "checkpoints/droid.pth -> vings_mono_tpu/weights/"
     "droid_selftrained.npz", "droid.pth is not in the repository"),
]
# The DroidNet weights in the repository were trained on this room at 96x128
# and are weak: the JAX package's own evaluation of them (40 frames at
# 120x160, every frame a keyframe) reads ATE 0.684 against 1.304 with random
# weights, and the port reads 0.705 on the same settings on the CPU. At
# 240x800 with the KITTI gates the trajectory is rougher still, so phase 7
# holds the ATE only below that of a camera that never moves (every
# estimate at one point: the ground truth's RMS distance from its centroid)
# and leaves the port's agreement with the JAX package to the CPU tests and
# its agreement between card and CPU to `card_follows_cpu` below. For the
# same reason the train PSNR does not rise over the stretch (the KITTI
# learning rates move a seeded surfel little in 100 iterations, so the PSNR
# is that of the tracker's depths); phase 7 holds it above a floor that a
# hand-over in a wrong layout would not reach, and phase 4 holds the rise
# with exact geometry.
VO_PSNR_FLOOR = 10.0


def card_follows_cpu(seed):
    """The tracker on the card against the same tracker on the CPU on a
    small input (16 frames at 64x96, f32 GRU, random weights from `seed`):
    the same edge lists, counters and spilled keyframes, poses within 1e-2
    and disparities within 5e-2 (the spread of f32 sum orders through 41
    updates of feedback)."""
    import torch
    from vings_mono_tpu_torch.tracker.tracker import Tracker
    from vings_mono_tpu_torch.utils.config import load_config
    h, w = 64, 96
    cfg = load_config(overrides={"mode": "vo", "frontend": {
        "buffer": 24, "warm_up": 8, "filter_thresh": -1.0,
        "keyframe_thresh": 0.0, "frontend_thresh": 1e9,
        "frontend_window": 10, "max_factors": 24, "edge_capacity": 36,
        "inactive_capacity": 48, "ba_window": 12, "iters1": 1, "iters2": 1,
        "active_window": 10, "max_age": 8, "rollup_at": 14, "rollup_n": 4,
        "save_buffer": 64, "bf16_gru": False}})
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    trackers = []
    for device in (DEVICE, "cpu"):
        tr = Tracker(cfg, h, w, device=device,
                     generator=torch.Generator().manual_seed(seed))
        for k in range(16):
            img = 0.5 + 0.5 * np.sin(0.11 * (xs + 3.5 * k)) * np.cos(
                0.07 * (ys + 1.5 * k))
            tr.track({"timestamp": float(k), "rgb": np.stack(
                [img, img * 0.8, img * 0.6], -1).astype(np.float32),
                "intrinsic": np.asarray([80.0, 80.0, w / 2, h / 2],
                                        np.float32)})
        trackers.append(tr)
    a, b = trackers
    for key in ("ii", "jj", "age", "slot", "ii_inac", "jj_inac"):
        check(np.array_equal(getattr(a.graph, key), getattr(b.graph, key)),
              f"card and CPU disagree on graph.{key}")
    check(a.video.counter == b.video.counter
          and a.video.count_save == b.video.count_save > 0,
          "card and CPU disagree on the window's counters")
    n, m = a.video.counter, a.video.count_save
    dp = float((a.video.bufs.poses[:n].cpu() - b.video.bufs.poses[:n])
               .abs().max())
    dd = float((a.video.bufs.disps[:n].cpu() - b.video.bufs.disps[:n])
               .abs().max())
    ds = float(np.abs(a.video.poses_save[:m] - b.video.poses_save[:m]).max())
    print(f"phase 7 card vs CPU on a small input (16 frames at {h}x{w}, "
          f"f32): edge lists and counters equal, {len(a.graph.ii)} active "
          f"edges, {m} keyframes spilled; max abs difference poses "
          f"{dp:.2e}, disparities {dd:.2e}, spilled poses {ds:.2e} "
          f"(tol 1e-2, 5e-2, 1e-2)", flush=True)
    check(dp <= 1e-2 and dd <= 5e-2 and ds <= 1e-2,
          "the tracker on the card left the CPU run")


def profiled(fn, again=False):
    """Run fn once under torch.profiler; (wall ms, (busy ms, rows)) with
    the device time read by `utils.profiling.device_time`: kernels,
    memcpy and memset only, busy as a union over streams, rows (ms,
    count, name) largest first. The tracer now and then hands back no
    device event for a short window; with `again`, fn is then run once
    more (only for an fn that may be)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vings_mono_tpu_torch.utils.profiling import (device_time,
                                                      profile_events)
    for _ in range(3 if again else 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy, rows = device_time(profile_events(prof))
        if rows:
            break
    return wall_ms, (busy, rows)


def print_profile(tag, what, wall_ms, dev, top=12):
    """The busy time, idle share and largest device rows of a profiled
    call; fails where the profiler saw no device work, or where the busy
    time exceeds the wall (a reader that counts what is no device work)."""
    busy, rows = dev
    check(busy > 0, f"{tag}: the profiler saw no device events")
    check(busy <= wall_ms, f"{tag}: device busy {busy:.1f} ms > wall "
          f"{wall_ms:.1f} ms")
    print(f"{tag} profile: {what} {wall_ms:.1f} ms wall, device busy "
          f"{busy:.1f} ms as a union over streams (idle share "
          f"{1 - busy / wall_ms:.3f}), {sum(r[1] for r in rows)} device "
          f"ops (kernels, memcpy, memset)", flush=True)
    for ms, n, key in rows[:top]:
        print(f"{tag}   {ms:9.2f} ms {n:7d}x  {key[:90]}", flush=True)


def tracker_op_times(tracker):
    """ms (CUDA events) and device-op count of the tracker's plain-PyTorch
    hot ops at the live graph's shapes, computed on copies: nothing in the
    tracker's state changes."""
    import torch
    from vings_mono_tpu_torch.ops import ba as ba_ops
    from vings_mono_tpu_torch.ops import corr as corr_ops
    from vings_mono_tpu_torch.ops import projective as pops
    from vings_mono_tpu_torch.ops.upsample import upsample_disp
    from vings_mono_tpu_torch.tracker import motion_filter as mf
    g, v = tracker.graph, tracker.video
    bufs, edges, inac = v.bufs, g.edges, g.inac
    t0 = max(1, int(g.ii.min()) + 1)
    t1 = max(int(g.ii.max()), int(g.jj.max())) + 1
    base = max(0, t1 - g.w_ba)
    m = (g.ii_inac >= t0 - g.inac_range) & (g.jj_inac >= t0 - g.inac_range)
    na, ni = len(g.ii), int(m.sum())
    p = g._upload(g.slot, g.ii, g.jj, g.slot_inac[m], g.ii_inac[m],
                  g.jj_inac[m])
    slots, ii, jj = p[:na], p[na:2 * na], p[2 * na:3 * na]
    o = 3 * na
    islots, iii, ijj = p[o:o + ni], p[o + ni:o + 2 * ni], p[o + 2 * ni:]
    h, w = g.h, g.w
    gdt = torch.bfloat16 if g.bf16_gru else torch.float32
    with torch.no_grad():
        coords1, _ = pops.projective_transform(bufs.poses, bufs.disps,
                                               bufs.intrinsics, ii, jj)
        pyr = corr_ops.CorrPyramid(levels=[
            edges.corr1[slots], edges.corr2[slots], edges.corr3[slots],
            edges.corr4[slots]])
        corr = corr_ops.lookup(pyr, coords1)
        coords0 = pops.coords_grid(h, w, device=coords1.device)
        motn = torch.cat([coords1 - coords0, edges.target[slots] - coords1],
                         -1).clamp(-64, 64)
        gru_in = (edges.net[slots].to(gdt), edges.inp[slots].to(gdt),
                  corr.to(gdt), motn.to(gdt),
                  (ii - base).clamp(0, g.w_ba - 1), g.w_ba + 1, True)
        _, _, _, _, upmask = g.update_module(*gru_in)
        win = slice(base, base + g.w_ba)
        rel = lambda x: (x - base).clamp(0, g.w_ba - 1)
        inw = lambda x: (x >= base) & (x < base + g.w_ba)
        all_ii = torch.cat([rel(ii), rel(iii)])
        all_jj = torch.cat([rel(jj), rel(ijj)])
        valid = torch.cat([inw(ii) & inw(jj), inw(iii) & inw(ijj)])
        tgt = torch.cat([edges.target[slots],
                         inac.target[islots]]).movedim(-1, 1)
        wgt = torch.cat([edges.weight[slots],
                         inac.weight[islots]]).movedim(-1, 1)
        ba_args = (tgt, wgt, 0.2 * bufs.damping[win] + 1e-7, bufs.poses[win],
                   bufs.disps[win], bufs.intrinsics[win], all_ii, all_jj,
                   valid)

        def covariance():
            H_, v_, E_, C_, w_ = ba_ops.build_system(*ba_args, fixedp=0)
            S_, _, Q_ = ba_ops.schur_reduce(H_, v_, E_, C_, w_)
            free = torch.arange(g.w_ba, device=tgt.device) >= t0 - base
            cov = ba_ops.depth_covariance(S_, E_, Q_, bufs.disps[win],
                                          free_mask=free)
            return upsample_disp(cov, upmask[:g.w_ba].float())

        image = bufs.images[t1 - 1]
        nb = min(g.edge_batch, na)
        ops = [
            ("reproject", lambda: pops.projective_transform(
                bufs.poses, bufs.disps, bufs.intrinsics, ii, jj)),
            ("corr lookup (gather of 4 levels)",
             lambda: corr_ops.lookup(pyr, coords1)),
            (f"update module ({'bf16' if g.bf16_gru else 'f32'} GRU + "
             f"GraphAgg)", lambda: g.update_module(*gru_in)),
            ("ba_window, 2 iterations", lambda: ba_ops.ba_window(
                *ba_args, t0 - base, iters=2)),
            ("depth covariance + its upsample", covariance),
            ("upsample_disp", lambda: upsample_disp(
                bufs.disps[win], upmask[:g.w_ba].float())),
            (f"corr pyramid of {nb} new edges", lambda: corr_ops.build_pyramid(
                bufs.fmaps[ii[:nb]], bufs.fmaps[jj[:nb]],
                dtype=torch.bfloat16)),
            ("motion filter: fnet + corr + 1 GRU step",
             lambda: mf._features_and_gate(
                 tracker.model_run, image, tracker.filter.fmap,
                 tracker.filter.net, tracker.filter.inp)),
            ("cnet (context of a new keyframe)",
             lambda: mf._context(tracker.model_run, image)),
        ]
        print(f"phase 7 op shapes: {na} active + {ni} inactive edges, "
              f"window {g.w_ba} frames of {h}x{w}, pyramid "
              f"{[tuple(l.shape[1:]) for l in pyr.levels]} "
              f"{pyr.levels[0].dtype}", flush=True)
        rows = []
        for name, fn in ops:
            ms = cuda_ms(fn, 10, warmup=2)
            _, (_, dev) = profiled(fn, again=True)
            n_ops = sum(r[1] for r in dev)
            rows.append((name, ms, n_ops))
            print(f"phase 7 op {name}: {ms:.3f} ms, "
                  + (f"{n_ops} device ops per call" if n_ops else
                     "device ops not measured (the tracer returned none)"),
                  flush=True)
    return rows


def vo_slice(args, tk, rehearsal=None):
    """Phase 7. Returns the kernels' launch counts during the VO run, the
    frame log, the ATE, the tracker and the config. `rehearsal`: config
    overrides for a run at a small size on the CPU (never set by main)."""
    import torch
    from vings_mono_tpu_torch import middleware
    from vings_mono_tpu_torch.datasets.base import get_dataset
    from vings_mono_tpu_torch.runners import run as run_vo
    from vings_mono_tpu_torch.utils.config import load_config
    from vings_mono_tpu_torch.utils.trajectory import ate_rmse, tracker_c2ws

    save_dir = OUT / "vo"
    shutil.rmtree(save_dir, ignore_errors=True)
    # the same camera speed whatever the frame count: 0.6 of a circle per
    # 60 frames; the KITTI focal length scaled to 800 px of width
    n_all = args.vo_frames + 40
    cfg = load_config(str(CONFIG), overrides={
        "mode": "vo", "use_storage_manager": False, "use_vis": False,
        "dataset": {"module": "synthetic3d", "n_frames": n_all,
                    "revs": 0.01 * n_all, "focal": INTRINSIC["fv"],
                    "tex_seed": args.seed},
        "frontend": {"weight": str(WEIGHTS), "rollup_at": 28,
                     "rollup_n": 20},
        "training_args": {"iters": args.iters}, "seed": args.seed,
        "output": {"save_dir": str(save_dir)},
        "device": {"tracker": DEVICE, "mapper": DEVICE}})
    if rehearsal:
        from vings_mono_tpu_torch.utils.config import _deep_merge
        cfg = _deep_merge(cfg, rehearsal)
    check(list(cfg["frontend"]["image_size"]) == [H, W]
          and cfg["frontend"].get("bf16_gru", True),
          "phase 7 is not at 240x800 with the bf16 GRU")
    for key, change, why in VO_CUTS:
        print(f"phase 7 cut: {key}: {change} ({why})", flush=True)
    fe = cfg["frontend"]
    print(f"phase 7 config: frontend buffer {fe['buffer']}, ba_window "
          f"{fe['ba_window']}, edge_capacity {fe['edge_capacity']}, "
          f"inactive_capacity {fe['inactive_capacity']}, filter_thresh "
          f"{fe['filter_thresh']}, keyframe_thresh {fe['keyframe_thresh']}, "
          f"rollup_at {fe['rollup_at']}, rollup_n {fe['rollup_n']}, iters1 "
          f"{fe['iters1']}, iters2 {fe['iters2']}; mapper iters "
          f"{args.iters}, kf_capacity {cfg['mapper']['kf_capacity']}; "
          f"{args.vo_frames} frames", flush=True)

    log = {"appended": 0, "rejected": 0, "removed": 0, "kept": 0,
           "mapped": [], "packaged": 0, "rollups": 0, "last_counter": 0,
           "time_idx": 0, "frame_s": [], "t_last": None}

    def on_frame(idx, tracker, mapper, viz_out):
        now = time.perf_counter()
        if log["t_last"] is not None:
            log["frame_s"].append(now - log["t_last"])
        fe_, v = tracker.frontend, tracker.video
        grew = v.counter + v.count_save - log["last_counter"]
        log["last_counter"] = v.counter + v.count_save
        if fe_.is_initialized and idx >= fe_.warmup:
            if tracker.filter.count > 0:
                log["rejected"] += 1
            else:
                log["appended"] += 1
                if fe_.new_frame_added:
                    log["kept"] += 1
                elif grew == 0:
                    log["removed"] += 1
        log["rollups"] += bool(fe_.did_rollup)
        fe_.did_rollup = False
        log["packaged"] += viz_out is not None
        if mapper.time_idx > log["time_idx"]:
            # the mapper trained: the package held a keyframe new to it
            log["time_idx"] = mapper.time_idx
            per_iter = mapper.metrics["psnr_per_iter"]
            k = max(1, len(per_iter) // 10)
            log["mapped"].append(
                (idx, float(per_iter[:k].mean()), float(per_iter[-k:].mean()),
                 bool(torch.isfinite(mapper.metrics["loss_per_iter"]).all()),
                 mapper.n_alive))
        log["t_last"] = time.perf_counter()

    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    t0 = time.perf_counter()
    tracker, mapper, timer = run_vo.run(
        cfg, str(save_dir), max_frames=args.vo_frames, on_frame=on_frame,
        sync_timer=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"rasterize_forward": tk.rasterize_forward.launches,
                "rasterize_backward": tk.rasterize_backward.launches}

    # ---- what happened
    for idx, p0, p1, finite, n_alive in log["mapped"]:
        print(f"phase 7 mapped keyframe at frame {idx}: train psnr "
              f"{p0:.3f} (first tenth of the iterations) -> {p1:.3f} (last "
              f"tenth), n_alive {n_alive}", flush=True)
    print(timer.report().replace("\n", "\nphase 7 ").replace(
        "stage times", "phase 7 stage times"), flush=True)
    n_map = len(log["mapped"])
    v, g, fe_ = tracker.video, tracker.graph, tracker.frontend
    tracked = log["appended"] + log["rejected"]
    stretch = log["frame_s"][fe_.warmup:]
    print(f"phase 7 run: {args.vo_frames} frames in {run_s:.1f} s; after "
          f"the warm-up {tracked} frames: motion filter rejected "
          f"{log['rejected']}, appended {log['appended']}; keyframe gate "
          f"removed {log['removed']}, kept {log['kept']}; rollups "
          f"{log['rollups']} (count_save {v.count_save}); window counter "
          f"{v.counter}; proximity prefetch hits {g._prox_hits}, keyframe "
          f"distance prefetch hits {fe_._kf_dist_hits}; {log['packaged']} "
          f"packages, the mapper trained on {n_map} "
          f"keyframes at {1e3 * timer.totals['map'] / max(n_map, 1):.1f} ms "
          f"each; {len(stretch) / sum(stretch):.2f} frames per second "
          f"after the warm-up (host clock, each stage ends with a device "
          f"synchronize); launches {launches}", flush=True)
    check(fe_.is_initialized, "the frontend did not initialise")
    check(log["kept"] >= 20, f"only {log['kept']} frames tracked into "
          f"keyframes after the initialisation")
    check(n_map >= 20, f"mapper.run trained on {n_map} packages only")
    check(log["rejected"] > 0 and log["appended"] > 0,
          f"the motion filter took one branch only: rejected "
          f"{log['rejected']}, appended {log['appended']}")
    check(log["removed"] > 0 and log["kept"] > 0,
          f"the keyframe gate took one branch only: removed "
          f"{log['removed']}, kept {log['kept']}")
    check(v.count_save > 0 and log["rollups"] > 0, "no rollup fired")
    check(g._prox_hits > 0 and fe_._kf_dist_hits > 0,
          "a prefetch was never consumed")
    n = v.counter
    check(bool(torch.isfinite(v.bufs.poses[:n]).all()
               and torch.isfinite(v.bufs.disps[:n]).all()
               and torch.isfinite(v.bufs.disps_up[:n]).all()),
          "poses or disparities are not finite")
    check(np.isfinite(v.poses_save[:v.count_save]).all()
          and np.isfinite(v.disps_up_save[:v.count_save]).all(),
          "the save buffers are not finite")
    check(all(m[3] for m in log["mapped"]), "a mapping loss is not finite")
    for name, cnt in launches.items():
        check(cnt >= n_map * args.iters, f"{name} launched {cnt} times for "
              f"{n_map * args.iters} train iterations")
    head = np.mean([m[1] for m in log["mapped"][:3]])
    tail = np.mean([m[2] for m in log["mapped"][-3:]])
    low = min(m[2] for m in log["mapped"])
    print(f"phase 7 train psnr: {head:.3f} (first tenth of the iterations, "
          f"first 3 mapped keyframes) -> {tail:.3f} (last tenth, last 3); "
          f"lowest last tenth {low:.3f} (floor {VO_PSNR_FLOOR})",
          flush=True)
    check(low >= VO_PSNR_FLOOR, f"a mapped keyframe's train PSNR {low:.3f} "
          f"is under {VO_PSNR_FLOOR}")

    ts, c2ws = tracker_c2ws(tracker)
    gt = get_dataset(cfg).load_gt_dict()
    ate = ate_rmse(ts, c2ws, gt["timestamps"], gt["c2ws"])
    at_kf = np.asarray([np.asarray(gt["c2ws"][int(t)])[:3, 3] for t in ts])
    still = float(np.sqrt(((at_kf - at_kf.mean(0)) ** 2).sum(1).mean()))
    print(f"phase 7 trajectory: {len(ts)} keyframes, scale-aligned ATE "
          f"rmse {ate:.4f} room units; a camera that never moves would "
          f"read {still:.4f} (the bound)", flush=True)
    check(ate is not None and ate < still,
          f"ATE {ate} is not under the still camera's {still}")
    poses = sorted((save_dir / "droid_c2w").glob("*.txt"))
    check(len(poses) == len(ts), "pose files missing")
    check(np.isfinite(np.loadtxt(poses[-1])).all(), "a pose file holds a "
          "non-finite value")
    check((save_dir / "keyframelist.txt").is_file()
          and (save_dir / "ply" / "final_2dgs.ply").stat().st_size > 0,
          "keyframelist.txt or the final .ply is missing")

    card_follows_cpu(args.seed)

    # ---- where a tracked frame's time goes
    tracker_op_times(tracker)
    dataset = get_dataset(cfg)
    state = {}

    def track_one(idx):
        tracker.track(dataset[idx])
        state["viz"] = middleware.judge_and_package(tracker, cfg)

    for idx in range(args.vo_frames, n_all):
        before = fe_.count
        wall_ms, rows = profiled(lambda: track_one(idx))
        if fe_.count > before and fe_.new_frame_added:
            print_profile("phase 7", f"tracked frame {idx} (motion filter, "
                          f"{fe_.iters1}+{fe_.iters2} graph updates, "
                          f"packaging)", wall_ms, rows)
            break
    else:
        fail("no frame after the run was tracked into a keyframe")
    viz = state["viz"]
    check(viz is not None and viz["images"].is_cuda,
          "the packaged images are not on the card")
    # the hand-over: with every synchronizing call made an error (a copy
    # to the host is one), the mapper packs the tracker's tensors
    image_bytes = viz["images"].numel() * 4
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        batch = mapper._pack_batch(viz)
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    same = batch.images.untyped_storage().data_ptr() == \
        viz["images"].untyped_storage().data_ptr()
    print(f"phase 7 hand-over: _pack_batch of {tuple(viz['images'].shape)} "
          f"images ({image_bytes / 1e6:.1f} MB) on the card: {host_ms:.2f} "
          f"ms of host time, no synchronizing call (a device-to-host copy "
          f"would raise); the batch's images "
          f"{'share' if same else 'do not share'} the packaged tensor's "
          f"storage", flush=True)
    check(same, "the packaged images took a copy on their way into the "
          "mapper")
    return launches, log, ate, tracker, cfg

# ---------------------------------------------------------------------------
# phase 8: the visual-inertial slice with storage paging
# ---------------------------------------------------------------------------

VIO_DT = 0.05               # camera frame period of phase 8, s
IMU_HZ = 100.0              # KITTI's IMU rate
GRAVITY = 9.81              # along the room's down axis (+y, the camera's)
VIO_REVS_PER_FRAME = 0.01   # phase 7's camera speed: 0.113 units per frame
# The camera circles the room's centre at a radius of 1.8 units (the room
# is 8 across), so the distance from an early keyframe rises to 3.6 across
# the circle and falls again on the way back: at 2.5 units keyframes are
# paged out some 25 frames after the camera left them and back in some 25
# frames before it returns (on the ground-truth circle).
STORAGE_THRESHOLD = 2.5
VIO_CUTS = [
    ("dataset", "kitti_sync -> synthetic3d (phase 7's room) at a frame "
     f"period of {VIO_DT} s with a {IMU_HZ:.0f} Hz IMU stream from the "
     "room's analytic trajectory (gravity 9.81 along the room's down axis, "
     "c2i identity)", "no KITTI frames or metadata/imu.txt in the "
     "repository; the dataset's own IMU stream is gravity only, so VI init "
     "would never fire"),
    ("frontend.weight", "checkpoints/droid.pth -> vings_mono_tpu/weights/"
     "droid_selftrained.npz", "droid.pth is not in the repository"),
    ("storage_manager.distance_threshold", f"70.0 -> {STORAGE_THRESHOLD} "
     "room units", "70 m is KITTI's street scale: in an 8-unit room nothing "
     f"would page; {STORAGE_THRESHOLD} pages keyframes out across the "
     "circle and back in when the camera returns"),
]


def room_imu(n, revs, dt, room=4.0, hz=IMU_HZ):
    """IMU rows [t, gyro deg/s x3, acc x3] (body = camera frame) of
    synthetic3d's trajectory_c2w(t / dt, n, room, revs), from its analytic
    derivatives: th = W t; position on a circle of radius 0.45 room with a
    0.3 sin(2.1 th) bob in y; R = Ry(yaw) Rx(pitch) with yaw = 0.35
    sin(th + 0.5), pitch = 0.12 sin(1.7 th). Specific force R^T (a - g)
    with g = +9.81 y; gyro yaw' Rx^T e_y + pitch' e_x."""
    W = 2.0 * np.pi * revs / max(n, 1) / dt
    t = np.arange(int(round((n - 1) * dt * hz)) + 1) / hz
    th = W * t
    rad = 0.45 * room
    acc_w = W ** 2 * np.stack([-rad * np.sin(th),
                               -0.3 * 2.1 ** 2 * np.sin(2.1 * th),
                               -rad * np.cos(th)], -1)
    yaw, pitch = 0.35 * np.sin(th + 0.5), 0.12 * np.sin(1.7 * th)
    dyaw = 0.35 * np.cos(th + 0.5) * W
    dpitch = 0.12 * 1.7 * np.cos(1.7 * th) * W
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    z, o = np.zeros_like(th), np.ones_like(th)
    Ry = np.stack([np.stack([cy, z, sy], -1), np.stack([z, o, z], -1),
                   np.stack([-sy, z, cy], -1)], -2)
    Rx = np.stack([np.stack([o, z, z], -1), np.stack([z, cp, -sp], -1),
                   np.stack([z, sp, cp], -1)], -2)
    R = Ry @ Rx
    gyro = dyaw[:, None] * np.stack([z, cp, -sp], -1) \
        + dpitch[:, None] * np.stack([o, z, z], -1)
    f = np.einsum("nji,nj->ni", R, acc_w - np.array([0.0, GRAVITY, 0.0]))
    return np.concatenate([t[:, None], np.rad2deg(gyro), f], 1)


def with_imu(room_cls):
    """synthetic3d at a frame period of VIO_DT with room_imu's stream."""
    class RoomWithImu(room_cls):
        def __getitem__(self, k):
            pkt = super().__getitem__(k)
            pkt["timestamp"] = k * VIO_DT
            return pkt

        def preload_imu(self):
            return room_imu(self.n, self.revs, VIO_DT, self.room)

        def load_gt_dict(self):
            gt = super().load_gt_dict()
            gt["timestamps"] = gt["timestamps"] * VIO_DT
            return gt
    return RoomWithImu


@contextlib.contextmanager
def replaced(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _row_bytes(state, gids):
    """Every alive row of the keyframes `gids`, all FIELDS side by side as
    bytes, rows sorted: a canonical form to compare bit for bit."""
    import torch
    from vings_mono_tpu_torch.storage.manager import FIELDS
    sel = torch.as_tensor(np.asarray(gids, np.int64),
                          device=state.xyz.device)
    m = state.alive & torch.isin(state.globalkf_id.long(), sel)
    out = {}
    gid = state.globalkf_id[m].cpu().numpy()
    cols = np.concatenate([
        np.ascontiguousarray(getattr(state, f)[m].cpu().numpy())
        .view(np.uint8).reshape(len(gid), getattr(state, f)[:1].numel()
                                * getattr(state, f).element_size())
        for f in FIELDS], axis=1)
    for g in gids:
        rows = cols[gid == g]
        out[int(g)] = rows[np.lexsort(rows.T[::-1])] if len(rows) else rows
    return out


def checked_storage(base, made):
    """The StorageManager with a check round it: the rows of each keyframe
    it evicts are kept (read directly from the device), and the rows a
    page-in brings back must equal them bit for bit in every field. Each
    instance is appended to `made`."""
    class Checked(base):
        def __init__(self, cfg):
            super().__init__(cfg)
            made.append(self)
            self.evicted = {}
            self.round_trips = 0
            self.rows_checked = 0
            self.mismatches = []

        def gpu2cpu(self, mapper, dist):
            far = np.where((self.place[:len(dist)] == 1)
                           & (dist > self.threshold))[0]
            if len(far):
                self.evicted.update(_row_bytes(mapper.state, far))
            super().gpu2cpu(mapper, dist)

        def cpu2gpu(self, mapper, dist):
            near = np.where((self.place[:len(dist)] == 0)
                            & (dist < self.threshold))[0]
            before = self.pages_in
            super().cpu2gpu(mapper, dist)
            if self.pages_in == before:
                return
            back = _row_bytes(mapper.state, near)
            for g, rows in back.items():
                want = self.evicted.get(g)
                if want is None or not len(want):
                    continue
                self.round_trips += 1
                self.rows_checked += len(rows)
                if rows.shape != want.shape or not np.array_equal(rows,
                                                                  want):
                    self.mismatches.append(g)
    return Checked


def vio_tracker_pair(seed):
    """The VIO tracker of tests/test_vio.py (18 frames at 64x96, its
    wiggly IMU, f32 GRU, random weights from `seed`) on the card and on
    the CPU."""
    import torch
    from vings_mono_tpu_torch.tracker.imu import so3_exp
    from vings_mono_tpu_torch.tracker.tracker import Tracker
    from vings_mono_tpu_torch.tracker.vio import InertialFusion
    from vings_mono_tpu_torch.utils.config import load_config
    h, w, fps = 64, 96, 10.0
    cfg = load_config(overrides={"mode": "vio", "frontend": {
        "buffer": 24, "warm_up": 8, "filter_thresh": -1.0,
        "keyframe_thresh": 0.0, "frontend_thresh": 1e9,
        "frontend_window": 10, "frontend_radius": 2, "frontend_nms": 1,
        "max_factors": 24, "edge_capacity": 36, "inactive_capacity": 48,
        "ba_window": 12, "iters1": 1, "iters2": 1, "active_window": 10,
        "max_age": 8, "rollup_at": 100, "rollup_n": 4, "save_buffer": 64,
        "vi_warmup": 10, "bf16_gru": False}})
    g = np.array([0.0, 0.0, -9.81])
    R, rows = np.eye(3), []
    for k in range(400):
        t = k / 100.0
        wb = np.array([0.2 * np.sin(0.8 * t), 0.15, -0.1 * np.cos(0.5 * t)])
        a_world = np.array([1.5 * np.sin(2.0 * t), 1.0 * np.cos(2.0 * t),
                            0.3 * np.sin(1.0 * t)])
        rows.append(np.concatenate([[t], np.rad2deg(wb),
                                    R.T @ (a_world - g)]))
        R = R @ so3_exp(wb * 0.01)
    imu = np.asarray(rows)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for device in (DEVICE, "cpu"):
        tr = Tracker(cfg, h, w, device=device,
                     generator=torch.Generator().manual_seed(seed))
        inertial = InertialFusion(tr.video, cfg, imu, np.eye(4))
        tr.frontend.attach_inertial(inertial)
        init = None
        for k in range(18):
            img = 0.5 + 0.5 * np.sin(0.11 * (xs + 3.5 * k)) * np.cos(
                0.07 * (ys + 1.5 * k))
            tr.track({"timestamp": k / fps, "rgb": np.stack(
                [img, img * 0.8, img * 0.6], -1).astype(np.float32),
                "intrinsic": np.asarray([80.0, 80.0, w / 2, h / 2],
                                        np.float32)})
            if init is None and inertial.vi_init_t1 >= 0:
                init = k
        out.append((tr, inertial, init))
    return out


def card_follows_cpu_vio(seed):
    """The VIO tracker on the card against the same tracker on the CPU, both
    f32: the VI-init frame, edge lists and counters equal; camera poses,
    disparities and body states (p, v, biases) within 1e-3."""
    (a, ia, inita), (b, ib, initb) = vio_tracker_pair(seed)
    check(inita is not None and inita == initb,
          f"VI init fired at frame {inita} on the card, {initb} on the CPU")
    for key in ("ii", "jj", "age", "slot", "ii_inac", "jj_inac"):
        check(np.array_equal(getattr(a.graph, key), getattr(b.graph, key)),
              f"card and CPU disagree on graph.{key}")
    check(a.video.counter == b.video.counter
          and ia.last_t0 == ib.last_t0 and ia.last_t1 == ib.last_t1
          and ia.stats["updates"] == ib.stats["updates"] > 0,
          "card and CPU disagree on the window's or the inertial layer's "
          "counters")
    n = a.video.counter
    dp = float((a.video.bufs.poses[:n].cpu() - b.video.bufs.poses[:n])
               .abs().max())
    dd = float((a.video.bufs.disps[:n].cpu() - b.video.bufs.disps[:n])
               .abs().max())
    ds = {f: max(float(np.abs(getattr(x, f) - getattr(y, f)).max())
                 for x, y in zip(ia.states, ib.states))
          for f in ("p", "v", "b")}
    print(f"phase 8 card vs CPU on a small input (the VIO tracker, 18 "
          f"frames at 64x96, f32): VI init at frame {inita} on both, edge "
          f"lists and counters equal, {ia.stats['updates']} multi-sensor "
          f"updates on both; max abs difference poses {dp:.2e}, disparities "
          f"{dd:.2e}, states p {ds['p']:.2e}, v {ds['v']:.2e}, biases "
          f"{ds['b']:.2e} (tol 1e-3 each)", flush=True)
    check(max(dp, dd, *ds.values()) <= 1e-3, "the VIO tracker on the card "
          "left the CPU run")


def gt_alignment(first, bg_true):
    """VINS-Mono alignment on room_imu (gyro bias `bg_true` added) with the
    room's ground-truth poses in a video on the card: 14 keyframes every
    second frame from frame `first` at phase 8's frame period and speed,
    aligned over the last 8 with the lever arm ignored, as the first step
    of `maybe_initialize`. Returns (excitation, gyro bias error rad/s,
    scale, gravity error degrees, largest relative velocity error)."""
    import torch
    from vings_mono_tpu_torch.datasets.synthetic3d import trajectory_c2w
    from vings_mono_tpu_torch.ops import lie
    from vings_mono_tpu_torch.tracker.video import empty_buffers
    from vings_mono_tpu_torch.tracker.vio import InertialFusion
    from vings_mono_tpu_torch.utils.config import load_config
    n = 120
    revs = VIO_REVS_PER_FRAME * n
    frames = list(range(first, first + 28, 2))
    t1 = len(frames)
    imu = room_imu(n, revs, VIO_DT)
    imu[:, 1:4] += np.rad2deg(bg_true)
    c2w = lambda k: trajectory_c2w(k, n, 4.0, revs)  # noqa: E731
    c2ws = np.stack([c2w(k) for k in frames])

    class Video:
        bufs = empty_buffers(t1, H, W, device=DEVICE)
        counter = t1
        tstamps_host = [k * VIO_DT for k in frames]
        imu_enabled = visual_only_init = False
    Video.bufs.disps[:] = 1.0
    Video.bufs.poses[:t1] = lie.se3_from_matrix(torch.as_tensor(
        np.linalg.inv(c2ws), dtype=torch.float32, device=DEVICE))
    layer = InertialFusion(Video, load_config(overrides={
        "mode": "vio", "frontend": {"vi_warmup": 12}}), imu, np.eye(4))
    layer.init_states()
    excitation = layer.excitation(t1)
    layer.visual_imu_alignment(t1 - 8, t1, ignore_lever=True)
    s = 1.0 / float(Video.bufs.disps[:t1].mean())
    # the alignment turns gravity to -z; the room's is +y
    R0 = layer.states[t1 - 1].R @ c2ws[t1 - 1, :3, :3].T
    up = R0 @ np.array([0.0, -1.0, 0.0])
    h, dv = 1e-4, 0.0
    for i in range(t1 - 8, t1):
        v_gt = (c2w(frames[i] + h) - c2w(frames[i] - h))[:3, 3] / (
            2 * h * VIO_DT)
        dv = max(dv, float(np.linalg.norm(layer.states[i].v - s * R0 @ v_gt)
                           / np.linalg.norm(v_gt)))
    return (excitation, float(np.abs(layer.states[t1 - 1].b[:3]
                                     - bg_true).max()),
            s, float(np.degrees(np.arccos(min(up[2], 1.0)))), dv)


def check_gt_alignment():
    """The room's IMU stream and the alignment at phase 8's settings, on
    ground-truth poses (tests/test_torch_vio_slice.py holds the same on
    the CPU): the gyro bias within 5e-3 rad/s, the scale within 2e-2 of 1,
    gravity within 0.5 degree, velocities within 1 %."""
    for first in (0, 40):
        for bg in (np.zeros(3), np.array([0.01, -0.02, 0.015])):
            ex, dbg, s, dg, dv = gt_alignment(first, bg)
            print(f"phase 8 alignment on ground-truth poses (keyframes "
                  f"every second frame from frame {first}, gyro bias "
                  f"{np.abs(bg).max():.3f} rad/s): excitation {ex:.4f}, "
                  f"gyro bias error {dbg:.2e} rad/s, scale {s:.4f}, "
                  f"gravity off by {dg:.3f} degrees, velocities off by "
                  f"{100 * dv:.2f} % at most", flush=True)
            check(ex > 0.25 and dbg <= 5e-3 and abs(s - 1.0) <= 2e-2
                  and dg <= 0.5 and dv <= 1e-2, "the alignment on "
                  "ground-truth poses missed the room's bias, scale or "
                  "gravity")


def run_alignment(tracker, t1):
    """How the run's own alignment came out, from the video just after VI
    init: the window's keyframe-to-keyframe rotations against the ground
    truth's (degrees), the estimated window's spread over the ground
    truth's (1 when the scale is right) and gravity's error in degrees."""
    from vings_mono_tpu_torch.datasets.synthetic3d import trajectory_c2w
    from vings_mono_tpu_torch.ops import lie
    from vings_mono_tpu_torch.tracker.imu import so3_log
    v = tracker.video
    n_all = tracker.cfg["dataset"]["n_frames"]
    revs = tracker.cfg["dataset"]["revs"]
    win = range(max(t1 - 8, 0), t1)
    est = np.linalg.inv(lie.se3_matrix(v.bufs.poses[:t1]).cpu().numpy()
                        .astype(np.float64))
    gt = np.stack([trajectory_c2w(round(v.tstamps_host[i] / VIO_DT), n_all,
                                  4.0, revs) for i in range(t1)])
    rel = lambda T, i: T[i, :3, :3].T @ T[i + 1, :3, :3]  # noqa: E731
    d_rot = [np.degrees(np.linalg.norm(so3_log(rel(gt, i).T @ rel(est, i))))
             for i in win[:-1]]
    gt_rot = [np.degrees(np.linalg.norm(so3_log(rel(gt, i))))
              for i in win[:-1]]
    M = sum(est[i, :3, :3] @ gt[i, :3, :3].T for i in win)
    U, _, Vt = np.linalg.svd(M)
    R0 = U @ Vt
    up = R0 @ np.array([0.0, -1.0, 0.0])
    pe = est[list(win), :3, 3]
    pg = gt[list(win), :3, 3]
    spread = float(np.sqrt(((pe - pe.mean(0)) ** 2).sum(1).mean()
                           / ((pg - pg.mean(0)) ** 2).sum(1).mean()))
    return {"rot_err": d_rot, "rot": gt_rot, "spread": spread,
            "gravity_deg": float(np.degrees(np.arccos(np.clip(up[2], -1,
                                                              1))))}


def vio_slice(args, tk):
    """Phase 8. Returns the kernels' launch counts during the VIO run."""
    import warnings

    import torch
    import vings_mono_tpu_torch.datasets.base as dbase
    import vings_mono_tpu_torch.storage.manager as smod
    from vings_mono_tpu_torch import middleware
    from vings_mono_tpu_torch.datasets.synthetic3d import Synthetic3DDataset
    from vings_mono_tpu_torch.runners import run as run_vo
    from vings_mono_tpu_torch.utils.config import load_config
    from vings_mono_tpu_torch.utils.trajectory import ate_rmse, tracker_c2ws

    save_dir = OUT / "vio"
    shutil.rmtree(save_dir, ignore_errors=True)
    # frames after the run: one is tracked again for the sync count and
    # the profile
    n_all = args.vio_frames + 20
    cfg = load_config(str(CONFIG), overrides={
        "dataset": {"module": "synthetic3d", "n_frames": n_all,
                    "revs": VIO_REVS_PER_FRAME * n_all,
                    "focal": INTRINSIC["fv"], "tex_seed": args.seed},
        "frontend": {"weight": str(WEIGHTS)},
        "storage_manager": {"distance_threshold": STORAGE_THRESHOLD},
        "training_args": {"iters": args.iters}, "seed": args.seed,
        "output": {"save_dir": str(save_dir)},
        "device": {"tracker": DEVICE, "mapper": DEVICE}})
    check(cfg["mode"] == "vio" and cfg["use_storage_manager"]
          and list(cfg["frontend"]["image_size"]) == [H, W],
          "phase 8 is not mode vio with storage at 240x800")
    for key, change, why in VIO_CUTS:
        print(f"phase 8 cut: {key}: {change} ({why})", flush=True)
    fe = cfg["frontend"]
    print(f"phase 8 config: mode {cfg['mode']}, use_storage_manager "
          f"{cfg['use_storage_manager']} (every "
          f"{cfg['storage_manager']['every']} frames), frontend buffer "
          f"{fe['buffer']}, ba_window {fe['ba_window']}, edge_capacity "
          f"{fe['edge_capacity']}, vi_warmup {fe['vi_warmup']}, iters1 "
          f"{fe['iters1']}, iters2 {fe['iters2']}; mapper capacity "
          f"{cfg['mapper']['capacity']}, iters {args.iters}; "
          f"{args.vio_frames} frames, {VIO_REVS_PER_FRAME * args.vio_frames:.2f}"
          f" circles", flush=True)

    dataset_cls = with_imu(Synthetic3DDataset)
    log = {"init_idx": None, "at_init": None, "mapped": [], "updates": 0,
           "after_init": 0, "t_last": None, "frame_s": [],
           "zeroed": ([], [])}

    def on_frame(idx, tracker, mapper, viz_out):
        now = time.perf_counter()
        if log["t_last"] is not None:
            log["frame_s"].append(now - log["t_last"])
        inertial = tracker.frontend.inertial
        updated = tracker.frontend.count > log["updates"]
        log["updates"] = tracker.frontend.count
        if log["init_idx"] is None and inertial.vi_init_t1 >= 0:
            log["init_idx"] = idx
            log["at_init"] = dict(inertial.stats)
            log["excitation"] = inertial.excitation(inertial.vi_init_t1)
            log["run_alignment"] = run_alignment(tracker,
                                                 inertial.vi_init_t1)
        elif log["init_idx"] is not None and updated:
            log["after_init"] += 1
        if viz_out is not None:
            # the share of packaged depth pixels the middleware's gate
            # zeroed, before and after VI init
            d = torch.as_tensor(viz_out["depths"][:viz_out["n_valid"]])
            log["zeroed"][log["init_idx"] is not None].append(
                float((d == 0).float().mean()))
        if mapper.time_idx > len(log["mapped"]):
            per_iter = mapper.metrics["psnr_per_iter"]
            k = max(1, len(per_iter) // 10)
            log["mapped"].append(
                (idx, float(per_iter[:k].mean()), float(per_iter[-k:].mean()),
                 bool(torch.isfinite(mapper.metrics["loss_per_iter"]).all())))
        log["t_last"] = time.perf_counter()

    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    made = []
    with replaced(dbase, "get_dataset", lambda c: dataset_cls(c)), \
            replaced(smod, "StorageManager",
                     checked_storage(smod.StorageManager, made)), \
            recording_vis(run_vo) as vis_calls:
        tracker, mapper, timer = run_vo.run(
            cfg, str(save_dir), max_frames=args.vio_frames,
            on_frame=on_frame, sync_timer=True)
    (storage,) = made
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"rasterize_forward": tk.rasterize_forward.launches,
                "rasterize_backward": tk.rasterize_backward.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    smi = nvidia_smi()
    inertial = tracker.frontend.inertial
    v, fe_ = tracker.video, tracker.frontend
    print(timer.report().replace("\n", "\nphase 8 ").replace(
        "stage times", "phase 8 stage times"), flush=True)
    n_map = len(log["mapped"])
    stretch = log["frame_s"][fe_.warmup:]
    print(f"phase 8 run [{smi}]: {args.vio_frames} frames in {run_s:.1f} s, "
          f"{len(stretch) / sum(stretch):.2f} frames per second after the "
          f"warm-up (host clock, each stage ends with a device synchronize); "
          f"{v.counter + v.count_save} keyframes, the mapper trained on "
          f"{n_map}; peak device memory {peak_gb:.2f} GB; launches "
          f"{launches}", flush=True)
    check_vis("phase 8", vis_calls, H, W, n_map, cfg.get("vis"))
    check_vis_kernels("phase 8", vis_calls, mapper, cfg.get("vis"),
                      args.seed + 30, host=True)
    check(log["init_idx"] is not None and v.imu_enabled
          and inertial.imu_enabled, "VI init did not fire")
    print(f"phase 8 VI init: at frame {log['init_idx']} (keyframe "
          f"{inertial.vi_init_t1 if inertial.vi_init_t1 >= 0 else 'rolled out'}"
          f"), excitation {log['excitation']:.4f} (gate 0.25)", flush=True)
    ra = log["run_alignment"]
    print(f"phase 8 the run's alignment, on the tracker's poses: the "
          f"window's keyframe-to-keyframe rotations (ground truth "
          f"{np.mean(ra['rot']):.2f} degrees on average) are off by "
          + ", ".join(f"{d:.2f}" for d in ra["rot_err"])
          + f" degrees; the window's spread is {ra['spread']:.3f} of the "
          f"ground truth's (1 is the right scale), gravity off by "
          f"{ra['gravity_deg']:.2f} degrees", flush=True)
    check_gt_alignment()
    st, s0 = inertial.stats, log["at_init"]
    n_upd = st["updates"]
    nf = max(log["after_init"], 1)
    per = {k: (st[k] - s0[k]) / nf for k in st}
    print(f"phase 8 inertial layer [{smi}]: multi_sensor_ba ran on {n_upd} "
          f"updates ({st['updates'] - s0['updates']} over the "
          f"{log['after_init']} tracked frames after init); per tracked "
          f"frame after init: device ba_hessian {per['hessian_ms']:.3f} ms, "
          f"device-to-host copies {per['pulls']:.2f} "
          f"({per['pull_ms']:.3f} ms, {per['pull_bytes'] / 1e3:.1f} kB), "
          f"host LM {1e3 * per['lm_s']:.2f} ms + marginalization "
          f"{1e3 * per['marg_s']:.2f} ms", flush=True)
    check(n_upd >= 10, f"multi_sensor_ba ran on {n_upd} updates only")

    n = v.counter
    finite_states = all(np.isfinite(s.p).all() and np.isfinite(s.v).all()
                        and np.isfinite(s.b).all() and np.isfinite(s.R).all()
                        for s in inertial.states)
    check(finite_states and bool(torch.isfinite(v.bufs.poses[:n]).all()
                                 and torch.isfinite(v.bufs.disps[:n]).all()),
          "states, poses or disparities are not finite")
    check(all(m[3] for m in log["mapped"]) and n_map >= 10,
          f"{n_map} keyframes mapped, or a mapping loss is not finite")
    for name, cnt in launches.items():
        check(cnt >= n_map * args.iters, f"{name} launched {cnt} times for "
              f"{n_map * args.iters} train iterations")
    # The floor holds for the keyframes mapped before VI init, where the
    # tracker is phase 7's. After it the trajectory rests on the run's own
    # alignment, which takes the tracker's keyframe rotations and positions
    # (printed above against the ground truth) where check_gt_alignment
    # takes the ground truth's: with these weights it misses the scale and
    # gravity, the trajectory and depths come out several times too large,
    # the middleware's max_depth gate zeroes most pixels, and a keyframe's
    # PSNR is that of a mostly black target (printed, not held).
    before = [m[2] for m in log["mapped"] if m[0] <= log["init_idx"]]
    print("phase 8 mapped keyframes (frame: train psnr last tenth): "
          + ", ".join(f"{m[0]}: {m[2]:.2f}" for m in log["mapped"]),
          flush=True)
    print(f"phase 8 train psnr: lowest last tenth before VI init "
          f"{min(before):.3f} over {len(before)} keyframes (floor "
          f"{VO_PSNR_FLOOR}), after it {min(m[2] for m in log['mapped']):.3f}"
          f" at the lowest; depth pixels the gate zeroed: "
          f"{np.mean(log['zeroed'][0] or [np.nan]):.3f} of each package "
          f"before VI init, {np.mean(log['zeroed'][1] or [np.nan]):.3f} "
          f"after", flush=True)
    check(len(before) >= 3 and min(before) >= VO_PSNR_FLOOR,
          f"a keyframe mapped before VI init has a train PSNR under "
          f"{VO_PSNR_FLOOR}")

    ts, c2ws = tracker_c2ws(tracker)
    gt = dataset_cls(cfg).load_gt_dict()
    ate = ate_rmse(ts, c2ws, gt["timestamps"], gt["c2ws"])
    ate_se3 = ate_rmse(ts, c2ws, gt["timestamps"], gt["c2ws"],
                       scale_align=False)
    at_kf = np.asarray([np.asarray(gt["c2ws"][int(round(t / VIO_DT))])[:3, 3]
                        for t in ts])
    still = float(np.sqrt(((at_kf - at_kf.mean(0)) ** 2).sum(1).mean()))
    est = np.asarray(c2ws)[:, :3, 3]
    spread = float(np.sqrt(((est - est.mean(0)) ** 2).sum(1).mean()))
    print(f"phase 8 trajectory: {len(ts)} keyframes, ATE rmse scale-aligned "
          f"{ate:.4f}, rigid only (no scale) {ate_se3:.4f} room units; a "
          f"camera that never moves would read {still:.4f}; the estimate's "
          f"spread is {spread / still:.3f} of the ground truth's (with a "
          f"consistent IMU the scale is observable: the rigid-only error "
          f"says how far the run recovered it)", flush=True)
    check(np.isfinite([ate, ate_se3]).all(), "the trajectory is not finite")

    per_call = 1e3 * timer.totals["storage"] / max(timer.counts["storage"], 1)
    print(f"phase 8 storage [{smi}]: {timer.counts['storage']} calls at "
          f"{per_call:.2f} ms each; pages_out {storage.pages_out} rows in "
          f"{storage.evict_events} events "
          f"({storage.bytes_out / max(storage.evict_events, 1) / 1e6:.3f} MB"
          f" per page-out), pages_in {storage.pages_in} rows in "
          f"{storage.pagein_events} events; {storage.n_host} rows on the "
          f"host at the end of the run", flush=True)
    check(storage.pages_out > 0, "storage paged nothing out")
    # The estimated trajectory runs away after VI init (above) and never
    # comes back to the keyframes it paged out, so the run itself pages
    # nothing in. The camera is brought back: one more storage call with
    # the estimate's first keyframe as the current camera, on the run's
    # tracker and map, pages the nearby keyframes in through the same
    # StorageManager.run.
    first = torch.as_tensor(np.asarray(c2ws[0]), dtype=torch.float32)
    revisit = {"poses": first[None], "global_kf_id_host": np.asarray(
        [len(storage.place)])}
    pages_in0, bytes_in0 = storage.pages_in, storage.bytes_in
    mapper._binned = "stale"
    t0 = time.perf_counter()
    storage.run(tracker, mapper, revisit)
    torch.cuda.synchronize()
    revisit_ms = (time.perf_counter() - t0) * 1e3
    print(f"phase 8 storage revisit [{smi}]: camera back at the first "
          f"keyframe: {revisit_ms:.2f} ms, pages_in "
          f"{storage.pages_in - pages_in0} rows "
          f"({(storage.bytes_in - bytes_in0) / 1e6:.3f} MB) in "
          f"{storage.pagein_events} page-in events in all; round trips "
          f"checked {storage.round_trips} keyframes, {storage.rows_checked} "
          f"rows, bit-exact in every field: {not storage.mismatches}; "
          f"binning cache dropped: {mapper._binned is None}", flush=True)
    check(storage.pages_in > pages_in0, "the revisit paged nothing in")
    check(storage.round_trips > 0 and not storage.mismatches,
          f"paged-in rows differ from the evicted ones: keyframes "
          f"{storage.mismatches}")
    check(mapper._binned is None, "the page-in left the binning cache")

    card_follows_cpu_vio(args.seed)

    # ---- one more tracked frame: its synchronizing calls, and a profile
    dataset = dataset_cls(cfg)
    state = {}

    def track_one(idx):
        tracker.track(dataset[idx])
        state["viz"] = middleware.judge_and_package(tracker, cfg)

    idx = args.vio_frames
    pulls0 = inertial.stats["pulls"]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            track_one(idx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{pathlib.Path(w.filename).name}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    syncs = sum(sites.values())
    print(f"phase 8 syncs: frame {idx} (an update ran: "
          f"{fe_.count > log['updates']}) made {syncs} synchronizing calls, "
          f"{inertial.stats['pulls'] - pulls0} of them the inertial layer's "
          f"S/v copies; by call site: "
          + ", ".join(f"{k} {n}" for k, n in sorted(
              sites.items(), key=lambda kv: -kv[1])), flush=True)
    for idx in range(args.vio_frames + 1, n_all):
        before = fe_.count
        wall_ms, rows = profiled(lambda: track_one(idx))
        if fe_.count > before and fe_.new_frame_added:
            print_profile(f"phase 8 [{smi}]", f"tracked frame {idx} "
                          f"(motion filter, {fe_.iters1}+{fe_.iters2} fused "
                          f"updates, packaging)", wall_ms, rows)
            break
    else:
        fail("no frame after the run was tracked into a keyframe")
    return launches


# ---------------------------------------------------------------------------
# vis outputs (phases 8 and 9)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_vis(run_mod):
    """runners.run._save_vis with a recorder round it: for every call the
    keyframe count, the storage manager's host rows, each image's shape
    and non-black share, and the cameras it rendered (the newest
    keyframe's pose and intrinsic; at a map, the trajectory the map's
    camera frames) with the first HOST_CHUNK rows of the host pages that
    `vis_map` composited. No file is written on a machine without cv2."""
    from vings_mono_tpu_torch.utils.trajectory import tracker_c2ws
    from vings_mono_tpu_torch.utils.vis import HOST_CHUNK, host_array
    calls = []
    orig = run_mod._save_vis

    def rec(cfg, save_dir, tracker, mapper, storage, viz_out, kf_count):
        out = orig(cfg, save_dir, tracker, mapper, storage, viz_out,
                   kf_count)
        n_host = 0 if storage is None else storage.n_host
        call = {"kf": kf_count, "host_rows": n_host,
                "pose": host_array(viz_out["poses"][-1]).astype(np.float64),
                "intrinsic": dict(viz_out["intrinsic"]),
                "images": {k: (v.shape, v.dtype,
                               float((v.sum(-1) > 0).mean()))
                           for k, v in out.items()}}
        if "map" in out:
            call["c2ws"] = np.asarray(tracker_c2ws(tracker)[1])
            if n_host:
                call["host_chunk"] = {
                    k: storage.host[k][:HOST_CHUNK].copy()
                    for k in ("xyz", "log_scale", "quat", "logit_opacity",
                              "rgb")}
        calls.append(call)
        return out
    with replaced(run_mod, "_save_vis", rec):
        yield calls


def check_vis_kernels(tag, calls, mapper, vcfg, seed, host=False):
    """Both kernels against their plain twins on the inputs the vis
    stage gives them: the newest keyframe's camera (the rgbdnua panel's
    render, the training shape), the map's bird's-eye camera over the
    trained state and the follow-cam BEV at the last map; with `host`,
    instead the map's camera over the first HOST_CHUNK rows of the host
    pages at the last map that composited any, as `vis_map` renders them
    through the raw `render`. Returns the largest forward and bf16
    backward errors, absolute and relative to what they are held to."""
    import types
    import torch
    from vings_mono_tpu_torch.utils.vis import follow_camera, map_camera
    vcfg = vcfg or {}
    map_size = tuple(vcfg.get("map_size", (480, 640)))
    bev_size = tuple(vcfg.get("bev_size", (320, 320)))
    maps = [c for c in calls if "c2ws" in c]
    check(bool(maps), f"{tag}: no map was drawn")
    kw = dict(mapper.bin_kwargs)
    blocks = []
    if host:
        with_host = [c for c in maps if "host_chunk" in c]
        check(bool(with_host), f"{tag}: no map composited host pages")
        c = with_host[-1]
        rows = {k: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
                for k, a in c["host_chunk"].items()}
        blocks.append((f"host pages {len(rows['xyz'])} of {c['host_rows']} "
                       f"rows, map camera at keyframe {c['kf']}",
                       types.SimpleNamespace(alive=None, **rows),
                       map_camera(c["c2ws"], map_size)))
    else:
        last = calls[-1]
        blocks.append((f"newest keyframe's camera at keyframe {last['kf']}",
                       mapper.state, (np.linalg.inv(last["pose"]),
                                      last["intrinsic"])))
        blocks.append((f"map camera at keyframe {maps[-1]['kf']}",
                       mapper.state, map_camera(maps[-1]["c2ws"], map_size)))
        blocks.append((f"follow-cam at keyframe {maps[-1]['kf']}",
                       mapper.state, follow_camera(maps[-1]["pose"],
                                                   bev_size)))
    fwd, bwd, fwd_rel, bwd_rel = 0.0, 0.0, 0.0, 0.0
    for i, (what, st, (w2c, intr)) in enumerate(blocks):
        w2c = torch.as_tensor(w2c, dtype=torch.float32, device=DEVICE)
        pd, binned, meta = pair_inputs(st, w2c, kw, DEVICE, intrinsic=intr)
        n_pairs = int(binned.n_pairs)
        label = f"{tag} {int(intr['H'])}x{int(intr['W'])} {what}"
        print(f"{tag} kernels on the vis inputs: {label}: {n_pairs} pairs, "
              f"p_cap {pd.shape[1]}", flush=True)
        check(n_pairs > 0, f"{label}: no pair to rasterize")
        f, b, _, _, _, rel = check_kernels(label, pd, binned.tile_chunks,
                                           meta, int(kw["chunk"]), seed + i,
                                           n_pairs)
        fwd, bwd = max(fwd, f), max(bwd, b["bf16"])
        fwd_rel, bwd_rel = max(fwd_rel, rel["fwd"]), max(bwd_rel,
                                                         rel["bf16"])
    return fwd, bwd, fwd_rel, bwd_rel


def check_vis(tag, calls, h, w, min_calls, vcfg=None):
    """The rgbdnua panel at every call, the map and BEV at every tenth
    keyframe (sizes from the config's `vis` block, as `_save_vis` takes
    them), uint8 of the right shapes and not black."""
    from vings_mono_tpu_torch.utils import vis
    vcfg = vcfg or {}
    check(len(calls) >= min_calls, f"{tag}: vis ran {len(calls)} times")
    want = {"rgbdnua": (2 * h, 4 * w, 3),
            "map": tuple(vcfg.get("map_size", (480, 640))) + (3,),
            "bev": tuple(vcfg.get("bev_size", (320, 320))) + (3,)}
    for c in calls:
        names = ["rgbdnua"] + (["map", "bev"] if (c["kf"] - 1) % 10 == 0
                               else [])
        check(sorted(c["images"]) == sorted(names),
              f"{tag}: keyframe {c['kf']} drew {sorted(c['images'])}")
        # the panel holds the ground truth; the map must show something,
        # and so must the first follow-cam BEV (over the seeded map);
        # later ones may look past the map
        for k, (shape, dtype, lit) in c["images"].items():
            floor = {"rgbdnua": 0.02, "map": 0.0,
                     "bev": 0.0 if c["kf"] == 1 else -1.0}[k]
            check(shape == want[k] and dtype == np.uint8 and lit > floor,
                  f"{tag}: {k} of keyframe {c['kf']}: {shape} {dtype}, "
                  f"non-black share {lit:.3f}")
    maps = [c for c in calls if "map" in c["images"]]
    share = lambda k, cs: ", ".join(  # noqa: E731
        f"{c['images'][k][2]:.3f}" for c in cs)
    print(f"{tag} vis: {len(calls)} rgbdnua panels {want['rgbdnua']} "
          f"(non-black share {min(c['images']['rgbdnua'][2] for c in calls):.3f}"
          f" at the lowest); maps {want['map']} at keyframes "
          f"{[c['kf'] for c in maps]} (non-black {share('map', maps)}; host "
          f"rows composited {[c['host_rows'] for c in maps]}); BEVs "
          f"{want['bev']} (non-black {share('bev', maps)}); files written: "
          f"{vis.cv2 is not None} (cv2 imports: {vis.cv2 is not None})",
          flush=True)


# ---------------------------------------------------------------------------
# phase 9: configs/synthetic/smoke_vio.yaml as committed
# ---------------------------------------------------------------------------

SMOKE_VIO = ROOT / "configs/synthetic/smoke_vio.yaml"
SNAP_FIELDS = ("poses", "disps", "images", "disps_up")


def video_snapshot(video):
    """The video's keyframe buffers on the host: what GlobalBA reads."""
    return {"count_save": video.count_save, "counter": video.counter,
            "save": {k: getattr(video, k + "_save")[:video.count_save].copy()
                     for k in SNAP_FIELDS},
            "live": {k: getattr(video.bufs, k).cpu().clone()
                     for k in SNAP_FIELDS + ("intrinsics",)}}


def global_ba_on_cpu(snap, cfg, model, h, w):
    """GlobalBA on the CPU from a snapshot, with a CPU copy of the f32
    network. Returns the poses after it, save buffers first."""
    import copy
    import types
    import torch
    from vings_mono_tpu_torch.tracker.backend import GlobalBA
    from vings_mono_tpu_torch.tracker.video import DepthVideo
    cfg = dict(cfg, device={"tracker": "cpu", "mapper": "cpu"})
    video = DepthVideo(cfg, h, w, device="cpu")
    ns = video.count_save = snap["count_save"]
    video.counter = snap["counter"]
    for k, a in snap["save"].items():
        getattr(video, k + "_save")[:ns] = a
    for k, t in snap["live"].items():
        getattr(video.bufs, k).copy_(t)
    tracker = types.SimpleNamespace(
        video=video, cfg=cfg,
        model=copy.deepcopy(model).cpu().float().eval())
    stats = GlobalBA(tracker, cfg).run()
    return stats, np.concatenate([video.poses_save[:ns],
                                  video.bufs.poses[:video.counter].numpy()])


def smoke_vio_phase(args, tk):
    """Phase 9. Returns the kernels' launch counts during the run and
    their largest errors against the plain twins on its inputs."""
    import torch
    import vings_mono_tpu_torch.tracker.backend as backend
    from vings_mono_tpu_torch.runners import run as run_vo
    from vings_mono_tpu_torch.utils.config import load_config
    from vings_mono_tpu_torch.utils.profiling import StageTimer
    save_dir = OUT / "smoke_vio"
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = load_config(str(SMOKE_VIO), overrides={
        "output": {"save_dir": str(save_dir)},
        "device": {"tracker": DEVICE, "mapper": DEVICE}})
    h, w = (int(x) for x in cfg["frontend"]["image_size"])
    check(cfg["mode"] == "vio" and cfg["use_storage_manager"]
          and cfg["use_vis"] and cfg["use_global_ba"]
          and cfg["dataset"]["n_frames"] == 30 and (h, w) == (240, 432),
          "phase 9 is not smoke_vio.yaml as committed")
    print(f"phase 9 config: {SMOKE_VIO.relative_to(ROOT)} as committed "
          f"(mode {cfg['mode']}, storage every "
          f"{cfg['storage_manager']['every']}, use_vis, use_global_ba with "
          f"backend {cfg['backend']}, {cfg['dataset']['n_frames']} frames "
          f"at {h}x{w}, random DroidNet weights from the seed); only the "
          f"device and the save dir are set", flush=True)
    got = {}

    class Recorded(backend.GlobalBA):
        def run(self):
            got["snap"] = video_snapshot(self.tracker.video)
            self.timer = StageTimer(sync_device=DEVICE)
            got["gba"] = self
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = super().run()
            torch.cuda.synchronize()
            got["ms"] = (time.perf_counter() - t0) * 1e3
            got["stats"] = stats
            return stats

    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    t0 = time.perf_counter()
    with replaced(backend, "GlobalBA", Recorded), \
            recording_vis(run_vo) as vis_calls:
        tracker, mapper, timer = run_vo.run(cfg, str(save_dir),
                                            sync_timer=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"rasterize_forward": tk.rasterize_forward.launches,
                "rasterize_backward": tk.rasterize_backward.launches}
    smi = nvidia_smi()
    print(timer.report().replace("\n", "\nphase 9 ").replace(
        "stage times", "phase 9 stage times"), flush=True)
    v = tracker.video
    stats, gba = got["stats"], got["gba"]
    parts = {k: 1e3 * gba.timer.totals[k] for k in gba.timer.totals}
    print(f"phase 9 run [{smi}]: {cfg['dataset']['n_frames']} frames in "
          f"{run_s:.1f} s, {v.counter + v.count_save} keyframes, the mapper "
          f"trained on {mapper.time_idx}, {mapper.n_alive} Gaussians; "
          f"global BA: {stats} in {got['ms']:.1f} ms ("
          + ", ".join(f"{k} {ms:.1f}" for k, ms in parts.items())
          + f" ms), CG iterations per Gauss-Newton step "
          f"{gba.cg_iters_used}; launches {launches}", flush=True)
    check(not stats["skipped"] and stats["edges"] >= stats["frames"] - 1,
          f"global BA skipped or too few edges: {stats}")
    check(mapper.time_idx >= 10, f"the mapper trained on "
          f"{mapper.time_idx} keyframes only")
    for name, cnt in launches.items():
        check(cnt >= mapper.time_idx * int(cfg["training_args"]["iters"]),
              f"{name} launched {cnt} times in phase 9")
    n = v.counter
    check(bool(torch.isfinite(v.bufs.poses[:n]).all()
               and torch.isfinite(v.bufs.disps_up[:n]).all())
          and np.isfinite(v.poses_save[:v.count_save]).all(),
          "phase 9 poses or disparities are not finite")
    check_vis("phase 9", vis_calls, h, w, mapper.time_idx, cfg.get("vis"))
    # the kernels on the main path's own inputs (its storage pages nothing
    # out over 30 frames: phase 8 holds them on host pages)
    print(f"phase 9 host rows at the maps: "
          f"{[c['host_rows'] for c in vis_calls if 'c2ws' in c]}",
          flush=True)
    errs = check_vis_kernels("phase 9", vis_calls, mapper, cfg.get("vis"),
                             args.seed + 20)
    check(len(list((save_dir / "droid_c2w").glob("*.txt")))
          == n + v.count_save
          and (save_dir / "ply" / "final_2dgs.ply").stat().st_size > 0,
          "phase 9 trajectory or .ply missing")

    # card vs CPU: the same pass from the same snapshot
    card = np.concatenate([v.poses_save[:v.count_save],
                           v.bufs.poses[:n].cpu().numpy()])
    t0 = time.perf_counter()
    cpu_stats, cpu = global_ba_on_cpu(got["snap"], cfg, tracker.model, h, w)
    cpu_s = time.perf_counter() - t0
    d = float(np.abs(card - cpu).max())
    print(f"phase 9 global BA card vs CPU from the same snapshot of the "
          f"video's buffers: {cpu_stats} on the CPU in {cpu_s:.1f} s; max "
          f"abs difference of the poses {d:.2e} (tol 1e-3)", flush=True)
    check(cpu_stats == stats and d <= 1e-3,
          "global BA on the card left the CPU run")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 10: GlobalBA at full width, the banded solve at trajectory scale
# ---------------------------------------------------------------------------

BA_T = 1024        # keyframes of the banded solve against the dense one
BA_T_FULL = 8000   # and alone: the KITTI-360 configurations' save_buffer
BA_EDGE_BAND = 2   # |i - j| of its edges
BA_CG_FULL = 4096  # CG cap and stop rule of the converged comparison
BA_CG_TOL = 1e-12


def count_syncs(fn):
    """Run fn with every synchronizing CUDA call reported; returns (fn's
    result, {call site: count})."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{pathlib.Path(w.filename).name}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return out, sites


def banded_problem(T, h, w, intr8, seed, d_cap=8):
    """tests/test_backend.py's `_banded_problem` on the card: a random-walk
    trajectory, bounded i.i.d. drift on every pose but the first,
    ground-truth reprojection targets (oracle) over the edges |i-j| <= 2,
    the capped adjacency list."""
    import torch
    from vings_mono_tpu_torch.ops import lie
    from vings_mono_tpu_torch.ops import projective as pops
    rng = np.random.default_rng(seed)
    xi = np.zeros((T, 6), np.float32)
    for k in range(1, T):
        xi[k, :3] = xi[k - 1, :3] + rng.normal(size=3) * 0.05
        xi[k, 3:] = xi[k - 1, 3:] + rng.normal(size=3) * 0.01
    dev = torch.device(DEVICE)
    gt = lie.se3_exp(torch.as_tensor(xi, device=dev))
    disps = torch.as_tensor(rng.uniform(0.25, 0.5, size=(T, h, w)),
                            dtype=torch.float32, device=dev)
    intr = torch.as_tensor(intr8, device=dev)[None].expand(T, 4)
    amp = np.asarray([0.03, 0.03, 0.03, 0.008, 0.008, 0.008])
    pert = (amp * rng.normal(size=(T, 6))).astype(np.float32)
    pert[0] = 0.0
    drift = lie.se3_retr(gt, torch.as_tensor(pert, device=dev))
    edges = [(i, j) for i in range(T)
             for j in range(max(0, i - BA_EDGE_BAND),
                            min(T, i + BA_EDGE_BAND + 1)) if i != j]
    ii = torch.as_tensor([e[0] for e in edges], device=dev)
    jj = torch.as_tensor([e[1] for e in edges], device=dev)
    gi = np.zeros((T, d_cap), np.int64)
    gv = np.zeros((T, d_cap), bool)
    fill = np.zeros(T, np.int64)
    for e, (m, _) in enumerate(edges):
        gi[m, fill[m]], gv[m, fill[m]] = e, True
        fill[m] += 1
    with torch.no_grad():
        coords, _ = pops.projective_transform(gt, disps, intr, ii, jj)
    E = len(edges)
    return dict(
        gt=gt, drift=drift, args=(
            coords.movedim(-1, 1).contiguous(),
            torch.ones((E, 2, h, w), device=dev),
            torch.full((T, h, w), 1e-4, device=dev), drift, disps, intr,
            ii, jj, torch.ones(E, dtype=torch.bool, device=dev),
            torch.as_tensor(gi, device=dev), torch.as_tensor(gv, device=dev),
            torch.arange(T, device=dev) >= 1))


def position_rmse(poses, gt):
    """RMS distance of the camera centers (w2c 7-vectors), no alignment."""
    from vings_mono_tpu_torch.ops import lie
    a = lie.se3_inv(poses)[:, :3]
    b = lie.se3_inv(gt)[:, :3]
    return float(((a - b) ** 2).sum(-1).mean().sqrt())


def global_ba_phase(tracker, cfg):
    """Phase 10: GlobalBA with the backend defaults at the end of phase 7's
    VO loop (240x800, KITTI-0028 frontend), then `ba_global_banded` at
    T = 1024 against the dense `ba_global`."""
    import torch
    from vings_mono_tpu_torch.datasets.base import get_dataset
    from vings_mono_tpu_torch.ops import ba as ba_ops
    from vings_mono_tpu_torch.tracker.backend import GlobalBA
    from vings_mono_tpu_torch.utils.device import true_f32
    from vings_mono_tpu_torch.utils.profiling import StageTimer
    from vings_mono_tpu_torch.utils.trajectory import ate_rmse, tracker_c2ws
    gt = get_dataset(cfg).load_gt_dict()

    def ate():
        ts, c2ws = tracker_c2ws(tracker)
        return ate_rmse(ts, c2ws, gt["timestamps"], gt["c2ws"])

    gba = GlobalBA(tracker, cfg)
    gba.timer = StageTimer(sync_device=DEVICE)
    be = {k: getattr(gba, k) for k in ("steps", "gn_iters", "band", "chunk",
                                       "d_cap", "cg_iters")}
    v = tracker.video
    T = v.counter + v.count_save
    ate0 = ate()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stats, sites = count_syncs(gba.run)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    ate1 = ate()
    parts = {k: 1e3 * gba.timer.totals[k] for k in gba.timer.totals}
    syncs = sum(sites.values())
    print(f"phase 10 global BA [{nvidia_smi()}] at the end of phase 7 "
          f"({T} keyframes of {tuple(v.bufs.disps.shape[1:])} at 1/8 of "
          f"{H}x{W}, backend {be}): {stats} in {ms:.1f} ms: "
          + ", ".join(f"{k} {t:.1f} ms" for k, t in parts.items())
          + f"; peak device memory above the run's {peak:.2f} GB; "
          f"{syncs} synchronizing calls ("
          + ", ".join(f"{k} {n}" for k, n in sorted(
              sites.items(), key=lambda kv: -kv[1]))
          + f"); CG iterations per Gauss-Newton step {gba.cg_iters_used}; "
          f"scale-aligned ATE {ate0:.4f} before, {ate1:.4f} after (room "
          f"units)", flush=True)
    check(not stats["skipped"] and stats["edges"] >= T - 1,
          f"phase 10 global BA skipped or too few edges: {stats}")
    # the device ops it launches: the pass once more (from the trajectory
    # the first one left) under the profiler
    wall_ms, rows = profiled(lambda: GlobalBA(tracker, cfg).run())
    print_profile("phase 10", "the global BA pass once more", wall_ms, rows)
    n = v.counter
    check(bool(torch.isfinite(v.bufs.poses[:n]).all()
               and torch.isfinite(v.bufs.disps_up[:n]).all())
          and np.isfinite(v.poses_save[:v.count_save]).all()
          and ate1 is not None and np.isfinite(ate1),
          "phase 10: the poses after global BA are not finite")

    # the banded solve at trajectory scale against the dense one
    h, w = v.bufs.disps.shape[1:]
    intr8 = np.asarray([INTRINSIC["fv"] / 8, INTRINSIC["fu"] / 8, w / 2,
                        h / 2], np.float32)
    prob = banded_problem(BA_T, h, w, intr8, seed=8)
    iters = 4
    band = 2 * BA_EDGE_BAND
    res = {}
    # GlobalBA's PCG (128 iterations, stop at rz <= 1e-8 rz0) leaves ~1e-3
    # of pose error on this chain-like system, whose low-frequency modes
    # converge slowly; the comparison with the dense solve takes the PCG
    # to rz <= 1e-12 rz0 (its stop rule swapped in here: the product has
    # the JAX package's fixed rule)
    pcg = ba_ops.banded_pcg

    def converged(st):
        def to_tol(*a, **k):
            return pcg(*a, **dict(k, tol=BA_CG_TOL))
        with replaced(ba_ops, "banded_pcg", to_tol):
            return ba_ops.ba_global_banded(*prob["args"], iters=iters,
                                           band=band, cg_iters=BA_CG_FULL,
                                           stats=st)

    with torch.no_grad(), true_f32():
        for name, fn in (
                ("banded", lambda st: ba_ops.ba_global_banded(
                    *prob["args"], iters=iters, band=band, stats=st)),
                ("banded to convergence", lambda st: converged(st)),
                ("dense", lambda st: ba_ops.ba_global(*prob["args"],
                                                      iters=iters))):
            fn({})                                  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            st = {}
            t0 = time.perf_counter()
            out = fn(st)
            torch.cuda.synchronize()
            res[name] = (out, (time.perf_counter() - t0) * 1e3 / iters,
                         torch.cuda.max_memory_allocated() / 1e9,
                         [int(x) for x in st.get("cg_iters_used", [])])
    e0 = position_rmse(prob["drift"], prob["gt"])
    (pd, dd), d_ms, d_gb, _ = res["dense"]
    print(f"phase 10 banded solve [{nvidia_smi()}]: T = {BA_T} keyframes "
          f"of {h}x{w} (the dense system would take 9.2 GB at the "
          f"KITTI-360 save_buffer's 8000; the banded solve runs there "
          f"alone below), {prob['args'][6].shape[0]} edges |i-j| <= "
          f"{BA_EDGE_BAND}, oracle targets, band {band}, {iters} "
          f"Gauss-Newton steps; position rmse drifted {e0:.4f}; dense "
          f"{d_ms:.1f} ms per step, peak {d_gb:.2f} GB, position rmse "
          f"{position_rmse(pd, prob['gt']):.4f}", flush=True)
    for name in ("banded", "banded to convergence"):
        (pb, db), b_ms, b_gb, cg = res[name]
        dpose = float((pb - pd).abs().max())
        ddisp = float((db - dd).abs().max())
        eb = position_rmse(pb, prob["gt"])
        cap, tol = (128, 1e-8) if name == "banded" else (BA_CG_FULL,
                                                          BA_CG_TOL)
        print(f"phase 10 {name}: {b_ms:.1f} ms per Gauss-Newton step, CG "
              f"iterations {cg} (cap {cap}, stop at rz <= {tol} rz0), peak "
              f"{b_gb:.2f} GB; against "
              f"the dense solve max abs difference poses {dpose:.2e}, "
              f"disparities {ddisp:.2e} (tol 5e-4, 5e-3 when converged); "
              f"position rmse {eb:.4f}", flush=True)
        check(eb < 0.7 * e0, f"phase 10: {name} did not reduce drift")
    check(dpose <= 5e-4 and ddisp <= 5e-3,
          "phase 10: the converged banded solve left the dense one")
    return be


def banded_at_scale(be, h, w):
    """Phase 10's banded solve at the KITTI-360 configurations' scale
    (save_buffer 8000 keyframes), as GlobalBA calls it: its band, CG cap
    and stop rule, one pass of its Gauss-Newton steps, on a card that
    holds nothing else of the run. Prints ms per step, CG iterations and
    the peak memory."""
    import gc
    import torch
    from vings_mono_tpu_torch.ops import ba as ba_ops
    from vings_mono_tpu_torch.utils.device import true_f32
    gc.collect()
    torch.cuda.empty_cache()
    intr8 = np.asarray([INTRINSIC["fv"] / 8, INTRINSIC["fu"] / 8, w / 2,
                        h / 2], np.float32)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    prob = banded_problem(BA_T_FULL, h, w, intr8, seed=8)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    prob_gb = (torch.cuda.memory_allocated() - base) / 1e9
    iters = be["gn_iters"]
    band = 2 * be["band"]       # GlobalBA's: twice its proposal band
    st = {}
    with torch.no_grad(), true_f32():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pb, _ = ba_ops.ba_global_banded(
            *prob["args"], iters=iters, band=band,
            cg_iters=be["cg_iters"], stats=st)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    e0 = position_rmse(prob["drift"], prob["gt"])
    e1 = position_rmse(pb, prob["gt"])
    print(f"phase 10 banded solve at scale [{nvidia_smi()}]: T = "
          f"{BA_T_FULL} keyframes of {h}x{w} (the KITTI-360 save_buffer), "
          f"{prob['args'][6].shape[0]} edges |i-j| <= {BA_EDGE_BAND}, "
          f"oracle targets, GlobalBA's solver band {band}, CG cap "
          f"{be['cg_iters']} and stop rule, {iters} Gauss-Newton steps (one "
          f"of its {be['steps']} rounds): {ms:.1f} ms per step, CG "
          f"iterations {[int(x) for x in st['cg_iters_used']]}; the problem "
          f"{prob_gb:.2f} GB (made in {make_s:.1f} s), peak {peak:.2f} GB "
          f"with it of the card's {total:.1f} GB; position rmse drifted "
          f"{e0:.4f} -> {e1:.4f}", flush=True)
    check(np.isfinite(e1) and e1 < e0,
          "phase 10: the banded solve at scale did not reduce drift")


# ---------------------------------------------------------------------------
# phase 11: the mapper's options at full width
# ---------------------------------------------------------------------------

REFINE_KF = 2      # the keyframe whose pose phase 11 perturbs
# phase 11's sky and coarse runs and 16b replay the first 2 of phase 4's 5
# windows (cut to keep the script inside its time)
REPLAY_WINDOWS = 2
REFINE_PERT = (0.03, -0.02, 0.025, 0.004, -0.003, 0.002)   # SE3 tangent


def perturbed_windows(src, dst, gid, xi):
    """Phase 4's windows with keyframe `gid`'s c2w right-multiplied by
    exp(xi) in every window that holds it."""
    import torch
    from vings_mono_tpu_torch.datasets.replay import (ReplayDataset,
                                                      save_viz_out)
    from vings_mono_tpu_torch.ops import lie
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    pert = lie.se3_matrix(lie.se3_exp(torch.tensor(xi))).numpy()
    src_data = ReplayDataset({"dataset": {"root": str(src)}})
    for i, f in enumerate(src_data.files):
        viz = src_data[i]
        k = np.where(viz["global_kf_id"] == gid)[0]
        if len(k):
            viz["poses"] = viz["poses"].copy()
            viz["poses"][k[0]] = viz["poses"][k[0]] @ pert
        save_viz_out(str(dst / pathlib.Path(f).name), viz)
    return pert


def pose_error(c2w, ref):
    """(translation m, rotation degrees) between two c2w."""
    d = np.linalg.inv(ref) @ c2w
    ang = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1,
                                       1)))
    return float(np.linalg.norm(d[:3, 3])), float(ang)


def refine_grad_check(mapper, window):
    """The gradient of refine's photometric loss with respect to xi of the
    perturbed keyframe, through both kernels and through their plain
    twins, on the trained map: within phase 3's bf16 tolerance of the
    largest entry."""
    import torch
    from vings_mono_tpu_torch.mapper import train
    from vings_mono_tpu_torch.mapper.cameras import make_camera
    from vings_mono_tpu_torch.mapper.losses import masked_l1
    from vings_mono_tpu_torch.mapper.mapper import _intr4
    from vings_mono_tpu_torch.ops import lie
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tkm
    rmod = importlib.import_module("vings_mono_tpu_torch.ops.rasterizer."
                                   "render")
    batch = mapper._pack_batch(window)
    intr4 = _intr4(window["intrinsic"])
    binned = train.bin_stack(mapper.state, batch, intr4, H, W,
                             **mapper.bin_kwargs)
    kf = int(np.where(mapper._gids_host == REFINE_KF)[0][0])
    s = mapper.state

    def grad():
        xi = torch.zeros(6, device=s.xyz.device, requires_grad=True)
        c2w = torch.linalg.inv(batch.w2cs[kf]) @ lie.se3_matrix(
            lie.se3_exp(xi))
        cam = make_camera(torch.linalg.inv(c2w), intr4, H, W)
        rets = rmod.render(s.xyz, s.log_scale, s.quat, s.logit_opacity,
                           s.rgb, cam, alive=s.alive,
                           binned=train._select_kf(binned, kf),
                           **mapper.bin_kwargs)
        gt = batch.images[kf]
        valid = (gt.sum(0) > 0) & (batch.depths[kf][0] > 0)
        return torch.autograd.grad(masked_l1(rets["rgb"], gt, valid), xi)[0]

    def plain_fwd(pd, tc, meta, chunk, **_):
        return tkm.forward_plain(pd, tc, meta, chunk)[0]

    def plain_bwd(pd, tc, meta, chunk, out, g, out_dtype=None, **_):
        return tkm.backward_plain(pd, tc, meta, chunk, out, g).to(out_dtype)

    g_kernel = grad()
    with replaced(rmod, "rasterize_forward", plain_fwd), \
            replaced(rmod, "rasterize_backward", plain_bwd):
        g_plain = grad()
    err = float((g_kernel - g_plain).abs().max())
    scale = float(g_plain.abs().max())
    print(f"phase 11 refine gradient wrt xi of keyframe {REFINE_KF} through "
          f"the kernels vs their plain twins: {g_kernel.tolist()} vs "
          f"{g_plain.tolist()}, max abs err {err:.3e} = {err / scale:.3e} "
          f"of the largest (tol {BWD_TOL['bf16']})", flush=True)
    check(np.isfinite(scale) and scale > 0
          and err <= BWD_TOL["bf16"] * scale,
          "phase 11: refine's gradient through the kernels left the plain "
          "twins'")


def mapper_options_phase(args, tk, cfg, phase4_ms, win_dir, seed):
    """Phase 11: phase 4's replay once with each of use_sky, use_refine and
    coarse_frac 0.5. Returns the kernels' launch counts per run."""
    import torch
    from vings_mono_tpu_torch.datasets.replay import ReplayDataset
    from vings_mono_tpu_torch.mapper.sky import sky_render_params
    from vings_mono_tpu_torch.mapper.train import half_intr4
    from vings_mono_tpu_torch.runners import run_mapping
    from vings_mono_tpu_torch.utils.config import _deep_merge
    refine_dir = OUT / "windows_refine"
    pert = perturbed_windows(win_dir, refine_dir, REFINE_KF, REFINE_PERT)
    runs = {
        "sky": {"use_sky": True},
        "refine": {"use_refine": True,
                   "dataset": {"root": str(refine_dir)}},
        "coarse": {"training_args": {"coarse_frac": 0.5}},
    }
    launches, mappers = {}, {}
    for name, over in runs.items():
        c = _deep_merge(cfg, dict(over, output={
            "save_dir": str(OUT / f"run_{name}")}))
        tk.rasterize_forward.launches = 0
        tk.rasterize_backward.launches = 0
        mapper, records = run_mapping.run(
            c, str(OUT / f"run_{name}"),
            max_windows=None if name == "refine" else REPLAY_WINDOWS)
        launches[name] = {"rasterize_forward": tk.rasterize_forward.launches,
                          "rasterize_backward":
                              tk.rasterize_backward.launches}
        mappers[name] = mapper
        kf_ms = [r["ms"] for r in records]
        print(f"phase 11 {name} [{nvidia_smi()}]: {len(records)} keyframes, "
              f"keyframe mean {np.mean(kf_ms):.1f} ms (phase 4: "
              f"{phase4_ms:.1f} ms), train psnr "
              f"{records[0]['psnr_start']:.3f} (first iteration) -> "
              f"{records[-1]['psnr']:.3f} (last), n_alive "
              f"{records[-1]['n_alive']}; launches {launches[name]}",
              flush=True)
        check(all(r["losses_finite"] for r in records),
              f"phase 11 {name}: a loss is not finite")
        for k, n in launches[name].items():
            check(n >= len(records) * args.iters,
                  f"phase 11 {name}: {k} launched {n} times")

    # the sky: the sphere holds rows, and the kernels on its pairs
    sky = mappers["sky"].sky.state
    n_sky = int(sky.n_alive())
    check(n_sky > 0, "phase 11 sky: the sphere is empty")
    last = ReplayDataset(cfg)[len(ReplayDataset(cfg)) - 1]
    w2c = torch.linalg.inv(torch.as_tensor(last["poses"][-1],
                                           device=DEVICE))
    xyz, log_scale = sky_render_params(sky)
    sky_r = dataclasses.replace(sky, xyz=xyz, log_scale=log_scale)
    kw = dict(mappers["sky"].bin_kwargs)
    pd, binned, meta = pair_inputs(sky_r, w2c, kw, DEVICE)
    print(f"phase 11 sky: {n_sky} rows on the sphere", flush=True)
    check_kernels("sky sphere", pd, binned.tile_chunks, meta,
                  int(kw["chunk"]), seed + 11, int(binned.n_pairs))

    # refine: the perturbed keyframe's pose against the truth
    m = mappers["refine"]
    truth = np.asarray(last["poses"][REFINE_KF], np.float64)
    k = int(np.where(m._gids_host == REFINE_KF)[0][0])
    refined = m.refined_poses[k].cpu().numpy().astype(np.float64)
    e0 = pose_error(truth @ pert.astype(np.float64), truth)
    e1 = pose_error(refined, truth)
    print(f"phase 11 refine: keyframe {REFINE_KF} perturbed by exp("
          f"{list(REFINE_PERT)}): error {e0[0]:.4f} m, {e0[1]:.3f} deg "
          f"before refinement, {e1[0]:.4f} m, {e1[1]:.3f} deg after the "
          f"last keyframe's 20 iterations", flush=True)
    check(np.isfinite(e1).all() and e1 != e0,
          "phase 11 refine: the pose did not move or is not finite")
    rw = ReplayDataset(_deep_merge(cfg, {"dataset": {
        "root": str(refine_dir)}}))
    refine_grad_check(m, rw[len(rw) - 1])

    # coarse: the kernels at 120x400
    half = dict(zip(("fv", "fu", "cv", "cu"),
                    half_intr4((INTRINSIC["fv"], INTRINSIC["fu"],
                                INTRINSIC["cv"], INTRINSIC["cu"]))))
    half.update(H=H // 2, W=W // 2)
    mc = mappers["coarse"]
    kw = dict(mc.bin_kwargs_c)
    pd, binned, meta = pair_inputs(mc.state, w2c, kw, DEVICE,
                                   intrinsic=half)
    print(f"phase 11 coarse: half-resolution bucket p_cap {kw['p_cap']}, "
          f"v_cap {kw['v_cap']}", flush=True)
    check_kernels("coarse 120x400", pd, binned.tile_chunks, meta,
                  int(kw["chunk"]), seed + 12, int(binned.n_pairs))
    return launches


# ---------------------------------------------------------------------------
# phase 12: configs/synthetic/smoke.yaml as committed (loop closure, dynamic
# masks and every other option)
# ---------------------------------------------------------------------------

SMOKE = ROOT / "configs/synthetic/smoke.yaml"
WEIGHTS_DIR = ROOT / "vings_mono_tpu/weights"
MAP_FIELDS = ("xyz", "log_scale", "quat", "logit_opacity", "rgb", "alive")


def culled(state, c2w, max_dist):
    """The rows `render_at(..., max_dist)` renders: alive and within
    max_dist of the camera center."""
    import types
    import torch
    c = torch.as_tensor(np.asarray(c2w)[:3, 3], dtype=torch.float32,
                        device=state.xyz.device)
    alive = state.alive & (((state.xyz - c) ** 2).sum(-1) < max_dist ** 2)
    return types.SimpleNamespace(
        **{f: getattr(state, f) for f in MAP_FIELDS if f != "alive"},
        alive=alive)


@contextlib.contextmanager
def first_train_window():
    """GaussianMapper.train_on_window with its first call's map (the rows
    a render reads, as they were before the training) and the window's
    first camera kept: the retrain's kernel inputs."""
    import types
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
    got = {}
    train = GaussianMapper.train_on_window

    def rec(self, viz_out, iters, weights=None):
        if not got:
            got.update(state=types.SimpleNamespace(
                **{f: getattr(self.state, f).clone() for f in MAP_FIELDS}),
                c2w=np.asarray(viz_out["poses"][0]),
                intr=dict(viz_out["intrinsic"]), n=len(viz_out["poses"]))
        return train(self, viz_out, iters, weights)
    with replaced(GaussianMapper, "train_on_window", rec):
        yield got


def kernels_on(tag, blocks, kw, seed):
    """check_kernels on (label, state, c2w, intrinsic) blocks; returns the
    largest forward and bf16 backward errors, absolute and relative to
    what they are held to."""
    import torch
    fwd = bwd = fwd_rel = bwd_rel = 0.0
    for i, (label, st, c2w, intr) in enumerate(blocks):
        w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                              device=DEVICE)
        pd, binned, meta = pair_inputs(st, w2c, kw, DEVICE, intrinsic=intr)
        n_pairs = int(binned.n_pairs)
        label = f"{tag} {int(intr['H'])}x{int(intr['W'])} {label}"
        print(f"{tag} kernels on the loop path's inputs: {label}: "
              f"{n_pairs} pairs, p_cap {pd.shape[1]}", flush=True)
        check(n_pairs > 0, f"{label}: no pair to rasterize")
        f, b, _, _, _, rel = check_kernels(label, pd, binned.tile_chunks,
                                           meta, int(kw["chunk"]), seed + i,
                                           n_pairs)
        fwd, bwd = max(fwd, f), max(bwd, b["bf16"])
        fwd_rel, bwd_rel = max(fwd_rel, rel["fwd"]), max(bwd_rel,
                                                         rel["bf16"])
    return fwd, bwd, fwd_rel, bwd_rel


def smoke_phase(args, tk):
    """Phase 12. Returns the kernels' launch counts during the run, their
    largest errors against the plain twins on its inputs, and the run's
    (tracker, mapper, cfg) for phase 13."""
    import torch
    from vings_mono_tpu_torch.loop import detect as detect_mod
    from vings_mono_tpu_torch.runners import run as run_mod
    from vings_mono_tpu_torch.utils.config import load_config
    save_dir = OUT / "smoke"
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = load_config(str(SMOKE), overrides={
        "output": {"save_dir": str(save_dir)},
        "device": {"tracker": DEVICE, "mapper": DEVICE}})
    h, w = (int(x) for x in cfg["frontend"]["image_size"])
    flags = ("use_loop", "use_dynamic", "use_sky", "use_refine",
             "use_storage_manager", "use_vis", "use_global_ba")
    check(cfg["mode"] == "vo" and all(cfg[f] for f in flags)
          and not cfg["use_metric"] and cfg["dataset"]["n_frames"] == 30
          and (h, w) == (240, 432), "phase 12 is not smoke.yaml as committed")
    print(f"phase 12 config: {SMOKE.relative_to(ROOT)} as committed (mode "
          f"{cfg['mode']}, {', '.join(flags)}, looper {cfg['looper']}, "
          f"{cfg['dataset']['n_frames']} frames at {h}x{w}, random DroidNet "
          f"and SuperPoint weights from the seed); only the device and the "
          f"save dir are set", flush=True)
    got = {"renders": [], "loop_calls": []}
    build, render = run_mod.build, detect_mod.map_render

    def rec_build(*a, **k):
        out = build(*a, **k)
        got["looper"], got["dynamic"] = out[4], out[5]
        run = got["looper"].run

        def rec_run(mapper, tracker, viz_out, frame_idx):
            got["loop_calls"].append(np.array(
                viz_out["poses"][-1].cpu().numpy(), np.float64))
            return run(mapper, tracker, viz_out, frame_idx)
        got["looper"].run = rec_run
        return out

    def rec_render(mapper, c2w, intr, max_dist):
        # the trace's stage says which render this is: "pnp" at the
        # current pose, "verify" at the recovered one
        stage = got["looper"].detector.traces[-1]["stage"]
        got["renders"].append((stage, np.array(c2w), dict(intr), max_dist))
        return render(mapper, c2w, intr, max_dist)

    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    t0 = time.perf_counter()
    with replaced(run_mod, "build", rec_build), \
            replaced(detect_mod, "map_render", rec_render), \
            first_train_window() as retrain:
        tracker, mapper, timer = run_mod.run(cfg, str(save_dir),
                                             sync_timer=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"rasterize_forward": tk.rasterize_forward.launches,
                "rasterize_backward": tk.rasterize_backward.launches}
    smi = nvidia_smi()
    print(timer.report().replace("\n", "\nphase 12 ").replace(
        "stage times", "phase 12 stage times"), flush=True)
    v = tracker.video
    looper, dyn = got["looper"], got["dynamic"]
    traces = looper.detector.traces
    accepted = [(t["cand_gid"], t["cur_gid"]) for t in looper.loop_traces
                if "rejected" not in t]
    gated = [t for t in looper.loop_traces if "rejected" in t]
    print(f"phase 12 run [{smi}]: {cfg['dataset']['n_frames']} frames in "
          f"{run_s:.1f} s, {v.counter + v.count_save} keyframes, the mapper "
          f"trained on {mapper.time_idx}, {mapper.n_alive} Gaussians, "
          f"{int(mapper.sky.state.n_alive())} sky rows; loop "
          f"detection ran {len(got['loop_calls'])} times, {len(traces)} "
          f"attempts reaching stages "
          f"{[t['stage'] for t in traces]} (matches "
          f"{[t['matches'] for t in traces]}, PnP inliers "
          f"{[t['pnp_inliers'] for t in traces]}, verify L1 "
          f"{[t['verify_err'] for t in traces]}); closures accepted "
          f"{accepted}, gated by the drift bound {len(gated)}; dynamic "
          f"pixels masked {dyn.n_masked}; launches {launches}", flush=True)
    for stage in ("loop", "dynamic", "global_ba", "vis", "storage", "map"):
        check(stage in timer.totals, f"phase 12: no {stage} stage")
    check(len(got["loop_calls"]) >= 1, "phase 12: loop detection never ran")
    check(mapper.time_idx >= 10, f"the mapper trained on "
          f"{mapper.time_idx} keyframes only")
    for name, cnt in launches.items():
        check(cnt >= mapper.time_idx * int(cfg["training_args"]["iters"]),
              f"{name} launched {cnt} times in phase 12")
    n = v.counter
    check(bool(torch.isfinite(v.bufs.poses[:n]).all()
               and torch.isfinite(v.bufs.disps_up[:n]).all())
          and np.isfinite(v.poses_save[:v.count_save]).all(),
          "phase 12 poses or disparities are not finite")
    check(len(list((save_dir / "droid_c2w").glob("*.txt")))
          == n + v.count_save
          and (save_dir / "ply" / "final_2dgs.ply").stat().st_size > 0,
          "phase 12 trajectory or .ply missing")

    # the kernels on the loop path's own inputs: the verify render at the
    # recovered pose, else the render at the current pose, else (no attempt
    # got past matching) the current pose as the detector would render it;
    # and the first retrain window as it was when the closure trained it
    # (retrain trains saved keyframes only: none while all are live)
    verify = [r for r in got["renders"] if r[0] == "verify"]
    cur = [r for r in got["renders"] if r[0] == "pnp"]
    if verify or cur:
        _, c2w, intr, max_dist = (verify or cur)[-1]
        what = "verify render at the recovered pose" if verify else \
            "render at the current pose"
    else:
        what, c2w = "current pose of the last loop call", \
            got["loop_calls"][-1]
        intr, max_dist = tracker._intr_cache, 60.0
    blocks = [(f"{what}, max_dist {max_dist}",
               culled(mapper.state, c2w, max_dist), c2w, intr)]
    if retrain:
        blocks.append((f"retrain window's first camera ({retrain['n']} "
                       f"keyframes)", retrain["state"], retrain["c2w"],
                       retrain["intr"]))
    else:
        print(f"phase 12 retrain trained no window: {v.count_save} "
              f"keyframes saved at the closures (phase 13 holds the "
              f"kernels on a retrain window)", flush=True)
    errs = kernels_on("phase 12", blocks, dict(mapper.bin_kwargs),
                      args.seed + 30)
    stats = run_quality("phase 12", cfg, save_dir, tracker, mapper, run_s)
    return launches, errs, (tracker, mapper, cfg), stats


def run_quality(tag, cfg, save_dir, tracker, mapper, run_s):
    """frames/s, ATE (eval_trajectory, scale-aligned, against the
    dataset's ground truth) and PSNR (eval_psnr) of a finished run."""
    from vings_mono_tpu_torch.datasets.base import get_dataset
    from vings_mono_tpu_torch.runners import evaluate
    n = int(cfg["dataset"]["n_frames"])
    stats = {"fps": n / run_s,
             "ate": evaluate.eval_trajectory(str(save_dir),
                                             get_dataset(cfg)),
             "psnr": evaluate.eval_psnr(mapper, tracker),
             "poses": poses_by_ts(tracker)}
    print(f"{tag} quality: {stats['fps']:.3f} frames/s, ATE {stats['ate']} "
          f"(eval_trajectory; None: the dataset has no ground truth), PSNR "
          f"{stats['psnr']} dB (eval_psnr)", flush=True)
    return stats


# ---------------------------------------------------------------------------
# phase 13: the learned nets and the rectification, card against CPU
# ---------------------------------------------------------------------------

def matched_set(kp_a, kp_b):
    return {tuple(np.round(np.r_[p, q], 3)) for p, q in zip(kp_a, kp_b)}


def detector_phase(seed, n_pairs=3, h=240, w=320):
    """Phase 13a: self-trained SuperPoint + LightGlue (2 layers) on the
    card and on the CPU, on views of the room at 240x320: extract, match,
    PnP. Returns ms per detect chain."""
    import torch
    from vings_mono_tpu_torch.loop.detect import LoopDetector
    from vings_mono_tpu_torch.models.superpoint import extract
    from vings_mono_tpu_torch.runners.eval_superpoint import \
        _pair as room_pair
    sp = str(WEIGHTS_DIR / "superpoint_selftrained.npz")
    lg = str(WEIGHTS_DIR / "lightglue_selftrained.npz")
    dets = {dev: LoopDetector({}, sp, lg_params_path=lg, device=dev)
            for dev in (DEVICE, "cpu")}
    check(dets[DEVICE].lg.layers == 2, "phase 13: LightGlue is not 2 layers")
    rng = np.random.default_rng(seed)
    chain_ms, ok = [], 0
    for k in range(n_pairs):
        rgb_a, dep_a, c2w_a, rgb_b, _, c2w_b, intr4 = room_pair(rng, h, w)
        # the net's maps at the detector's input (512 wide), card vs CPU
        gray = np.asarray(rgb_a) @ np.asarray([0.299, 0.587, 0.114])
        hh = int(round(h * 512.0 / w / 8)) * 8
        import cv2
        gray = cv2.resize(gray.astype(np.float32), (512, hh))
        maps = {}
        for dev, det in dets.items():
            with torch.no_grad():
                heat, desc = det.model(torch.as_tensor(
                    gray, device=dev)[None, :, :, None])
            maps[dev] = (heat.cpu().numpy(), desc.cpu().numpy())
        e_heat = float(np.abs(maps[DEVICE][0] - maps["cpu"][0]).max())
        e_desc = float(np.abs(maps[DEVICE][1] - maps["cpu"][1]).max())
        out = {}
        for dev, det in dets.items():
            if dev == DEVICE:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fa, fb = det.extract(rgb_a), det.extract(rgb_b)
            kp_a, kp_b = det.match(fa, fb, img_hw=(h, w))
            c2w = det.pnp_history_pose(kp_a, kp_b, dep_a, c2w_a, intr4)
            ms = (time.perf_counter() - t0) * 1e3
            out[dev] = (kp_a, kp_b, c2w, ms)
        chain_ms.append(out[DEVICE][3])
        sa, sb = (matched_set(*out[d][:2]) for d in (DEVICE, "cpu"))
        overlap = len(sa & sb) / max(len(sa), len(sb), 1)
        c2w = out[DEVICE][2]
        if c2w is not None:
            t_err = float(np.linalg.norm(c2w[:3, 3] - c2w_b[:3, 3]))
            r_err = float(np.degrees(np.arccos(np.clip((np.trace(
                c2w[:3, :3].T @ c2w_b[:3, :3]) - 1) / 2, -1, 1))))
            ok += t_err < 0.25
            pnp = f"{t_err:.4f} units, {r_err:.3f} deg"
        else:
            pnp = "no pose (too few inliers)"
        print(f"phase 13 SuperPoint + LightGlue pair {k} at {h}x{w}: heat "
              f"max abs err card vs CPU {e_heat:.3e}, descriptors "
              f"{e_desc:.3e} (tol 1e-4); matches card {len(sa)}, CPU "
              f"{len(sb)}, overlap {overlap:.4f}; PnP pose error against "
              f"the truth {pnp}; detect chain (extract x2, match, PnP) "
              f"card {out[DEVICE][3]:.1f} ms, CPU {out['cpu'][3]:.1f} ms",
              flush=True)
        check(e_heat <= 1e-4 and e_desc <= 1e-4,
              "phase 13: SuperPoint on the card left the CPU")
        check(overlap >= 0.95, f"phase 13: the card's matches overlap the "
              f"CPU's by {overlap:.4f}")
    # a second pass over the last pair, warm, for the time
    det = dets[DEVICE]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        kp_a, kp_b = det.match(det.extract(rgb_a), det.extract(rgb_b),
                               img_hw=(h, w))
        det.pnp_history_pose(kp_a, kp_b, dep_a, c2w_a, intr4)
    warm = (time.perf_counter() - t0) * 1e3 / 5
    print(f"phase 13 detect chain on the card: {warm:.1f} ms warm (first "
          f"calls {[round(x, 1) for x in chain_ms]} ms); PnP within 0.25 "
          f"units of the truth on {ok} of {n_pairs} pairs", flush=True)
    return warm


def fastsam_phase(seed, h=240, w=432):
    """Phase 13b: self-trained FastSAM at 240x432, card against CPU."""
    import torch
    from vings_mono_tpu_torch.datasets.synthetic3d import (render_room,
                                                           texture_params,
                                                           trajectory_c2w)
    from vings_mono_tpu_torch.models.fastsam import (load_fastsam, raw_maps,
                                                     segment_everything)
    path = str(WEIGHTS_DIR / "fastsam_selftrained.npz")
    rgb, _ = render_room(trajectory_c2w(5, 30),
                         np.asarray([0.9 * w, 0.9 * w, w / 2, h / 2]), h, w,
                         tex=texture_params(seed, sharpness=1.0))
    rgb = rgb.copy()
    rgb[60:140, 100:220] = (1.0, 0.1, 0.1)          # an object
    models = {dev: load_fastsam(path, device=dev) for dev in (DEVICE, "cpu")}
    maps = {dev: [x.cpu().numpy() for x in raw_maps(m, rgb)]
            for dev, m in models.items()}
    errs = [float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
            for a, b in zip(maps[DEVICE], maps["cpu"])]
    masks = {dev: segment_everything(m, rgb) for dev, m in models.items()}
    ious = [float((a & b).sum() / max((a | b).sum(), 1))
            for a, b in zip(masks[DEVICE], masks["cpu"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        segment_everything(models[DEVICE], rgb)
    ms = (time.perf_counter() - t0) * 1e3 / 5
    print(f"phase 13 FastSAM (width 0.25) at {h}x{w}: raw maps card vs CPU "
          f"max abs err / max(1, |CPU|) boxes {errs[0]:.3e}, scores "
          f"{errs[1]:.3e}, coefficients {errs[2]:.3e}, prototypes "
          f"{errs[3]:.3e} (tol 1e-4); masks card {len(masks[DEVICE])}, CPU "
          f"{len(masks['cpu'])}, IoU {[round(x, 4) for x in ious]}; "
          f"segment_everything {ms:.1f} ms per call on the card", flush=True)
    check(max(errs) <= 1e-4, "phase 13: FastSAM on the card left the CPU")
    check(len(masks[DEVICE]) == len(masks["cpu"]) >= 1
          and min(ious) >= 0.99, "phase 13: FastSAM masks differ")
    return ms


def video_copy(src, cfg, n_save, device):
    """A DepthVideo on `device` holding src's keyframes with the first
    n_save of them in the save buffers, the rest live."""
    import torch
    from vings_mono_tpu_torch.tracker.video import DepthVideo
    ns0, nl0 = src.count_save, src.counter
    rows = {k: np.concatenate([getattr(src, k + "_save")[:ns0],
                               getattr(src.bufs, k)[:nl0].cpu().numpy()])
            for k in ("poses", "disps", "disps_up", "images",
                      "depths_cov_up")}
    ts = np.concatenate([src.tstamp_save[:ns0], src.tstamps_host])
    v = DepthVideo(cfg, src.ht, src.wd, device=device)
    v.count_save, v.counter = n_save, len(ts) - n_save
    v.tstamp_save[:n_save] = ts[:n_save]
    for k, a in rows.items():
        getattr(v, k + "_save")[:n_save] = a[:n_save]
        getattr(v.bufs, k)[:v.counter] = torch.as_tensor(a[n_save:],
                                                         device=device)
    v.tstamps_host = [float(x) for x in ts[n_save:]]
    return v


def mapper_copy(src, cfg, device):
    """A GaussianMapper on `device` with src's map, Adam moments and image
    size, and a fresh generator from the config's seed."""
    from vings_mono_tpu_torch.mapper import state as st
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
    m = GaussianMapper(cfg, device=device)
    m.state = st.GaussianState(**{f: getattr(src.state, f).to(device).clone()
                                  for f in st.STATE_FIELDS})
    m.opt = st.SparseAdamState(
        m={k: x.to(device).clone() for k, x in src.opt.m.items()},
        v={k: x.to(device).clone() for k, x in src.opt.v.items()},
        step=src.opt.step)
    m.H, m.W, m.initialized = src.H, src.W, True
    m.bin_kwargs = dict(src.bin_kwargs)
    return m


RECT_SAVE = 16       # keyframes of phase 12's end state put in the save
RECT_RETRAIN = 1     # buffers; the retrain span 0..RECT_RETRAIN
RECT_WRITEBACK = 9   # the depth write-back span 0..RECT_WRITEBACK


def rel_err(a, b, rows):
    """Largest |a - b| / max(1, |b|) over `rows`: f32 coordinates carry
    an error in proportion to their magnitude (the random weights' maps
    reach |xyz| ~ 1e4, where one f32 step is ~1e-3)."""
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b)))[rows].max())


def rectification_phase(end, seed):
    """Phase 13c: rectify_poses, rectify_gaussians, rectify_tracker with
    the depth write-back and retrain_gaussians on phase 12's end state with
    a known endpoint correction, on the card and on the CPU from the same
    snapshot; the kernels held on the card's retrain window. Returns their
    largest errors there."""
    import types
    import torch
    from vings_mono_tpu_torch.loop import rectify
    from vings_mono_tpu_torch.loop.loop_model import LoopModel
    from vings_mono_tpu_torch.tracker.imu import so3_exp
    tracker, mapper, cfg = end
    intr = tracker._intr_cache
    corr = np.eye(4)
    corr[:3, :3] = so3_exp(np.radians([0.5, 2.0, -0.5]))
    corr[:3, 3] = [0.3, -0.1, 0.2]
    b = RECT_SAVE - 1
    res, ms = {}, {}
    for dev in (DEVICE, "cpu"):
        c = dict(cfg, device={"tracker": dev, "mapper": dev})
        tr = types.SimpleNamespace(
            video=video_copy(tracker.video, c, RECT_SAVE, dev))
        m = mapper_copy(mapper, c, dev)
        if dev == DEVICE:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        c2ws = LoopModel._history(tr)
        new = rectify.rectify_poses(c2ws, 0, b, corr @ c2ws[b])
        n_pruned = rectify.rectify_gaussians(m, c2ws, new)
        xyz_rect = m.state.xyz.cpu().numpy().copy()
        rectify.rectify_tracker(tr, new, mapper=m, intrinsic=intr,
                                loop_start=0, loop_end=RECT_WRITEBACK)
        with first_train_window() as window:
            n_re = rectify.retrain_gaussians(m, tr.video, intr, 0,
                                             RECT_RETRAIN)
        if dev == DEVICE:
            torch.cuda.synchronize()
            card_window, kw = window, dict(m.bin_kwargs)
        ms[dev] = (time.perf_counter() - t0) * 1e3
        v = tr.video
        res[dev] = dict(
            c2ws=c2ws, new=new, pruned=n_pruned, xyz_rect=xyz_rect,
            alive=m.state.alive.cpu().numpy().copy(),
            xyz=m.state.xyz.cpu().numpy().copy(),
            poses=np.concatenate([v.poses_save[:RECT_SAVE],
                                  v.bufs.poses[:v.counter].cpu().numpy()]),
            disp=v.disps_up_save[:RECT_WRITEBACK + 1].copy(),
            retrained=n_re, loss=m.last_metrics.get("total"))
    a, bb = res[DEVICE], res["cpu"]
    moved = float(np.abs(a["new"] - a["c2ws"])[:, :3, 3].max())
    e_pose = float(np.abs(a["poses"] - bb["poses"]).max())
    alive = a["alive"]
    e_rect = rel_err(a["xyz_rect"], bb["xyz_rect"], alive)
    e_xyz = rel_err(a["xyz"], bb["xyz"], alive)
    big = float(np.abs(bb["xyz"][alive]).max())
    rel = np.abs(a["disp"] - bb["disp"]) / np.maximum(np.abs(bb["disp"]),
                                                      1e-6)
    close = float(np.mean(rel <= 1e-3))
    print(f"phase 13 rectification on phase 12's end state ({RECT_SAVE} "
          f"keyframes saved, {len(a['c2ws']) - RECT_SAVE} live), endpoint "
          f"correction at keyframe {b}: rotation 2.1 deg, translation "
          f"{np.linalg.norm(corr[:3, 3]):.4f} (the chain moved up to "
          f"{moved:.4f}); card vs CPU from the same snapshot: poses after "
          f"rectify_tracker max abs diff {e_pose:.3e} (tol 1e-4), Gaussian "
          f"xyz (|xyz| up to {big:.1f}) max |diff| / max(1, |xyz|) after "
          f"rectify_gaussians {e_rect:.3e} (tol 1e-6), after "
          f"retrain_gaussians over keyframes 0..{RECT_RETRAIN} "
          f"({a['retrained']} keyframes, loss card {a['loss']:.5f}, CPU "
          f"{bb['loss']:.5f}) {e_xyz:.3e} (tol 1e-3); written-back "
          f"disparities over keyframes 0..{RECT_WRITEBACK}: max rel diff "
          f"{float(rel.max()):.3e}, share within 1e-3 {close:.6f} (tol "
          f"0.999); pruned {a['pruned']} / {bb['pruned']}; card "
          f"{ms[DEVICE]:.1f} ms, CPU {ms['cpu']:.1f} ms", flush=True)
    check(moved > 1e-3, "phase 13: the correction moved nothing")
    check(e_pose <= 1e-4 and e_rect <= 1e-6 and e_xyz <= 1e-3
          and close >= 0.999 and a["pruned"] == bb["pruned"]
          and (a["alive"] == bb["alive"]).all()
          and a["retrained"] == bb["retrained"] == RECT_RETRAIN + 1,
          "phase 13: the rectification on the card left the CPU run")
    check(np.isfinite(a["poses"]).all() and np.isfinite(a["disp"]).all(),
          "phase 13: rectified poses or disparities not finite")
    check(bool(card_window), "phase 13: retrain trained no window")
    return kernels_on("phase 13", [(
        f"retrain window's first camera ({card_window['n']} keyframes)",
        card_window["state"], card_window["c2w"], card_window["intr"])],
        kw, seed)


# ---------------------------------------------------------------------------
# phase 14: metric depth, sessions and the evaluation harness
# ---------------------------------------------------------------------------

METRIC_W = ROOT / "vings_mono_tpu/weights/metric_depth_selftrained.npz"
METRIC_OVERRIDES = {
    "use_metric": True,
    "metric": {"backend": "flax",
               "weights": str(METRIC_W)},
    "dataset": {"module": "synthetic3d", "n_frames": 20}}
CHECKPOINT_EVERY = 10
RESUME_AT = 10


def metric_depth_phase(cfg):
    """Phase 14a: MetricDepth's flax backend (the self-trained DPT) on the
    card against the CPU on three room frames at 240x432; warm ms per
    call on the card (the frame's upload included, as the runner calls
    it)."""
    import torch
    from vings_mono_tpu_torch.datasets.base import get_dataset
    from vings_mono_tpu_torch.models.metric_depth import MetricDepth
    ds = get_dataset(cfg)
    rgbs = [ds[k]["rgb"] for k in (0, 10, 20)]
    card = MetricDepth(cfg, device=DEVICE)
    cpu = MetricDepth(cfg, device="cpu")
    errs = []
    for rgb in rgbs:
        a = card.predict(rgb, None).cpu()
        b = cpu.predict(rgb, None)
        check(a.shape == b.shape == rgb.shape[:2]
              and bool(torch.isfinite(a).all()), "phase 14 metric depth "
              "has the wrong shape or is not finite")
        errs.append(float((a - b).abs().max() / b.abs().max()))
    ms = cuda_ms(lambda: card.predict(rgbs[0], None), 10, warmup=2)
    print(f"phase 14 metric depth (self-trained DPT dim 192, depth 6, hw "
          f"128x160) at {rgbs[0].shape[0]}x{rgbs[0].shape[1]}: card vs CPU "
          f"relative error {['%.3e' % e for e in errs]}, {ms:.3f} ms per "
          f"call warm on the card", flush=True)
    check(max(errs) < 1e-4, f"phase 14 metric depth card vs CPU "
          f"{max(errs):.3e} (tolerance 1e-4 of the largest depth)")


def poses_by_ts(tracker):
    from vings_mono_tpu_torch.utils.trajectory import tracker_c2ws
    ts, c2ws = tracker_c2ws(tracker)
    return {round(t, 6): np.asarray(m) for t, m in zip(ts, c2ws)}


def pose_gap(a, b, frames):
    """Largest camera-center distance and rotation angle (deg) between two
    trajectories over the given frame timestamps."""
    dist = ang = 0.0
    for t in frames:
        ma, mb = (np.asarray(m[float(t)], np.float64) for m in (a, b))
        dist = max(dist, float(np.linalg.norm(ma[:3, 3] - mb[:3, 3])))
        # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): exactly 0 for equal
        # rotations, where arccos of the trace rounds to ~0.03 deg in f32
        s = np.linalg.norm(ma[:3, :3] - mb[:3, :3]) / (2.0 * np.sqrt(2.0))
        ang = max(ang, float(np.degrees(2.0 * np.arcsin(min(s, 1.0)))))
    return dist, ang


def metric_session_phase(args, tk):
    """Phase 14: `runners.run.run` on smoke.yaml
    with use_metric (the flax DPT) on synthetic3d, checkpointing every 10
    frames; the evaluation harness and the MFU over it; the kernels on
    eval_psnr's render; a second identical run for the card's spread; the
    resume from the frame-RESUME_AT session. Returns the launch counts and the
    kernels' largest errors."""
    import tempfile
    import torch
    import yaml
    from vings_mono_tpu_torch.datasets.base import get_dataset
    from vings_mono_tpu_torch.runners import evaluate
    from vings_mono_tpu_torch.runners import run as run_mod
    from vings_mono_tpu_torch.utils import checkpoint as ckpt_mod
    from vings_mono_tpu_torch.utils.config import load_config
    from vings_mono_tpu_torch.utils.mfu import bench_mfu
    root = OUT / "metric"
    shutil.rmtree(root, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "smoke_metric.yaml"
        path.write_text(yaml.safe_dump(load_config(str(SMOKE), overrides={
            **METRIC_OVERRIDES, "output": {"save_dir": str(root)},
            "device": {"tracker": DEVICE, "mapper": DEVICE}})))
        cfg = load_config(str(path))
    h, w = (int(x) for x in cfg["frontend"]["image_size"])
    n_frames = int(cfg["dataset"]["n_frames"])
    print(f"phase 14 config: {SMOKE.relative_to(ROOT)} with "
          f"{METRIC_OVERRIDES} written to a temporary YAML (mode "
          f"{cfg['mode']}, use_loop, use_dynamic, use_sky, use_refine, "
          f"storage, vis and global BA as committed; {n_frames} frames at "
          f"{h}x{w}); --checkpoint-every {CHECKPOINT_EVERY}", flush=True)
    metric_depth_phase(cfg)

    def one_run(tag, **kw):
        """A run; its live window's c2w at the end of frames RESUME_AT - 1
        (what the session holds) and RESUME_AT (the first resumed
        frame)."""
        snaps = {}

        def on_frame(idx, tracker, *_):
            if idx in (RESUME_AT - 1, RESUME_AT):
                snaps[idx] = tracker.video.c2w_matrices()
        tk.rasterize_forward.launches = 0
        tk.rasterize_backward.launches = 0
        t0 = time.perf_counter()
        out = run_mod.run(cfg, str(root / tag), sync_timer=True,
                          on_frame=on_frame, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"rasterize_forward": tk.rasterize_forward.launches,
                    "rasterize_backward": tk.rasterize_backward.launches}
        return out, wall, launches, snaps

    def max_gap(a, b):
        return float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())

    (tracker, mapper, timer), wall, launches, snaps = one_run(
        "run", checkpoint_every=CHECKPOINT_EVERY)
    smi = nvidia_smi()
    print(timer.report().replace("\n", "\nphase 14 ").replace(
        "stage times", "phase 14 stage times"), flush=True)
    v = tracker.video
    n_kf = v.counter + v.count_save
    ds = v.bufs.disps_sens[:v.counter]
    pos = float((ds > 0).float().mean())
    med = float(1.0 / ds[ds > 0].median()) if pos > 0 else float("nan")
    session = root / "run" / "session"
    mb = sum(f.stat().st_size for f in session.iterdir()) / 1e6
    save_ms = 1e3 * timer.totals["checkpoint"] / timer.counts["checkpoint"]
    dataset = get_dataset(cfg)
    ate = evaluate.eval_trajectory(str(root / "run"), dataset)
    psnr_renders = []
    render = mapper.render_at

    def rec_render(w2c, intr, max_dist=None):
        psnr_renders.append((np.linalg.inv(w2c.cpu().numpy()), dict(intr)))
        return render(w2c, intr, max_dist)
    mapper.render_at = rec_render
    t0 = time.perf_counter()
    psnr = evaluate.eval_psnr(mapper, tracker)
    psnr_ms = 1e3 * (time.perf_counter() - t0)
    del mapper.render_at
    t0 = time.perf_counter()
    mfu = bench_mfu(tracker, mapper, n_frames, mapper.time_idx, wall)
    mfu_s = time.perf_counter() - t0
    print(f"phase 14 run [{smi}]: {n_frames} frames in {wall:.1f} s, "
          f"{n_kf} keyframes, the mapper trained on {mapper.time_idx}; "
          f"disps_sens positive share {pos:.4f} over {v.counter} live "
          f"keyframes, median prior depth {med:.3f}; ATE rmse {ate:.4f} "
          f"(eval_trajectory, scale-aligned), PSNR {psnr:.3f} dB "
          f"(eval_psnr over {len(psnr_renders)} keyframes, {psnr_ms:.1f} "
          f"ms); session {mb:.1f} MB, save_session {save_ms:.1f} ms "
          f"(n={timer.counts['checkpoint']}); launches {launches}",
          flush=True)
    print(f"phase 14 bench_mfu (H100 dense bf16 peak 989 TFLOP/s; counted "
          f"in {mfu_s:.1f} s after the run): {json.dumps(mfu)}", flush=True)
    for stage in ("metric", "track", "map", "checkpoint", "global_ba"):
        check(stage in timer.totals, f"phase 14: no {stage} stage")
    check(timer.counts["metric"] == n_frames, "phase 14: the metric stage "
          "did not run every frame")
    check(timer.counts["checkpoint"] == (n_frames - 1) // CHECKPOINT_EVERY,
          "phase 14: the session was not saved every 10 frames")
    check(pos > 0.9, f"phase 14: disps_sens positive share {pos}")
    check(0.3 < med < 40.0, f"phase 14: median prior depth {med}")
    check(ate is not None and np.isfinite(ate), "phase 14: no ATE")
    check(psnr is not None and np.isfinite(psnr), "phase 14: no PSNR")
    check(mfu["flops_train_loop"] > 0 and mfu["flops_fused_update"] > 0,
          "phase 14: bench_mfu counted nothing")
    for name, cnt in launches.items():
        check(cnt >= mapper.time_idx * int(cfg["training_args"]["iters"]),
              f"{name} launched {cnt} times in phase 14")
    check(bool(torch.isfinite(v.bufs.poses[:v.counter]).all()),
          "phase 14 poses are not finite")
    c2w, intr = psnr_renders[-1]
    errs = kernels_on("phase 14", [(
        f"eval_psnr's render of its last keyframe", mapper.state, c2w,
        intr)], dict(mapper.bin_kwargs), args.seed + 60)
    first = poses_by_ts(tracker)
    del tracker, mapper

    (again, _, _), wall2, _, snaps2 = one_run("again")
    frames = range(RESUME_AT, n_frames)
    second = poses_by_ts(again)
    spread = pose_gap(first, second, frames)
    spread_1 = max_gap(snaps[RESUME_AT], snaps2[RESUME_AT])
    ate2 = evaluate.eval_trajectory(str(root / "again"), dataset)
    same = sorted(first) == sorted(second) and all(
        np.array_equal(first[t], second[t]) for t in first)
    print(f"phase 14 the same run again (runners.run.run inside "
          f"utils.device.reproducible): {wall2:.1f} s, ATE rmse "
          f"{ate2:.4f}; every keyframe pose "
          f"{'bitwise equal to' if same else 'NOT equal to'} the first "
          f"run's; the window after frame {RESUME_AT} within "
          f"{spread_1:.4e} units of the first run's, the final poses of "
          f"frames {RESUME_AT}-{n_frames - 1} within {spread[0]:.4e} units "
          f"/ {spread[1]:.4e} deg", flush=True)
    check(same and spread_1 == 0.0, "phase 14: the same run again did "
          "not give the same poses bit for bit")
    del again

    # the session on disk is the last one saved: before frame RESUME_AT
    host = ckpt_mod.load_host(str(session))
    check(host["counter"] + host["count_save"] == RESUME_AT,
          f"phase 14: the session holds {host['counter']} + "
          f"{host['count_save']} keyframes, not {RESUME_AT}")
    load_ms, loaded = [], []
    load = ckpt_mod.load_session

    def timed_load(path, tracker, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = load(path, tracker, *a, **k)
        torch.cuda.synchronize()
        load_ms.append(1e3 * (time.perf_counter() - t0))
        loaded.append(tracker.video.c2w_matrices())
        return out
    with replaced(ckpt_mod, "load_session", timed_load):
        (resumed, _, rtimer), wall3, _, snaps3 = one_run(
            "resumed", resume=str(session))
    rv = resumed.video
    gap = pose_gap(first, poses_by_ts(resumed), frames)
    gap_1 = max_gap(snaps[RESUME_AT], snaps3[RESUME_AT])
    ate3 = evaluate.eval_trajectory(str(root / "resumed"), dataset)
    exact = np.array_equal(loaded[0], snaps[RESUME_AT - 1])
    print(f"phase 14 resume from the frame-{RESUME_AT} session: "
          f"load_session {load_ms[0]:.1f} ms, the loaded window "
          f"{'bitwise equal to' if exact else 'NOT equal to'} the first "
          f"run's at the save; frames {RESUME_AT}-{n_frames - 1} in "
          f"{wall3:.1f} s, {rv.counter + rv.count_save} keyframes, ATE rmse "
          f"{ate3:.4f}; the window after frame {RESUME_AT} within "
          f"{gap_1:.4e} units of the first run's (the same run again: "
          f"{spread_1:.4e}), the final poses of frames {RESUME_AT}-"
          f"{n_frames - 1} within {gap[0]:.4e} units / {gap[1]:.4e} deg "
          f"(again: {spread[0]:.4e} / {spread[1]:.4e}); the resumed mapper "
          f"starts fresh Adam moments, sky and random stream, and its loop "
          f"detection counts keyframes from the resume", flush=True)
    check(exact, "phase 14: the loaded window differs from the saved one")
    check(sorted(snaps3) == [RESUME_AT], "phase 14: the resume did not "
          f"start at frame {RESUME_AT}")
    check(rv.counter + rv.count_save == n_kf, "phase 14: the resumed run "
          "ends with another keyframe count")
    check(bool(torch.isfinite(rv.bufs.poses[:rv.counter]).all()),
          "phase 14 resumed poses are not finite")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 15: the image-folder datasets, the threaded runners, the trainer
# ---------------------------------------------------------------------------

KITTI_FRAMES = 30           # frames of the written kitti_sync folder
KITTI_DT = 0.1              # KITTI's 10 Hz camera
TRAIN_STEPS = 5             # steps of the trainer's loop
TRAIN_UNROLL = 8            # train_droid's --num-steps default
# card vs CPU on one training clip: the loss to 1e-4 relative; each
# parameter's gradient to 1e-2 of its own largest magnitude (8 unrolled
# GRU + BA steps sum in other orders on the two devices), and a tensor
# whose CPU gradient stays below 1e-6 of the largest of all (the biases
# ahead of an instance norm, whose true gradient is 0) below that bound
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-2
TRAIN_NOISE = 1e-6


def write_kitti_sync(root, n, imu_delay, dt=KITTI_DT):
    """A kitti_sync folder of the synthetic3d room at KITTI-0028's
    370x1226 with its intrinsics: image_02/data/*.png, metadata/
    camstamp.txt at 1/dt Hz, metadata/imu.txt from room_imu at 100 Hz
    written `imu_delay` late (the loader subtracts it), metadata/c2i.txt
    (identity) and pose/<t>.txt c2ws. The camera moves at phase 7's
    speed. Returns the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor
    from vings_mono_tpu_torch.datasets.synthetic3d import (
        render_room, texture_params, trajectory_c2w)
    import cv2
    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    for d in ("image_02/data", "metadata", "pose"):
        (root / d).mkdir(parents=True)
    intr = np.asarray([KITTI["fv"], KITTI["fu"], KITTI["cv"], KITTI["cu"]],
                      np.float32)
    revs = VIO_REVS_PER_FRAME * n
    tex = texture_params(0)

    def one(k):
        c2w = trajectory_c2w(k, n, revs=revs)
        rgb, _ = render_room(c2w, intr, KITTI["H"], KITTI["W"], tex=tex)
        name = f"{k:010d}.png"
        cv2.imwrite(str(root / "image_02/data" / name),
                    np.round(rgb[..., ::-1] * 255).astype(np.uint8))
        np.savetxt(root / "pose" / f"{k * dt:.6f}.txt", c2w)
        return f"{k * dt:.6f} {name}"
    with ThreadPoolExecutor(8) as ex:
        lines = list(ex.map(one, range(n)))
    (root / "metadata/camstamp.txt").write_text("\n".join(lines) + "\n")
    imu = room_imu(n, revs, dt)
    imu[:, 0] += imu_delay
    np.savetxt(root / "metadata/imu.txt", imu)
    np.savetxt(root / "metadata/c2i.txt", np.eye(4))
    return time.perf_counter() - t0


class TimedDataset:
    """A dataset whose `__getitem__` is timed on the host clock."""

    def __init__(self, ds):
        self.ds = ds
        self.ms = []

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        t0 = time.perf_counter()
        pkt = self.ds[idx]
        self.ms.append(1e3 * (time.perf_counter() - t0))
        return pkt

    def __getattr__(self, name):
        return getattr(self.ds, name)


def kitti_cfg(folder, out):
    """configs/kitti/sync/kitti_2011_09_30_drive_0028.yaml as committed
    with dataset.root on the folder and the repository's DroidNet
    weights, written to a temporary YAML and loaded from there."""
    import tempfile
    import yaml
    from vings_mono_tpu_torch.utils.config import load_config
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "kitti_0028.yaml"
        path.write_text(yaml.safe_dump(load_config(str(CONFIG), overrides={
            "dataset": {"root": str(folder)},
            "frontend": {"weight": str(WEIGHTS)},
            "output": {"save_dir": str(out)},
            "device": {"tracker": DEVICE, "mapper": DEVICE}})))
        return load_config(str(path))


def agreement(tag, a, b, what):
    """Keyframe timestamps two trackers share, whether their poses there
    are bitwise equal and their largest pose gap, printed as a finding."""
    pa, pb = poses_by_ts(a), poses_by_ts(b)
    common = sorted(set(pa) & set(pb))
    dist, ang = pose_gap(pa, pb, common) if common else (float("nan"),) * 2
    same = bool(common) and all(np.array_equal(pa[t], pb[t]) for t in common)
    print(f"{tag} keyframes against {what}: {len(common)} timestamps "
          f"shared of {len(pa)} and {len(pb)}, the poses there "
          f"{'bitwise equal' if same else 'not equal'}; largest pose gap "
          f"over them {dist:.4e} units / {ang:.4e} deg (a finding)",
          flush=True)
    return len(common)


# a camera for the twin check: the newest trained keyframe whose depths
# were kept at this share of its pixels or more (a keyframe whose depths
# were gated away seeded nothing, and the map may lie behind or beside it)
# and under which the final map has this many pairs
SEEN_KEPT_SHARE = 0.5
SEEN_MIN_PAIRS = 1000


def seen_camera(mapper, cams, tag="phase 15a"):
    """The newest trained keyframe's camera with its depths kept at
    SEEN_KEPT_SHARE of its pixels or more and SEEN_MIN_PAIRS pairs of the
    final map under it: (c2w, intrinsic, label). Where none has both, the
    camera with the most pairs, said so. Prints the cameras passed over."""
    import torch
    from vings_mono_tpu_torch.mapper.cameras import camera_from_intrinsic
    from vings_mono_tpu_torch.ops.rasterizer import bin_for_camera
    s = mapper.state
    alive = s.xyz[s.alive]
    best = None
    for back, (idx, c2w, intr, share) in enumerate(reversed(cams)):
        w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                              device=s.xyz.device)
        cam = camera_from_intrinsic(w2c, intr)
        with torch.no_grad():
            n = int(bin_for_camera(s.xyz, s.log_scale, s.quat,
                                   s.logit_opacity, s.rgb, cam,
                                   alive=s.alive,
                                   **mapper.bin_kwargs).n_pairs)
            dist = (alive - torch.as_tensor(c2w[:3, 3], dtype=torch.float32,
                                            device=alive.device)).norm(dim=-1)
        print(f"{tag} camera of the keyframe mapped at frame {idx} "
              f"({back} before the newest): {n} pairs; its depths kept at "
              f"{share:.4f} of its pixels; {len(alive)} live surfels, "
              f"distance to its centre median {float(dist.median()):.3f}, "
              f"min {float(dist.min()):.3f}", flush=True)
        label = (f"the final map under the camera of the keyframe mapped "
                 f"at frame {idx}, {back} before the newest")
        if share >= SEEN_KEPT_SHARE and n >= SEEN_MIN_PAIRS:
            return c2w, intr, label
        if n > 0 and (best is None or n > best[0]):
            best = (n, c2w, intr, label)
    if best is None:
        fail(f"{tag}: no trained keyframe's camera sees the final map")
    print(f"{tag}: no keyframe has its depths kept at {SEEN_KEPT_SHARE} of "
          f"its pixels and {SEEN_MIN_PAIRS} pairs under it; the camera "
          f"with the most pairs ({best[0]}) is used", flush=True)
    return best[1:]


def kitti_folder_phase(args, tk):
    """Phase 15a-d, this slice's main path: a written kitti_sync folder
    through runners.run, run_tracking, run_multiprocess and the mobile
    workers (15d: behind the server, profile_configs.py's F8). Returns
    the launch counts of 15a, 15c and 15d and the kernels' largest errors
    on 15a's and 15d's final maps."""
    import torch
    import profile_configs as pc
    from vings_mono_tpu_torch.datasets import base as ds_base
    from vings_mono_tpu_torch.runners import evaluate
    from vings_mono_tpu_torch.runners import run as run_mod
    from vings_mono_tpu_torch.runners import run_multiprocess, run_tracking
    smi = nvidia_smi()
    root = OUT / "kitti"
    folder = root / "folder"
    shutil.rmtree(root, ignore_errors=True)
    cfg = kitti_cfg(folder, root)
    delay = float(cfg["dataset"]["imu_delay"])
    write_s = write_kitti_sync(folder, KITTI_FRAMES, delay)
    h, w = (int(x) for x in cfg["frontend"]["image_size"])
    print(f"phase 15 folder: {KITTI_FRAMES} frames of the synthetic3d room "
          f"at {KITTI['H']}x{KITTI['W']} (KITTI-0028's intrinsics) in the "
          f"kitti_sync layout, {KITTI_DT} s apart, a {IMU_HZ:.0f} Hz IMU "
          f"written {delay} s late, written in {write_s:.1f} s; config "
          f"{CONFIG.relative_to(ROOT)} as committed (mode {cfg['mode']}, "
          f"use_storage_manager {cfg['use_storage_manager']}, use_vis "
          f"{cfg['use_vis']}, {h}x{w}) with dataset.root on the folder and "
          f"frontend.weight {WEIGHTS.relative_to(ROOT)}", flush=True)
    check(cfg["mode"] == "vio" and cfg["use_storage_manager"]
          and cfg["use_vis"] and (h, w) == (240, 800),
          "phase 15 is not KITTI-0028 as committed")

    def launches():
        return {"rasterize_forward": tk.rasterize_forward.launches,
                "rasterize_backward": tk.rasterize_backward.launches}

    def reset():
        tk.rasterize_forward.launches = 0
        tk.rasterize_backward.launches = 0

    # ---- 15a: runners.run on the folder
    timed, last = [], {}
    get_dataset = ds_base.get_dataset

    def timed_get(c):
        timed.append(TimedDataset(get_dataset(c)))
        return timed[-1]

    def on_frame(idx, tracker, mapper, viz_out):
        # the newest keyframe's camera of every window the mapper trained
        # on, with the share of its pixels that kept a depth
        if viz_out is not None and mapper.time_idx > len(cams):
            k = int(viz_out["n_valid"]) - 1
            cams.append((idx, np.asarray(viz_out["poses"][k].cpu()),
                         dict(viz_out["intrinsic"]),
                         float((viz_out["depths"][k] > 0).float().mean())))
    cams = []
    reset()
    t0 = time.perf_counter()
    with replaced(ds_base, "get_dataset", timed_get):
        tracker_a, mapper, timer = run_mod.run(
            cfg, str(root / "run"), sync_timer=True, on_frame=on_frame)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launch_a = launches()
    print(timer.report().replace("\n", "\nphase 15a ").replace(
        "stage times", "phase 15a stage times"), flush=True)
    load_ms = timed[0].ms
    dataset = get_dataset(cfg)
    ate = evaluate.eval_trajectory(str(root / "run"), dataset)
    v = tracker_a.video
    n_kf = v.counter + v.count_save
    print(f"phase 15a run.py [{smi}]: {KITTI_FRAMES} frames in {wall_a:.1f} "
          f"s ({KITTI_FRAMES / wall_a:.3f} frames/s), {n_kf} keyframes, the "
          f"mapper trained on {mapper.time_idx}; dataset[idx] host "
          f"{np.mean(load_ms):.2f} ms mean, {np.median(load_ms):.2f} ms "
          f"median, {max(load_ms):.2f} ms max over {len(load_ms)} frames "
          f"({KITTI['H']}x{KITTI['W']} png -> {h}x{w}); ATE rmse "
          f"{ate if ate is None else round(ate, 4)} (eval_trajectory, "
          f"scale-aligned, against pose/); launches {launch_a}", flush=True)
    check(len(load_ms) == KITTI_FRAMES, "phase 15a: not every frame loaded")
    check(ate is not None and np.isfinite(ate), "phase 15a: no ATE")
    check(mapper.time_idx > 0, "phase 15a: nothing was mapped")
    for name, cnt in launch_a.items():
        check(cnt > 0, f"phase 15a: {name} never launched")
    check(bool(torch.isfinite(v.bufs.poses[:v.counter]).all()),
          "phase 15a poses are not finite")
    check((root / "run" / "ply" / "final_2dgs.ply").is_file(),
          "phase 15a: no .ply")
    c2w, intr, label = seen_camera(mapper, cams)
    errs = kernels_on("phase 15a", [(label, mapper.state, c2w, intr)],
                      dict(mapper.bin_kwargs), args.seed + 80)
    del mapper

    # ---- 15b: run_tracking on the same folder
    t0 = time.perf_counter()
    tracker_b = run_tracking.run(cfg, str(root / "tracking"))
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    print(f"phase 15b run_tracking [{smi}]: {KITTI_FRAMES} frames in "
          f"{wall_b:.1f} s ({KITTI_FRAMES / wall_b:.3f} frames/s)",
          flush=True)
    agreement("phase 15b", tracker_b, tracker_a, "15a's run.py")
    check(len(list((root / "tracking" / "droid_c2w").glob("*.txt"))) > 0,
          "phase 15b: no trajectory")
    del tracker_a

    # ---- 15c: run_multiprocess on the same folder
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    reset()
    t0 = time.perf_counter()
    tracker_c, mapper_c, stats = run_multiprocess.run(
        cfg, str(root / "multiprocess"))
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launch_c = launches()
    after = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    ply = (root / "multiprocess" / "ply" / "final_2dgs.ply").is_file()
    print(f"phase 15c run_multiprocess [{smi}]: {KITTI_FRAMES} frames in "
          f"{wall_c:.1f} s ({KITTI_FRAMES / wall_c:.3f} frames/s; run.py "
          f"{KITTI_FRAMES / wall_a:.3f}); windows {stats['windows']} "
          f"packaged, {stats['mapped']} mapped ({mapper_c.time_idx} with a "
          f"new keyframe to train on), {stats['dropped']} dropped by the "
          f"backpressure; .ply written: {ply}; TF32 flags (matmul, "
          f"cudnn) {flags} before, {after} after; launches {launch_c}",
          flush=True)
    agreement("phase 15c", tracker_c, tracker_b, "15b's run_tracking")
    check(ply, "phase 15c: no .ply")
    check(after == flags, "phase 15c changed the TF32 flags")
    check(stats["mapped"] >= mapper_c.time_idx > 0
          and stats["mapped"] + stats["dropped"] == stats["windows"],
          f"phase 15c: windows {stats}, trained on {mapper_c.time_idx}")
    for name, cnt in launch_c.items():
        check(cnt > 0, f"phase 15c: {name} never launched")
    del tracker_b, tracker_c, mapper_c

    # ---- 15d: the mobile workers behind the server, fed the phone's
    # messages: profile_configs.py's F8 at its fewest frames
    phone = pc.FAMILIES["F8"]
    rec = pc.run_family(phone, phone.smoke_frames, OUT / "phone", DEVICE,
                        args.seed, tag="phase 15d F8")
    launch_d = rec["launches"]
    errs = [max(a, b) for a, b in zip(errs, (
        rec["max_abs_err"]["rasterize_forward"],
        rec["max_abs_err"]["rasterize_backward"],
        rec["max_err_over_scale"]["rasterize_forward"],
        rec["max_err_over_scale"]["rasterize_backward"]))]
    return {"a": launch_a, "c": launch_c, "d": launch_d}, errs


def named_grads(model):
    """{name: gradient on the host}, zeros where a parameter has none."""
    import torch
    return {n: (p.grad if p.grad is not None
                else torch.zeros_like(p)).cpu()
            for n, p in model.named_parameters()}


def card_against_cpu(tag, got):
    """got {device: (loss, {name: gradient on the host})} for DEVICE and
    the CPU -> (the loss's relative gap, the largest gradient gap over
    each tensor's largest CPU magnitude, the tensors so held). A tensor
    whose CPU gradient stays below TRAIN_NOISE of the largest of all is
    held to that bound on the card too."""
    (lc, gc), (lh, gh) = got[DEVICE], got["cpu"]
    gmax = max(float(g.abs().max()) for g in gh.values())
    worst, n_held = 0.0, 0
    for n, g in gh.items():
        scale = float(g.abs().max())
        if scale < TRAIN_NOISE * gmax:
            check(float(gc[n].abs().max()) < TRAIN_NOISE * gmax,
                  f"{tag}: {n}'s gradient is not noise on the card")
            continue
        n_held += 1
        worst = max(worst, float((gc[n] - g).abs().max()) / scale)
    return abs(lc - lh) / abs(lh), worst, n_held


def train_phase(args):
    """Phase 15e: the DROID trainer. One clip's loss and gradients, card
    against CPU; TRAIN_STEPS steps of train_droid's loop from the
    repository's weights at its shapes; the checkpoint round trip."""
    import torch
    from vings_mono_tpu_torch.models import droid_trainer as tt
    from vings_mono_tpu_torch.models.droid_net import load_droid_weights
    from vings_mono_tpu_torch.runners import train_droid
    from vings_mono_tpu_torch.utils.device import true_f32
    smi = nvidia_smi()
    clip = train_droid.random_clip(np.random.default_rng(args.seed + 70))
    got, secs = {}, {}
    for dev in (DEVICE, "cpu"):
        model = train_droid.build_model(str(WEIGHTS), dev)
        batch = train_droid.to_batch(clip, dev)
        t0 = time.perf_counter()
        with true_f32():
            loss = tt.droid_training_loss(model, batch,
                                          num_steps=TRAIN_UNROLL)
            loss.backward()
        if dev == DEVICE:
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
        got[dev] = (float(loss.detach()), named_grads(model))
    (lc, gc), (lh, gh) = got[DEVICE], got["cpu"]
    loss_rel, worst, n_held = card_against_cpu("phase 15e", got)
    print(f"phase 15e trainer card vs CPU [{smi}] on one clip (P "
          f"{train_droid.P}, {train_droid.H}x{train_droid.W}, "
          f"{TRAIN_UNROLL} unrolled steps, true f32): loss {lc:.6f} vs "
          f"{lh:.6f} (relative {loss_rel:.3e}, tolerance "
          f"{TRAIN_LOSS_REL}); gradients of {n_held} tensors within "
          f"{worst:.3e} of their largest magnitude (tolerance "
          f"{TRAIN_GRAD_REL}); forward + backward {secs[DEVICE]:.2f} s on "
          f"the card (first call), {secs['cpu']:.2f} s on the CPU",
          flush=True)
    check(loss_rel <= TRAIN_LOSS_REL and worst <= TRAIN_GRAD_REL,
          "phase 15e: the trainer on the card left the CPU")

    out = OUT / "train" / "droid_trained.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    stamps, applied = [], []

    def on_step(it, loss, ok):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        applied.append(ok)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, losses = train_droid.train(
        TRAIN_STEPS, str(out), num_steps=TRAIN_UNROLL, ckpt_every=
        TRAIN_STEPS, resume=str(WEIGHTS), device=DEVICE,
        seed=args.seed + 71, log_every=10, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps_s = np.diff([t0] + stamps)
    print(f"phase 15e train_droid [{smi}]: {TRAIN_STEPS} steps (P "
          f"{train_droid.P}, {train_droid.H}x{train_droid.W}, num_steps "
          f"{TRAIN_UNROLL}) from {WEIGHTS.relative_to(ROOT)}: first step "
          f"{steps_s[0]:.2f} s, then {np.mean(steps_s[1:]):.3f} s/step "
          f"(median {np.median(steps_s[1:]):.3f}), peak memory {peak:.2f} "
          f"GB, steps applied {sum(applied)}/{TRAIN_STEPS}; losses "
          f"{['%.4f' % x for x in losses]}", flush=True)
    check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
          "phase 15e: a training loss is not finite")
    back = load_droid_weights(str(out))
    same = all(torch.equal(p.cpu(), back[n])
               for n, p in model.state_dict().items())
    start = load_droid_weights(str(WEIGHTS))
    moved = max(float((p.cpu() - start[n]).abs().max())
                for n, p in model.state_dict().items())
    print(f"phase 15e checkpoint {out.name}: "
          f"{out.stat().st_size / 1e6:.1f} MB, loaded back "
          f"{'bitwise equal' if same else 'NOT equal'}; the parameters "
          f"moved up to {moved:.3e} from the start", flush=True)
    check(same, "phase 15e: the checkpoint did not load back bitwise")
    check(moved > 0.0, "phase 15e: the training moved nothing")


RECIPE_STEPS = 3            # steps of each recipe's repeated run


def recipe_specs(seed):
    """Per self-training recipe: (module, shipped weights, loss_of(model,
    device) on one batch made on the host from `seed`, the samples of a
    fixed pool, load(path) -> the state_dict a checkpoint loads as)."""
    import torch
    from vings_mono_tpu_torch.models.dpt_depth import load_dpt
    from vings_mono_tpu_torch.models.fastsam import load_fastsam
    from vings_mono_tpu_torch.models.lightglue import load_lightglue
    from vings_mono_tpu_torch.models.superpoint import load_superpoint
    from vings_mono_tpu_torch.runners import (train_fastsam,
                                              train_lightglue,
                                              train_metric_depth,
                                              train_superpoint)
    rng = np.random.default_rng(seed)
    sp = train_superpoint
    pairs = [sp.random_pair(rng) for _ in range(8)]
    sp_batch = sp.stack_pairs(pairs[:sp.BS_PAIRS])

    def sp_loss(model, dev):
        table = torch.as_tensor(sp.target_table(), device=dev)
        return sp.superpoint_loss(model, sp.to_batch(sp_batch, dev), table)
    lg = train_lightglue
    views = [lg.sample_views(rng) for _ in range(4)]
    # the frozen SuperPoint's keypoints from the host: both devices see
    # the same inputs
    lg_in = lg.pair_inputs(load_superpoint(lg.SUPERPOINT), views[0], "cpu")
    fs = train_fastsam
    comps = [fs.sample(rng) for _ in range(4)]
    md = train_metric_depth
    rooms = [md.sample(rng) for _ in range(4)]
    return {
        "superpoint": (sp, "superpoint_selftrained.npz", sp_loss, pairs,
                       lambda p: load_superpoint(p).state_dict()),
        "lightglue": (lg, "lightglue_selftrained.npz",
                      lambda m, dev: lg.lightglue_loss(
                          m, *(x.to(dev) for x in lg_in)), views,
                      lambda p: load_lightglue(p).state_dict()),
        "fastsam": (fs, "fastsam_selftrained.npz",
                    lambda m, dev: fs.fastsam_loss(
                        m, *fs.to_batch(comps, dev)), comps,
                    lambda p: load_fastsam(p).state_dict()),
        "metric_depth": (md, "metric_depth_selftrained.npz",
                         lambda m, dev: md.depth_loss(
                             m, *md.to_batch(rooms, dev)), rooms,
                         lambda p: load_dpt(p, device="cpu")[0]
                         .state_dict()),
    }


def recipe_phase(args):
    """Phase 15e, the self-training recipes of SuperPoint, LightGlue,
    FastSAM and the DPT metric-depth net: per recipe one batch's loss and
    gradients card against CPU from the shipped weights; TRAIN_STEPS
    steps of its runner's `train` from them (s/step, peak memory); the
    checkpoint loaded back bitwise; RECIPE_STEPS steps on a fixed pool
    twice, bitwise equal."""
    import torch
    from vings_mono_tpu_torch.runners.self_training import SamplePool
    from vings_mono_tpu_torch.utils.device import reproducible, true_f32
    smi = nvidia_smi()
    out_dir = OUT / "train"
    out_dir.mkdir(parents=True, exist_ok=True)
    for k, (name, (mod, wname, loss_of, items, load)) in enumerate(
            recipe_specs(args.seed + 72).items()):
        tag = f"phase 15e train_{name}"
        weights = str(WEIGHTS_DIR / wname)
        got, secs = {}, {}
        for dev in (DEVICE, "cpu"):
            model = mod.build_model(weights, dev)
            t0 = time.perf_counter()
            with reproducible(), true_f32():
                loss, _ = loss_of(model, dev)
                loss.backward()
            if dev == DEVICE:
                torch.cuda.synchronize()
            secs[dev] = time.perf_counter() - t0
            got[dev] = (float(loss.detach()), named_grads(model))
        loss_rel, worst, n_held = card_against_cpu(tag, got)
        print(f"{tag} card vs CPU [{smi}] on one batch at the recipe's "
              f"shapes: loss {got[DEVICE][0]:.6f} vs {got['cpu'][0]:.6f} "
              f"(relative {loss_rel:.3e}, tolerance {TRAIN_LOSS_REL}); "
              f"gradients of {n_held} tensors within {worst:.3e} of their "
              f"largest magnitude (tolerance {TRAIN_GRAD_REL}); forward + "
              f"backward {secs[DEVICE]:.2f} s on the card (first call), "
              f"{secs['cpu']:.2f} s on the CPU", flush=True)
        check(loss_rel <= TRAIN_LOSS_REL and worst <= TRAIN_GRAD_REL,
              f"{tag}: the card left the CPU")

        out = out_dir / f"{name}_trained.npz"
        stamps, applied = [], []

        def on_step(it, loss, ok):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            applied.append(ok)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model, hist = mod.train(TRAIN_STEPS, str(out), resume=weights,
                                device=DEVICE, seed=args.seed + 73 + k,
                                log_every=10, on_step=on_step)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        steps_s = np.diff(stamps)
        losses = [h[0] for h in hist]
        print(f"{tag} [{smi}]: {TRAIN_STEPS} steps from {wname}: the pool "
              f"filled and the first step done {stamps[0] - t0:.2f} s after "
              f"the start, then {np.mean(steps_s):.4f} s/step (median "
              f"{np.median(steps_s):.4f}), peak memory {peak:.3f} GB above "
              f"what was allocated before, steps "
              f"applied {sum(applied)}/{TRAIN_STEPS}; losses "
              f"{['%.4f' % x for x in losses]}", flush=True)
        check(len(losses) == TRAIN_STEPS and bool(np.isfinite(losses).all()),
              f"{tag}: a training loss is not finite")
        back, start = load(str(out)), load(weights)
        state = {n: p.cpu() for n, p in model.state_dict().items()}
        same = sorted(back) == sorted(state) and all(
            torch.equal(state[n], back[n]) for n in state)
        moved = max(float((state[n] - start[n]).abs().max()) for n in state)
        runs = []
        for run in range(2):
            m, _ = mod.train(RECIPE_STEPS, str(out_dir / f"{name}_{run}.npz"),
                             resume=weights, device=DEVICE,
                             pool=SamplePool.fixed(items), log_every=10)
            runs.append({n: p.cpu() for n, p in m.state_dict().items()})
        equal = all(torch.equal(runs[0][n], runs[1][n]) for n in runs[0])
        print(f"{tag} checkpoint {out.name}: {out.stat().st_size / 1e6:.1f} "
              f"MB, loaded back {'bitwise equal' if same else 'NOT equal'}; "
              f"the parameters moved up to {moved:.3e} from the start; "
              f"{RECIPE_STEPS} steps on a fixed pool of {len(items)} twice: "
              f"parameters {'bitwise equal' if equal else 'NOT equal'}",
              flush=True)
        check(same, f"{tag}: the checkpoint did not load back bitwise")
        check(moved > 0.0, f"{tag}: the training moved nothing")
        check(equal, f"{tag}: two identical runs parted")


# ---------------------------------------------------------------------------
# phase 16: data parallelism over the keyframe window (parallel: {dp: N})
# ---------------------------------------------------------------------------

DP_GLOO = {"dp": 2, "backend": "gloo", "devices": ["cuda:0", "cuda:0"],
           "verify": True}
DP_NCCL = {"dp": 2, "verify": True}   # cuda:0, cuda:1 over NCCL
DP_K = 8                    # tests/test_parallel.py's keyframes
DP_SURFELS = 37500          # its 200 surfels at 32x32, scaled to 240x800
DP_P_CAP = 1 << 20          # holds the scene's pairs (checked)
DP_CHUNK = 128
DP_GRAD_RTOL, DP_GRAD_ATOL = 2e-4, 1e-6   # dp = 2 against dp = 1
DP_LOSS_REL = 1e-5
# card against the CPU plain path, of each tensor's largest: the kernel's
# bf16 per-pair gradients against the twin's, phase 3's bf16 tolerance
DP_CPU_GRAD = BWD_TOL["bf16"]
DP_SMOKE_FRAMES = 20        # 16c: smoke.yaml's first 20 of its 30 frames
DP_REPLAY_WINDOWS = 1       # 16b's windows (profile_multicard.py: 2)


def child_pids():
    """(pid, command line) of this process's children (Linux /proc)."""
    import os
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != os.getpid():
                continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, ValueError, IndexError):
            continue
        out.append((int(d), cmd.strip()))
    return out


def check_no_children(tag, group):
    """The group's followers have exited and no child process is left but
    multiprocessing's resource tracker (one per interpreter, started by the
    first multiprocessing queue and ended with the interpreter)."""
    import multiprocessing as mp
    kids = [c for c in child_pids() if "resource_tracker" not in c[1]]
    check(group.closed and not group.alive_followers()
          and not mp.active_children() and not kids,
          f"{tag}: children left: {kids}, followers alive "
          f"{group.alive_followers()}")
    print(f"{tag}: the dp group is closed, its followers exited, no child "
          f"process left ({len(child_pids()) - len(kids)} resource "
          f"tracker)", flush=True)


def dp_scene(device, seed=3):
    """tests/test_parallel.py's scene scaled to 240x800: surfels at depth
    2-6 spread over the view, log scale -1.5, opacity logit 1, random
    colours; k random images and depths, all cameras at the origin; focal
    30 x 240 / 32."""
    import torch
    from vings_mono_tpu_torch.mapper.state import adam_init, empty_state
    k, n = DP_K, DP_SURFELS
    rng = np.random.default_rng(seed)
    st = empty_state(1 << 16, device)
    z = rng.uniform(2.0, 6.0, n)
    xyz = np.stack([(rng.uniform(0, 1, n) - 0.5) * z * W / H,
                    (rng.uniform(0, 1, n) - 0.5) * z, z], -1)
    st.xyz[:n] = torch.as_tensor(xyz, dtype=torch.float32)
    st.rgb[:n] = torch.as_tensor(rng.uniform(0, 1, (n, 3)),
                                 dtype=torch.float32)
    st.log_scale[:n] = -1.5
    st.logit_opacity[:n] = 1.0
    st.alive[:n] = True
    f32 = dict(dtype=torch.float32, device=device)
    batch = [torch.as_tensor(rng.uniform(0, 1, (k, 3, H, W)), **f32),
             torch.as_tensor(rng.uniform(2, 6, (k, 1, H, W)), **f32),
             torch.full((k, 1, H, W), 0.01, **f32),
             torch.eye(4, **f32).repeat(k, 1, 1)]
    f = 30.0 * H / 32
    return st, adam_init(st), batch, (f, f, W / 2, H / 2)


def grads_agree(tag, a, b, rtol, atol_of_max=None, atol=0.0):
    """Largest |a - b| beyond rtol |b| over each gradient tensor, checked
    against atol (or atol_of_max of the tensor's largest |b|)."""
    worst = 0.0
    for k in b:
        tol = atol if atol_of_max is None else \
            atol_of_max * float(b[k].abs().max())
        e = float(((a[k].cpu() - b[k].cpu()).abs()
                   - rtol * b[k].cpu().abs()).max())
        check(e <= tol, f"{tag} gradient {k}: {e} past {tol}")
        worst = max(worst, e / max(tol, 1e-30))
    return worst


def dp_grads_phase(args, tk, group, label):
    """16a: sharded_tile_grads through `group` against dp = 1 on the card
    (the same kernels and sums, split over the ranks) and against the CPU
    plain path on one keyframe per rank; both kernels against their plain
    twins on one rank's inputs. Returns the kernels' largest errors and
    the numbers printed."""
    import torch
    from vings_mono_tpu_torch.parallel import mesh
    st, opt, batch, intr4 = dp_scene(DEVICE)
    kw = dict(height=H, width=W, p_cap=DP_P_CAP, chunk=DP_CHUNK)
    mesh.sharded_tile_grads(group, st, opt, *batch, intr4, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g2, v2, l2 = mesh.sharded_tile_grads(group, st, opt, *batch, intr4, **kw)
    torch.cuda.synchronize()
    dp2_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    g1, v1, l1 = mesh.local_grads(st.params(), st.alive, *batch,
                                        intr4, H, W, DP_P_CAP, DP_CHUNK)
    torch.cuda.synchronize()
    dp1_ms = (time.perf_counter() - t0) * 1e3
    l1, l2 = float(l1), float(l2)
    dp = group.dp
    check(abs(l2 - l1) <= DP_LOSS_REL * abs(l1),
          f"16a {label}: loss {l2} at dp {dp}, {l1} at dp 1")
    check(torch.equal(v2, v1), f"16a {label}: visibility differs")
    w1 = grads_agree(f"16a {label} dp {dp} vs dp 1", g2, g1, DP_GRAD_RTOL,
                     atol=DP_GRAD_ATOL)
    print(f"phase 16a sharded_tile_grads [{label}] on tests/test_parallel."
          f"py's scene at {H}x{W} ({DP_SURFELS} surfels, K = {DP_K}, p_cap "
          f"{DP_P_CAP}): loss {l2:.7f} (dp 1 {l1:.7f}), {int(v2.sum())} "
          f"visible; gradients dp {dp} vs dp 1 within {w1:.3e} of rtol "
          f"{DP_GRAD_RTOL} / atol {DP_GRAD_ATOL}; {dp2_ms:.1f} ms at dp "
          f"{dp} ({group.backend}, rank 0 on {group.device}), {dp1_ms:.1f} "
          f"ms at dp 1", flush=True)
    # the CPU plain path on one keyframe per rank
    sub = [x[:dp] for x in batch]
    gs, vs, ls = mesh.sharded_tile_grads(group, st, opt, *sub, intr4, **kw)
    cpu_st = dataclasses.replace(st, **{
        f: getattr(st, f).cpu() for f in ("xyz", "rgb", "log_scale", "quat",
                                          "logit_opacity", "alive")})
    t0 = time.perf_counter()
    gc, vc, lc = mesh.local_grads(
        cpu_st.params(), cpu_st.alive, *[x.cpu() for x in sub], intr4, H, W,
        DP_P_CAP, DP_CHUNK)
    cpu_s = time.perf_counter() - t0
    check(abs(float(ls) - float(lc)) <= DP_LOSS_REL * abs(float(lc)),
          f"16a {label}: loss {float(ls)} on the card, {float(lc)} on CPU")
    check(torch.equal(vs.cpu(), vc), f"16a {label}: visibility differs "
          f"from the CPU's")
    wc = grads_agree(f"16a {label} card vs CPU", gs, gc, 0.0,
                     atol_of_max=DP_CPU_GRAD)
    print(f"phase 16a [{label}] card vs CPU plain path (K = {dp}, one "
          f"keyframe per rank, {cpu_s:.1f} s on the CPU): loss "
          f"{float(ls):.7f} vs {float(lc):.7f}, visibility equal, gradients "
          f"within {wc:.3e} of {DP_CPU_GRAD} x each tensor's largest",
          flush=True)
    # both kernels on rank 1's inputs (its keyframes see the scene from the
    # origin, as rank 0's do)
    intr = {"fu": intr4[1], "fv": intr4[0], "cu": intr4[3], "cv": intr4[2],
            "H": H, "W": W}
    pd, binned, meta = pair_inputs(st, batch[3][DP_K // 2],
                                   {"p_cap": DP_P_CAP, "chunk": DP_CHUNK},
                                   DEVICE, intrinsic=intr)
    check(not bool(binned.overflow), f"16a: {int(binned.n_pairs)} pairs "
          f"overflow p_cap {DP_P_CAP}")
    fwd, bwd, *_ = check_kernels(f"16a rank 1's keyframe ({label})", pd,
                                 binned.tile_chunks, meta, DP_CHUNK,
                                 args.seed + 60, int(binned.n_pairs))
    return {"errs": (fwd, bwd["bf16"]), "loss": l2, "loss_dp1": l1,
            "grad_worst": w1, "ms": dp2_ms, "ms_dp1": dp1_ms,
            "cpu_worst": wc}


def dp_replay_phase(args, tk, cfg, phase4_ms, phase4_psnr, parallel,
                    label, windows=REPLAY_WINDOWS):
    """16b: phase 4's replay through GaussianMapper with `parallel`, every
    call digest-checked across the ranks (`verify`). Returns the numbers
    printed."""
    import torch
    from vings_mono_tpu_torch.runners import run_mapping
    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mapper, records = run_mapping.run(
        dict(cfg, parallel=parallel), str(OUT / f"run_dp_{label}"),
        max_windows=windows)
    run_s = time.perf_counter() - t0
    g = mapper.group
    ranks = {0: {k.__name__: k.launches for k in (tk.rasterize_forward,
                                                  tk.rasterize_backward)}}
    ranks.update(g.launches)
    peak = {0: torch.cuda.max_memory_allocated(), **g.peak_bytes}
    kf_ms = [r["ms"] for r in records]
    iters = len(records) * args.iters
    comm = g.comm_s * 1e3 / iters
    comm_mb = g.comm_bytes / 1e6 / iters
    print(f"phase 16b replay [{label}, {nvidia_smi()}]: {len(records)} "
          f"keyframes x {args.iters} iters in {run_s:.1f} s, keyframe mean "
          f"{np.mean(kf_ms):.1f} ms (phase 4, dp 1: {phase4_ms:.1f} ms); "
          f"collectives {comm:.2f} ms and {comm_mb:.3f} MB per iteration "
          f"on rank 0 ({g.comm_calls} collectives, {g.calls} dp calls, each "
          f"digest-checked); train psnr last {records[-1]['psnr']:.3f} "
          f"(phase 4: {phase4_psnr:.3f}); peak memory per rank "
          f"{ {r: round(b / 1e9, 3) for r, b in peak.items()} } GB; "
          f"launches per rank {ranks}", flush=True)
    check(all(r["losses_finite"] for r in records),
          f"16b {label}: a loss is not finite")
    check(g.calls == 2 * len(records), f"16b {label}: {g.calls} dp calls "
          f"for {len(records)} keyframes")
    for r, counts in ranks.items():
        for name, n in counts.items():
            check(n >= iters, f"16b {label}: rank {r} launched {name} "
                  f"{n} times for {iters} iterations")
    check_no_children(f"phase 16b [{label}]", g)
    return {"kf_ms": float(np.mean(kf_ms)), "psnr": records[-1]["psnr"],
            "comm_ms": comm, "comm_mb": comm_mb,
            "calls": g.comm_calls / iters, "peak": peak, "ranks": ranks}


def dp_smoke_phase(args, tk, smoke_stats, parallel, label):
    """16c: smoke.yaml through runners.run.run with `parallel`. Returns
    the launches summed over the ranks and the numbers printed."""
    import torch
    from vings_mono_tpu_torch.parallel.mesh import digest
    from vings_mono_tpu_torch.runners import run as run_mod
    from vings_mono_tpu_torch.utils.config import load_config
    save_dir = OUT / f"smoke_dp_{label}"
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = load_config(str(SMOKE), overrides={
        "output": {"save_dir": str(save_dir)},
        "device": {"tracker": DEVICE, "mapper": DEVICE},
        "dataset": {"n_frames": DP_SMOKE_FRAMES},
        "parallel": parallel})
    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tracker, mapper, timer = run_mod.run(cfg, str(save_dir),
                                         sync_timer=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    g = mapper.group
    ranks = {0: {k.__name__: k.launches for k in (tk.rasterize_forward,
                                                  tk.rasterize_backward)}}
    ranks.update(g.launches)
    peak = {0: torch.cuda.max_memory_allocated(), **g.peak_bytes}
    print(timer.report().replace("\n", "\nphase 16c ").replace(
        "stage times", "phase 16c stage times"), flush=True)
    stats = run_quality(f"phase 16c [{label}]", cfg, save_dir, tracker,
                        mapper, run_s)
    print(f"phase 16c smoke.yaml [{label}, {nvidia_smi()}]: "
          f"{cfg['dataset']['n_frames']} frames in {run_s:.1f} s, "
          f"{stats['fps']:.3f} frames/s (phase 12, dp 1: "
          f"{smoke_stats['fps']:.3f}), ATE {stats['ate']} (phase 12: "
          f"{smoke_stats['ate']}), PSNR {stats['psnr']} (phase 12: "
          f"{smoke_stats['psnr']}); the mapper trained on "
          f"{mapper.time_idx} keyframes in {g.calls} dp calls; "
          f"collectives {g.comm_s * 1e3:.1f} ms on rank 0's host clock; "
          f"peak memory per rank "
          f"{ {r: round(b / 1e9, 3) for r, b in peak.items()} } GB; "
          f"launches per rank {ranks}", flush=True)
    shared = sorted(set(stats["poses"]) & set(smoke_stats["poses"]))
    dist, ang = pose_gap(stats["poses"], smoke_stats["poses"], shared)
    print(f"phase 16c trajectory against phase 12's: {len(shared)} shared "
          f"keyframe timestamps, largest pose gap {dist:.4e} units / "
          f"{ang:.4f} deg (the map's refined poses feed the tracker, and "
          f"two dp = 1 runs with these random weights also part: phase "
          f"14)", flush=True)
    check(mapper.time_idx >= 10 and g.calls >= 2 * mapper.time_idx,
          f"16c {label}: {mapper.time_idx} keyframes, {g.calls} dp calls")
    check(stats["psnr"] is not None and np.isfinite(stats["psnr"]),
          f"16c {label}: PSNR {stats['psnr']}")
    for r, counts in ranks.items():
        for name, n in counts.items():
            check(n >= mapper.time_idx * int(cfg["training_args"]["iters"]),
                  f"16c {label}: rank {r} launched {name} {n} times")
    check_no_children(f"phase 16c [{label}]", g)
    return {"launches": {name: sum(c[name] for c in ranks.values())
                         for name in ranks[0]},
            "ranks": ranks, "peak": peak, "stats": stats,
            "gap": (len(shared), dist, ang),
            "map": digest([getattr(mapper.state, f) for f in MAP_FIELDS])}


def dp_phase(args, tk, cfg, phase4_ms, phase4_psnr, smoke_stats):
    """Phase 16. Returns the launches of 16c's run summed over the ranks
    and the kernels' largest errors against their twins on 16a's inputs."""
    import gc
    import torch
    from vings_mono_tpu_torch.parallel import mesh
    t_start = time.perf_counter()
    # ranks on one card share its memory: release what the earlier phases
    # left in this process's caching allocator before the followers start
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 16: rank 0 holds {torch.cuda.memory_reserved() / 1e9:.2f} "
          f"GB of the card when the followers start", flush=True)
    runs = [("gloo, cuda:0 x 2", DP_GLOO)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl, cuda:0 + cuda:1", DP_NCCL))
    else:
        print(f"phase 16: NCCL did not run: this machine has "
              f"{torch.cuda.device_count()} CUDA device (NCCL needs one "
              f"card per rank); 16a and 16b ran over Gloo on cuda:0 only. "
              f"profile_multicard.py runs them over NCCL on four cards",
              flush=True)
    errs = []
    for label, parallel in runs:
        group = mesh.make_dp_mesh(parallel["dp"], devices=parallel.get(
            "devices"), backend=parallel.get("backend"))
        group.verify = True
        try:
            errs.append(dp_grads_phase(args, tk, group, label)["errs"])
        finally:
            group.close()
        check_no_children(f"phase 16a [{label}]", group)
        dp_replay_phase(args, tk, cfg, phase4_ms, phase4_psnr, parallel,
                        label, windows=DP_REPLAY_WINDOWS)
    launches = dp_smoke_phase(args, tk, smoke_stats, DP_GLOO,
                              "gloo")["launches"]
    print(f"phase 16 in {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches, [max(e[0] for e in errs), max(e[1] for e in errs)]


# ---------------------------------------------------------------------------
# phase 17: the mesh's sp row split, and mapper.impl: naive
# ---------------------------------------------------------------------------

SP_LOSS_REL = 1e-6          # sp 2 against the whole-image step at 240x800
SP_SMALL_LOSS_REL = 1e-5    # 17b, as tests/test_torch_sp.py
SP_STEPS = 2                # timed steps at each of sp 2 and sp 1
NAIVE_SUB = (5, 10)         # 17c: every 5th row and 10th column: 48x80
NAIVE_MAPPER = {"capacity": 2048, "pair_capacity": 4096, "chunk": 64,
                "kf_capacity": 4, "points_first_frame": 512,
                "points_per_frame": 256, "visible_capacity": 0,
                "impl": "naive"}


def rank_device():
    """The one card every rank of phase 17 shares."""
    return "cuda:0" if DEVICE == "cuda" else DEVICE


def launches_of(tk, group):
    """{rank: {kernel: launches}} since the counters were last zeroed:
    rank 0's counters and the followers' reports."""
    out = {0: {k.__name__: k.launches for k in (tk.rasterize_forward,
                                                tk.rasterize_backward)}}
    out.update(group.launches)
    return out


def zero_launches(tk, group):
    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    group.launches = {}


def sp_full_phase(args, tk, mesh_kw=None, shape=None):
    """17a: the tile step over a mesh on phase 16a's scene at 240x800,
    against the whole-image step; both kernels against their plain twins
    on rank 1's band. The mesh is `make_mesh(**mesh_kw)`, which must have
    `shape`: by default two ranks on cuda:0 over Gloo, (dp, sp) = (1, 2).
    Returns the launches of the mesh's steps summed over the ranks, the
    kernels' largest errors on the band's inputs and the numbers
    printed."""
    import torch
    from vings_mono_tpu_torch.parallel import mesh
    mesh_kw = mesh_kw or {"devices": [rank_device()] * 2, "dp": 1,
                          "backend": "gloo"}
    shape = shape or {"dp": 1, "sp": 2}
    group = mesh.make_mesh(**mesh_kw)
    group.verify = True
    try:
        check(group.shape == shape, f"17a: mesh {group.shape}")
        where = (f"(dp, sp) = ({group.dp}, {group.sp}), {group.world} ranks "
                 f"on {mesh_kw.get('devices', 'every card')} over "
                 f"{group.backend}")
        st, opt, batch, intr4 = dp_scene(DEVICE)
        kw = dict(height=H, width=W, p_cap=DP_P_CAP, chunk=DP_CHUNK)
        g2, v2, l2 = mesh.sharded_tile_grads(group, st, opt, *batch, intr4,
                                             **kw)
        # the pair reduction the mesh's step uses (see sharded_grads)
        reduce = "f32" if group.sp > 1 else "bf16"
        g1, v1, l1 = mesh.local_grads(st.params(), st.alive, *batch, intr4,
                                      H, W, DP_P_CAP, DP_CHUNK, "tile",
                                      reduce)
        l1, l2 = float(l1), float(l2)
        check(abs(l2 - l1) <= SP_LOSS_REL * abs(l1),
              f"17a: loss {l2} at {group.shape}, {l1} whole")
        check(torch.equal(v2, v1), "17a: visibility differs")
        wg = grads_agree(f"17a {group.shape} vs whole", g2, g1,
                         DP_GRAD_RTOL, atol=DP_GRAD_ATOL)
        # the step, the main path of this phase: the mesh, then the whole
        # image
        st_b, opt_b, _, _ = dp_scene(DEVICE)
        comm0, bytes0 = group.comm_s, group.comm_bytes
        calls0 = group.comm_calls
        torch.cuda.reset_peak_memory_stats()
        zero_launches(tk, group)
        ms2 = []
        for i in range(SP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, loss = mesh.sharded_train_step(
                st, opt, *batch, intr4, impl="tile", group=group, **kw)
            torch.cuda.synchronize()
            ms2.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                ls2 = float(loss)
        ranks = launches_of(tk, group)
        peak = {0: torch.cuda.max_memory_allocated(), **group.peak_bytes}
        comm = (group.comm_s - comm0) * 1e3 / SP_STEPS
        comm_mb = (group.comm_bytes - bytes0) / 1e6 / SP_STEPS
        calls = (group.comm_calls - calls0) / SP_STEPS
        ms1 = []
        for i in range(SP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, loss = mesh.sharded_train_step(
                st_b, opt_b, *batch, intr4, impl="tile", **kw)
            torch.cuda.synchronize()
            ms1.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                ls1 = float(loss)
        check(abs(ls2 - ls1) <= SP_LOSS_REL * abs(ls1),
              f"17a: first step's loss {ls2} at {group.shape}, {ls1} with "
              f"no group")
        check(bool(torch.isfinite(st.xyz).all()), "17a: xyz not finite")
        print(f"phase 17a sharded_train_step(impl=tile) [{nvidia_smi()}] at "
              f"{H}x{W} ({DP_SURFELS} surfels, K = {DP_K}, p_cap "
              f"{DP_P_CAP}), {where}, bands {mesh.row_bands(H, group.sp)}: "
              f"loss {l2:.7f} (whole {l1:.7f}), {int(v2.sum())} visible, "
              f"gradients on the mesh vs whole ({reduce} pair reduction) "
              f"within {wg:.3e} of rtol {DP_GRAD_RTOL} / atol "
              f"{DP_GRAD_ATOL}; first step loss {ls2:.7f} (no group "
              f"{ls1:.7f}); ms per step on the mesh "
              f"{[round(x, 1) for x in ms2]}, whole image (no group, bf16 "
              f"pair reduction) {[round(x, 1) for x in ms1]}; collectives "
              f"{comm:.1f} ms and {comm_mb:.3f} MB per step on rank 0; peak "
              f"memory per rank "
              f"{ {r: round(b / 1e9, 3) for r, b in peak.items()} } GB; "
              f"launches per rank {ranks}", flush=True)
        for r, counts in ranks.items():
            for name, n in counts.items():
                check(n >= SP_STEPS * DP_K // group.dp, f"17a: rank {r} "
                      f"launched {name} {n} times in {SP_STEPS} steps")
        # both kernels on rank 1's band (at sp 2 rows 128..239 and the halo
        # from 112; at sp 1 the whole image)
        r0, r1, h0, h1 = mesh.row_bands(H, group.sp)[1 % group.sp]
        band = {"fu": intr4[1], "fv": intr4[0], "cu": intr4[3] - h0,
                "cv": intr4[2], "H": h1 - h0, "W": W}
        pd, binned, meta = pair_inputs(st, batch[3][0], {
            "p_cap": DP_P_CAP, "chunk": DP_CHUNK}, DEVICE, intrinsic=band)
        check(not bool(binned.overflow), f"17a: {int(binned.n_pairs)} pairs "
              f"overflow p_cap {DP_P_CAP}")
        fwd, bwd, *_ = check_kernels(
            f"17a rank 1's band, rows {h0}..{h1 - 1}", pd,
            binned.tile_chunks, meta, DP_CHUNK, args.seed + 70,
            int(binned.n_pairs))
    finally:
        group.close()
    check_no_children("phase 17a", group)
    return ({name: sum(c[name] for c in ranks.values()) for name in ranks[0]},
            (fwd, bwd["f32"]),
            {"shape": group.shape, "loss": l2, "loss_whole": l1,
             "grad_worst": wg, "ms": ms2,
             "ms_whole": ms1, "comm_ms": comm, "comm_mb": comm_mb,
             "calls": calls, "peak": peak, "ranks": ranks})


def sp_grid_phase(tk, mesh_kw=None):
    """17b: (dp, sp) = (2, 2), `make_mesh(**mesh_kw)` (by default four
    ranks on cuda:0 over Gloo), on __graft_entry__.py's dryrun scene
    (32x32, 256 surfels, K = 4), naive and tile, against the whole-image
    step in this process."""
    import torch
    from vings_mono_tpu_torch.mapper.state import adam_init, empty_state
    from vings_mono_tpu_torch.parallel import mesh
    h = w = 32
    rng = np.random.default_rng(0)
    st = empty_state(1024, DEVICE)
    n = 256
    z = rng.uniform(2.0, 6.0, size=n).astype(np.float32)
    xyz = np.stack([(rng.uniform(0, 1, n) - 0.5) * z,
                    (rng.uniform(0, 1, n) - 0.5) * z, z], -1)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    st.xyz[:n] = torch.as_tensor(xyz, **f32)
    st.rgb[:n] = torch.as_tensor(rng.uniform(0, 1, (n, 3)), **f32)
    st.log_scale[:n] = -1.5
    st.logit_opacity[:n] = 1.0
    st.alive[:n] = True
    k = 4
    batch = [torch.as_tensor(rng.uniform(0, 1, (k, 3, h, w)), **f32),
             torch.as_tensor(rng.uniform(2, 6, (k, 1, h, w)), **f32),
             torch.full((k, 1, h, w), 0.01, **f32),
             torch.eye(4, **f32).repeat(k, 1, 1)]
    intr4 = (30.0, 30.0, w / 2, h / 2)
    mesh_kw = mesh_kw or {"devices": [rank_device()] * 4, "dp": 2,
                          "backend": "gloo"}
    group = mesh.make_mesh(**mesh_kw)
    group.verify = True
    try:
        check(group.shape == {"dp": 2, "sp": 2}, f"17b: mesh {group.shape}")
        for impl in ("naive", "tile"):
            opt = adam_init(st)
            g2, v2, l2 = mesh.sharded_grads(group, st, opt, *batch, intr4,
                                            height=h, width=w, impl=impl)
            g1, v1, l1 = mesh.local_grads(st.params(), st.alive, *batch,
                                          intr4, h, w, 4096, 128, impl,
                                          "f32")
            l1, l2 = float(l1), float(l2)
            check(abs(l2 - l1) <= SP_SMALL_LOSS_REL * abs(l1),
                  f"17b {impl}: loss {l2} on the mesh, {l1} whole")
            check(torch.equal(v2, v1), f"17b {impl}: visibility differs")
            wg = grads_agree(f"17b {impl}", g2, g1, DP_GRAD_RTOL,
                             atol=DP_GRAD_ATOL)
            s2 = dataclasses.replace(st, **{
                f: getattr(st, f).clone() for f in ("xyz", "rgb",
                                                    "log_scale", "quat",
                                                    "logit_opacity")})
            zero_launches(tk, group)
            _, _, loss = mesh.sharded_train_step(
                s2, opt, *batch, intr4, height=h, width=w, impl=impl,
                group=group)
            ranks = launches_of(tk, group)
            print(f"phase 17b (dp, sp) = (2, 2) on "
                  f"{mesh_kw.get('devices', 'every card')} over "
                  f"{group.backend}, impl {impl}, {h}x{w}, K = {k}: loss "
                  f"{l2:.7f} (whole "
                  f"{l1:.7f}), step loss {float(loss):.7f}, gradients within "
                  f"{wg:.3e} of rtol {DP_GRAD_RTOL} / atol {DP_GRAD_ATOL}, "
                  f"launches per rank {ranks}", flush=True)
            check(opt.step == 1 and bool(torch.isfinite(s2.xyz).all()),
                  f"17b {impl}: the step did not run")
            want_launches = impl == "tile"
            for r, counts in ranks.items():
                for name, cnt in counts.items():
                    check((cnt > 0) == want_launches, f"17b {impl}: rank {r} "
                          f"launched {name} {cnt} times")
    finally:
        group.close()
    check_no_children("phase 17b", group)


def naive_windows():
    """Three viz_out windows of render_view's road at 48x80 (every 5th row
    and 10th column of 240x800): keyframes 0-1, then 0-2, then 0-3."""
    sy, sx = NAIVE_SUB
    views = [render_view(0.5 * i) for i in range(4)]
    intr = {"fu": INTRINSIC["fu"] / sy, "fv": INTRINSIC["fv"] / sx,
            "cu": INTRINSIC["cu"] / sy, "cv": INTRINSIC["cv"] / sx,
            "H": H // sy, "W": W // sx}
    out = []
    for last in (1, 2, 3):
        ks = list(range(last + 1))
        poses = np.tile(np.eye(4, dtype=np.float32), (len(ks), 1, 1))
        poses[:, 2, 3] = 0.5 * np.asarray(ks)
        out.append({
            "images": np.stack([views[k][0][::sy, ::sx] for k in ks]),
            "depths": np.stack([views[k][1][::sy, ::sx] for k in ks]),
            "depths_cov": np.full((len(ks), H // sy, W // sx, 1), 0.01,
                                  np.float32),
            "poses": poses, "intrinsic": intr,
            "viz_out_idx_to_f_idx": np.asarray(ks, np.float64) * 5,
            "global_kf_id": np.asarray(ks, np.int64)})
    return out


def naive_mapper_phase(tk):
    """17c: GaussianMapper with mapper.impl naive on the card against the
    same on the CPU, per keyframe (tests/test_torch_slice.py's tolerances:
    Gaussians 1 %, loss 1 %, PSNR 0.1 dB); no tile kernel launches."""
    import torch
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
    from vings_mono_tpu_torch.utils.config import load_config
    cfg = load_config(overrides={"mapper": NAIVE_MAPPER,
                                 "training_args": {"iters": 10}})
    zero = {k: k.launches for k in (tk.rasterize_forward,
                                    tk.rasterize_backward)}
    mappers = {d: GaussianMapper(cfg, device=d) for d in (DEVICE, "cpu")}
    secs = {d: 0.0 for d in mappers}
    for i, viz in enumerate(naive_windows()):
        row = {}
        for d, m in mappers.items():
            t0 = time.perf_counter()
            m.run(viz)
            if d == DEVICE:
                torch.cuda.synchronize()
            secs[d] += time.perf_counter() - t0
            row[d] = (m.n_alive, m.last_metrics)
        (na, ma), (nb, mb) = row[DEVICE], row["cpu"]
        print(f"phase 17c keyframe {i} (impl naive, {viz['intrinsic']['H']}"
              f"x{viz['intrinsic']['W']}): card n_alive {na} loss "
              f"{ma['total']:.6f} psnr {ma['psnr']:.4f}; CPU n_alive {nb} "
              f"loss {mb['total']:.6f} psnr {mb['psnr']:.4f}", flush=True)
        check(nb > 100 and abs(na - nb) <= 0.01 * nb,
              f"17c: n_alive {na} on the card, {nb} on the CPU")
        check(abs(ma["total"] - mb["total"]) <= 0.01 * abs(mb["total"]),
              f"17c: loss {ma['total']} on the card, {mb['total']} on CPU")
        check(abs(ma["psnr"] - mb["psnr"]) <= 0.1,
              f"17c: psnr {ma['psnr']} on the card, {mb['psnr']} on CPU")
    ran = {k.__name__: k.launches - n for k, n in zero.items()}
    check(not any(ran.values()), f"17c: tile kernels launched under "
          f"mapper.impl naive: {ran}")
    check(not mappers[DEVICE].state.local_scores.any(),
          "17c: scores moved on the naive path")
    print(f"phase 17c: card {secs[DEVICE]:.1f} s, CPU {secs['cpu']:.1f} s "
          f"for 3 keyframes; tile kernel launches {ran}", flush=True)


def sp_phase(args, tk):
    """Phase 17. Returns 17a's launches summed over the ranks and the
    kernels' largest errors on rank 1's band."""
    import gc
    import torch
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    launches, errs, _ = sp_full_phase(args, tk)
    sp_grid_phase(tk)
    naive_mapper_phase(tk)
    print(f"phase 17 in {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches, errs


# ---------------------------------------------------------------------------
# phase 18: the evaluation entry points
# ---------------------------------------------------------------------------

def eval_runs():
    """(entry point, arguments, the keys its JAX script prints) of phase
    18, at reduced depth, with the weights named absolutely."""
    sp = ["--weights", str(WEIGHTS_DIR / "superpoint_selftrained.npz")]
    droid = str(WEIGHTS_DIR / "droid_selftrained.npz")
    return (
        ("eval_superpoint", ["--pairs", "3"] + sp,
         ("trained", "random", "pairs", "trained_beats_random")),
        ("eval_droid", ["--frames", "16", "--weights", droid],
         ("random", "trained", "trained_gated", "frames",
          "trained_beats_random", "gating_selective")),
        ("eval_track_long", ["--frames", "16", "--grid", "2x1",
                             "--weights", droid],
         ("2x1", "frames", "revs")),
        ("eval_loop_e2e", ["--frames", "48", "--skip-baseline",
                           "--droid-weights", droid] + sp,
         ("frames", "keyframes", "detect_attempts", "loops_closed",
          "closed_at", "ate_rmse_m", "ate_no_loop_m", "closure_deltas",
          "stage_histogram", "loop_traces", "traces")),
        ("eval_long_run", ["--frames", "32", "--skip-baseline",
                           "--droid-weights", droid] + sp,
         ("frames", "revs", "full")))


@contextlib.contextmanager
def recorded_builds():
    """runners.run.build with each build's parts kept, and each mapper's
    last mapped window (its newest keyframe's c2w and intrinsics)."""
    from vings_mono_tpu_torch.runners import run as run_mod
    from vings_mono_tpu_torch.utils.vis import host_array
    builds = []
    build = run_mod.build

    def rec(cfg, device=None):
        parts = build(cfg, device=device)
        mapper, last = parts[2], {}
        run = mapper.run

        def mapped(viz_out):
            last.update(c2w=host_array(viz_out["poses"][-1]),
                        intr=dict(viz_out["intrinsic"]))
            return run(viz_out)
        mapper.run = mapped
        builds.append((cfg, parts, last))
        return parts
    with replaced(run_mod, "build", rec):
        yield builds


def eval_phase(args, tk):
    """Phase 18: the five evaluation entry points at reduced depth on the
    card; both kernels against their plain twins on the final maps of
    eval_loop_e2e and eval_long_run. Returns the launch counts of those
    two runs and the kernels' largest errors."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    root = OUT / "eval"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_start = time.perf_counter()
    launches, errs = {}, [0.0] * 4
    for name, argv, keys in eval_runs():
        mod = importlib.import_module(f"vings_mono_tpu_torch.runners.{name}")
        out_path = root / f"{name}.json"
        tk.rasterize_forward.launches = 0
        tk.rasterize_backward.launches = 0
        t0 = time.perf_counter()
        with recorded_builds() as builds, \
                open(root / f"{name}.log", "w") as log, \
                contextlib.redirect_stdout(log):
            out = mod.main(argv + ["--out", str(out_path), "--device",
                                   DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {"rasterize_forward": tk.rasterize_forward.launches,
             "rasterize_backward": tk.rasterize_backward.launches}
        check(json.loads(out_path.read_text()) == json.loads(
            json.dumps(out)), f"phase 18 {name}: --out differs")
        missing = [k for k in keys if k not in out]
        check(not missing, f"phase 18 {name}: keys {missing} missing")
        nums = eval_numbers(name, out)
        check(all(a is not None and np.isfinite(a) for a in nums),
              f"phase 18 {name}: not finite: {nums}")
        print(f"phase 18 {name} {' '.join(argv[:4])}: {wall:.1f} s; "
              f"{eval_summary(name, out)}; launches {n}", flush=True)
        if name not in ("eval_loop_e2e", "eval_long_run"):
            continue
        check(len(builds) == 1, f"phase 18 {name}: {len(builds)} builds")
        cfg, parts, last = builds[0]
        _, tracker, mapper, _, looper = parts[:5]
        for what, dev in (("tracker", tracker.device),
                          ("mapper", mapper.device),
                          ("detector", looper.detector.device)):
            check(torch.device(dev).type == "cuda",
                  f"phase 18 {name}: the {what} sits on {dev}")
        iters = int(cfg["training_args"]["iters"])
        for kname, cnt in n.items():
            check(cnt >= mapper.time_idx * iters, f"phase 18 {name}: "
                  f"{kname} launched {cnt} times for {mapper.time_idx} "
                  f"keyframes x {iters} iterations")
        launches[name] = n
        e = kernels_on(f"phase 18 {name}", [(
            "the final map under the last mapped keyframe's camera",
            mapper.state, last["c2w"], last["intr"])],
            dict(mapper.bin_kwargs), args.seed + 70)
        errs = [max(x, y) for x, y in zip(errs, e)]
        del builds, parts, tracker, mapper, looper
    print(f"phase 18 in {time.perf_counter() - t_start:.1f} s", flush=True)
    return launches, errs


def eval_numbers(name, out):
    """The numbers of an evaluation that must be finite: its ATEs (and
    PSNR), or SuperPoint's match counts."""
    if name == "eval_superpoint":
        return [out["trained"]["mean_matches"],
                out["random"]["mean_matches"]]
    if name == "eval_droid":
        return [out[k]["ate_rmse_m"] for k in ("random", "trained",
                                                "trained_gated")]
    if name == "eval_track_long":
        return [out["2x1"]["ate_rmse_m"]]
    if name == "eval_loop_e2e":
        return [out["ate_rmse_m"]]
    return [out["full"][k] for k in ("ate_online_m",
                                     "ate_after_global_ba_m", "psnr")]


def eval_summary(name, out):
    if name == "eval_superpoint":
        return "; ".join(f"{k}: {out[k]['mean_matches']:.1f} matches, PnP "
                         f"{out[k]['pnp_success']}/{out['pairs']}"
                         for k in ("trained", "random"))
    if name == "eval_droid":
        return "; ".join(f"{k}: ATE {out[k]['ate_rmse_m']:.4f}, "
                         f"{out[k]['n_keyframes']} keyframes"
                         for k in ("random", "trained", "trained_gated"))
    if name == "eval_track_long":
        return f"2x1: ATE {out['2x1']['ate_rmse_m']:.4f}"
    if name == "eval_loop_e2e":
        return (f"{out['keyframes']} keyframes, {out['detect_attempts']} "
                f"detect attempts, {out['loops_closed']} loops closed, ATE "
                f"{out['ate_rmse_m']:.4f}, stages {out['stage_histogram']}")
    f = out["full"]
    return (f"{f['keyframes']} keyframes, {f['loops_closed']} loops closed, "
            f"ATE {f['ate_online_m']:.4f} -> {f['ate_after_global_ba_m']:.4f} "
            f"after global BA, PSNR {f['psnr']:.3f} dB, peak "
            f"{f['peak_gaussians']} Gaussians, pages out/in "
            f"{f['pages_out']}/{f['pages_in']}")


# ---------------------------------------------------------------------------
# phase 19: the bench (runners/bench.py) at full width, reduced depth

BENCH_SIZES = {"n_warm": 10, "n_meas": 2, "g_warm": 28}


def bench_phase(args, tk):
    """Phase 19: runners.bench.run's two lanes; both kernels on each
    lane's final map at chunk 256 and at chunk 512. Returns the launch
    counts of the run, the kernels' largest errors (forward, bf16
    backward) and their ms at chunk 512 on the all-keyframe map."""
    import gc
    import torch
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
    from vings_mono_tpu_torch.runners import bench
    from vings_mono_tpu_torch.utils.vis import host_array
    gc.collect()
    torch.cuda.empty_cache()
    last = {}
    run = GaussianMapper.run

    def recording(self, viz_out):
        if viz_out is not None:
            last[id(self)] = (host_array(viz_out["poses"][-1]),
                              dict(viz_out["intrinsic"]))
        return run(self, viz_out)
    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    t0 = time.perf_counter()
    with replaced(GaussianMapper, "run", recording):
        out, lanes = bench.run(DEVICE, str(WEIGHTS), **BENCH_SIZES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {"rasterize_forward": tk.rasterize_forward.launches,
         "rasterize_backward": tk.rasterize_backward.launches}
    print(f"phase 19 bench {BENCH_SIZES}: {wall:.1f} s; {json.dumps(out)}; "
          f"launches {n}", flush=True)
    check(tuple(out) == bench.KEYS, f"phase 19: keys {tuple(out)}")
    check(all(np.isfinite(out[k]) for k in bench.KEYS
              if k not in ("metric", "unit")), "phase 19: not finite")
    check(out["value"] > 0 and out["allkf_fps"] > 0
          and out["gated_keyframe_frac"] > 0 and out["mfu"] > 0,
          f"phase 19: a lane did not run: {out}")
    for name, cnt in n.items():
        check(cnt > 0, f"phase 19: {name} never launched")
    blocks = []
    for lane, (tracker, mapper) in lanes.items():
        for what, dev in (("tracker", tracker.device),
                          ("mapper", mapper.device)):
            check(torch.device(dev).type == "cuda",
                  f"phase 19 {lane}: the {what} sits on {dev}")
        check(mapper.time_idx > 0 and id(mapper) in last,
              f"phase 19 {lane}: nothing mapped")
        if id(mapper) not in last:
            continue
        c2w, intr = last[id(mapper)]
        blocks.append((f"the {lane} lane's final map", mapper.state, c2w,
                       intr))
    kw = dict(lanes["allkf"][1].bin_kwargs)
    check(kw["chunk"] == 256, f"phase 19: chunk {kw['chunk']}")
    errs = kernels_on("phase 19 chunk 256", blocks, kw, args.seed + 80)
    kw512 = dict(kw, chunk=512)
    errs = [max(a, b) for a, b in zip(errs, kernels_on(
        "phase 19 chunk 512", blocks, kw512, args.seed + 81))]
    attrs = tk.kernel_attributes(512)
    _, state, c2w, intr = blocks[0]
    w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                          device=DEVICE)
    ms = {}
    for chunk in (256, 512):
        pd, binned, meta = pair_inputs(state, w2c, dict(kw, chunk=chunk),
                                       DEVICE, intrinsic=intr)
        tc = binned.tile_chunks
        o = tk.rasterize_forward(pd, tc, meta, chunk)
        g = torch.randn_like(o)
        ms[chunk] = (
            cuda_ms(lambda: tk.rasterize_forward(pd, tc, meta, chunk), 50),
            cuda_ms(lambda: tk.rasterize_backward(
                pd, tc, meta, chunk, o, g, out_dtype=torch.bfloat16), 50))
    print(f"phase 19 kernels at chunk 512: shared memory forward "
          f"{attrs['rasterize_forward']['smem_bytes']} B, backward "
          f"{attrs['rasterize_backward_bf16']['smem_bytes']} B, blocks/SM "
          f"{attrs['rasterize_forward']['blocks_per_sm']} / "
          f"{attrs['rasterize_backward_bf16']['blocks_per_sm']}; on the "
          f"all-keyframe map ({int(binned.n_pairs)} pairs, p_cap "
          f"{kw['p_cap']}) forward {ms[256][0]:.4f} ms at chunk 256, "
          f"{ms[512][0]:.4f} at 512; backward bf16 {ms[256][1]:.4f} / "
          f"{ms[512][1]:.4f} ms; largest errors {errs}", flush=True)
    return n, errs, ms[512]


# ---------------------------------------------------------------------------
# phase 20: the shipped configuration families at full width
# ---------------------------------------------------------------------------

def families_phase(args):
    """Phase 20: profile_configs.py's families but F8, which is phase
    15d (F1 Waymo vo_nerfslam, F2 KITTI-360 vio + v0_kitti360, F3 RTG, F4
    Hierarchical + npz prior, F5 KITTI loop closure, F6 Waymo npz prior +
    refine + vis, F7 pocket through run_mobile) through their entry
    points at their committed
    configurations' full widths, each on a folder written in its dataset
    module's layout, at the fewest frames that map two windows (F5: that
    reach its first loop calls; an attempt needs min_history 35
    keyframes, which these frames do not make, so the loop detector is
    then called directly on the final state).
    `profile_configs.run_family` checks each run (two windows, both
    kernels on every training and refinement iteration, finite poses and
    map; F6's refined windows, F7's .ply files) and holds both kernels
    against their plain twins on its
    final map. A thread writes the next family's folder while one runs.
    Returns each family's launches and the kernels' largest errors."""
    from concurrent.futures import ThreadPoolExecutor
    import profile_configs as pc
    launches, errs = {}, [0.0, 0.0, 0.0, 0.0]
    root = OUT / "families"
    shutil.rmtree(root, ignore_errors=True)

    def write(key):
        fam = pc.FAMILIES[key]
        cfg = pc.family_cfg(fam, root / key / "folder", root / key, DEVICE)
        return pc.write_folder(fam, root / key / "folder", fam.smoke_frames,
                               cfg, workers=6)
    keys = [k for k in pc.FAMILIES if k != "F8"]
    with ThreadPoolExecutor(1) as writer:
        written = {key: writer.submit(write, key) for key in keys}
        for key in keys:
            fam = pc.FAMILIES[key]
            t0 = time.perf_counter()
            rec = pc.run_family(fam, fam.smoke_frames, root / key, DEVICE,
                                args.seed, tag=f"phase 20 {key}",
                                written=written[key])
            if key == "F5":
                # no attempt is possible here: the newest keyframe is
                # younger than min_history; the detector is then called
                # directly on the final state
                check(rec["stage_n"].get("loop", 0) >= 1,
                      "phase 20 F5: the looper never ran")
                check(bool(rec["loop_attempts"] or rec.get("direct_detect")),
                      "phase 20 F5: the loop detector never ran")
            if key == "F6":
                check(rec["refine_iters"] > 0, "phase 20 F6: nothing was "
                      "refined")
            launches[key] = rec["launches"]
            got = [rec["max_abs_err"]["rasterize_forward"],
                   rec["max_abs_err"]["rasterize_backward"],
                   rec["max_err_over_scale"]["rasterize_forward"],
                   rec["max_err_over_scale"]["rasterize_backward"]]
            errs = [max(a, b) for a, b in zip(errs, got)]
            print(f"phase 20 {key} in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return launches, errs


def run_worker(args):
    """Phases 9, 18 and 20 in a process of their own (`--worker PATH`),
    which main() starts after phase 8 and joins after phase 15, so that
    they run beside phases 11-15: the card and the host's cores have room
    for both, and the script keeps inside its time. No profiled or timed
    phase (5-8, 10, 16, 17, 19) runs beside it. Writes their launches and
    the kernels' largest errors to PATH as JSON."""
    from vings_mono_tpu_torch.utils.device import resolve_device
    resolve_device(DEVICE)
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    t0 = time.perf_counter()
    smoke_launches, smoke_errs = smoke_vio_phase(args, tk)
    print(f"chip_smoke worker: phase 9 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    eval_launches, eval_errs = eval_phase(args, tk)
    print(f"chip_smoke worker: phase 18 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    family_launches, family_errs = families_phase(args)
    print(f"chip_smoke worker: phase 20 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    pathlib.Path(args.worker).write_text(json.dumps({
        "smoke_vio_launches": smoke_launches, "smoke_vio_errs": smoke_errs,
        "eval_launches": eval_launches, "eval_errs": eval_errs,
        "family_launches": family_launches, "family_errs": family_errs}))


def start_worker(args):
    """The worker process of phases 9, 18 and 20, its output to a log."""
    import subprocess
    out = OUT / "worker.json"
    out.unlink(missing_ok=True)
    log = open(OUT / "worker.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
         str(args.seed), "--worker", str(out)], cwd=str(ROOT),
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    print(f"chip_smoke: phases 9, 18 and 20 run in worker process "
          f"{proc.pid} beside phases 11-15 (its output follows phase 15)",
          flush=True)
    return proc, out


def join_worker(proc, out, timeout):
    """Wait for the worker, print its output, fail unless it passed;
    returns its JSON."""
    try:
        rc = proc.wait(timeout=timeout)
    except Exception:
        proc.kill()
        proc.wait()
        raise
    print((OUT / "worker.log").read_text(), end="", flush=True)
    check(rc == 0 and out.is_file(), f"the worker of phases 9, 18 and 20 "
          f"exited {rc}")
    return json.loads(out.read_text())


def nvidia_smi():
    from vings_mono_tpu_torch.runners.eval_all import card_line
    return card_line()

# ---------------------------------------------------------------------------

def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--keyframes", type=int, default=6)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--vo-frames", type=int, default=70,
                   help="camera frames of phase 7")
    p.add_argument("--vio-frames", type=int, default=60,
                   help="camera frames of phase 8")
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return run_worker(args)

    t_start = time.perf_counter()
    laps = [t_start]

    def lap(what):
        now = time.perf_counter()
        print(f"chip_smoke: {what} in {now - laps[-1]:.1f} s", flush=True)
        laps.append(now)
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from vings_mono_tpu_torch.utils.device import resolve_device
    # before the first cuBLAS call: the runners' reproducible mode needs
    # cuBLAS's workspace fixed
    device = resolve_device(DEVICE)
    from vings_mono_tpu_torch.utils import cuda_build
    from vings_mono_tpu_torch.utils.config import load_config
    from vings_mono_tpu_torch.mapper.state import adam_init, empty_state
    from vings_mono_tpu_torch.mapper.densify import add_frame, draw_densify
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    from vings_mono_tpu_torch.ops.rasterizer.projection import PK_DIM
    from vings_mono_tpu_torch.runners import run_mapping
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
    fwd_err, bwd_err, evals, hits, culled, _ = check_kernels(
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
    del mapper
    lap("phases 1-6")
    # ---- 7. the VO slice, then 10. global BA on its tracker
    vo_launches, _, _, vo_tracker, vo_cfg = vo_slice(args, tk)
    backend_defaults = global_ba_phase(vo_tracker, vo_cfg)
    del vo_tracker
    banded_at_scale(backend_defaults, H // 8, W // 8)
    lap("phases 7 and 10")
    # ---- 8. the VIO + storage slice (with vis)
    vio_launches = vio_slice(args, tk)
    lap("phase 8")
    # ---- 9. smoke_vio.yaml as committed, 18 and 20 run in a worker
    # process beside phases 11-15
    worker, worker_out = start_worker(args)
    try:
        # ---- 11. the mapper's options on phase 4's replay
        opt_launches = mapper_options_phase(
            args, tk, cfg, float(np.mean(kf_ms)), win_dir, args.seed)
        lap("phase 11")
        # ---- 12. smoke.yaml as committed: loop closure and dynamic masks
        all_launches, all_errs, end, smoke_stats = smoke_phase(args, tk)
        lap("phase 12")
        # ---- 13. the learned nets and the rectification, card against CPU
        detector_phase(args.seed + 40)
        fastsam_phase(args.seed + 41)
        retrain_errs = rectification_phase(end, args.seed + 50)
        del end
        # phase 12's loop renders and phase 13's retrain
        all_errs = [max(x, y) for x, y in zip(all_errs, retrain_errs)]
        lap("phase 13")
        # ---- 14. metric depth, sessions, the evaluation harness
        metric_launches, metric_errs = metric_session_phase(args, tk)
        lap("phase 14")
        # ---- 15. the kitti_sync folder through the runners: the main path;
        # then the trainer
        folder_launches, main_errs = kitti_folder_phase(args, tk)
        lap("phase 15a-d")
        train_phase(args)
        recipe_phase(args)
        lap("phase 15e")
        # ---- 9. smoke_vio.yaml, 18. the evaluation entry points and 20.
        # the shipped configuration families at full width, from the worker
        got = join_worker(worker, worker_out, timeout=1200)
        lap("the wait for the worker (phases 9, 18 and 20)")
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
    smoke_launches = got["smoke_vio_launches"]
    smoke_errs = got["smoke_vio_errs"]
    eval_launches, eval_errs = got["eval_launches"], got["eval_errs"]
    family_launches = got["family_launches"]
    family_errs = got["family_errs"]
    # ---- 16. data parallelism over the keyframe window
    dp_launches, dp_errs = dp_phase(
        args, tk, cfg, float(np.mean(kf_ms)), records[-1]["psnr"],
        smoke_stats)
    lap("phase 16")
    # ---- 17. the mesh's sp row split, and mapper.impl: naive
    sp_launches, sp_errs = sp_phase(args, tk)
    lap("phase 17")
    # ---- 19. the bench
    bench_launches, bench_errs, bench_ms512 = bench_phase(args, tk)
    lap("phase 19")
    kernels = []
    for name, line, err, err_rel, err_metric, err_smoke, err_vio, \
            err_800 in (
            ("rasterize_forward", 263, main_errs[0], main_errs[2],
             metric_errs[0], all_errs[0], smoke_errs[0], fwd_err),
            ("rasterize_backward", 423, main_errs[1], main_errs[3],
             metric_errs[1], all_errs[1], smoke_errs[1], bwd_err["bf16"])):
        key = "fwd" if name.endswith("forward") else "bwd"
        bnd = fwd_bound if key == "fwd" else bwd_bound
        kernels.append({
            "name": name, "route": "cuda",
            "source": "vings_mono_tpu_torch/csrc/rasterizer.cu",
            "replaces": f"vings_mono_tpu/ops/rasterizer/tile_kernel.py:{line}",
            "launches": folder_launches["a"][name],
            "launches_multiprocess": folder_launches["c"][name],
            "launches_mobile": folder_launches["d"][name],
            "launches_metric_session": metric_launches[name],
            "launches_dp": dp_launches[name],
            "launches_sp": sp_launches[name],
            "launches_eval_loop_e2e": eval_launches["eval_loop_e2e"][name],
            "launches_eval_long_run": eval_launches["eval_long_run"][name],
            "launches_bench": bench_launches[name],
            **{f"launches_config_{k}": n[name]
               for k, n in family_launches.items()},
            "launches_smoke": all_launches[name],
            "launches_smoke_vio": smoke_launches[name],
            "launches_vio": vio_launches[name],
            "launches_vo": vo_launches[name],
            "launches_mapping_replay": launches[name],
            **{f"launches_{o}": n[name] for o, n in opt_launches.items()},
            # the backward's rows reach ~1e9 at edge-on pairs (1/den), so
            # its absolute error is read against the row maximum
            "max_abs_err": err, "max_err_over_scale": err_rel,
            "max_abs_err_metric_session": err_metric,
            "max_abs_err_dp": dp_errs[0 if key == "fwd" else 1],
            "max_abs_err_sp": sp_errs[0 if key == "fwd" else 1],
            "max_abs_err_eval": eval_errs[0 if key == "fwd" else 1],
            "max_abs_err_bench": bench_errs[0 if key == "fwd" else 1],
            "max_abs_err_configs": family_errs[0 if key == "fwd" else 1],
            "max_err_over_scale_configs":
                family_errs[2 if key == "fwd" else 3],
            "ms_chunk512_bench": bench_ms512[0 if key == "fwd" else 1],
            "max_abs_err_smoke": err_smoke,
            "max_abs_err_smoke_vio": err_vio,
            "max_abs_err_trained_240x800": err_800,
            "ms": times[key],
            "plain_ms": times[key + "_plain"], "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None})
    print(f"chip_smoke: phases 1-20 in {time.perf_counter() - t_start:.1f} "
          f"s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
