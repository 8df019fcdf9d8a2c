"""Five shipped configuration families on one card at full width.

    python3 profile_configs.py [--family F1 ...] [--seed 0] [--device cuda]

Needs a CUDA card (about 10 minutes on one H100). Each family runs through
`runners.run.run`, the entry point of `python -m
vings_mono_tpu_torch.runners.run <config>`, with its configuration as
committed. Real Waymo, KITTI-360, RTG, Hierarchical-3DGS and KITTI frames
are not in the repository, so each family's folder is written here in its
dataset module's layout: the procedural `synthetic3d` room ray-cast at the
configuration's source resolution and intrinsics along the room's
trajectory, so the loader's own decode, crop and resize run. The only
overrides (`OVERRIDES`, each with its reason): dataset.root (and the
metric prior's root under it), the DroidNet weights, the loop detector's
SuperPoint and LightGlue weights, output.save_dir and the device.

  F1 configs/waymo/nerfslam/Scene01.yaml: mode vo_nerfslam, color/*.jpg
     at 1280x1920 -> 344x616;
  F2 configs/kitti360/unsync/kitti360_2013_05_28_drive_0000.yaml: mode
     vio, middleware v0_kitti360, storage paging, vis, save_buffer 8000;
     image_00/data_rect/*.png at 512x1392 -> 264x728, metadata/
     camstamp.txt at 10 Hz, a 100 Hz IMU written 0.04 s late (the loader's
     default shift), c2i.txt;
  F3 configs/rtg/hotel.yaml: mode vo, vis; nosky_color/<i>.jpg at
     720x1280, cropped by 15 px and resized to 360x640;
  F4 configs/hierarchical/smallcity.yaml: mode vo with the metric prior
     from precomputed maps (metric.backend npz): color/*.png at 690x1024 ->
     344x616 and one .npy of the room's depth per frame;
  F5 configs/kitti/sync/kitti_2011_10_03_drive_0027_LC.yaml: mode vio with
     loop closure; the kitti_sync layout at 376x1241 -> 344x616 (IMU
     written 0.07 s late), on a path that comes round more than once, so
     the detector has a revisit to find (the run's VIO positions run away
     after VI init, whose alignment fails or mis-scales on these poses,
     and its looper finds no candidate: ROADMAP.md's recorded
     divergences).

For each family it prints frames/s; the stage ms (track, package, map and
metric / loop / storage / vis where the family has them); host ms per
`dataset[idx]`; peak device memory; keyframes and windows mapped; the ATE
against pose/ and the PSNR (`runners/evaluate.py`) and the last train
PSNR; the launches of each tile kernel, checked on every training
iteration; both kernels against their plain twins on the final map under
the newest mapped keyframe's camera whose depths were kept; for the vio
families whether VI init's alignment succeeded; for F5 the stage each
loop attempt reached and what the candidate search saw, and where the
run made no attempt, the stage of one direct call of the detector on
the final state (the newest keyframe against the one nearest it in the
ground truth). F1 runs twice, and the rerun must equal the first bit for bit
(`utils.device.reproducible`). The card's name and power limit precede
the last line, one JSON record of every number. Without a card it exits
1 (with `--device cpu` the kernels' plain twins run and the kernel checks
are skipped: a rehearsal, not a measurement). chip_smoke.py phase 20
runs the same families at the fewest frames that map two windows.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

OUT = ROOT / "output" / "profile_configs"
WEIGHTS_DIR = ROOT / "vings_mono_tpu/weights"
REVS_PER_FRAME = 0.01      # chip_smoke.py phase 7's pace: ~0.11 room units
IMU_DT = 0.1               # KITTI's and KITTI-360's 10 Hz cameras


class Family:
    """One shipped configuration, the layout its loader reads, and how
    far to run it: `frames` in profile_configs.py, `smoke_frames` in
    chip_smoke.py phase 20 (the fewest that map two windows; F5's the
    fewest that reach its first loop calls)."""

    def __init__(self, key, config, layout, frames, smoke_frames,
                 revs_per_frame=REVS_PER_FRAME):
        self.key, self.config, self.layout = key, ROOT / config, layout
        self.frames, self.smoke_frames = frames, smoke_frames
        self.revs_per_frame = revs_per_frame


FAMILIES = {f.key: f for f in (
    Family("F1", "configs/waymo/nerfslam/Scene01.yaml", "waymo", 30, 10),
    # v0_kitti360 packages the keyframes a rollup saved: the second window
    # needs the second rollup (rollup_at 65, rollup_n 30: ~96 keyframes)
    Family("F2", "configs/kitti360/unsync/"
           "kitti360_2013_05_28_drive_0000.yaml", "kitti360", 160, 136),
    Family("F3", "configs/rtg/hotel.yaml", "rtg", 30, 20),
    Family("F4", "configs/hierarchical/smallcity.yaml", "hierarchical", 30,
           25),
    # one and a quarter turns of the room in 96 frames: frame k + 77
    # revisits frame k, more than the looper's min_history (35) keyframes
    # later
    Family("F5", "configs/kitti/sync/kitti_2011_10_03_drive_0027_LC.yaml",
           "kitti_sync", 96, 32, revs_per_frame=1.25 / 96))
}

# what each family's run sets on top of the committed configuration
OVERRIDES = [
    ("dataset.root", "the folder this script writes", "the datasets' "
     "frames are not in the repository"),
    ("metric.root (F4)", "<folder>/metric_depth", "the committed path lies "
     "under the dataset's root"),
    ("frontend.weight", "vings_mono_tpu/weights/droid_selftrained.npz",
     "checkpoints/droid.pth is not in the repository"),
    ("looper.superpoint_weights (F5)",
     "vings_mono_tpu/weights/superpoint_selftrained.npz", "the committed "
     "configuration names none: SuperPoint would run on random weights"),
    ("looper.lightglue_weights (F5)",
     "vings_mono_tpu/weights/lightglue_selftrained.npz", "the committed "
     "configuration names none: the detector would match by mutual "
     "nearest neighbours and LightGlue would not run"),
    ("output.save_dir", "under output/profile_configs (or chip_smoke's)",
     "the committed directory is the user's"),
    ("device", "tracker and mapper on the card", "the run's device"),
]


# ---------------------------------------------------------------------------
# the folder writers
# ---------------------------------------------------------------------------

def source_intrinsic(cfg, size=None):
    """[fx, fy, cx, cy] of the config's `intrinsic` block at its source
    resolution, or scaled to `size` (h, w); the block names rows u and
    columns v. Returns (intr, h, w)."""
    ic = cfg["intrinsic"]
    h, w = size or (int(ic["H"]), int(ic["W"]))
    sy, sx = h / float(ic["H"]), w / float(ic["W"])
    return (np.asarray([ic["fv"] * sx, ic["fu"] * sy, ic["cv"] * sx,
                        ic["cu"] * sy], np.float64), h, w)


def write_folder(family, folder, n, cfg, size=None, workers=8, pace=None):
    """Write `n` frames of the room in `family`'s dataset layout under
    `folder` at the config's source resolution (or `size`), with
    ground-truth poses in pose/<t>.txt; for a `vio` family the IMU stream
    of the same trajectory, written as late as its loader shifts it back.
    `pace`: turns of the room per frame (default the family's). Returns
    the seconds it took."""
    import cv2
    from vings_mono_tpu_torch.datasets.synthetic3d import (
        render_room, texture_params, trajectory_c2w)
    t0 = time.perf_counter()
    folder = pathlib.Path(folder)
    shutil.rmtree(folder, ignore_errors=True)
    layout = family.layout
    intr, h, w = source_intrinsic(cfg, size)
    revs = (pace or family.revs_per_frame) * n
    tex = texture_params(0)
    timed = layout in ("kitti360", "kitti_sync")
    img_dir = {"waymo": "color", "hierarchical": "color",
               "rtg": "nosky_color", "kitti360": "image_00/data_rect",
               "kitti_sync": "image_02/data"}[layout]
    for d in (img_dir, "pose") + (("metadata",) if timed else ()) + (
            ("metric_depth",) if layout == "hierarchical" else ()):
        (folder / d).mkdir(parents=True, exist_ok=True)

    def one(k):
        c2w = trajectory_c2w(k, n, revs=revs)
        rgb, depth = render_room(c2w, intr, h, w, tex=tex)
        bgr = np.round(rgb[..., ::-1] * 255).astype(np.uint8)
        name = {"waymo": f"{k:06d}.jpg", "hierarchical": f"{k:06d}.png",
                "rtg": f"{k}.jpg"}.get(layout, f"{k:010d}.png")
        cv2.imwrite(str(folder / img_dir / name), bgr)
        if layout == "hierarchical":
            np.save(folder / "metric_depth" / f"{k:06d}.npy", depth)
        t = k * IMU_DT if timed else float(k)
        np.savetxt(folder / "pose" / (f"{t:.6f}.txt" if timed
                                      else f"{k}.txt"), c2w)
        return f"{t:.6f} {name}"
    with ThreadPoolExecutor(workers) as ex:
        lines = list(ex.map(one, range(n)))
    if timed:
        (folder / "metadata/camstamp.txt").write_text("\n".join(lines)
                                                      + "\n")
        delay = float(cfg["dataset"].get(
            "imu_delay", 0.04 if layout == "kitti360" else 0.0))
        imu = cs.room_imu(n, revs, IMU_DT)
        imu[:, 0] += delay
        np.savetxt(folder / "metadata/imu.txt", imu)
        np.savetxt(folder / "metadata/c2i.txt", np.eye(4))
    return time.perf_counter() - t0


def family_overrides(family, folder, save_dir, device, extra=None):
    """OVERRIDES as a config dict (and `extra`, a rehearsal's or a test's
    smaller sizes, merged over them)."""
    from vings_mono_tpu_torch.utils.config import _deep_merge, load_config
    over = {"dataset": {"root": str(folder)},
            "frontend": {"weight": str(WEIGHTS_DIR /
                                       "droid_selftrained.npz")},
            "output": {"save_dir": str(save_dir)},
            "device": {"tracker": str(device), "mapper": str(device)}}
    cfg = load_config(str(family.config))
    if cfg.get("use_metric") and cfg["metric"].get("backend") == "npz":
        over["metric"] = {"root": str(pathlib.Path(folder) / "metric_depth")}
    if cfg.get("use_loop"):
        over["looper"] = {
            "superpoint_weights": str(WEIGHTS_DIR /
                                      "superpoint_selftrained.npz"),
            "lightglue_weights": str(WEIGHTS_DIR /
                                     "lightglue_selftrained.npz")}
    return _deep_merge(over, extra) if extra else over


def family_cfg(family, folder, save_dir, device, extra=None):
    """The committed configuration with `family_overrides` applied."""
    from vings_mono_tpu_torch.utils.config import load_config
    return load_config(str(family.config), overrides=family_overrides(
        family, folder, save_dir, device, extra))


# ---------------------------------------------------------------------------
# one family's run
# ---------------------------------------------------------------------------

def host(x):
    """A tensor or an array as a host array (v0_kitti360's windows are
    numpy, the other variants' tensors on the tracker's device)."""
    import torch
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def digest(tracker, mapper):
    """One hash of the keyframe poses and the map's rows."""
    import torch
    from vings_mono_tpu_torch.parallel.mesh import digest as bytes_digest
    from vings_mono_tpu_torch.utils.trajectory import tracker_c2ws
    _, c2ws = tracker_c2ws(tracker)
    return bytes_digest([torch.as_tensor(np.asarray(c2ws))]
                        + [getattr(mapper.state, f) for f in cs.MAP_FIELDS])


def ground_truth(folder, ts):
    """The written pose/<t>.txt c2ws at the keyframe timestamps `ts`."""
    files = {round(float(f.stem), 6): f
             for f in (pathlib.Path(folder) / "pose").glob("*.txt")}
    return np.stack([np.loadtxt(files[round(float(t), 6)]) for t in ts])


def direct_detect(looper, mapper, tracker, viz_out, folder):
    """The loop detector called once, outside the run's own attempts, on
    the newest packaged keyframe and the keyframe nearest it in the
    ground truth among those min_history older (the oldest where none
    is): SuperPoint, LightGlue, the map render and PnP at the tracked
    size on the run's final state. Returns the trace of that call."""
    from vings_mono_tpu_torch.utils.trajectory import tracker_c2ws
    cur = int(host(viz_out.get("global_kf_id_host",
                               viz_out["global_kf_id"]))[-1])
    c2ws = looper._history(tracker)
    gt = ground_truth(folder, tracker_c2ws(tracker)[0])[:, :3, 3]
    old = cur - looper.min_history
    cand = int(np.argmin(np.linalg.norm(gt[:old + 1] - gt[cur], axis=-1))
               ) if old >= 0 else 0
    looper.detector.detect(
        mapper, looper._image(tracker, cur),
        host(viz_out["depths"][-1])[..., 0], host(viz_out["poses"][-1]),
        looper._image(tracker, cand), c2ws[cand], viz_out["intrinsic"],
        min_inliers=looper.min_inliers)
    return dict(looper.detector.traces[-1], cur_gid=cur, cand_gid=cand,
                gt_distance=float(np.linalg.norm(gt[cand] - gt[cur])))


def run_family(family, n, out, device, seed=0, tag=None, extra=None,
               size=None, pace=None, kernels=True, written=None):
    """Write `family`'s folder of n frames under `out` (or, given
    `written`, a future of that write started elsewhere, wait for it),
    run it through runners.run.run and check it: two windows mapped, both
    tile kernels launched on every training iteration, finite poses and
    map, and (on a card, with `kernels`) both kernels against their plain
    twins on the final map. Returns a record of its numbers."""
    import torch
    from vings_mono_tpu_torch.datasets import base as ds_base
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
    from vings_mono_tpu_torch.runners import evaluate
    from vings_mono_tpu_torch.runners import run as run_mod
    from vings_mono_tpu_torch.tracker.vio import InertialFusion
    tag = tag or family.key
    out = pathlib.Path(out)
    folder, save_dir = out / "folder", out / "run"
    cfg = family_cfg(family, folder, out, device, extra)
    if written is None:
        shutil.rmtree(out, ignore_errors=True)
        write_s = write_folder(family, folder, n, cfg, size=size, pace=pace)
    else:
        shutil.rmtree(save_dir, ignore_errors=True)
        write_s = written.result()
    src = source_intrinsic(cfg, size)
    h, w = (int(x) for x in cfg["frontend"]["image_size"])
    opts = [k for k in ("use_metric", "use_loop", "use_storage_manager",
                        "use_vis", "use_global_ba") if cfg.get(k)]
    print(f"{tag} {family.config.relative_to(ROOT)}: mode {cfg['mode']}, "
          f"middleware {cfg['middleware'].get('variant')}, {opts}, "
          f"{n} frames of the room written in the {family.layout} layout "
          f"at {src[1]}x{src[2]} in {write_s:.1f} s, tracked at {h}x{w} "
          f"({h / 16:.2f} x {w / 16:.2f} tiles), save_buffer "
          f"{cfg['frontend']['save_buffer']}", flush=True)
    cuda = torch.device(device).type == "cuda"

    timed, cams, windows_at, trains, got = [], [], [], [], {}
    get_dataset, build = ds_base.get_dataset, run_mod.build
    train = GaussianMapper._train
    align = InertialFusion.visual_imu_alignment
    aligned = []

    def rec_align(self, t0, t1, *a, **k):
        # VI init's alignment: whether it succeeded, the largest angle
        # between a window state's up and the truth's (the room's y is
        # down), and the window's path length against the truth's
        ok = bool(align(self, t0, t1, *a, **k))
        gt = ground_truth(folder, self.video.tstamps_host[:t1])
        up = [np.degrees(np.arccos(np.clip(
            (gt[i, :3, :3].T @ [0.0, -1.0, 0.0])
            @ (self.states[i].R.T @ [0.0, 0.0, 1.0]), -1.0, 1.0)))
            for i in range(t0, t1)]
        p = np.asarray([self.states[i].p for i in range(t0, t1)])
        path = np.linalg.norm(np.diff(p, axis=0), axis=1).sum() / max(
            np.linalg.norm(np.diff(gt[t0:t1, :3, 3], axis=0),
                           axis=1).sum(), 1e-12)
        aligned.append({"t0": t0, "t1": t1, "ok": ok,
                        "gravity_deg": float(max(up)),
                        "path_ratio": float(path)})
        return ok

    def timed_get(c):
        timed.append(cs.TimedDataset(get_dataset(c)))
        return timed[-1]

    def rec_build(*a, **k):
        built = build(*a, **k)
        looper = got["looper"] = built[4]
        if looper is not None:
            run = looper.run

            def rec_run(mapper, tracker, viz_out, frame_idx):
                # what the candidate search sees: the newest keyframe's id
                # and its distance to the nearest keyframe old enough
                cur = int(host(viz_out.get("global_kf_id_host",
                                           viz_out["global_kf_id"]))[-1])
                c2ws = looper._history(tracker)
                old = cur - looper.min_history
                near = float(np.linalg.norm(
                    c2ws[:old + 1, :3, 3] - c2ws[cur, :3, 3], axis=-1).min()
                ) if old >= 0 and cur < len(c2ws) else None
                got.setdefault("loop_calls", []).append(
                    (frame_idx, cur, near))
                return run(mapper, tracker, viz_out, frame_idx)
            looper.run = rec_run
        return built

    def rec_train(self, *a, **k):
        f0 = tk.rasterize_forward.launches
        b0 = tk.rasterize_backward.launches
        res = train(self, *a, **k)
        trains.append((int(k["iters"]), tk.rasterize_forward.launches - f0,
                       tk.rasterize_backward.launches - b0))
        return res

    def on_frame(idx, tracker, mapper, viz_out):
        if viz_out is not None:
            got["last_viz"] = viz_out
        if viz_out is not None and mapper.time_idx > len(windows_at):
            windows_at.append(idx)
            if "viz" not in got:
                got["viz"] = {k: host(v) if torch.is_tensor(v) else v
                              for k, v in viz_out.items()}
            k = int(viz_out["n_valid"]) - 1
            cams.append((idx, host(viz_out["poses"][k]),
                         dict(viz_out["intrinsic"]),
                         float((host(viz_out["depths"][k]) > 0).mean())))
        if got.get("looper") is not None and "first_attempt" not in got \
                and got["looper"].detector.traces:
            got["first_attempt"] = idx

    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cs.replaced(ds_base, "get_dataset", timed_get), \
            cs.replaced(run_mod, "build", rec_build), \
            cs.replaced(GaussianMapper, "_train", rec_train), \
            cs.replaced(InertialFusion, "visual_imu_alignment", rec_align):
        tracker, mapper, timer = run_mod.run(cfg, str(save_dir),
                                             sync_timer=True,
                                             on_frame=on_frame)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    launches = {"rasterize_forward": tk.rasterize_forward.launches,
                "rasterize_backward": tk.rasterize_backward.launches}
    smi = cs.nvidia_smi() if cuda else "cpu"
    stages = {k: 1e3 * timer.totals[k] / max(timer.counts[k], 1)
              for k in timer.totals}
    load_ms = timed[0].ms
    dataset = get_dataset(cfg)
    ate = evaluate.eval_trajectory(str(save_dir), dataset)
    psnr = evaluate.eval_psnr(mapper, tracker)
    train_psnr = mapper.last_metrics.get("psnr")
    v = tracker.video
    n_kf = v.counter + v.count_save
    rec = {"family": family.key, "config": str(family.config.relative_to(
        ROOT)), "frames": n, "source": [src[1], src[2]], "tracked": [h, w],
        "wall_s": wall, "frames_per_s": n / wall, "stage_ms": stages,
        "stage_n": dict(timer.counts),
        "dataset_ms_mean": float(np.mean(load_ms)),
        "dataset_ms_median": float(np.median(load_ms)),
        "peak_gb": peak_gb, "keyframes": n_kf, "windows": mapper.time_idx,
        "windows_at": windows_at, "ate": ate, "psnr": psnr,
        "train_psnr": train_psnr, "launches": launches,
        "train_calls": len(trains),
        "train_iters": sum(t[0] for t in trains), "card": smi}
    print(f"{tag} run [{smi}]: {n} frames in {wall:.1f} s "
          f"({rec['frames_per_s']:.3f} frames/s), {n_kf} keyframes, "
          f"windows mapped {mapper.time_idx} (at frames {windows_at}); "
          f"dataset[idx] host {rec['dataset_ms_mean']:.2f} ms mean, "
          f"{rec['dataset_ms_median']:.2f} median over {len(load_ms)} "
          f"frames ({src[1]}x{src[2]} -> {h}x{w}); peak device memory "
          f"{peak_gb if peak_gb is None else round(peak_gb, 3)} GB; ATE "
          f"{ate if ate is None else round(ate, 4)} (eval_trajectory, "
          f"scale-aligned, against pose/), PSNR {psnr} dB (eval_psnr), "
          f"last train PSNR {train_psnr}; launches {launches} over "
          f"{rec['train_iters']} training iterations in {len(trains)} "
          f"train calls", flush=True)
    print(f"{tag} stage ms (host clock, each stage synchronized): "
          + ", ".join(f"{k} {ms:.1f} x{timer.counts[k]}"
                      for k, ms in sorted(stages.items())), flush=True)
    cs.check(len(load_ms) == n, f"{tag}: not every frame loaded")
    cs.check(mapper.time_idx >= 2, f"{tag}: {mapper.time_idx} windows "
             f"mapped, not two")
    if cuda:
        for iters, nf, nb in trains:
            cs.check(nf >= iters and nb >= iters, f"{tag}: a train call "
                     f"of {iters} iterations launched the kernels {nf} / "
                     f"{nb} times")
        for name, cnt in launches.items():
            cs.check(cnt >= rec["train_iters"], f"{tag}: {name} launched "
                     f"{cnt} times")
    nv = v.counter
    cs.check(bool(torch.isfinite(v.bufs.poses[:nv]).all())
             and np.isfinite(v.poses_save[:v.count_save]).all(),
             f"{tag}: poses not finite")
    s = mapper.state
    cs.check(all(bool(torch.isfinite(getattr(s, f)[s.alive]).all())
                 for f in cs.MAP_FIELDS if f != "alive"),
             f"{tag}: the map is not finite")
    cs.check(ate is not None and np.isfinite(ate), f"{tag}: no ATE")
    if cfg["mode"] == "vio":
        inertial = tracker.frontend.inertial
        rec["vi_alignments"] = aligned
        print(f"{tag} VI init: IMU fusion on: {inertial.imu_enabled}; "
              f"alignments (keyframes, succeeded, largest gravity error "
              f"of the window's states against the truth, its path length "
              f"over the truth's): " + ", ".join(
                  f"({a['t0']}-{a['t1']}, {a['ok']}, "
                  f"{a['gravity_deg']:.2f} deg, {a['path_ratio']:.4f})"
                  for a in aligned), flush=True)
    looper = got.get("looper")
    if looper is not None:
        traces = looper.detector.traces
        rec["loop_attempts"] = [t["stage"] for t in traces]
        rec["first_attempt_frame"] = got.get("first_attempt")
        rec["loop_calls"] = got.get("loop_calls", [])
        print(f"{tag} loop: {len(traces)} attempts reaching stages "
              f"{rec['loop_attempts']} (matches "
              f"{[t['matches'] for t in traces]}, PnP inliers "
              f"{[t['pnp_inliers'] for t in traces]}), the first after "
              f"frame {rec['first_attempt_frame']}; closures "
              f"{[(t['cand_gid'], t['cur_gid']) for t in looper.loop_traces]}"
              f"; loop calls (frame, newest keyframe id, distance to the "
              f"nearest keyframe min_history {looper.min_history} older; "
              f"search radius {looper.search_radius}): "
              + ", ".join(f"({f}, {c}, "
                          f"{'-' if d is None else round(d, 3)})"
                          for f, c, d in rec["loop_calls"]), flush=True)
        if not traces:
            tr = rec["direct_detect"] = direct_detect(
                looper, mapper, tracker, got["last_viz"], folder)
            print(f"{tag} loop detector called directly (the run made no "
                  f"attempt): the newest keyframe {tr['cur_gid']} against "
                  f"keyframe {tr['cand_gid']}, {tr['gt_distance']:.3f} "
                  f"apart in the ground truth, at {h}x{w}: stage "
                  f"{tr['stage']}, matches {tr['matches']}, PnP inliers "
                  f"{tr['pnp_inliers']}, map render share {tr['rend_frac']}",
                  flush=True)
    if cuda and kernels:
        c2w, intr, label = cs.seen_camera(mapper, cams, tag=tag)
        errs = cs.kernels_on(tag, [(label, mapper.state, c2w, intr)],
                             dict(mapper.bin_kwargs), seed + 90)
        rec["max_abs_err"] = {"rasterize_forward": errs[0],
                              "rasterize_backward": errs[1]}
        rec["max_err_over_scale"] = {"rasterize_forward": errs[2],
                                     "rasterize_backward": errs[3]}
    rec["digest"] = digest(tracker, mapper)
    rec["viz"] = got.get("viz")
    del tracker, mapper
    if cuda:
        torch.cuda.empty_cache()
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--family", nargs="*", default=list(FAMILIES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    from vings_mono_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        from vings_mono_tpu_torch.utils import cuda_build
        cuda_build.build()
    cs.DEVICE = str(device)
    for what, value, why in OVERRIDES:
        print(f"override {what} -> {value} ({why})", flush=True)
    t_start = time.perf_counter()
    recs, failed = [], []
    for key in args.family:
        fam = FAMILIES[key]
        n = fam.frames
        try:
            rec = run_family(fam, n, OUT / key, device, args.seed)
            if key == "F1":
                again = run_family(fam, n, OUT / (key + "_rerun"), device,
                                   args.seed, tag="F1 rerun", kernels=False)
                rec["rerun_bitwise"] = again["digest"] == rec["digest"]
                print(f"F1 rerun: poses and map bitwise equal to the first "
                      f"run: {rec['rerun_bitwise']}", flush=True)
                cs.check(rec["rerun_bitwise"], "F1: the rerun differs")
        except SystemExit:
            # cs.check printed the failure; the other families still run,
            # and the script exits 1 at the end
            failed.append(key)
            continue
        rec.pop("viz")
        recs.append(rec)
    print(f"profile_configs: {len(recs)} families in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if failed:
        cs.fail(f"families {failed} failed")
    print(cs.nvidia_smi() if device.type == "cuda" else "cpu", flush=True)
    print(json.dumps({"families": recs}), flush=True)


if __name__ == "__main__":
    main()
