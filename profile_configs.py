"""Eight shipped configuration families on one card at full width.

    python3 profile_configs.py [--family F1 ...] [--seed 0] [--device cuda]

Needs a CUDA card (about 15 minutes on one H100). Each family runs through
its entry point with its configuration as committed: `runners.run.run`
(`python -m vings_mono_tpu_torch.runners.run <config>`) for F1-F6,
`runners.run_mobile.run` for F7, and for F8 the live phone pipeline of
`runners.run_multiprocess_mobile` (`server/server.py`'s WebsocketServer in
front of `start_workers`' tracker and mapper threads). Real Waymo,
KITTI-360, RTG, Hierarchical-3DGS, KITTI and phone frames are not in the
repository, so each family's folder is written here in its dataset
module's layout: the procedural `synthetic3d` room ray-cast at the
configuration's source resolution and intrinsics along the room's
trajectory, so the loader's own decode, crop and resize run. The only
overrides are in `OVERRIDES`, each with its reason: dataset.root (and the
metric prior's root under it), the DroidNet weights, the loop detector's
SuperPoint and LightGlue weights, output.save_dir, the device, F7's
`ply_every` and its second run's paging threshold, and F8's server
address.

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
     divergences);
  F6 configs/waymo/Scene03.yaml: mode vo with the npz metric prior, NVS
     pose refinement (`use_refine`: 20 iterations a window through both
     tile kernels, the refined poses written back into the tracker) and
     vis, 100 iterations at capacity 524288; color/*.jpg at 720x1280 ->
     344x616 and metric_depth/<frame>.npy;
  F7 configs/pocket/pocket_scene.yaml through `run_mobile.run`: mode vo
     with storage paging every 10 frames and a 3DGS .ply every PLY_EVERY
     frames; the phone's color/*.jpg at 720x1280 -> 344x616. It runs
     twice: as committed over 60 frames (a 65-unit threshold pages
     nothing in the room), and over PAGING_FRAMES, one turn of the room,
     with the paging threshold at the room's scale (PAGING_THRESHOLD);
  F8 the same configuration through the live pipeline: the phone's
     messages (the same JPEG frames with the timestamp in EXIF tag 306 at
     30 Hz, and 100 Hz IMU JSON rows between them) sent to the server as
     fast as the socket takes them, over a websocket on 127.0.0.1 where the
     `websockets` package imports, else through an in-process connection
     into the server's own `receive` and `send`.

For each family it prints frames/s; the stage ms (track, package, map and
metric / loop / storage / vis where the family has them; F8's on its
threads' streams, with the server's decode and JPEG encode); host ms per
`dataset[idx]` (F8: per `_decode_frame`); peak device memory; keyframes
and windows mapped; the ATE against pose/ and the PSNR
(`runners/evaluate.py`) and the last train PSNR; the launches of each tile
kernel, checked on every training iteration and every refinement
iteration; both kernels against their plain twins on the final map under
the newest mapped keyframe's camera whose depths were kept; for the vio
families whether VI init's alignment succeeded; for F5 the stage each
loop attempt reached and what the candidate search saw, and where the
run made no attempt, the stage of one direct call of the detector on the
final state (the newest keyframe against the one nearest it in the
ground truth); for F6 each window's refinement ms, its poses' change, each
keyframe's error against pose/ before and after refinement (held to
REFINE_ERR_TOL and POSE_ERR_MAX), `apply_pose_bias_to_gaussians`' ms, and
that the tracker holds the refined poses; for F7 each .ply's Gaussians
against those alive on the device and those paged to the host, and the
rows paged out and back in; for F8 the frames received and tracked, the
windows packaged, mapped and dropped, the renders (one finite render made
per mapped window; at each of the sender's turns, `server.send_hz`, the
newest is sent, the last one included), the imu.csv rows against the IMU
messages, and whether
the pipeline kept up with the socket (the server's queue of
`run_multiprocess_mobile.SERVER_QUEUE` frames). F1 runs twice, and the
rerun must equal the first bit for bit (`utils.device.reproducible`). The
card's name and power limit precede the last line, one JSON record of
every number. Without a card it exits 1 (with `--device cpu` the kernels'
plain twins run and the kernel checks are skipped: a rehearsal, not a
measurement). chip_smoke.py phase 20 runs F1-F7 at the fewest frames that
map two windows (F7: that write two map .ply files), and its phase 15d
F8.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import io
import json
import pathlib
import queue
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
PHONE_DT = 1.0 / 30.0      # F8: the phone's 30 Hz camera
JPEG_QUALITY = 95          # cv2.imwrite's default, as the other layouts
PLY_EVERY = 10             # F7: run_mobile's --ply-every
# F7's second run: PAGING_FRAMES frames, one turn of the room at its pace,
# so that the camera comes back to where it started; keyframes farther
# than PAGING_THRESHOLD of the tracker's units from the camera page out.
# The camera circles at a radius of 1.8 room units (3.6 across); a VO
# run's units are its own, 0.76-1.9 of them to the room's unit in the
# card's first runs (F6, F7), so the threshold lies well inside the
# circle's width in either and above the drift the camera returns with
PAGING_FRAMES = 100
PAGING_THRESHOLD = 1.5
# F6: a window's mean keyframe position error against pose/ (the whole
# run's keyframes Umeyama-aligned to it, in room units) may grow by at
# most REFINE_ERR_TOL through refinement (20 Adam steps of 1e-3 a window
# move a pose by ~1e-2 of the tracker's units at most), and stays below
# POSE_ERR_MAX before and after (a quarter of the room's half-width)
REFINE_ERR_TOL = 0.02
POSE_ERR_MAX = 1.0
# the tracker's window holds the refined c2ws after retrieve_to_tracker
# (an se3 round trip in f32)
RETRIEVE_TOL = 1e-4
PHONE_TIMEOUT_S = 1200.0   # F8's session, past which it has hung
RENDER_WAIT_S = 10.0       # F8: the last render's way back to the phone


class Family:
    """One shipped configuration, the layout its loader reads, its entry
    point ("run", "run_mobile" or "server") and how far to run it:
    `frames` in profile_configs.py, `smoke_frames` in chip_smoke.py phase
    20 (the fewest that map two windows; F5's the fewest that reach its
    first loop calls)."""

    def __init__(self, key, config, layout, frames, smoke_frames,
                 revs_per_frame=REVS_PER_FRAME, entry="run"):
        self.key, self.config, self.layout = key, ROOT / config, layout
        self.frames, self.smoke_frames = frames, smoke_frames
        self.revs_per_frame = revs_per_frame
        self.entry = entry


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
           "kitti_sync", 96, 32, revs_per_frame=1.25 / 96),
    Family("F6", "configs/waymo/Scene03.yaml", "waymo", 30, 11),
    # F7's first window maps at frame 12: map .ply files at frames 19, 29
    Family("F7", "configs/pocket/pocket_scene.yaml", "pocket", 60, 30,
           entry="run_mobile"),
    Family("F8", "configs/pocket/pocket_scene.yaml", "pocket", 60, 24,
           entry="server"),
)}

# what each family's run sets on top of the committed configuration
OVERRIDES = [
    ("dataset.root", "the folder this script writes", "the datasets' "
     "frames are not in the repository"),
    ("metric.root (F4, F6)", "<folder>/metric_depth", "the committed path "
     "lies under the dataset's root"),
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
    ("run_mobile ply_every (F7)", f"300 -> {PLY_EVERY}", "the CLI default "
     "writes no .ply in a run of 60 frames; every 10th frame writes six"),
    ("storage_manager.distance_threshold (F7's second run)",
     f"65.0 -> {PAGING_THRESHOLD}", "65 units is a street's scale: in the "
     "room (8 units across, a circle of 3.6) nothing would page; at "
     f"{PAGING_THRESHOLD} the keyframes across the circle page out and "
     "back in as the camera comes round"),
    ("frames (F7's second run)", f"60 -> {PAGING_FRAMES}", "one turn of "
     "the room at its pace: in 60 frames (0.6 of a turn) the camera "
     "never comes back to a keyframe it left, so nothing could page in; "
     "at 1.0 / 60 turns a frame the tracker lost the room after frame "
     "48 (the card's first run)"),
    ("server.host, server.port (F8)", "127.0.0.1 and a free port",
     "the committed default binds 0.0.0.0:8765 for a phone on the "
     "network; the client here is local"),
]
PAGING = {"storage_manager": {"distance_threshold": PAGING_THRESHOLD}}


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


def npz_prior(cfg):
    return bool(cfg.get("use_metric")) and \
        cfg["metric"].get("backend") == "npz"


def write_folder(family, folder, n, cfg, size=None, workers=8, pace=None):
    """Write `n` frames of the room in `family`'s dataset layout under
    `folder` at the config's source resolution (or `size`), with
    ground-truth poses in pose/<t>.txt; for a `vio` family the IMU stream
    of the same trajectory, written as late as its loader shifts it back;
    for an npz metric prior the room's depth of every frame as
    metric_depth/<frame>.npy (the backend matches files to frames in
    sorted order); for the phone's layout (F7, F8) JPEGs with the frame's
    capture time (k * PHONE_DT) in EXIF tag 306, as a phone writes them.
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
    metric = npz_prior(cfg)
    img_dir = {"waymo": "color", "hierarchical": "color", "pocket": "color",
               "rtg": "nosky_color", "kitti360": "image_00/data_rect",
               "kitti_sync": "image_02/data"}[layout]
    for d in (img_dir, "pose") + (("metadata",) if timed else ()) + (
            ("metric_depth",) if metric else ()):
        (folder / d).mkdir(parents=True, exist_ok=True)

    def one(k):
        c2w = trajectory_c2w(k, n, revs=revs)
        rgb, depth = render_room(c2w, intr, h, w, tex=tex)
        rgb8 = np.round(rgb * 255).astype(np.uint8)
        name = {"waymo": f"{k:06d}.jpg", "hierarchical": f"{k:06d}.png",
                "pocket": f"{k:06d}.jpg", "rtg": f"{k}.jpg"}.get(
                    layout, f"{k:010d}.png")
        if layout == "pocket":
            phone_jpeg(folder / img_dir / name, rgb8, k * PHONE_DT)
        else:
            cv2.imwrite(str(folder / img_dir / name), rgb8[..., ::-1])
        if metric:
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


def phone_jpeg(path, rgb8, ts):
    """A JPEG as the phone sends it: its capture time in EXIF DateTime
    (tag 306), which the server reads back as the frame's timestamp."""
    from PIL import Image
    exif = Image.Exif()
    exif[306] = f"{ts:.6f}"
    Image.fromarray(rgb8).save(path, format="JPEG", quality=JPEG_QUALITY,
                               exif=exif)


def phone_messages(folder, n, revs):
    """F8's input: the folder's first n JPEG frames as bytes, with the
    IMU samples of the room's trajectory (100 Hz, gyro in rad/s, specific
    force in m/s^2) as the phone's JSON messages before each frame they
    precede. Returns (messages, number of IMU messages)."""
    files = sorted((pathlib.Path(folder) / "color").glob("*.jpg"))[:n]
    imu = cs.room_imu(n, revs, PHONE_DT)
    msgs, i = [], 0
    for k, f in enumerate(files):
        while i < len(imu) and imu[i, 0] <= k * PHONE_DT + 1e-9:
            msgs.append(json.dumps({
                "timestamp": float(imu[i, 0]),
                "gyro": np.deg2rad(imu[i, 1:4]).tolist(),
                "accel": imu[i, 4:7].tolist()}))
            i += 1
        msgs.append(f.read_bytes())
    return msgs, i


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def family_overrides(family, folder, save_dir, device, extra=None):
    """OVERRIDES as a config dict (and `extra`, a rehearsal's or a test's
    smaller sizes or F7's paging threshold, merged over them)."""
    from vings_mono_tpu_torch.utils.config import _deep_merge, load_config
    over = {"dataset": {"root": str(folder)},
            "frontend": {"weight": str(WEIGHTS_DIR /
                                       "droid_selftrained.npz")},
            "output": {"save_dir": str(save_dir)},
            "device": {"tracker": str(device), "mapper": str(device)}}
    cfg = load_config(str(family.config))
    if npz_prior(cfg):
        over["metric"] = {"root": str(pathlib.Path(folder) / "metric_depth")}
    if cfg.get("use_loop"):
        over["looper"] = {
            "superpoint_weights": str(WEIGHTS_DIR /
                                      "superpoint_selftrained.npz"),
            "lightglue_weights": str(WEIGHTS_DIR /
                                     "lightglue_selftrained.npz")}
    if family.entry == "server":
        over["server"] = {"host": "127.0.0.1", "port": free_port()}
    return _deep_merge(over, extra) if extra else over


def family_cfg(family, folder, save_dir, device, extra=None):
    """The committed configuration with `family_overrides` applied."""
    from vings_mono_tpu_torch.utils.config import load_config
    return load_config(str(family.config), overrides=family_overrides(
        family, folder, save_dir, device, extra))


# ---------------------------------------------------------------------------
# what a run is watched by
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


def umeyama(P, Q):
    """(s, R, t) with s R p + t closest to q over the rows of P, Q (N, 3)."""
    mp, mq = P.mean(0), Q.mean(0)
    U, S, Vt = np.linalg.svd((Q - mq).T @ (P - mp))
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = (S * D.diagonal()).sum() / ((P - mp) ** 2).sum()
    return s, R, mq - s * R @ mp


def rigid_change(a, b):
    """Translation norm and rotation angle (deg) of b @ inv(a), per row."""
    d = b @ np.linalg.inv(a)
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(d[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1.0, 1.0)))
    return np.linalg.norm(d[:, :3, 3], axis=-1), ang


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


class Watch:
    """Wrappers around the entry points' parts, installed for one run:
    `dataset[idx]` timed, the looper and the storage manager kept, each
    train call's iterations and launches, each mapped window's camera,
    each VI alignment, each refinement (its ms, launches and poses) and
    `apply_pose_bias_to_gaussians`' ms, each .ply written, and the host
    ms of track, package, map and render, each ended by a synchronize of
    the calling thread's stream (F8's stage times: its threads run on
    streams of their own)."""

    def __init__(self, folder, cuda):
        self.folder, self.cuda = folder, cuda
        self.timed, self.cams, self.windows_at, self.trains = [], [], [], []
        self.refines, self.biases, self.plys, self.aligned = [], [], [], []
        self.stage_ms = {}
        self.frames = 0
        self.got = {}
        self._stack = None

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.current_stream().synchronize()

    def _timed(self, stage, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            res = fn(*a, **k)
            self._sync()
            self.stage_ms.setdefault(stage, []).append(
                1e3 * (time.perf_counter() - t0))
            return res
        return call

    def __enter__(self):
        import contextlib
        import torch
        from vings_mono_tpu_torch import middleware
        from vings_mono_tpu_torch.datasets import base as ds_base
        from vings_mono_tpu_torch.mapper import mapper as mapper_mod
        from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
        from vings_mono_tpu_torch.runners import run as run_mod
        from vings_mono_tpu_torch.tracker.tracker import Tracker
        from vings_mono_tpu_torch.tracker.vio import InertialFusion
        GM = mapper_mod.GaussianMapper
        get_dataset, build = ds_base.get_dataset, run_mod.build
        train, mrun, save_ply = GM._train, GM.run, GM.save_ply
        refine, bias = (mapper_mod.refine_poses,
                        mapper_mod.apply_pose_bias_to_gaussians)
        align = InertialFusion.visual_imu_alignment
        track = self._timed("track", Tracker.track)
        w = self

        def launches():
            return (tk.rasterize_forward.launches,
                    tk.rasterize_backward.launches)

        def timed_get(c):
            w.timed.append(cs.TimedDataset(get_dataset(c)))
            return w.timed[-1]

        def rec_build(*a, **k):
            built = build(*a, **k)
            w.got["storage"], w.got["looper"] = built[3], built[4]
            looper = built[4]
            if looper is not None:
                run = looper.run

                def rec_run(mapper, tracker, viz_out, frame_idx):
                    # what the candidate search sees: the newest keyframe's
                    # id and its distance to the nearest keyframe old enough
                    cur = int(host(viz_out.get("global_kf_id_host",
                                               viz_out["global_kf_id"]))[-1])
                    c2ws = looper._history(tracker)
                    old = cur - looper.min_history
                    near = float(np.linalg.norm(
                        c2ws[:old + 1, :3, 3] - c2ws[cur, :3, 3],
                        axis=-1).min()) if old >= 0 and cur < len(c2ws) \
                        else None
                    w.got.setdefault("loop_calls", []).append(
                        (frame_idx, cur, near))
                    return run(mapper, tracker, viz_out, frame_idx)
                looper.run = rec_run
            return built

        def rec_track(self, pkt):
            w.frames += 1
            return track(self, pkt)

        def rec_train(self, *a, **k):
            f0, b0 = launches()
            res = train(self, *a, **k)
            f1, b1 = launches()
            w.trains.append((int(k["iters"]), f1 - f0, b1 - b0))
            return res

        timed_map = self._timed("map", mrun)

        def rec_map(self, viz_out):
            res = timed_map(self, viz_out)
            if self.time_idx > len(w.cams):
                # the newest keyframe's camera of every window trained on,
                # with the share of its pixels that kept a depth
                k = int(host(viz_out["n_valid"])) - 1
                w.windows_at.append(w.frames - 1)
                w.cams.append((w.frames - 1, host(viz_out["poses"][k]),
                               dict(viz_out["intrinsic"]),
                               float((host(viz_out["depths"][k]) > 0).mean())))
            return res

        def rec_refine(state, batch, binned, intr4, **k):
            w._sync()
            f0, b0 = launches()
            t0 = time.perf_counter()
            new_c2ws, xi = refine(state, batch, binned, intr4, **k)
            w._sync()
            ms = 1e3 * (time.perf_counter() - t0)
            f1, b1 = launches()
            n = int(batch.n_valid)
            w.refines.append({
                "iters": int(k["iters"]), "ms": ms,
                "launches": (f1 - f0, b1 - b0),
                "before": host(torch.linalg.inv(batch.w2cs[:n])),
                "after": host(new_c2ws[:n])})
            return new_c2ws, xi

        def rec_bias(*a, **k):
            w._sync()
            t0 = time.perf_counter()
            res = bias(*a, **k)
            w._sync()
            w.biases.append(1e3 * (time.perf_counter() - t0))
            return res

        def rec_save_ply(self, path, mode="2dgs"):
            from vings_mono_tpu_torch.utils.ply import load_ply
            storage = w.got.get("storage")
            save_ply(self, path, mode=mode)
            w.plys.append({"file": pathlib.Path(path).name,
                           "device": self.n_alive,
                           "host": storage.n_host if storage else 0,
                           "written": len(load_ply(path)["xyz"])})

        def rec_align(self, t0, t1, *a, **k):
            # VI init's alignment: whether it succeeded, the largest angle
            # between a window state's up and the truth's (the room's y is
            # down), and the window's path length against the truth's
            ok = bool(align(self, t0, t1, *a, **k))
            gt = ground_truth(w.folder, self.video.tstamps_host[:t1])
            up = [np.degrees(np.arccos(np.clip(
                (gt[i, :3, :3].T @ [0.0, -1.0, 0.0])
                @ (self.states[i].R.T @ [0.0, 0.0, 1.0]), -1.0, 1.0)))
                for i in range(t0, t1)]
            p = np.asarray([self.states[i].p for i in range(t0, t1)])
            path = np.linalg.norm(np.diff(p, axis=0), axis=1).sum() / max(
                np.linalg.norm(np.diff(gt[t0:t1, :3, 3], axis=0),
                               axis=1).sum(), 1e-12)
            w.aligned.append({"t0": t0, "t1": t1, "ok": ok,
                              "gravity_deg": float(max(up)),
                              "path_ratio": float(path)})
            return ok

        self._stack = contextlib.ExitStack()
        for obj, name, value in (
                (ds_base, "get_dataset", timed_get),
                (run_mod, "build", rec_build),
                (Tracker, "track", rec_track),
                (middleware, "judge_and_package",
                 self._timed("package", middleware.judge_and_package)),
                (GM, "_train", rec_train), (GM, "run", rec_map),
                (GM, "render_at", self._timed("render", GM.render_at)),
                (GM, "save_ply", rec_save_ply),
                (mapper_mod, "refine_poses", rec_refine),
                (mapper_mod, "apply_pose_bias_to_gaussians", rec_bias),
                (InertialFusion, "visual_imu_alignment", rec_align)):
            self._stack.enter_context(cs.replaced(obj, name, value))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def on_frame(self, idx, tracker, mapper, viz_out):
        """runners.run's per-frame hook: the loop's first attempt, the
        newest window, and after a refined window that the tracker holds
        its refined poses."""
        if viz_out is not None:
            self.got["last_viz"] = viz_out
        looper = self.got.get("looper")
        if looper is not None and "first_attempt" not in self.got \
                and looper.detector.traces:
            self.got["first_attempt"] = idx
        ref = self.refines[-1] if self.refines else None
        if viz_out is not None and ref is not None and "ts" not in ref:
            import torch
            from vings_mono_tpu_torch.ops import lie
            n = len(ref["after"])
            poses = tracker.video.bufs.poses
            sel = torch.as_tensor(host(viz_out["valid_localkf_id"])[:n],
                                  device=poses.device)
            held = host(lie.se3_matrix(poses[sel]))
            ref["ts"] = [float(t) for t in
                         host(viz_out["viz_out_idx_to_f_idx"])[:n]]
            ref["frame"] = idx
            ref["retrieved_err"] = float(np.abs(
                held - np.linalg.inv(ref["after"])).max())


# ---------------------------------------------------------------------------
# F8: the phone's messages through the server into the workers
# ---------------------------------------------------------------------------

class WatchedQueue(queue.Queue):
    """A queue.Queue that counts what is put on it and how long a put
    waited for room, and holds each float image put on it to its shape
    and finiteness (the mapper's renders)."""

    def __init__(self, maxsize):
        super().__init__(maxsize)
        self.n_put, self.full_waits, self.waited_s, self.high = 0, 0, 0.0, 0
        self.items = []

    def put(self, item, block=True, timeout=None):
        t0 = time.perf_counter()
        wait = self.full()
        super().put(item, block, timeout)
        if wait:
            self.full_waits += 1
            self.waited_s += time.perf_counter() - t0
        self.high = max(self.high, self.qsize())
        if item is not None:
            self.n_put += 1
            if isinstance(item, np.ndarray):
                self.items.append((item.shape,
                                   bool(np.isfinite(item).all())))


class PhoneConnection:
    """The phone's side of a connection, in process: the messages as the
    server's `receive` iterates them, and what its `send` sends."""

    def __init__(self, msgs, sent=None):
        self.msgs, self.sent = msgs, [] if sent is None else sent

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        for m in self.msgs:
            yield m
            await asyncio.sleep(0)

    async def send(self, msg):
        self.sent.append(msg)


def drive_phone(cfg, msgs, n_frames, save_dir, device):
    """`run_multiprocess_mobile.start_workers` behind the WebsocketServer,
    fed `msgs` as fast as the connection takes them: over a websocket on
    cfg's server address where `websockets` imports, else through a
    PhoneConnection into the server's `receive` and `send`. After the last
    frame is queued the end sentinel follows; the session ends when both
    workers have and the newest render has reached the phone. Returns
    (tracker, mapper, record, the ms of each `_decode_frame`)."""
    import importlib.util
    from PIL import Image
    from vings_mono_tpu_torch.runners import run_multiprocess_mobile as rmm
    from vings_mono_tpu_torch.server.server import WebsocketServer
    s2t = WatchedQueue(rmm.SERVER_QUEUE)
    m2s = WatchedQueue(rmm.RENDER_QUEUE)
    server = WebsocketServer(cfg, s2t, m2s, str(save_dir))
    decode, save = server._decode_frame, Image.Image.save
    decode_ms, encode_ms, renders = [], [], []

    def timed_decode(payload):
        t0 = time.perf_counter()
        res = decode(payload)
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        return res
    server._decode_frame = timed_decode

    def timed_save(img, fp, format=None, **kw):
        t0 = time.perf_counter()
        save(img, fp, format, **kw)
        if format == "JPEG":
            encode_ms.append(1e3 * (time.perf_counter() - t0))

    transport = "websockets" if importlib.util.find_spec("websockets") \
        else "in-process"
    times = {}
    workers, results, stats = rmm.start_workers(cfg, s2t, m2s, device)

    async def until(ok, what, timeout=PHONE_TIMEOUT_S):
        t0 = time.perf_counter()
        while not ok():
            if workers.errors:
                raise workers.errors[0]
            cs.check(time.perf_counter() - t0 < timeout,
                     f"F8: no end to {what}")
            await asyncio.sleep(0.05)

    async def after_sending():
        times["sent"] = time.perf_counter()
        await until(lambda: s2t.n_put == n_frames, "the frames' decode")
        await asyncio.to_thread(s2t.put, None)
        await until(lambda: not any(t.is_alive() for t in workers.threads),
                    "the workers")
        times["done"] = time.perf_counter()
        # every 1 / send_hz s the sender takes the newest render (those
        # put since its last turn are dropped: the phone shows the newest)
        # and encodes it before its next await: once the queue is empty,
        # every render sent is encoded; the phone then has them all
        await until(m2s.empty, "the renders' stream-back", RENDER_WAIT_S)
        await until(lambda: len(renders) >= len(encode_ms),
                    "the renders' stream-back", RENDER_WAIT_S)

    async def over_websocket():
        import websockets
        done = asyncio.Event()
        serving = asyncio.create_task(server.serve(until=done.wait()))
        url = f"ws://{server.host}:{server.port}"
        try:
            for _ in range(200):             # until the server listens
                try:
                    ws = await websockets.connect(url, max_size=None)
                    break
                except OSError:
                    await asyncio.sleep(0.05)
            async with ws:
                async def read():
                    async for m in ws:
                        renders.append(m)
                reader = asyncio.create_task(read())
                times["first"] = time.perf_counter()
                for m in msgs:
                    await ws.send(m)
                await after_sending()
            await asyncio.gather(reader, return_exceptions=True)
        finally:
            done.set()
            await asyncio.wait_for(serving, 60)

    async def in_process():
        conn = PhoneConnection(msgs, renders)
        sender = asyncio.create_task(server.send(conn))
        try:
            times["first"] = time.perf_counter()
            await server.receive(conn)
            await after_sending()
        finally:
            sender.cancel()
            await asyncio.gather(sender, return_exceptions=True)

    try:
        with cs.replaced(Image.Image, "save", timed_save):
            asyncio.run(over_websocket() if transport == "websockets"
                        else in_process())
    finally:
        workers.stop.set()
        workers.join(60)
        server.close()
    shapes = [np.asarray(Image.open(io.BytesIO(base64.b64decode(
        json.loads(m)["jpeg"])))).shape for m in renders]
    imu_rows = len((pathlib.Path(save_dir) / "imu.csv").read_text()
                   .splitlines())
    rec = {"transport": transport, "frames_received": len(decode_ms),
           "frames_tracked": stats["frames"],
           "windows_packaged": stats["windows"],
           "windows_mapped": stats["mapped"],
           "windows_dropped": stats["dropped"],
           "renders_put": m2s.n_put, "renders_sent": len(renders),
           "renders_finite": sum(f for _, f in m2s.items),
           "render_shapes": sorted({str(s) for s, _ in m2s.items}),
           "sent_shapes": sorted({str(s) for s in shapes}),
           "decode_ms_mean": float(np.mean(decode_ms)),
           "decode_ms_median": float(np.median(decode_ms)),
           "encode_ms_mean": float(np.mean(encode_ms)) if encode_ms
           else None, "imu_rows": imu_rows,
           "send_s": times["sent"] - times["first"],
           "session_s": times["done"] - times["first"],
           "frames_per_s": n_frames / (times["done"] - times["first"]),
           "queue_high": s2t.high, "queue_full_waits": s2t.full_waits,
           "queue_waited_s": s2t.waited_s,
           "kept_up": s2t.full_waits == 0}
    return results["tracker"], results["mapper"], rec, decode_ms


# ---------------------------------------------------------------------------
# one family's run
# ---------------------------------------------------------------------------

def run_family(family, n, out, device, seed=0, tag=None, extra=None,
               size=None, pace=None, kernels=True, written=None):
    """Write `family`'s folder of n frames under `out` (or, given
    `written`, a future of that write started elsewhere, wait for it),
    run it through its entry point and check it: two windows mapped, both
    tile kernels launched on every training and refinement iteration,
    finite poses and map, and (on a card, with `kernels`) both kernels
    against their plain twins on the final map. Returns a record of its
    numbers."""
    import torch
    from vings_mono_tpu_torch.runners import evaluate
    from vings_mono_tpu_torch.runners import run as run_mod
    from vings_mono_tpu_torch.ops.rasterizer import tile_kernel as tk
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
                        "use_vis", "use_global_ba", "use_refine")
            if cfg.get(k)]
    print(f"{tag} {family.config.relative_to(ROOT)} through "
          f"{family.entry}: mode {cfg['mode']}, middleware "
          f"{cfg['middleware'].get('variant')}, {opts}, {n} frames of the "
          f"room written in the {family.layout} layout at {src[1]}x{src[2]} "
          f"in {write_s:.1f} s, tracked at {h}x{w} ({h / 16:.2f} x "
          f"{w / 16:.2f} tiles), save_buffer "
          f"{cfg['frontend']['save_buffer']}", flush=True)
    cuda = torch.device(device).type == "cuda"
    watch = Watch(folder, cuda)
    phone = None
    if family.entry == "server":
        msgs, n_imu = phone_messages(folder, n,
                                     (pace or family.revs_per_frame) * n)

    tk.rasterize_forward.launches = 0
    tk.rasterize_backward.launches = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with watch:
        if family.entry == "server":
            tracker, mapper, phone, load_ms = drive_phone(
                cfg, msgs, n, save_dir, device)
            stages = {k: float(np.mean(v)) for k, v in
                      watch.stage_ms.items()}
            counts = {k: len(v) for k, v in watch.stage_ms.items()}
        else:
            run = run_mod.run
            if family.entry == "run_mobile":
                from vings_mono_tpu_torch.runners import run_mobile
                entry = run_mobile.run

                def run_with(cfg_, save_dir_, max_frames=None, on_frame=None,
                             device=None):
                    # run_mobile's own hook, then the watch's
                    def both(*a):
                        on_frame(*a)
                        watch.on_frame(*a)
                    return run(cfg_, save_dir_, max_frames, on_frame=both,
                               device=device, sync_timer=True)
                with cs.replaced(run_mod, "run", run_with):
                    tracker, mapper, timer = entry(cfg, str(save_dir),
                                                   ply_every=PLY_EVERY)
            else:
                tracker, mapper, timer = run(
                    cfg, str(save_dir), sync_timer=True,
                    on_frame=watch.on_frame)
            stages = {k: 1e3 * timer.totals[k] / max(timer.counts[k], 1)
                      for k in timer.totals}
            counts = dict(timer.counts)
            load_ms = watch.timed[0].ms
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    launches = {"rasterize_forward": tk.rasterize_forward.launches,
                "rasterize_backward": tk.rasterize_backward.launches}
    smi = cs.nvidia_smi() if cuda else "cpu"
    if phone is None:
        from vings_mono_tpu_torch.datasets.base import get_dataset
        ate = evaluate.eval_trajectory(str(save_dir), get_dataset(cfg))
    else:
        from vings_mono_tpu_torch.utils.trajectory import (ate_rmse,
                                                           tracker_c2ws)
        # the phone's timestamps are k * PHONE_DT, its frames' poses pose/k
        ts, c2ws = tracker_c2ws(tracker)
        k = np.round(np.asarray(ts) / PHONE_DT)
        ate = ate_rmse(k, c2ws, k, ground_truth(folder, k))
    psnr = evaluate.eval_psnr(mapper, tracker)
    train_psnr = mapper.last_metrics.get("psnr")
    v = tracker.video
    n_kf = v.counter + v.count_save
    trains = watch.trains
    refine_iters = sum(r["iters"] for r in watch.refines)
    rec = {"family": family.key, "tag": tag, "entry": family.entry,
           "config": str(family.config.relative_to(ROOT)), "frames": n,
           "source": [src[1], src[2]], "tracked": [h, w], "wall_s": wall,
           "frames_per_s": n / wall, "stage_ms": stages,
           "stage_n": counts,
           "dataset_ms_mean": float(np.mean(load_ms)),
           "dataset_ms_median": float(np.median(load_ms)),
           "peak_gb": peak_gb, "keyframes": n_kf, "windows": mapper.time_idx,
           "windows_at": watch.windows_at, "ate": ate, "psnr": psnr,
           "train_psnr": train_psnr, "launches": launches,
           "train_calls": len(trains),
           "train_iters": sum(t[0] for t in trains),
           "refine_iters": refine_iters, "card": smi}
    loader = "the server's _decode_frame" if phone else "dataset[idx]"
    print(f"{tag} run [{smi}]: {n} frames in {wall:.1f} s "
          f"({rec['frames_per_s']:.3f} frames/s), {n_kf} keyframes, "
          f"windows mapped {mapper.time_idx} (at frames "
          f"{watch.windows_at}); {loader} host "
          f"{rec['dataset_ms_mean']:.2f} ms mean, "
          f"{rec['dataset_ms_median']:.2f} median over {len(load_ms)} "
          f"frames ({src[1]}x{src[2]} -> {h}x{w}); peak device memory "
          f"{peak_gb if peak_gb is None else round(peak_gb, 3)} GB; ATE "
          f"{ate if ate is None else round(ate, 4)} (scale-aligned, "
          f"against pose/), PSNR {psnr} dB (eval_psnr), last train PSNR "
          f"{train_psnr}; launches {launches} over {rec['train_iters']} "
          f"training iterations in {len(trains)} train calls and "
          f"{refine_iters} refinement iterations", flush=True)
    synced = ("on each thread's stream" if phone else "each stage "
              "synchronized")
    print(f"{tag} stage ms (host clock, {synced}): "
          + ", ".join(f"{k} {ms:.1f} x{counts[k]}"
                      for k, ms in sorted(stages.items())), flush=True)
    cs.check(len(load_ms) == n, f"{tag}: not every frame loaded")
    cs.check(mapper.time_idx >= 2, f"{tag}: {mapper.time_idx} windows "
             f"mapped, not two")
    if cuda:
        for iters, nf, nb in trains:
            cs.check(nf >= iters and nb >= iters, f"{tag}: a train call "
                     f"of {iters} iterations launched the kernels {nf} / "
                     f"{nb} times")
        for r in watch.refines:
            nf, nb = r["launches"]
            cs.check(nf >= r["iters"] and nb >= r["iters"], f"{tag}: a "
                     f"refinement of {r['iters']} iterations launched the "
                     f"kernels {nf} / {nb} times")
        for name, cnt in launches.items():
            cs.check(cnt >= rec["train_iters"] + refine_iters,
                     f"{tag}: {name} launched {cnt} times")
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
        report_vio(tag, rec, tracker, watch)
    if watch.got.get("looper") is not None:
        report_loop(tag, rec, watch, mapper, tracker, folder, h, w)
    if cfg.get("use_refine"):
        report_refine(tag, rec, watch, tracker, folder)
    if family.entry == "run_mobile":
        report_plys(tag, rec, watch, tracker, folder)
    if phone is not None:
        report_phone(tag, rec, phone, n, n_imu, (h, w))
    if cuda and kernels:
        c2w, intr, label = cs.seen_camera(mapper, watch.cams, tag=tag)
        errs = cs.kernels_on(tag, [(label, mapper.state, c2w, intr)],
                             dict(mapper.bin_kwargs), seed + 90)
        rec["max_abs_err"] = {"rasterize_forward": errs[0],
                              "rasterize_backward": errs[1]}
        rec["max_err_over_scale"] = {"rasterize_forward": errs[2],
                                     "rasterize_backward": errs[3]}
    rec["digest"] = digest(tracker, mapper)
    del tracker, mapper
    if cuda:
        torch.cuda.empty_cache()
    return rec


def report_vio(tag, rec, tracker, watch):
    rec["vi_alignments"] = watch.aligned
    print(f"{tag} VI init: IMU fusion on: "
          f"{tracker.frontend.inertial.imu_enabled}; alignments "
          f"(keyframes, succeeded, largest gravity error of the window's "
          f"states against the truth, its path length over the truth's): "
          + ", ".join(f"({a['t0']}-{a['t1']}, {a['ok']}, "
                      f"{a['gravity_deg']:.2f} deg, {a['path_ratio']:.4f})"
                      for a in watch.aligned), flush=True)


def report_loop(tag, rec, watch, mapper, tracker, folder, h, w):
    looper = watch.got["looper"]
    traces = looper.detector.traces
    rec["loop_attempts"] = [t["stage"] for t in traces]
    rec["first_attempt_frame"] = watch.got.get("first_attempt")
    rec["loop_calls"] = watch.got.get("loop_calls", [])
    print(f"{tag} loop: {len(traces)} attempts reaching stages "
          f"{rec['loop_attempts']} (matches "
          f"{[t['matches'] for t in traces]}, PnP inliers "
          f"{[t['pnp_inliers'] for t in traces]}), the first after "
          f"frame {rec['first_attempt_frame']}; closures "
          f"{[(t['cand_gid'], t['cur_gid']) for t in looper.loop_traces]}"
          f"; loop calls (frame, newest keyframe id, distance to the "
          f"nearest keyframe min_history {looper.min_history} older; "
          f"search radius {looper.search_radius}): "
          + ", ".join(f"({f}, {c}, {'-' if d is None else round(d, 3)})"
                      for f, c, d in rec["loop_calls"]), flush=True)
    if not traces:
        tr = rec["direct_detect"] = direct_detect(
            looper, mapper, tracker, watch.got["last_viz"], folder)
        print(f"{tag} loop detector called directly (the run made no "
              f"attempt): the newest keyframe {tr['cur_gid']} against "
              f"keyframe {tr['cand_gid']}, {tr['gt_distance']:.3f} apart "
              f"in the ground truth, at {h}x{w}: stage {tr['stage']}, "
              f"matches {tr['matches']}, PnP inliers {tr['pnp_inliers']}, "
              f"map render share {tr['rend_frac']}", flush=True)


def report_refine(tag, rec, watch, tracker, folder):
    """F6: each refined window's ms, launches, the poses' change, each
    keyframe's position error against pose/ before and after (the whole
    run's keyframes Umeyama-aligned to the truth), and that the tracker
    held the refined poses; checked against REFINE_ERR_TOL, POSE_ERR_MAX
    and RETRIEVE_TOL."""
    from vings_mono_tpu_torch.utils.trajectory import tracker_c2ws
    ts, c2ws = tracker_c2ws(tracker)
    s, R, t = umeyama(np.asarray(c2ws)[:, :3, 3],
                      ground_truth(folder, ts)[:, :3, 3])
    wins = []
    cs.check(len(watch.refines) >= 2, f"{tag}: {len(watch.refines)} "
             f"windows refined, not two")
    for r in watch.refines:
        gt = ground_truth(folder, r["ts"])[:, :3, 3]
        err = {k: np.linalg.norm(s * r[k][:, :3, 3] @ R.T + t - gt, axis=-1)
               for k in ("before", "after")}
        move, turn = rigid_change(r["before"], r["after"])
        wins.append({"frame": r["frame"], "keyframes": len(r["ts"]),
                     "ms": r["ms"], "launches": list(r["launches"]),
                     "move_max": float(move.max()),
                     "turn_deg_max": float(turn.max()),
                     "err_before": err["before"].tolist(),
                     "err_after": err["after"].tolist(),
                     "retrieved_err": r["retrieved_err"]})
    rec["refine"] = {"windows": wins, "scale": float(s),
                     "bias_ms": watch.biases}
    print(f"{tag} refinement ({len(wins)} windows, 20 iterations each; "
          f"the run's keyframes aligned to pose/ at scale {s:.4f}): "
          f"apply_pose_bias_to_gaussians {np.mean(watch.biases):.2f} ms "
          f"mean over {len(watch.biases)}", flush=True)
    for wn in wins:
        eb, ea = np.mean(wn["err_before"]), np.mean(wn["err_after"])
        print(f"{tag} refined window at frame {wn['frame']}: "
              f"{wn['keyframes']} keyframes, {wn['ms']:.1f} ms, launches "
              f"{wn['launches']}, poses moved {wn['move_max']:.3e} units / "
              f"{wn['turn_deg_max']:.3e} deg at most; position error "
              f"against pose/ mean {eb:.4f} -> {ea:.4f} (max "
              f"{max(wn['err_before']):.4f} -> {max(wn['err_after']):.4f}) "
              f"room units; the tracker holds the refined poses to "
              f"{wn['retrieved_err']:.2e}", flush=True)
        cs.check(ea <= eb + REFINE_ERR_TOL, f"{tag}: refinement moved a "
                 f"window's error {eb:.4f} -> {ea:.4f}, over "
                 f"{REFINE_ERR_TOL}")
        cs.check(max(eb, ea) <= POSE_ERR_MAX, f"{tag}: a window's pose "
                 f"error {eb:.4f} / {ea:.4f} is over {POSE_ERR_MAX}")
        cs.check(wn["retrieved_err"] <= RETRIEVE_TOL, f"{tag}: the "
                 f"tracker does not hold the refined poses "
                 f"({wn['retrieved_err']:.2e})")


def report_plys(tag, rec, watch, tracker, folder):
    """F7: each .ply's Gaussians against those alive on the device and
    those paged to the host when it was written, the rows paged, and the
    tracker's units per room unit (the paging threshold is in the
    former)."""
    from vings_mono_tpu_torch.utils.trajectory import tracker_c2ws
    ts, c2ws = tracker_c2ws(tracker)
    s = umeyama(np.asarray(c2ws)[:, :3, 3],
                ground_truth(folder, ts)[:, :3, 3])[0]
    rec["units_per_room_unit"] = 1.0 / s
    storage = watch.got.get("storage")
    rec["plys"] = watch.plys
    rec["paged_out"] = storage.pages_out if storage else 0
    rec["paged_in"] = storage.pages_in if storage else 0
    maps = [p for p in watch.plys if p["file"].startswith("map_")]
    print(f"{tag} plys (file: written / alive on the device + on the host): "
          + ", ".join(f"{p['file']}: {p['written']} / {p['device']} + "
                      f"{p['host']}" for p in watch.plys)
          + f"; storage paged {rec['paged_out']} rows out and "
          f"{rec['paged_in']} back in (threshold "
          f"{storage.threshold if storage else None} of the tracker's "
          f"units, {1.0 / s:.4f} to the room's unit)", flush=True)
    cs.check(len(maps) >= 2, f"{tag}: {len(maps)} map .ply written")
    cs.check(all(p["written"] == p["device"] for p in watch.plys),
             f"{tag}: a .ply holds other than the device's Gaussians")


def report_phone(tag, rec, phone, n, n_imu, hw):
    rec["phone"] = phone
    p = phone
    print(f"{tag} phone pipeline over {p['transport']}: {p['frames_received']}"
          f" frames received (decode {p['decode_ms_mean']:.2f} ms mean at "
          f"the phone's size), {p['frames_tracked']} tracked; windows "
          f"{p['windows_packaged']} packaged, {p['windows_mapped']} mapped, "
          f"{p['windows_dropped']} dropped; renders {p['renders_put']} "
          f"made, one a mapped window ({p['renders_finite']} finite, "
          f"{p['render_shapes']}), {p['renders_sent']} sent as JPEG "
          f"{p['sent_shapes']}, the newest at each of the sender's turns "
          f"(encode {p['encode_ms_mean']} ms mean), the last among them; "
          f"imu.csv {p['imu_rows']} rows "
          f"of {n_imu} IMU messages; the client sent every message in "
          f"{p['send_s']:.2f} s, the pipeline ended {p['session_s']:.2f} s "
          f"after the first ({p['frames_per_s']:.3f} frames/s end to end); "
          f"the server's queue of frames peaked at {p['queue_high']}, full "
          f"{p['queue_full_waits']} times, the receiver waited "
          f"{p['queue_waited_s']:.2f} s: kept up with the socket: "
          f"{p['kept_up']}", flush=True)
    cs.check(p["frames_received"] == p["frames_tracked"] == n,
             f"{tag}: frames lost between the phone and the tracker")
    cs.check(p["windows_mapped"] >= 2 and p["renders_put"] ==
             p["windows_mapped"] == p["renders_finite"]
             and 1 <= p["renders_sent"] <= p["renders_put"]
             and p["render_shapes"] == [str(hw + (3,))]
             and p["sent_shapes"] == [str(hw + (3,))],
             f"{tag}: not one finite render per mapped window, or none "
             f"sent")
    cs.check(p["imu_rows"] == n_imu, f"{tag}: imu.csv has {p['imu_rows']} "
             f"rows for {n_imu} IMU messages")


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
            if key == "F7":
                recs.append(rec)
                rec = run_family(fam, PAGING_FRAMES, OUT / (key + "_paging"),
                                 device, args.seed, tag="F7 paging",
                                 extra=PAGING)
                cs.check(rec["paged_out"] > 0 and rec["paged_in"] > 0,
                         "F7 paging: no rows paged out and back in")
        except SystemExit:
            # cs.check printed the failure; the other families still run,
            # and the script exits 1 at the end
            failed.append(key)
            continue
        recs.append(rec)
    print(f"profile_configs: {len(recs)} runs in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if failed:
        cs.fail(f"families {failed} failed")
    print(cs.nvidia_smi() if device.type == "cuda" else "cpu", flush=True)
    print(json.dumps({"families": recs}), flush=True)


if __name__ == "__main__":
    main()
