"""Port parity and behaviour of the remaining runners on a `kitti_sync`
folder that the test writes (the synthetic3d room at 48x72, loaded at
32x48 with the KITTI layout: image_02/data, metadata/camstamp.txt,
c2i.txt and imu.txt, pose/<t>.txt):

  * `run_tracking` of both packages: the same keyframe timestamps, poses
    within 10 % of the JAX path's extent (test_torch_vo_slice's tolerance);
  * the `vizout_dict` dumps of each package replayed by the other's
    `run_mapping`;
  * the threaded `run_multiprocess`: its tracker equal to `run_tracking`'s
    on the CPU, an exception in a worker raised again with no hang, the
    TF32 flags unchanged after it;
  * `run_mobile`'s ply every N frames, and `run_multiprocess_mobile`'s
    workers fed from a queue, with the same error and flag checks.

A runner that could hang is called in a thread joined with a timeout, so
a hang fails the test instead of stalling the lane."""

import glob
import os
import pathlib
import queue
import threading

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_pipeline import make_cfg as j_make_cfg
from vings_mono_tpu.runners import run_mapping as j_run_mapping
from vings_mono_tpu.runners import run_tracking as j_run_tracking
from vings_mono_tpu.utils.trajectory import tracker_c2ws as j_tracker_c2ws
from vings_mono_tpu_torch.datasets.synthetic3d import (render_room,
                                                       texture_params,
                                                       trajectory_c2w)
from vings_mono_tpu_torch.runners import (run_mapping, run_mobile,
                                          run_multiprocess,
                                          run_multiprocess_mobile,
                                          run_tracking)
from vings_mono_tpu_torch.utils.config import load_config
from vings_mono_tpu_torch.utils.trajectory import ate_rmse, tracker_c2ws

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "vings_mono_tpu/weights/droid_selftrained.npz"
SH, SW = 48, 72          # stored frames
H, W = 32, 48            # tracked frames
N_FRAMES = 12
DT = 0.1
JOIN_S = 300.0           # a runner that takes longer has hung


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test worker: the lane runs several workers,
    and the JAX runs beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_kitti_folder(root, n=N_FRAMES):
    """The room along synthetic3d's trajectory in the kitti_sync layout;
    ground truth as pose/<t>.txt c2ws."""
    intr = np.asarray([0.9 * SW, 0.9 * SW, SW / 2, SH / 2], np.float32)
    tex = texture_params(0)
    for d in ("image_02/data", "metadata", "pose"):
        os.makedirs(root / d, exist_ok=True)
    lines = []
    for k in range(n):
        c2w = trajectory_c2w(k, 40, revs=0.6)
        rgb, _ = render_room(c2w, intr, SH, SW, tex=tex)
        name = f"{k:010d}.png"
        cv2.imwrite(str(root / "image_02/data" / name),
                    np.round(rgb[..., ::-1] * 255).astype(np.uint8))
        lines.append(f"{k * DT:.6f} {name}")
        np.savetxt(root / "pose" / f"{k * DT:.6f}.txt", c2w)
    (root / "metadata/camstamp.txt").write_text("\n".join(lines) + "\n")
    np.savetxt(root / "metadata/c2i.txt", np.eye(4))
    imu = np.zeros((10 * n, 7))
    imu[:, 0] = np.arange(10 * n) * DT / 10
    np.savetxt(root / "metadata/imu.txt", imu)
    return {"fu": float(intr[1]), "fv": float(intr[0]),
            "cu": float(intr[3]), "cv": float(intr[2]), "H": SH, "W": SW}


def cfgs(tmp, folder, intrinsic, **extra):
    """tests/test_pipeline.py's configuration on the folder, for both
    packages (f32 GRU, the repository's DroidNet weights, debug dumps)."""
    jcfg = j_make_cfg(tmp / "jax")
    jcfg["dataset"] = {"module": "kitti_sync", "root": str(folder),
                       "imu_delay": 0.0}
    jcfg["intrinsic"] = dict(intrinsic)
    jcfg["debug_mode"] = True
    jcfg["frontend"].update({"weight": str(WEIGHTS), "bf16_gru": False,
                             "image_size": [H, W]})
    over = {k: jcfg[k] for k in ("mode", "dataset", "frontend",
                                 "training_args", "middleware",
                                 "intrinsic", "debug_mode")}
    over["mapper"] = {k: v for k, v in jcfg["mapper"].items()
                      if k != "impl"}
    over["output"] = {"save_dir": str(tmp / "torch")}
    over.update(extra)
    return jcfg, load_config(overrides=over)


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    """The folder, both configurations and one run_tracking of each
    package (debug dumps on)."""
    tmp = tmp_path_factory.mktemp("runners")
    intrinsic = write_kitti_folder(tmp / "kitti")
    jcfg, tcfg = cfgs(tmp, tmp / "kitti", intrinsic)
    jdir, tdir = tmp / "jax_run", tmp / "torch_run"
    jtr = j_run_tracking.run(jcfg, str(jdir))
    ttr = run_tracking.run(tcfg, str(tdir), device="cpu")
    return {"tmp": tmp, "intrinsic": intrinsic, "jcfg": jcfg, "tcfg": tcfg,
            "jdir": jdir, "tdir": tdir, "jax": j_tracker_c2ws(jtr),
            "torch": tracker_c2ws(ttr)}


def test_run_tracking_as_jax(tracked):
    jts, jc2w = tracked["jax"]
    tts, tc2w = tracked["torch"]
    assert tts == jts and len(tts) == N_FRAMES
    extent = np.ptp(np.asarray(jc2w)[:, :3, 3], axis=0).max()
    rmse = ate_rmse(tts, tc2w, jts, jc2w, scale_align=False)
    assert rmse <= 0.1 * extent, (rmse, extent)
    for d in (tracked["jdir"], tracked["tdir"]):
        assert len(list((d / "droid_c2w").glob("*.txt"))) == N_FRAMES


@pytest.mark.parametrize("direction", ["torch_dumps_in_jax",
                                       "jax_dumps_in_torch"])
def test_vizout_dumps_replay_across(tracked, direction, tmp_path):
    """Each package's debug dumps hold the same windows (the same
    keyframe timestamps and shapes) and map in the other's run_mapping."""
    jdumps = sorted((tracked["jdir"] / "vizout_dict").glob("*.npz"))
    tdumps = sorted((tracked["tdir"] / "vizout_dict").glob("*.npz"))
    assert len(tdumps) == len(jdumps) > 3
    for a, b in zip(jdumps, tdumps):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].shape == zb[k].shape, k
            assert np.array_equal(za["viz_out_idx_to_f_idx"],
                                  zb["viz_out_idx_to_f_idx"])
            assert np.array_equal(za["global_kf_id"], zb["global_kf_id"])
    if direction == "torch_dumps_in_jax":
        cfg = dict(tracked["jcfg"])
        cfg["dataset"] = {"module": "replay",
                          "root": str(tracked["tdir"] / "vizout_dict")}
        os.makedirs(tmp_path / "ply")
        mapper = j_run_mapping.run(cfg, str(tmp_path), max_windows=3)
    else:
        cfg = load_config(overrides={**tracked["tcfg"], "dataset": {
            "module": "replay",
            "root": str(tracked["jdir"] / "vizout_dict")}})
        mapper, records = run_mapping.run(cfg, str(tmp_path),
                                          max_windows=3, device="cpu")
        assert all(r["losses_finite"] for r in records)
    assert mapper.time_idx == 3 and mapper.n_alive > 100
    assert (tmp_path / "ply" / "final_2dgs.ply").stat().st_size > 1000


def in_thread(fn, *args, **kw):
    """fn(*args, **kw) in a thread joined with JOIN_S; returns its result
    or raises its exception. Fails when it has not ended by then."""
    out = {}

    def body():
        try:
            out["result"] = fn(*args, **kw)
        except Exception as e:   # handed to the test's thread below
            out["error"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), f"{fn.__name__} hung"
    if "error" in out:
        raise out["error"]
    return out["result"]


@pytest.fixture
def odd_tf32(monkeypatch):
    """Flags that no product code sets (both TF32 paths on), so a runner
    that leaves them changed is seen."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    yield
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_run_multiprocess_tracker_equals_run_tracking(tracked, tmp_path,
                                                      odd_tf32):
    """The tracker thread computes what run_tracking computes (no
    refinement flows back from the mapper); every window was mapped or
    dropped by the backpressure; the .ply is written."""
    tr, mapper, stats = in_thread(run_multiprocess.run, tracked["tcfg"],
                                  str(tmp_path), device="cpu")
    ts, c2w = tracker_c2ws(tr)
    tts, tc2w = tracked["torch"]
    assert ts == tts
    np.testing.assert_allclose(np.asarray(c2w), np.asarray(tc2w), rtol=0,
                               atol=1e-6)
    assert stats["mapped"] + stats["dropped"] == stats["windows"] > 3
    assert stats["mapped"] >= mapper.time_idx >= 1
    assert (tmp_path / "ply" / "final_2dgs.ply").stat().st_size > 1000
    assert len(list((tmp_path / "droid_c2w").glob("*.txt"))) == N_FRAMES


class Boom(RuntimeError):
    pass


def test_a_failing_worker_fails_run_multiprocess(tracked, tmp_path,
                                                 monkeypatch, odd_tf32):
    """A dataset that raises at frame 3: run raises that exception (the
    JAX runner hangs here: its end sentinel is never queued)."""
    from vings_mono_tpu_torch.datasets import kitti_sync
    get_item = kitti_sync.KITTISyncDataset.__getitem__

    def failing(self, idx):
        if idx == 3:
            raise Boom("frame 3")
        return get_item(self, idx)
    monkeypatch.setattr(kitti_sync.KITTISyncDataset, "__getitem__", failing)
    with pytest.raises(Boom):
        in_thread(run_multiprocess.run, tracked["tcfg"], str(tmp_path),
                  device="cpu")


def test_a_failing_mapper_stops_run_multiprocess(tracked, tmp_path,
                                                 monkeypatch):
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper

    def failing(self, viz_out):
        raise Boom("mapper")
    monkeypatch.setattr(GaussianMapper, "run", failing)
    with pytest.raises(Boom):
        in_thread(run_multiprocess.run, tracked["tcfg"], str(tmp_path),
                  device="cpu")


def test_run_mobile_writes_a_ply_every_n_frames(tracked, tmp_path):
    """A ply after every second frame once the map exists (the frontend
    initializes at frame 8, so the first window maps then)."""
    _, mapper, _ = run_mobile.run(tracked["tcfg"], str(tmp_path),
                                  ply_every=2, device="cpu")
    assert mapper.initialized
    plys = sorted(os.path.basename(p) for p in
                  glob.glob(str(tmp_path / "ply" / "map_*_3dgs.ply")))
    first = int(plys[0][4:10])
    assert plys == [f"map_{i:06d}_3dgs.ply"
                    for i in range(first, N_FRAMES, 2)]
    assert first % 2 == 1 and first <= 9 and len(plys) >= 2
    with open(tmp_path / "ply" / plys[-1], "rb") as f:
        header = f.read(2000)
    assert b"f_dc_0" in header and b"scale_2" in header   # the 3DGS layout


def feed(s2t, folder, n):
    """The server's role: frames of the folder as decoded (float RGB at the
    stored size) with their timestamps, then the end sentinel."""
    meta = np.loadtxt(folder / "metadata/camstamp.txt", dtype=str)[:n]
    for t, name in meta:
        bgr = cv2.imread(str(folder / "image_02/data" / name))
        s2t.put({"timestamp": float(t),
                 "rgb": bgr[..., ::-1].astype(np.float32) / 255.0})
    s2t.put(None)


def test_mobile_workers_fed_from_a_queue(tracked, odd_tf32):
    """One finite (H, W, 3) render of the newest keyframe per mapped
    window, and the tracker's keyframes those of run_tracking."""
    s2t, m2s = queue.Queue(), queue.Queue()
    workers, results, stats = run_multiprocess_mobile.start_workers(
        tracked["tcfg"], s2t, m2s, device="cpu")
    feed(s2t, tracked["tmp"] / "kitti", N_FRAMES)
    in_thread(workers.join)
    renders = []
    while not m2s.empty():
        renders.append(m2s.get_nowait())
    assert stats["frames"] == N_FRAMES
    assert len(renders) == stats["mapped"] >= results["mapper"].time_idx > 0
    for r in renders:
        assert r.shape == (H, W, 3) and np.isfinite(r).all()
    ts, _ = tracker_c2ws(results["tracker"])
    assert ts == tracked["torch"][0]


def test_a_failing_mobile_worker_fails_the_pipeline(tracked, monkeypatch):
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper

    def failing(self, viz_out):
        raise Boom("mapper")
    monkeypatch.setattr(GaussianMapper, "run", failing)
    s2t, m2s = queue.Queue(), queue.Queue()
    workers, _, _ = run_multiprocess_mobile.start_workers(
        tracked["tcfg"], s2t, m2s, device="cpu")
    threading.Thread(target=feed, args=(s2t, tracked["tmp"] / "kitti",
                                        N_FRAMES), daemon=True).start()
    with pytest.raises(Boom):
        in_thread(workers.join)
