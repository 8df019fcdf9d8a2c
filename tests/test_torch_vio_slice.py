"""Port parity for the visual-inertial slice as a whole: `runners.run.run`
of the port against the JAX package's with `mode: vio` and
`use_storage_manager`, on the `synthetic3d` room at 64x96 with an IMU
stream derived from the room's analytic trajectory (below), the DroidNet
weights in the repository and an f32 GRU: dataset -> tracker -> inertial
fusion -> middleware -> mapper -> storage paging -> files.

What must be equal: the keyframes, the frame at which VI init fires, and
the storage manager's decisions (evict and page-in events, the placement of
every keyframe). The rows each event moves are the rows of two maps whose
densification decides per pixel in f32 (the port replays the JAX mapper's
random draws, as tests/test_torch_slice.py does, and still the two maps
differ by 10-45 % in size over these runs), so the row counts are not
compared across packages; each package must account for every row it paged
out. Trajectories: keyframe positions within 0.05 room units rms of the
JAX run's, and the ATE against the ground truth within 0.05 of JAX's."""

import os
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import vings_mono_tpu.datasets.base as j_base
import vings_mono_tpu.storage.manager as j_storage
import vings_mono_tpu_torch.datasets.base as t_base
import vings_mono_tpu_torch.mapper.mapper as t_mapper
import vings_mono_tpu_torch.storage.manager as t_storage
from test_pipeline import make_cfg as j_make_cfg
from test_torch_slice import JaxDraws
from vings_mono_tpu.datasets.synthetic3d import Synthetic3DDataset as JRoom
from vings_mono_tpu.runners.run import run as j_run
from vings_mono_tpu.tracker.vio import InertialFusion as JInertial
from vings_mono_tpu.utils.trajectory import tracker_c2ws as j_tracker_c2ws
from vings_mono_tpu_torch.datasets.synthetic3d import Synthetic3DDataset
from vings_mono_tpu_torch.ops import lie
from vings_mono_tpu_torch.runners import run as run_t
from vings_mono_tpu_torch.tracker.video import empty_buffers
from vings_mono_tpu_torch.tracker.vio import InertialFusion
from vings_mono_tpu_torch.utils.config import load_config
from vings_mono_tpu_torch.utils.trajectory import ate_rmse, tracker_c2ws

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "vings_mono_tpu/weights/droid_selftrained.npz"
DT = 0.05           # camera frame period, s
IMU_HZ = 100.0      # KITTI's IMU rate
GRAVITY = 9.81      # along the room's down axis (+y, the camera's down)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops at these sizes are small. With the default thread
    count every test worker spins a whole OpenMP team on each of them, and
    the workers (and the JAX runs beside them) starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """synthetic3d at a frame period of DT with room_imu's stream."""
    class RoomWithImu(room_cls):
        def __getitem__(self, k):
            pkt = super().__getitem__(k)
            pkt["timestamp"] = k * DT
            return pkt

        def preload_imu(self):
            return room_imu(self.n, self.revs, DT, self.room)

        def load_gt_dict(self):
            gt = super().load_gt_dict()
            gt["timestamps"] = gt["timestamps"] * DT
            return gt
    return RoomWithImu


def test_room_imu_matches_finite_differences():
    from vings_mono_tpu_torch.datasets.synthetic3d import trajectory_c2w
    from vings_mono_tpu_torch.tracker.imu import so3_log
    n, revs = 40, 1.2
    imu = room_imu(n, revs, DT)
    c2w = lambda k: trajectory_c2w(k, n, 4.0, revs)  # noqa: E731
    for k in (3.0, 11.0, 27.0):
        i = int(round(k * DT * IMU_HZ))
        assert abs(imu[i, 0] - k * DT) < 1e-12
        h = 1e-4
        R = c2w(k)[:3, :3]
        w = so3_log(c2w(k - h)[:3, :3].T @ c2w(k + h)[:3, :3]) / (2 * h * DT)
        np.testing.assert_allclose(np.deg2rad(imu[i, 1:4]), w, atol=1e-5)
        a = (c2w(k + h)[:3, 3] - 2 * c2w(k)[:3, 3] + c2w(k - h)[:3, 3]) \
            / (h * DT) ** 2
        np.testing.assert_allclose(
            imu[i, 4:7], R.T @ (a - [0.0, GRAVITY, 0.0]), atol=1e-3)


class _Video:
    """A video holding only the ground-truth poses of the keyframes at
    `frames` (as w2c quaternions, float32 like the tracker's), their
    timestamps and unit disparities."""

    def __init__(self, c2ws, frames):
        n = len(frames)
        self.bufs = empty_buffers(n, 64, 96)
        self.bufs.disps[:] = 1.0
        self.bufs.poses[:n] = lie.se3_from_matrix(torch.as_tensor(
            np.linalg.inv(c2ws), dtype=torch.float32))
        self.counter = n
        self.tstamps_host = [k * DT for k in frames]
        self.imu_enabled = self.visual_only_init = False


def _jvideo(video):
    class Bufs:
        def __init__(self, poses, disps):
            self.poses, self.disps = poses, disps

        def replace(self, **kw):
            return Bufs(kw.get("poses", self.poses),
                        kw.get("disps", self.disps))

    class V:
        pass

    v = V()
    v.bufs = Bufs(jnp.asarray(video.bufs.poses.numpy()),
                  jnp.asarray(video.bufs.disps.numpy()))
    v.tstamps_host = list(video.tstamps_host)
    v.counter = video.counter
    v.imu_enabled = v.visual_only_init = False
    return v


@pytest.mark.parametrize("first", [0, 40])
@pytest.mark.parametrize("bias", [False, True])
def test_alignment_on_ground_truth_room_poses(first, bias):
    """VINS-Mono alignment on room_imu with the room's ground-truth poses,
    at chip_smoke.py phase 8's keyframe spacing (every second frame of a
    0.05 s period, 0.01 circle per frame; 14 keyframes from frame `first`,
    aligned over the last 8, as `maybe_initialize` does), with no gyro bias
    (phase 8's stream) or with 0.01-0.02 rad/s on each axis:

      * the excitation passes the 0.25 gate and `maybe_initialize` fires on
        the fourteenth keyframe;
      * the first alignment (lever arm ignored) recovers the gyro bias
        within 5e-3 rad/s, the scale within 2e-2 of 1, the gravity within
        0.5 degree of the room's down axis and the window's velocities
        within 1 % (the stream is sampled at 100 Hz and integrated by
        forward steps, which leaves ~1e-2 on the scale and ~2e-3 rad/s on
        the bias);
      * the port's states equal the JAX package's after the first
        alignment and after the whole `maybe_initialize` (which aligns a
        second time and, in either package, leaves the gyro bias at ~0:
        ROADMAP.md §C): rotations, positions and velocities within 1e-5 of
        their magnitude, biases within 1e-5 rad/s. Each package turns the
        float32 poses into matrices with its own lie (~1e-7 apart), and
        the alignment's least squares carry that to ~5e-6.

    So the room's IMU conventions hold and the alignment recovers the
    room's scale and gravity: a phase-8 run that goes wrong after VI init
    does so on the tracker's poses."""
    from vings_mono_tpu_torch.datasets.synthetic3d import trajectory_c2w
    n, revs = 120, 1.2
    frames = list(range(first, first + 28, 2))
    t1 = len(frames)
    bg_true = np.array([0.01, -0.02, 0.015]) if bias else np.zeros(3)
    imu = room_imu(n, revs, DT)
    imu[:, 1:4] += np.rad2deg(bg_true)
    c2ws = np.stack([trajectory_c2w(k, n, 4.0, revs) for k in frames])
    # vi_warmup as in the KITTI-0028 configuration phase 8 runs
    cfg = load_config(overrides={"mode": "vio", "frontend": {"vi_warmup": 12}})

    def layers():
        tv = _Video(c2ws, frames)
        jv = _jvideo(tv)
        t, j = (InertialFusion(tv, cfg, imu, np.eye(4)),
                JInertial(jv, cfg, imu, np.eye(4)))
        t.init_states()
        j.init_states()
        return tv, t, j

    def same_states(t, j):
        for a, b in zip(t.states, j.states, strict=True):
            for f in ("R", "p", "v"):
                x, y = getattr(a, f), getattr(b, f)
                assert np.abs(x - y).max() <= 1e-5 * max(
                    np.abs(y).max(), 1.0), f
            np.testing.assert_allclose(a.b, b.b, rtol=0, atol=1e-5)

    tv, t, j = layers()
    assert t.excitation(t1) > 0.25
    t.visual_imu_alignment(t1 - 8, t1, ignore_lever=True)
    j.visual_imu_alignment(t1 - 8, t1, ignore_lever=True)
    same_states(t, j)
    np.testing.assert_allclose(t.states[t1 - 1].b[:3], bg_true, atol=5e-3)
    s = 1.0 / float(tv.bufs.disps[:t1].mean())
    assert abs(s - 1.0) <= 2e-2, s
    # the alignment rotates the world so that gravity points along -z
    # (g0 along +z); the room's gravity is +y, so R0 takes -y to +z
    R0 = t.states[t1 - 1].R @ c2ws[t1 - 1, :3, :3].T
    up = R0 @ np.array([0.0, -1.0, 0.0])
    assert np.degrees(np.arccos(min(up[2], 1.0))) <= 0.5, up
    h = 1e-4
    for i in range(t1 - 8, t1):
        k = frames[i]
        v_gt = (trajectory_c2w(k + h, n, 4.0, revs)[:3, 3]
                - trajectory_c2w(k - h, n, 4.0, revs)[:3, 3]) / (2 * h * DT)
        err = np.linalg.norm(t.states[i].v - s * R0 @ v_gt)
        assert err <= 1e-2 * np.linalg.norm(v_gt), (i, err)

    tv, t, j = layers()
    t.maybe_initialize(t1)
    j.maybe_initialize(t1)
    assert t.vi_init_t1 == j.vi_init_t1 == t1 and t.imu_enabled
    same_states(t, j)
    np.testing.assert_allclose(t.states[t1 - 1].b[:3], 0.0, atol=1e-5)


def cfgs(tmp, n, revs, threshold, every):
    jcfg = j_make_cfg(tmp / "jax")
    jcfg.update(mode="vio", use_storage_manager=True, seed=0)
    jcfg["storage_manager"] = {"distance_threshold": threshold,
                               "every": every}
    jcfg["dataset"] = {"module": "synthetic3d", "n_frames": n,
                       "revs": revs}
    jcfg["frontend"].update({
        "image_size": [64, 96], "bf16_gru": False, "weight": str(WEIGHTS),
        "buffer": 40, "frontend_window": 10, "max_factors": 24,
        "edge_capacity": 36, "inactive_capacity": 48, "ba_window": 12,
        "active_window": 10, "max_age": 8, "vi_warmup": 10})
    over = {k: jcfg[k] for k in ("mode", "dataset", "frontend", "seed",
                                 "training_args", "middleware",
                                 "use_storage_manager", "storage_manager")}
    over["mapper"] = {k: v for k, v in jcfg["mapper"].items()
                      if k != "impl"}
    over["output"] = {"save_dir": str(tmp / "torch")}
    return jcfg, load_config(overrides=over)


def run_both(tmp, monkeypatch, n, revs, threshold, every):
    jcfg, tcfg = cfgs(tmp, n, revs, threshold, every)
    monkeypatch.setattr(j_base, "get_dataset",
                        lambda cfg: with_imu(JRoom)(cfg))
    monkeypatch.setattr(t_base, "get_dataset",
                        lambda cfg: with_imu(Synthetic3DDataset)(cfg))
    made = {}

    class JStorage(j_storage.StorageManager):
        def __init__(self, cfg):
            super().__init__(cfg)
            made["jax"] = self

    class TStorage(t_storage.StorageManager):
        def __init__(self, cfg):
            super().__init__(cfg)
            made["torch"] = self

    class Mapper(t_mapper.GaussianMapper):
        def __init__(self, cfg, device=None):
            super().__init__(cfg, device=device)
            draws = JaxDraws(int(cfg.get("seed", 0)))
            self._densify_draws = draws.densify(self)
            self._kf_schedule = draws.schedule

    monkeypatch.setattr(j_storage, "StorageManager", JStorage)
    monkeypatch.setattr(t_storage, "StorageManager", TStorage)
    monkeypatch.setattr(t_mapper, "GaussianMapper", Mapper)
    jdir, tdir = tmp / "jax" / "run", tmp / "torch" / "run"
    os.makedirs(jdir / "ply")
    jtr, jmap, _ = j_run(jcfg, str(jdir))
    ttr, tmap, timer = run_t.run(tcfg, str(tdir), device="cpu")
    assert "storage" in timer.report()
    gt = with_imu(Synthetic3DDataset)(tcfg).load_gt_dict()
    return dict(jtr=jtr, ttr=ttr, jst=made["jax"], tst=made["torch"],
                tmap=tmap,
                j=j_tracker_c2ws(jtr), t=tracker_c2ws(ttr), gt=gt,
                tdir=tdir)


def check(r, pages_in):
    jtr, ttr, jst, tst = r["jtr"], r["ttr"], r["jst"], r["tst"]
    (jts, jc2w), (tts, tc2w) = r["j"], r["t"]
    assert tts == jts
    ji, ti = jtr.frontend.inertial, ttr.frontend.inertial
    assert ti.vi_init_t1 == ji.vi_init_t1 >= 0
    assert ttr.video.imu_enabled and ti.stats["updates"] > 0
    rmse = ate_rmse(tts, tc2w, jts, jc2w, scale_align=False)
    assert rmse <= 0.05, rmse
    for k in ("evict_events", "pagein_events"):
        assert getattr(tst, k) == getattr(jst, k), k
    np.testing.assert_array_equal(tst.place, jst.place)
    assert tst.pages_out > 0 and (tst.pages_in > 0) == pages_in
    for st in (tst, jst):       # every row paged out is on the host or back
        assert st.n_host == st.pages_out - st.pages_in > 0
    poses = sorted((r["tdir"] / "droid_c2w").glob("*.txt"))
    assert len(poses) == len(tts)
    gt = r["gt"]
    jate = ate_rmse(jts, jc2w, gt["timestamps"], gt["c2ws"])
    tate = ate_rmse(tts, tc2w, gt["timestamps"], gt["c2ws"])
    assert abs(tate - jate) <= 0.05, (tate, jate)


def test_vio_storage_slice_pages_out(tmp_path, monkeypatch):
    """16 frames (0.48 of a circle): VI init fires at the eleventh
    keyframe; keyframes the camera has left by more than 0.5 room units (of
    the tracker's own trajectory) are paged out, none comes back."""
    r = run_both(tmp_path, monkeypatch, n=16, revs=0.48, threshold=0.5,
                 every=3)
    check(r, pages_in=False)


@pytest.mark.slow
def test_vio_storage_slice_36_frames(tmp_path, monkeypatch):
    """36 frames (1.08 circles), 1-unit radius: the same decisions through
    eight page-out events and 25 fused-update frames. (At 64x96 these
    weights' trajectory does not come back round, so nothing pages in;
    page-in parity is tests/test_torch_storage.py's, and
    `chip_smoke.py` phase 8 pages in at full width on the card.)"""
    r = run_both(tmp_path, monkeypatch, n=36, revs=1.08, threshold=1.0,
                 every=3)
    check(r, pages_in=False)
