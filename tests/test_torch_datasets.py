"""Port parity of every image-folder dataset module: each case writes one
folder in its module's on-disk layout (the layouts of
tests/test_datasets.py, plus KITTI, KITTI-360 with K and distortion,
TartanAir with depth, and the live folders) and loads it with both
packages. Every packet (`rgb`, `depth`, `intrinsic`, `timestamp`),
`preload_imu`, `preload_camtimestamp`, `c2i` and `load_gt_dict` must be
exactly equal: the loaders are the same numpy and OpenCV calls."""

import os
import threading
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vings_mono_tpu.datasets.base import get_dataset as j_get_dataset
from vings_mono_tpu_torch.datasets.base import get_dataset

H, W = 32, 48      # packet size
SH, SW = 48, 64    # stored frame size
N = 3


def base_cfg(root, module, **dataset):
    return {
        "dataset": {"module": module, "root": str(root), "rgb_strip": 2,
                    "imu_delay": 0.0125, "use_depth": True, **dataset},
        "frontend": {"image_size": [H, W]},
        "intrinsic": {"fv": 40.0, "fu": 41.0, "cv": 32.5, "cu": 23.5,
                      "H": SH, "W": SW},
    }


def frames(dirpath, names, seed=0):
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    for n in names:
        cv2.imwrite(os.path.join(dirpath, n),
                    rng.integers(0, 255, (SH, SW, 3), np.uint8))


def poses(dirpath, stems, seed=1):
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    for s in stems:
        m = np.eye(4)
        m[:3, 3] = rng.normal(size=3)
        np.savetxt(os.path.join(dirpath, f"{s}.txt"), m)


def npy_depths(dirpath, names, seed=2):
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    for n in names:
        np.save(os.path.join(dirpath, n),
                rng.uniform(0.5, 20.0, (SH, SW)).astype(np.float32))


def png_depths(dirpath, names, seed=3):
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    for n in names:
        cv2.imwrite(os.path.join(dirpath, n),
                    rng.integers(0, 60000, (SH, SW), np.uint16))


def imu_rows(n=12, t0=0.0, seed=4):
    rng = np.random.default_rng(seed)
    imu = rng.normal(size=(n, 7))
    imu[:, 0] = t0 + 0.01 * np.arange(n)
    return imu


def camstamp(path, ts, names):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for t, n in zip(ts, names):
            f.write(f"{t:.6f} {n}\n")


NAMES = [f"{i:06d}" for i in range(N)]


def glob_layout(subdir, ext, names=None):
    def write(root):
        ns = names or [f"{s}.{ext}" for s in NAMES]
        frames(root / subdir, ns)
        poses(root / "pose", [n.split(".")[0] for n in ns])
    return write


def kitti(root, data="data"):
    names = [f"{s}.png" for s in NAMES]
    frames(root / "image_02" / data, names)
    camstamp(root / "metadata" / "camstamp.txt",
             100.0 + 0.1 * np.arange(N), names)
    np.savetxt(root / "metadata" / "c2i.txt",
               np.eye(4) + 0.01 * np.arange(16).reshape(4, 4))
    np.savetxt(root / "metadata" / "imu.txt", imu_rows(t0=100.0))
    poses(root / "pose", [f"{100.0 + 0.1 * i:.6f}" for i in range(N)])


def kitti360(root):
    names = [f"{s}.png" for s in NAMES]
    frames(root / "image_00" / "data_rect", names)
    camstamp(root / "metadata" / "camstamp.txt",
             5.0 + 0.1 * np.arange(N), names)
    np.savetxt(root / "metadata" / "c2i.txt", np.eye(4))
    np.savetxt(root / "metadata" / "imu.txt", imu_rows(t0=5.0))


def bundlefusion(root):
    frames(root, [f"frame-{i:06d}.color.jpg" for i in range(2 * N)])
    for i in range(2 * N):
        np.savetxt(root / f"frame-{i:06d}.pose.txt", np.eye(4) * (i + 1))
    np.savetxt(root / "frame-000099.pose.txt", np.eye(3))   # malformed


def mobile_offline(root):
    ns = [1700000000_000000000 + 100000000 * i for i in range(N)]
    frames(root / "pic", [f"{t}.png" for t in ns])
    np.savetxt(root / "c2i.txt", np.eye(4))
    np.savetxt(root / "imu.txt", imu_rows(t0=1.7e9), delimiter=",",
               header="t,gx,gy,gz,ax,ay,az")
    poses(root / "pose", ["1700000000.0", "1700000000.1"])


def realsense_vio(root):
    names = [f"{s}.png" for s in NAMES]
    frames(root / "image_00" / "data_nodyn", names)
    npy_depths(root / "image_00" / "depth", [f"{s}.npy" for s in NAMES[:2]])
    camstamp(root / "DBAF_format" / "camstamp.txt",
             7.0 + 0.1 * np.arange(N), names)
    np.savetxt(root / "DBAF_format" / "c2i.txt", 2 * np.eye(4))
    np.savetxt(root / "DBAF_format" / "imu.txt", imu_rows(t0=7.0))
    poses(root / "pose", ["7.0", "7.1"])


def phone_vio(root):
    frames(root / "rgb", [f"{i}.png" for i in range(N)])
    npy_depths(root / "depth", ["0.npy"])


def replica(root):
    frames(root / "results", [f"frame{s}.jpg" for s in NAMES])
    png_depths(root / "results", [f"depth{s}.png" for s in NAMES])


def scannetv1(root):
    frames(root / "color", [f"{i}.jpg" for i in (0, 2, 10)])
    png_depths(root / "depth", [f"{i}.png" for i in (0, 2, 10)])


def tumrgbd(root):
    ts = 1305031102.0 + 0.033 * np.arange(N)
    frames(root / "rgb", [f"{t:.6f}.png" for t in ts])
    png_depths(root / "depth", [f"{t + 0.01:.6f}.png" for t in ts])
    with open(root / "rgb.txt", "w") as f:
        f.write("# color images\n")
        for t in ts:
            f.write(f"{t:.6f} rgb/{t:.6f}.png\n")
    with open(root / "depth.txt", "w") as f:
        for t in ts:
            f.write(f"{t + 0.01:.6f} depth/{t + 0.01:.6f}.png\n")
    rng = np.random.default_rng(5)
    gt = np.concatenate([ts[:, None], rng.normal(size=(N, 3)),
                         rng.normal(size=(N, 4))], axis=1)
    gt[:, 4:] /= np.linalg.norm(gt[:, 4:], axis=1, keepdims=True)
    np.savetxt(root / "groundtruth.txt", gt, header="timestamp tx ty tz "
               "qx qy qz qw")


def tartanair(root):
    frames(root / "image_left", [f"{s}_left.png" for s in NAMES])
    npy_depths(root / "depth_left", [f"{s}_left_depth.npy" for s in NAMES])
    rng = np.random.default_rng(6)
    rows = np.concatenate([rng.normal(size=(N, 3)), rng.normal(size=(N, 4))],
                          axis=1)
    rows[:, 3:] /= np.linalg.norm(rows[:, 3:], axis=1, keepdims=True)
    np.savetxt(root / "pose_left.txt", rows)


LAYOUTS = {
    "waymo": (glob_layout("color", "jpg"), {}),
    "hierarchical": (glob_layout("color", "png"), {}),
    "pocket": (glob_layout("color", "jpg"), {}),
    "custom": (glob_layout("rgb", "png"), {}),
    "weilai": (glob_layout("nosky_color", "png"), {}),
    "kintinuous": (glob_layout("nosky_color", "png"), {}),
    "meganerf": (glob_layout("rgbs_4", "jpg"), {}),
    "urbanscene3d": (glob_layout("rgb_downsample", None,
                                 ["DJI_2.JPG", "DJI_10.JPG", "DJI_7.JPG"]),
                     {}),
    "rtgslam": (glob_layout("nosky_color", None,
                            ["0.jpg", "1.jpg", "10.jpg"]), {}),
    "kitti_sync": (kitti, {}),
    "kitti_sync_nosky": (lambda r: kitti(r, "data_nosky"), {}),
    "kitti360_unsync": (kitti360, {
        "K": [[40.0, 0.0, 31.0], [0.0, 41.0, 23.0], [0.0, 0.0, 1.0]],
        "distortion": [-0.25, 0.08, 0.001, -0.002, 0.0]}),
    "bundlefusion": (bundlefusion, {}),
    "mobile_offline": (mobile_offline, {}),
    "realsense_vio": (realsense_vio, {}),
    "phone_vio": (phone_vio, {}),
    "replica": (replica, {}),
    "scannetv1": (scannetv1, {}),
    "tumrgbd": (tumrgbd, {}),
    "bonn": (tumrgbd, {}),
    "tartanair": (tartanair, {}),
}
LIVE = ("mobile", "phone")


def assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif a is None:
        assert b is None
    elif isinstance(a, float):
        assert type(b) is float and a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def same_surface(jds, tds, n, depth=True):
    """Every packet, IMU, camera timestamps, c2i and ground truth."""
    for idx in range(n):
        j, t = jds[idx], tds[idx]
        assert_same(j, t)
        assert t["rgb"].shape == (H, W, 3) and t["rgb"].dtype == np.float32
    assert_same(jds.preload_imu(), tds.preload_imu())
    assert_same(jds.preload_camtimestamp(), tds.preload_camtimestamp())
    assert_same(jds.c2i, tds.c2i)
    assert_same(jds.load_gt_dict(), tds.load_gt_dict())


@pytest.mark.parametrize("module", sorted(LAYOUTS))
def test_loader_as_jax(tmp_path, module):
    write, extra = LAYOUTS[module]
    write(tmp_path)
    cfg = base_cfg(tmp_path, module, **extra)
    tds = get_dataset(cfg)
    n = len(tds)
    assert n >= 2
    if module == "tartanair":
        # the JAX loader reads depth_left/*.npy with cv2.imread, which
        # cannot read .npy (None.astype fails); the port reads them with
        # np.load. Everything else is held equal without depth.
        with pytest.raises(AttributeError):
            j_get_dataset(cfg)[0]
        d = np.load(tds.depth_files[0])
        assert np.array_equal(tds[0]["depth"], cv2.resize(
            d, (W, H), interpolation=cv2.INTER_NEAREST))
        cfg = base_cfg(tmp_path, module, use_depth=False)
        tds = get_dataset(cfg)
    jds = j_get_dataset(cfg)
    assert len(jds) == n
    same_surface(jds, tds, n)
    has_depth = {"realsense_vio", "phone_vio", "replica", "scannetv1",
                 "tumrgbd", "bonn"}
    assert ("depth" in tds[0]) == (module in has_depth)


@pytest.mark.parametrize("module", LIVE)
def test_live_folder_polls_as_jax(tmp_path, module):
    """The live loaders re-scan `cam0/` and wait for a frame that is not
    there yet: frame 1 lands after 0.3 s (renamed into place whole: the
    JAX loader would read a half-written file) while both packages'
    fetches of it poll. Each fetch runs in a thread joined with a 20 s
    timeout, so a loader that never sees the frame fails the test instead
    of hanging it."""
    frames(tmp_path / "cam0", ["000000.png"])
    cfg = base_cfg(tmp_path, module)
    jds, tds = j_get_dataset(cfg), get_dataset(cfg)
    assert len(tds) == len(jds) == 1000000
    assert_same(jds[0], tds[0])
    got = {}

    def fetch(name, ds):
        got[name] = ds[1]

    threads = [threading.Thread(target=fetch, args=(k, ds), daemon=True)
               for k, ds in (("jax", jds), ("torch", tds))]
    for t in threads:
        t.start()
    time.sleep(0.3)
    assert not got, "a fetch returned before its frame existed"
    frames(tmp_path / "staging", ["000000.png", "000001.png"])
    os.replace(tmp_path / "staging" / "000001.png",
               tmp_path / "cam0" / "000001.png")
    for t in threads:
        t.join(timeout=20.0)
        assert not t.is_alive(), "the live loader never saw frame 1"
    assert_same(got["jax"], got["torch"])
    assert got["torch"]["timestamp"] == 1.0


def test_phone_server_push_as_jax(tmp_path):
    cfg = base_cfg(tmp_path, "phone_server")
    jds, tds = j_get_dataset(cfg), get_dataset(cfg)
    rng = np.random.default_rng(7)
    for idx, t in enumerate((3.25, 3.5)):
        rec = {"rgb": rng.integers(0, 255, (SW, SH, 3), np.uint8),
               "timestamp": t}
        assert_same(jds.load_rgb(rec, idx), tds.load_rgb(rec, idx))
    assert tds.timestamps == jds.timestamps == [3.25, 3.5]
    with pytest.raises(RuntimeError):
        tds[0]


def test_every_module_dispatches():
    """get_dataset reaches every dataset module of the JAX package."""
    import vings_mono_tpu.datasets as jpkg
    import vings_mono_tpu_torch.datasets as tpkg
    jmods = {f[:-3] for f in os.listdir(os.path.dirname(jpkg.__file__))
             if f.endswith(".py") and f not in ("__init__.py", "base.py")}
    tmods = {f[:-3] for f in os.listdir(os.path.dirname(tpkg.__file__))
             if f.endswith(".py") and f not in ("__init__.py", "base.py")}
    assert jmods == tmods
    assert set(LAYOUTS) | set(LIVE) | {"phone_server", "synthetic",
                                       "synthetic3d", "replay"} == tmods
