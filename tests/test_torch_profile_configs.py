"""profile_configs.py without a card and without JAX: each family's folder
writer against its dataset module (the port's loader reads what the
writer wrote, in the layout, resolution and timing the configuration
names), the overrides applied to the committed configurations, and the
script's refusal without a card."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import profile_configs as pc
from vings_mono_tpu_torch.datasets.base import get_dataset
from vings_mono_tpu_torch.utils.config import load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = (48, 80)          # the written frames (RTG crops 15 px a side)
N = 3


@pytest.mark.parametrize("key", list(pc.FAMILIES))
def test_writer_feeds_the_family_loader(key, tmp_path):
    cv2 = pytest.importorskip("cv2")
    fam = pc.FAMILIES[key]
    cfg = pc.family_cfg(fam, tmp_path / "folder", tmp_path / "out", "cpu",
                        {"frontend": {"image_size": [16, 24]}})
    pc.write_folder(fam, tmp_path / "folder", N, cfg, size=SIZE,
                    workers=1)
    ds = get_dataset(cfg)
    assert len(ds) == N
    pkt = ds[N - 1]
    assert pkt["rgb"].shape == (16, 24, 3) and pkt["rgb"].max() > 0
    gt = ds.load_gt_dict()
    assert len(gt["timestamps"]) == N
    np.testing.assert_allclose(gt["timestamps"][-1], pkt["timestamp"])
    if cfg["mode"] == "vio":
        imu = ds.preload_imu()
        # written as late as the loader shifts it back: the stream starts
        # at the first frame again
        assert abs(imu[0, 0]) < 1e-9 and imu.shape[1] == 7
        assert np.allclose(ds.c2i, np.eye(4))
    if cfg.get("use_metric"):
        from vings_mono_tpu_torch.models.metric_depth import MetricDepth
        # the npz backend matches files to frames in sorted order: the
        # depth files sort as the frames do
        root = tmp_path / "folder"
        depths = sorted((root / "metric_depth").glob("*.np[yz]"))
        assert [f.stem for f in depths] == [
            pathlib.Path(f).stem for f in ds.rgb_files]
        prior = MetricDepth(cfg)
        for k in range(N):
            depth = prior.predict(pkt["rgb"], pkt["intrinsic"])
            assert depth.shape == (16, 24) and (depth > 0).all()
            np.testing.assert_allclose(depth, np.clip(cv2.resize(
                np.load(depths[k]), (24, 16),
                interpolation=cv2.INTER_NEAREST), 0, prior.d_max))
    if fam.layout == "pocket":
        # the phone's capture time in EXIF DateTime, as the server reads it
        from PIL import Image
        for k, f in enumerate(ds.rgb_files):
            assert float(Image.open(f).getexif()[306]) == pytest.approx(
                k * pc.PHONE_DT, abs=1e-6)
    if cfg.get("use_loop"):
        for k in ("superpoint_weights", "lightglue_weights"):
            assert os.path.isfile(cfg["looper"][k])
    assert cfg["frontend"]["weight"].endswith("droid_selftrained.npz")
    # the overrides leave every other section as committed
    ran, committed = pc.family_cfg(fam, "x", "y", "cpu"), load_config(
        str(fam.config))
    for k in ("mode", "middleware", "training_args", "mapper", "intrinsic",
              "storage_manager", "vis"):
        assert ran.get(k) == committed.get(k), k
    assert {k: v for k, v in ran.get("looper", {}).items()
            if not k.endswith("_weights")} == committed.get("looper", {})
    assert {k: v for k, v in ran["frontend"].items() if k != "weight"} \
        == {k: v for k, v in committed["frontend"].items() if k != "weight"}


def test_refuses_without_a_card():
    """Without a card the script exits 1 with no result line, and the run
    imported neither jax nor the JAX package; neither file names them."""
    probe = ("import runpy, sys\n"
             "sys.argv = ['profile_configs.py']\n"
             "try:\n"
             "    runpy.run_path('profile_configs.py', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    print('exit', e.code)\n"
             "print('modules', sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'vings_mono_tpu')))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120).stdout
    assert "CUDA is not available" in out and "exit 1" in out, out
    assert "modules []" in out and '"families"' not in out, out
    for name in ("profile_configs.py", "chip_smoke.py"):
        tree = ast.parse((ROOT / name).read_text())
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) else []
            for m in mods:
                assert m.split(".")[0] not in ("jax", "vings_mono_tpu"), \
                    (name, m)
