"""F2 of profile_configs.py,
configs/kitti360/unsync/kitti360_2013_05_28_drive_0000.yaml (mode vio,
middleware v0_kitti360: the keyframes a rollup saved, storage paging every
10 frames, vis), through both packages' runners.run.run on one written
KITTI-360 folder (image_00/data_rect/*.png, metadata/camstamp.txt, a 100 Hz
IMU written 0.04 s late, c2i.txt, pose/) at tests/torch_config_families.py's
small size, with its overrides and one more: frontend.rollup_at 65 -> 9
and rollup_n 30 -> 2, so that two rollups, and so two windows, fall within
13 frames (the committed values need ~96 keyframes)."""

import pytest
import torch

import torch_config_families as fam

FRAMES = 13
EXTRA = {"frontend": {"rollup_at": 9, "rollup_n": 2}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("kitti360")
        yield fam.run_both("F2", tmp, FRAMES, EXTRA)
    finally:
        torch.set_num_threads(n)


def test_keyframes_and_windows_as_jax(runs):
    assert runs["torch"]["ts"] == runs["jax"]["ts"]
    assert runs["torch"]["windows"] == runs["jax"]["windows"] >= 2


def test_poses_as_jax(runs):
    fam.assert_poses_close(runs)


def test_first_window_as_jax(runs):
    fam.assert_first_window_equal(runs)


def test_map_psnr_as_jax(runs):
    fam.assert_psnr_close(runs)
