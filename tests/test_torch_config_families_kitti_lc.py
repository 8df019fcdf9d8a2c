"""F5 of profile_configs.py,
configs/kitti/sync/kitti_2011_10_03_drive_0027_LC.yaml (mode vio with loop
closure), through both packages' runners.run.run on one written kitti_sync
folder (image_02/data/*.png, metadata/camstamp.txt, a 100 Hz IMU written
0.07 s late, c2i.txt, pose/) at tests/torch_config_families.py's small
size, with its overrides and one more: the looper's start_after 10 -> 2,
every 3 -> 1 and min_history 35 -> 4, so that the detector makes an
attempt within 12 frames."""

import pytest
import torch

import torch_config_families as fam

FRAMES = 12
EXTRA = {"looper": {"start_after": 2, "every": 1, "min_history": 4}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("kitti_lc")
        yield fam.run_both("F5", tmp, FRAMES, EXTRA)
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


def test_loop_attempted_in_both(runs):
    assert runs["torch"]["loop"] and runs["jax"]["loop"], (
        runs["torch"]["loop"], runs["jax"]["loop"])
