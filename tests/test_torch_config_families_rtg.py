"""F3 of profile_configs.py, configs/rtg/hotel.yaml (mode vo, vis; the
loader crops 15 px borders before its resize), through both packages'
runners.run.run on one written RTG folder (nosky_color/<i>.jpg, pose/) at
tests/torch_config_families.py's small size, with its overrides; 11 frames
map two windows."""

import pytest
import torch

import torch_config_families as fam

FRAMES = 11
EXTRA = None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("rtg")
        yield fam.run_both("F3", tmp, FRAMES, EXTRA)
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
