"""F4 of profile_configs.py, configs/hierarchical/smallcity.yaml (mode vo
with the metric-depth prior from precomputed maps, metric.backend npz),
through both packages' runners.run.run on one written Hierarchical-3DGS
folder (color/*.png, one .npy of the room's depth per frame under
metric_depth/, pose/) at tests/torch_config_families.py's small size, with
its overrides and one more: the camera moves at 0.02 turns of the room a
frame, twice profile_configs.py's pace. At that pace 14 frames map two
windows. At 0.01 the prior's keyframe gate (keyframe_thresh 4.0 scaled to
72 px) meets the 9th keyframe's flow at its threshold, and the two
trackers, which part by JAX's slot-0 scatter (ROADMAP §C), decide it
apart."""

import pytest
import torch

import torch_config_families as fam

FRAMES = 14
PACE = 0.02
EXTRA = None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("hierarchical")
        yield fam.run_both("F4", tmp, FRAMES, EXTRA, pace=PACE)
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
