"""F6 of profile_configs.py, configs/waymo/Scene03.yaml (mode vo with the
npz metric prior, NVS pose refinement whose refined poses go back into
the tracker, and vis), through both packages' runners.run.run on one
written Waymo folder (color/*.jpg, metric_depth/<frame>.npy, pose/) at
tests/torch_config_families.py's small size, with its overrides; 10
frames map two windows.

The first refined window: the packages hand refinement poses that part
by the trackers' difference (ROADMAP §C, JAX's edge slot 0), and
refinement turns the maps' ~2e-5 `log_scale` rounding into ~3e-3 of pose
(ROADMAP §C, the refine item). So the correction refinement applies
(refined @ inv(input), per keyframe) agrees to REFINE_TOL, three times
that 3e-3 for the three axes of a translation or a rotation summed at
each entry; the refined poses themselves agree to the input poses' gap
plus REFINE_TOL."""

import numpy as np
import pytest
import torch

import torch_config_families as fam

FRAMES = 10
EXTRA = None
REFINE_TOL = 1e-2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("waymo_refine")
        yield fam.run_both("F6", tmp, FRAMES, EXTRA)
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


def test_first_refined_window_as_jax(runs):
    j, t = runs["jax"]["refined"], runs["torch"]["refined"]
    assert j is not None and t is not None
    assert j["after"].shape == t["after"].shape
    for r in (j, t):
        assert np.isfinite(r["after"]).all()
    corr = {k: r["after"] @ np.linalg.inv(r["before"])
            for k, r in (("jax", j), ("torch", t))}
    np.testing.assert_allclose(corr["torch"], corr["jax"], atol=REFINE_TOL)
    gap = np.abs(t["before"] - j["before"]).max()
    np.testing.assert_allclose(t["after"], j["after"],
                               atol=gap + REFINE_TOL)
