"""The port's committed evaluation artifacts, eval/h100/*.json, written by
`python -m vings_mono_tpu_torch.runners.eval_all` on an NVIDIA card at
the scripts' default depths. Each file exists, names the card and its
power limit, the commit, the arguments and the wall seconds, has every
key its JAX script prints, and is at that script's default depth. No
quality bar is asserted here: PERF.md holds the values against the bars
of tests/test_eval_artifacts.py."""

import json
import pathlib
import re

import pytest

H100_DIR = pathlib.Path(__file__).resolve().parents[1] / "eval" / "h100"

KEYS = {
    "superpoint": ("trained", "random", "pairs", "trained_beats_random"),
    "droid": ("random", "trained", "trained_gated", "frames",
              "trained_beats_random", "gating_selective"),
    "track_long": ("2x1", "4x2", "frames", "revs"),
    "loop_e2e": ("frames", "keyframes", "detect_attempts", "loops_closed",
                 "closed_at", "ate_rmse_m", "ate_no_loop_m",
                 "closure_deltas", "stage_histogram", "loop_traces",
                 "traces"),
    "long_run": ("frames", "revs", "full", "no_loop"),
}
NET_KEYS = ("mean_matches", "pnp_success", "pnp_success_rate",
            "median_pos_err_m")
LANE_KEYS = ("keyframes", "ate_online_m", "peak_gaussians",
             "closure_deltas", "pages_out", "pages_in", "evict_events",
             "pagein_events", "host_rows_end", "psnr")
FULL_KEYS = ("loops_closed", "closed_at", "loop_traces",
             "global_ba_loop_edges", "global_ba", "ate_after_global_ba_m")


def load(name):
    path = H100_DIR / f"{name}.json"
    assert path.exists(), (
        f"missing eval/h100/{name}.json: run python -m "
        f"vings_mono_tpu_torch.runners.eval_all on the card")
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", sorted(KEYS))
def test_artifact_names_its_card_and_run(name):
    run = load(name)["run"]
    assert run["card"].startswith("NVIDIA"), run["card"]
    assert re.search(r",\s*\d+(\.\d+)?\s*W$", run["card"]), run["card"]
    assert run["commit"] and run["commit"] != "unknown"
    assert run["argv"][0] == f"vings_mono_tpu_torch.runners.eval_{name}"
    assert run["wall_s"] > 0


@pytest.mark.parametrize("name", sorted(KEYS))
def test_artifact_has_its_scripts_keys(name):
    out = load(name)
    assert set(KEYS[name]) <= set(out), set(KEYS[name]) - set(out)
    if name == "superpoint":
        for net in ("trained", "random"):
            assert sorted(out[net]) == sorted(NET_KEYS)
    if name == "droid":
        for lane in ("random", "trained", "trained_gated"):
            assert sorted(out[lane]) == ["ate_rmse_m", "n_keyframes"]
    if name == "long_run":
        assert set(LANE_KEYS + FULL_KEYS) <= set(out["full"])
        assert set(LANE_KEYS) <= set(out["no_loop"])


def test_artifacts_are_at_the_scripts_default_depth():
    assert load("superpoint")["pairs"] == 12
    assert load("droid")["frames"] == 40
    track = load("track_long")
    assert (track["frames"], track["revs"]) == (160, 1.6)
    loop = load("loop_e2e")
    assert loop["frames"] == 160 and loop["ate_no_loop_m"] is not None
    long_run = load("long_run")
    assert long_run["frames"] >= 300 and long_run["revs"] == 2.2
    assert long_run["no_loop"] is not None
