"""`configs/synthetic/smoke.yaml`, the repository's all-features
configuration (`mode: vo` with loop closure, dynamic masks, sky, pose
refinement, storage paging, vis and the global-BA terminate pass), through
`runners.run.run` in both packages.

The whole run (marked slow) is shortened for the CPU as
tests/test_torch_smoke_vio.py shortens smoke_vio.yaml: 64x96 instead of
240x432, the DroidNet weights in the repository with an f32 GRU (the file
names none, and the two packages draw different random weights), a map of
8192 Gaussians trained 4 iterations per keyframe, vis renders at 64x96 /
48x48. All 30 frames run, so loop detection runs at keyframes 12, 15, ...
as the file sets it. `looper.superpoint_weights` is set to the self-trained
SuperPoint (the file names none, and the packages' random SuperPoints
differ); the dict is a copy, the file is not edited.

What is compared. The two trackers part by ~7e-2 in the pose vector at
the frontend's initialization (frame 7) on this sequence, with or without
`use_refine` (tests/test_torch_vo_slice.py holds the tracking itself to a
trajectory error within 0.1 of JAX's), so the comparison follows
tests/test_torch_smoke_vio.py: the same keyframes; the same loop calls and
attempts, each attempt's matches within 10 % + 2, and its stage the same
unless either side's PnP inlier count lies within 25 % of the
`min_inliers` gate; the same accepted closure pairs; the same dynamic
pixels per keyframe within 1 %; the trajectory after the global BA within
1e-3, the port's pass started from the JAX run's buffers and handed the
JAX run's loop pairs.

The short case (not slow) checks the runner's wiring on the port alone:
`check_ported` takes both flags, the `loop` and `dynamic` stages run, the
accepted pairs reach the global BA as extra edges."""

import os
import pathlib

import numpy as np
import pytest
import torch

import vings_mono_tpu.dynamic.dynamic_model as j_dynamic
import vings_mono_tpu.loop.loop_model as j_loop
import vings_mono_tpu.tracker.backend as j_backend
import vings_mono_tpu_torch.dynamic.dynamic_model as t_dynamic
import vings_mono_tpu_torch.loop.loop_model as t_loop
import vings_mono_tpu_torch.tracker.backend as t_backend
from vings_mono_tpu.runners.run import run as j_run
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu.utils.trajectory import tracker_c2ws as j_tracker_c2ws
from vings_mono_tpu_torch.runners import run as run_t
from vings_mono_tpu_torch.utils.config import load_config
from vings_mono_tpu_torch.utils.trajectory import tracker_c2ws

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/synthetic/smoke.yaml"
WEIGHTS = ROOT / "vings_mono_tpu/weights"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_overrides(save_dir):
    return {"frontend": {"image_size": [64, 96],
                         "weight": str(WEIGHTS / "droid_selftrained.npz"),
                         "bf16_gru": False},
            "mapper": {"capacity": 8192, "pair_capacity": 8192,
                       "chunk": 64, "visible_capacity": 4096,
                       "points_per_frame": 600, "points_first_frame": 800},
            "training_args": {"iters": 4},
            "vis": {"map_size": [64, 96], "bev_size": [48, 48]},
            "looper": {"superpoint_weights": str(
                WEIGHTS / "superpoint_selftrained.npz")},
            "output": {"save_dir": str(save_dir)}}


def recording(loop_cls, dyn_cls, store):
    """Subclasses of a package's LoopModel and DynamicModel that keep
    themselves in `store` and count the dynamic pixels each keyframe
    masks."""
    class Loop(loop_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            store["loop"] = self

    class Dynamic(dyn_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            store["dynamic"] = self
            store["masked"] = []

        def apply_to_viz_out(self, viz_out, mapper):
            out = super().apply_to_viz_out(viz_out, mapper)
            pm = out["pixel_mask"][int(viz_out["n_valid"]) - 1]
            if isinstance(pm, torch.Tensor):
                pm = pm.cpu()
            store["masked"].append(int((~np.asarray(pm)).sum()))
            return out
    return Loop, Dynamic


SNAP = ("poses", "disps", "images", "disps_up")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke")
    got = {"jax": {}, "torch": {}}
    snap = {}

    class JGlobalBA(j_backend.GlobalBA):
        def run(self):
            v = self.tracker.video
            snap["counts"] = (v.count_save, v.counter)
            snap["save"] = {k: getattr(v, k + "_save").copy() for k in SNAP}
            snap["live"] = {k: np.asarray(getattr(v.bufs, k)).copy()
                            for k in SNAP}
            snap["edges"] = list(self.extra_edges)
            return super().run()

    class TGlobalBA(t_backend.GlobalBA):
        def __init__(self, tracker, cfg=None, extra_edges=None):
            got["torch"]["edges"] = list(extra_edges or [])
            super().__init__(tracker, cfg, snap["edges"])

        def run(self):
            v = self.tracker.video
            got["torch"]["counts"] = (v.count_save, v.counter)
            v.count_save, v.counter = snap["counts"]
            for k, a in snap["save"].items():
                getattr(v, k + "_save")[:] = a
            for k, a in snap["live"].items():
                getattr(v.bufs, k).copy_(torch.from_numpy(a))
            return super().run()

    mp = pytest.MonkeyPatch()
    for mod_l, mod_d, key in ((j_loop, j_dynamic, "jax"),
                              (t_loop, t_dynamic, "torch")):
        loop_cls, dyn_cls = recording(mod_l.LoopModel, mod_d.DynamicModel,
                                      got[key])
        mp.setattr(mod_l, "LoopModel", loop_cls)
        mp.setattr(mod_d, "DynamicModel", dyn_cls)
    mp.setattr(j_backend, "GlobalBA", JGlobalBA)
    mp.setattr(t_backend, "GlobalBA", TGlobalBA)
    try:
        jcfg = j_load_config(str(CONFIG), cpu_overrides(tmp / "jax"))
        jcfg["mapper"]["interpret"] = True
        tcfg = load_config(str(CONFIG), cpu_overrides(tmp / "torch"))
        jdir, tdir = tmp / "jax" / "run", tmp / "torch" / "run"
        os.makedirs(jdir / "ply")
        jtr, _, _ = j_run(jcfg, str(jdir))
        ttr, _, timer = run_t.run(tcfg, str(tdir), device="cpu")
    finally:
        mp.undo()
    return dict(jtr=jtr, ttr=ttr, timer=timer, got=got, snap=snap,
                min_inliers=int(tcfg["looper"].get("min_inliers", 30)))


def accepted(lm):
    return [(t["cand_gid"], t["cur_gid"]) for t in lm.loop_traces
            if "rejected" not in t]


@pytest.mark.slow
def test_smoke_keyframes_loop_and_dynamic_as_jax(runs):
    jg, tg = runs["got"]["jax"], runs["got"]["torch"]
    assert tg["counts"] == runs["snap"]["counts"]     # the same keyframes
    jtr, ttr = jg["loop"].detector.traces, tg["loop"].detector.traces
    assert len(ttr) == len(jtr) >= 4
    gate = runs["min_inliers"]
    for a, b in zip(jtr, ttr):
        assert abs(b["matches"] - a["matches"]) <= 0.1 * a["matches"] + 2
        near = any(abs(x["pnp_inliers"] - gate) <= 0.25 * gate
                   for x in (a, b))
        if not near:
            assert b["stage"] == a["stage"], (a, b)
    assert accepted(tg["loop"]) == accepted(jg["loop"])
    assert tg["edges"] == runs["snap"]["edges"] == accepted(jg["loop"])
    assert len(tg["masked"]) == len(jg["masked"]) >= 20
    for a, b in zip(jg["masked"], tg["masked"]):
        assert abs(b - a) <= 0.01 * a, (a, b)
    assert sum(jg["masked"]) > 0
    assert tg["dynamic"].n_masked == sum(tg["masked"])
    report = runs["timer"].report()
    for stage in ("loop", "dynamic", "global_ba", "vis", "storage", "map",
                  "track"):
        assert stage in report, stage


@pytest.mark.slow
def test_smoke_trajectory_after_global_ba_as_jax(runs):
    jts, jc2w = j_tracker_c2ws(runs["jtr"])
    tts, tc2w = tracker_c2ws(runs["ttr"])
    assert tts == jts and len(tts) >= 20
    np.testing.assert_allclose(np.asarray(tc2w), np.asarray(jc2w), rtol=0,
                               atol=1e-3)


class AcceptingLoop(t_loop.LoopModel):
    """Accepts a closure (cur - 3, cur) at every call and logs a rejected
    one beside it, without rectifying: the runner's wiring is what is held
    here."""

    def run(self, mapper, tracker, viz_out, frame_idx):
        cur = int(viz_out["global_kf_id_host"][-1])
        self.loop_traces.append({"cand_gid": cur - 3, "cur_gid": cur})
        self.loop_traces.append({"cand_gid": 0, "cur_gid": cur,
                                 "rejected": "max_correction"})
        return True


def stage_count(report, stage):
    line = next(ln for ln in report.splitlines()
                if ln.startswith(stage + ":"))
    return int(line.split("n=")[1].split(",")[0])


def test_smoke_runner_wiring(tmp_path, monkeypatch):
    """smoke.yaml through the port's runner at 32x48 for 14 frames (the
    first keyframe is packaged after the 8-frame warm-up) with loop
    detection every 2 keyframes after the 2nd: `check_ported` takes
    use_loop and use_dynamic, the `dynamic` stage runs at every packaged
    keyframe and the `loop` stage at keyframes 4 and 6, and the accepted
    pairs (not the rejected ones) reach GlobalBA's extra edges."""
    cfg = load_config(str(CONFIG), {
        "dataset": {"n_frames": 14},
        "frontend": {"image_size": [32, 48]},
        "mapper": {"capacity": 2048, "pair_capacity": 2048, "chunk": 64,
                   "visible_capacity": 1024, "points_per_frame": 200,
                   "points_first_frame": 300},
        "training_args": {"iters": 2},
        "backend": {"steps": 1, "iters": 1},
        "vis": {"map_size": [32, 48], "bev_size": [32, 32]},
        "looper": {"start_after": 2, "every": 2},
        "output": {"save_dir": str(tmp_path)}})
    assert cfg["use_loop"] and cfg["use_dynamic"]
    run_t.check_ported(cfg)
    edges, gids = [], []

    class GlobalBA(t_backend.GlobalBA):
        def __init__(self, tracker, cfg=None, extra_edges=None):
            super().__init__(tracker, cfg, extra_edges)
            edges.extend(self.extra_edges)

    def on_frame(idx, tracker, mapper, viz_out):
        if viz_out is not None:
            gids.append(int(viz_out["global_kf_id_host"][-1]))

    monkeypatch.setattr(t_loop, "LoopModel", AcceptingLoop)
    monkeypatch.setattr(t_backend, "GlobalBA", GlobalBA)
    tr, mapper, timer = run_t.run(cfg, str(tmp_path / "run"),
                                  device="cpu", on_frame=on_frame)
    report = timer.report()
    assert 6 <= len(gids) < 8
    assert stage_count(report, "dynamic") == len(gids)
    assert stage_count(report, "loop") == 2
    assert edges == [(gids[3] - 3, gids[3]), (gids[5] - 3, gids[5])]
