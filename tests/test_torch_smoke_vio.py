"""Port parity for `configs/synthetic/smoke_vio.yaml` through
`runners.run.run` in both packages: `mode: vio`, storage paging, `use_vis`
and the global-BA terminate pass, the first configuration of the repository
that the port runs with nothing cut.

Shortened for the CPU: 12 frames at 64x96 (the file's 30 at 240x432), the
DroidNet weights in the repository with an f32 GRU (the file names none, and
the two packages draw different random weights), a map of 8192 Gaussians
trained 4 iterations per keyframe, and the vis renders at 64x96 / 48x48
(the defaults are 480x640 / 320x320). Everything else is the file's.

What is compared: the keyframes; the trajectory after the global BA,
within 1e-3, from the same snapshot of the video's buffers (the tracking
before it agrees within tests/test_torch_vo_slice.py's tolerance, not
1e-3, so the port's pass starts from the JAX run's buffers); the global
BA's stats; the same set of vis files."""

import os
import pathlib

import numpy as np
import pytest
import torch

import vings_mono_tpu.tracker.backend as j_backend
import vings_mono_tpu_torch.mapper.mapper as t_mapper
import vings_mono_tpu_torch.tracker.backend as t_backend
from test_torch_slice import JaxDraws
from vings_mono_tpu.runners.run import run as j_run
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu.utils.trajectory import tracker_c2ws as j_tracker_c2ws
from vings_mono_tpu_torch.runners import run as run_t
from vings_mono_tpu_torch.utils.config import load_config
from vings_mono_tpu_torch.utils.trajectory import tracker_c2ws

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/synthetic/smoke_vio.yaml"
WEIGHTS = ROOT / "vings_mono_tpu/weights/droid_selftrained.npz"
FRAMES = 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides(save_dir):
    return {"frontend": {"image_size": [64, 96], "weight": str(WEIGHTS),
                         "bf16_gru": False},
            "mapper": {"capacity": 8192, "pair_capacity": 8192,
                       "chunk": 64, "visible_capacity": 4096,
                       "points_per_frame": 600, "points_first_frame": 800},
            "training_args": {"iters": 4},
            "vis": {"map_size": [64, 96], "bev_size": [48, 48]},
            "output": {"save_dir": str(save_dir)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke_vio")
    snap = {}

    class JGlobalBA(j_backend.GlobalBA):
        def run(self):
            v = self.tracker.video
            snap["count_save"], snap["counter"] = v.count_save, v.counter
            snap["save"] = {k: getattr(v, k + "_save").copy() for k in
                            ("poses", "disps", "images", "disps_up")}
            snap["live"] = {k: np.asarray(getattr(v.bufs, k)).copy() for k in
                            ("poses", "disps", "images", "disps_up")}
            stats = super().run()
            snap["stats"] = stats
            return stats

    class TGlobalBA(t_backend.GlobalBA):
        def run(self):
            v = self.tracker.video
            assert (v.count_save, v.counter) == (snap["count_save"],
                                                 snap["counter"])
            for k, a in snap["save"].items():
                getattr(v, k + "_save")[:] = a
            for k, a in snap["live"].items():
                getattr(v.bufs, k).copy_(torch.from_numpy(a))
            return super().run()

    class Mapper(t_mapper.GaussianMapper):
        def __init__(self, cfg, device=None):
            super().__init__(cfg, device=device)
            draws = JaxDraws(int(cfg.get("seed", 0)))
            self._densify_draws = draws.densify(self)
            self._kf_schedule = draws.schedule

    mp = pytest.MonkeyPatch()
    mp.setattr(j_backend, "GlobalBA", JGlobalBA)
    mp.setattr(t_backend, "GlobalBA", TGlobalBA)
    mp.setattr(t_mapper, "GaussianMapper", Mapper)
    try:
        jcfg = j_load_config(str(CONFIG), overrides(tmp / "jax"))
        jcfg["mapper"]["interpret"] = True
        tcfg = load_config(str(CONFIG), overrides(tmp / "torch"))
        jdir, tdir = tmp / "jax" / "run", tmp / "torch" / "run"
        os.makedirs(jdir / "ply")
        jtr, _, _ = j_run(jcfg, str(jdir), max_frames=FRAMES)
        ttr, tmap, timer = run_t.run(tcfg, str(tdir), max_frames=FRAMES,
                                     device="cpu")
    finally:
        mp.undo()
    return dict(jtr=jtr, ttr=ttr, tmap=tmap, timer=timer, snap=snap,
                jdir=jdir, tdir=tdir)


def _files(d):
    return sorted(str(p.relative_to(d)) for sub in ("rgbdnua", "map", "bev")
                  for p in (d / sub).glob("*.png"))


def test_smoke_vio_trajectory_after_global_ba(runs):
    jts, jc2w = j_tracker_c2ws(runs["jtr"])
    tts, tc2w = tracker_c2ws(runs["ttr"])
    assert tts == jts and len(tts) >= 4
    assert not runs["snap"]["stats"]["skipped"]
    np.testing.assert_allclose(np.asarray(tc2w), np.asarray(jc2w),
                               atol=1e-3)
    # the pass moved the trajectory
    live = runs["snap"]["live"]["poses"][:runs["snap"]["counter"]]
    moved = runs["ttr"].video.bufs.poses[:len(live)].numpy() - live
    assert np.abs(moved).max() > 1e-5
    report = runs["timer"].report()
    for stage in ("global_ba", "vis", "storage", "map", "track"):
        assert stage in report, stage


def test_smoke_vio_writes_same_outputs(runs):
    jf, tf = _files(runs["jdir"]), _files(runs["tdir"])
    assert tf == jf
    assert any(f.startswith("map/") for f in tf)
    assert any(f.startswith("bev/") for f in tf)
    assert len([f for f in tf if f.startswith("rgbdnua/")]) >= 3
    tdir = runs["tdir"]
    assert (tdir / "ply" / "final_2dgs.ply").is_file()
    assert len(list((tdir / "droid_c2w").glob("*.txt"))) == \
        len(runs["ttr"].video.tstamps_host) + runs["ttr"].video.count_save


KITTI_0028 = ROOT / "configs/kitti/sync/kitti_2011_09_30_drive_0028.yaml"


@pytest.mark.parametrize("config", [CONFIG, KITTI_0028],
                         ids=["smoke_vio", "kitti_0028"])
def test_check_ported_accepts_and_refuses(config):
    """`check_ported` accepts smoke_vio.yaml and the KITTI 2011_09_30_drive_
    0028 configuration as committed (use_vis, use_global_ba, storage, vio),
    and the mapper options use_sky, use_refine and coarse_frac, use_loop,
    use_dynamic and use_metric, and parallel.dp and parallel.sp, which the
    mapper takes as JAX's does: dp alone is read (--resume and
    --checkpoint-every are run by tests/test_torch_vo_slice.py
    test_ported_option_runs)."""
    from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
    cfg = load_config(str(config))
    run_t.check_ported(cfg)
    opts = dict(cfg, use_sky=True, use_refine=True,
                training_args={**cfg["training_args"], "coarse_frac": 0.5})
    run_t.check_ported(opts)
    run_t.check_ported(dict(cfg, use_loop=True, use_dynamic=True,
                            use_metric=True))
    small = load_config(str(config), {"mapper": {"capacity": 1024,
                                                 "pair_capacity": 1024}})
    mapper = GaussianMapper(dict(small, use_sky=True, use_refine=True,
                                 training_args={**small["training_args"],
                                                "coarse_frac": 0.5}),
                            device="cpu")
    assert mapper.sky is not None and mapper.coarse_frac == 0.5
    # parallel.dp is ported (tests/test_torch_parallel.py); sp is read by
    # parallel.mesh.sharded_train_step's group alone (tests/test_torch_
    # sp.py), so the mapper takes it and starts no group at dp = 1
    run_t.check_ported(dict(cfg, parallel={"dp": 2}))
    run_t.check_ported(dict(cfg, parallel={"dp": 2, "sp": 2}))
    sp_only = GaussianMapper(dict(small, parallel={"dp": 1, "sp": 2}),
                             device="cpu")
    assert sp_only.dp == 1 and sp_only.group is None
