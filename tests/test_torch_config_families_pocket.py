"""F7 and F8 of profile_configs.py, configs/pocket/pocket_scene.yaml (mode
vo with storage paging), on one written phone folder (color/*.jpg with the
capture time in EXIF tag 306, pose/) at tests/torch_config_families.py's
small size, with its overrides and two more:

  * storage_manager.distance_threshold 65 -> PAGING (room units): 65 pages
    nothing in the room; at PAGING the keyframes of the first frames lie
    beyond it when storage runs at frame 9 (every 10 frames), so both
    packages page rows to the host there;
  * run_mobile's ply_every 300 -> 1: a .ply after every frame once the
    map exists (frame 8 on), so the frames before and after the paging
    each write one.

F7: both packages' run_mobile through its entry (the port's `run`; the
JAX package has only `main`, run here on the configuration written to
YAML) write the same .ply files, each holding the device's rows only:
with rows on the host both write a partial map (ROADMAP §C, the recorded
JAX-side divergences). The first window's .ply holds the same Gaussians
in both. After it the trackers part (ROADMAP §C, JAX's edge slot 0): a
later keyframe adds Gaussians only where the map's accumulated opacity
at its tracked pose is below adc_args.accum_thresh, and storage pages
the keyframes its tracked distance puts past the threshold, so there the
map's Gaussians (device + host) agree to COUNT_FRAC, the poses'
POSE_FRAC (0.026 measured here), and which rows page may differ. F8:
both packages' WebsocketServer.receive, fed the same phone messages
(JPEG frames and IMU JSON rows, profile_configs.phone_messages) through
an in-process connection, queue the same packets and write the same
imu.csv."""

import asyncio
import copy
import glob
import os
import queue

import numpy as np
import pytest
import torch
import yaml

import profile_configs as pc
import torch_config_families as fam
from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
from vings_mono_tpu.runners import run as j_run_mod
from vings_mono_tpu.runners import run_mobile as j_run_mobile
from vings_mono_tpu.server.server import WebsocketServer as JServer
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch.mapper.mapper import GaussianMapper
from vings_mono_tpu_torch.runners import run as t_run_mod
from vings_mono_tpu_torch.runners import run_mobile as t_run_mobile
from vings_mono_tpu_torch.server.server import WebsocketServer
from vings_mono_tpu_torch.utils.config import load_config
from vings_mono_tpu_torch.utils.ply import load_ply

FRAMES = 10
PAGING = 0.5
EXTRA = {"storage_manager": {"distance_threshold": PAGING}}
PLY_EVERY = 1
COUNT_FRAC = fam.POSE_FRAC
PHONE_FRAMES = 4
WAIT_S = 60.0


def recorded(mod, mapper_cls, at, got):
    """mod.build that keeps the storage manager it built in got, and a
    save_ply that records, for each file, the Gaussians it holds, those
    alive on the device and those on the host."""
    build, save_ply = mod.build, mapper_cls.save_ply

    def rec_build(*a, **k):
        built = build(*a, **k)
        got["storage"] = built[at]
        return built

    def rec_save_ply(self, path, mode="2dgs"):
        save_ply(self, path, mode=mode)
        got.setdefault("plys", {})[os.path.basename(path)] = (
            len(load_ply(path)["xyz"]),
            int(np.asarray(self.state.alive).sum()),
            got["storage"].n_host)
    return rec_build, rec_save_ply


@pytest.fixture(scope="module")
def plys(tmp_path_factory):
    """{package: ({ply name: (Gaussians written, alive on the device, on
    the host)}, rows paged out)} of both packages' run_mobile on one
    folder."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("pocket")
    f7 = pc.FAMILIES["F7"]
    folder = tmp / "folder"
    over = pc.family_overrides(f7, folder, tmp / "torch", "cpu",
                               fam.small_overrides(f7, EXTRA))
    tcfg = load_config(str(f7.config), overrides=over)
    jover = copy.deepcopy(over)
    jover["mapper"]["interpret"] = True
    jover["output"]["save_dir"] = str(tmp / "jax")
    pc.write_folder(f7, folder, FRAMES, tcfg, size=fam.SOURCE, workers=2,
                    pace=pc.REVS_PER_FRAME)
    jyaml = tmp / "jax.yaml"
    jyaml.write_text(yaml.safe_dump(j_load_config(str(f7.config),
                                                  overrides=jover)))
    out = {}
    try:
        for lib, mod, mcls, at in (
                ("jax", j_run_mod, JMapper, 4),
                ("torch", t_run_mod, GaussianMapper, 3)):
            got = {}
            build, save_ply = mod.build, mcls.save_ply
            mod.build, mcls.save_ply = recorded(mod, mcls, at, got)
            try:
                if lib == "jax":
                    j_run_mobile.main([str(jyaml), "--prefix", "m_",
                                       "--ply-every", str(PLY_EVERY)])
                    run_dir, = glob.glob(str(tmp / "jax" / "m_*"))
                else:
                    run_dir = str(tmp / "torch" / "run")
                    t_run_mobile.run(tcfg, run_dir, ply_every=PLY_EVERY,
                                     device="cpu")
            finally:
                mod.build, mcls.save_ply = build, save_ply
            assert sorted(got["plys"]) == sorted(
                os.path.basename(p) for p in glob.glob(
                    os.path.join(run_dir, "ply", "*.ply")))
            out[lib] = (got["plys"], got["storage"].pages_out)
    finally:
        torch.set_num_threads(n)
    return out


def test_run_mobile_writes_the_plys_of_jax(plys):
    (jp, _), (tp, _) = plys["jax"], plys["torch"]
    assert sorted(tp) == sorted(jp) == [
        "final_2dgs.ply", "map_000008_3dgs.ply", "map_000009_3dgs.ply"]
    first = "map_000008_3dgs.ply"
    assert tp[first] == jp[first] and tp[first][2] == 0
    for name in ("map_000009_3dgs.ply", "final_2dgs.ply"):
        j, t = sum(jp[name][1:]), sum(tp[name][1:])
        assert abs(t - j) <= COUNT_FRAC * j, (name, t, j)


def test_both_write_only_the_device_rows_after_paging(plys):
    """Both packages page rows to the host at frame 9, and every .ply
    holds the device's rows alone: frame 9's leaves the host's out in
    either package."""
    for lib in ("jax", "torch"):
        counts, paged = plys[lib]
        assert paged > 0, lib
        for name, (written, alive, on_host) in counts.items():
            assert written == alive, (lib, name)
        assert counts["map_000009_3dgs.ply"][2] > 0, lib


def test_server_receive_queues_the_packets_of_jax(tmp_path):
    f8 = pc.FAMILIES["F8"]
    cfg = load_config(str(f8.config), overrides={"frontend": {
        "image_size": [fam.H, fam.W]}})
    pc.write_folder(f8, tmp_path / "folder", PHONE_FRAMES, cfg,
                    size=fam.SOURCE, workers=1)
    msgs, n_imu = pc.phone_messages(tmp_path / "folder", PHONE_FRAMES,
                                    f8.revs_per_frame * PHONE_FRAMES)
    assert n_imu > PHONE_FRAMES
    got = {}
    for name, cls in (("jax", JServer), ("torch", WebsocketServer)):
        srv = cls(cfg, queue.Queue(), queue.Queue(), str(tmp_path / name))
        asyncio.run(asyncio.wait_for(srv.receive(pc.PhoneConnection(msgs)),
                                     WAIT_S))
        srv.imu_csv.close()
        pkts = []
        while not srv.s2t.empty():
            pkts.append(srv.s2t.get_nowait())
        got[name] = (pkts, (tmp_path / name / "imu.csv").read_bytes())
    (jp, jrows), (tp, trows) = got["jax"], got["torch"]
    assert trows == jrows and trows.count(b"\n") == n_imu
    assert len(tp) == len(jp) == PHONE_FRAMES
    for k, (a, b) in enumerate(zip(jp, tp)):
        assert a["timestamp"] == b["timestamp"] == pytest.approx(
            k * pc.PHONE_DT, abs=1e-6)
        assert b["rgb"].dtype == np.float32
        assert b["rgb"].shape == (fam.SOURCE[0], fam.SOURCE[1], 3)
        assert np.array_equal(a["rgb"], b["rgb"])
