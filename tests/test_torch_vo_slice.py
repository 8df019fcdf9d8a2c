"""Port parity for the VO slice as a whole: `runners.run.run` of the port
against the JAX package's on the same configuration, frames and DroidNet
weights (f32 GRU): dataset -> tracker -> middleware -> mapper -> files.

The two mappers draw their random numbers from different generators and the
trackers differ as test_torch_tracker states, so the comparison is loose:
the same keyframes, trajectories that agree far better than either agrees
with the truth, and a train PSNR in the same band. A single keyframe's
PSNR is that of one randomly drawn window slot after a few iterations (it
swings between 9 and 27 dB in either package on one run), so the PSNR that
is compared is the mean over the run's mapped keyframes."""

import os
import pathlib

import numpy as np
import pytest
import torch

from test_pipeline import make_cfg as j_make_cfg
from vings_mono_tpu.datasets.base import get_dataset as j_get_dataset
from vings_mono_tpu.models.droid_net import save_flax_weights
from vings_mono_tpu.runners.run import run as j_run
from vings_mono_tpu.tracker.tracker import Tracker as JTracker
from vings_mono_tpu.utils.trajectory import tracker_c2ws as j_tracker_c2ws
from vings_mono_tpu_torch.runners import run as run_vo
from vings_mono_tpu_torch.utils.config import load_config
from vings_mono_tpu_torch.utils.trajectory import ate_rmse, tracker_c2ws

ROOT = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "vings_mono_tpu/weights/droid_selftrained.npz"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops at these sizes are small. With the default thread
    count every test worker spins a whole OpenMP team on each of them, and
    the workers (and the JAX runs beside them) starve one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(tmp, weight, dataset, **frontend):
    """The tests/test_pipeline.py configuration for both packages."""
    jcfg = j_make_cfg(tmp / "jax")
    jcfg["dataset"] = dict(dataset)
    jcfg["frontend"].update({"weight": str(weight), "bf16_gru": False,
                             **frontend})
    over = {k: jcfg[k] for k in ("mode", "dataset", "frontend",
                                 "training_args", "middleware")}
    over["mapper"] = {k: v for k, v in jcfg["mapper"].items()
                      if k != "impl"}
    over["output"] = {"save_dir": str(tmp / "torch")}
    tcfg = load_config(overrides=over)
    return jcfg, tcfg


def run_both(tmp, jcfg, tcfg):
    jdir, tdir = str(tmp / "jax" / "run"), str(tmp / "torch" / "run")
    os.makedirs(os.path.join(jdir, "ply"))
    psnr = {"jax": [], "torch": []}

    def collect(key):
        def on_frame(idx, tracker, mapper, viz_out):
            if viz_out is not None and mapper.time_idx > len(psnr[key]):
                psnr[key].append(mapper.last_metrics["psnr"])
        return on_frame

    jtr, jmap, _ = j_run(jcfg, jdir, on_frame=collect("jax"))
    ttr, tmap, timer = run_vo.run(tcfg, tdir, device="cpu",
                                  on_frame=collect("torch"))
    assert "track" in timer.report() and "map" in timer.report()
    assert len(psnr["torch"]) == len(psnr["jax"]) == tmap.time_idx > 3
    assert np.isfinite(psnr["torch"]).all()
    jtr.psnr_mean = float(np.mean(psnr["jax"]))
    ttr.psnr_mean = float(np.mean(psnr["torch"]))
    return (jtr, jmap, j_tracker_c2ws(jtr)), (ttr, tmap, tracker_c2ws(ttr)), \
        pathlib.Path(tdir)


def check_files(tdir, n_kf):
    poses = sorted((tdir / "droid_c2w").glob("*.txt"))
    assert len(poses) == n_kf
    m = np.loadtxt(poses[-1])
    assert m.shape == (4, 4) and np.isfinite(m).all()
    assert len((tdir / "keyframelist.txt").read_text().split()) == n_kf
    assert (tdir / "ply" / "final_2dgs.ply").stat().st_size > 1000


def test_vo_slice_on_the_pipeline_config(tmp_path):
    """tests/test_pipeline.py's configuration (`synthetic`, 14 frames at
    48x64, every frame a keyframe) with one set of random flax weights for
    both. The pattern has no ground truth, so the port's trajectory is held
    against the JAX one: rmse of the keyframe positions under 10 % of the
    JAX path's extent. Mean train PSNR within 3 dB."""
    tr0 = JTracker(j_make_cfg(tmp_path), 48, 64)
    weight = tmp_path / "random_flax.npz"
    save_flax_weights(str(weight), tr0.params)
    jcfg, tcfg = cfgs(tmp_path, weight,
                      {"module": "synthetic", "n_frames": 14})
    (jtr, jmap, (jts, jc2w)), (ttr, tmap, (tts, tc2w)), tdir = run_both(
        tmp_path, jcfg, tcfg)
    assert tts == jts and len(tts) == 14
    assert tmap.initialized and tmap.n_alive > 100
    extent = np.ptp(np.asarray(jc2w)[:, :3, 3], axis=0).max()
    rmse = ate_rmse(tts, tc2w, jts, jc2w, scale_align=False)
    assert rmse <= 0.1 * extent, (rmse, extent)
    assert abs(ttr.psnr_mean - jtr.psnr_mean) <= 3.0, (ttr.psnr_mean,
                                                       jtr.psnr_mean)
    assert abs(tmap.n_alive - jmap.n_alive) <= 0.2 * jmap.n_alive
    check_files(tdir, 14)


@pytest.mark.slow
def test_vo_slice_on_synthetic3d_with_the_trained_weights(tmp_path):
    """22 frames of the `synthetic3d` room at 64x96 with the weights in the
    repository and both gates live (filter_thresh 1.0, keyframe_thresh 2.0:
    flow at 1/8 of 64x96 is small): the same keyframes, a scale-aligned ATE
    against the ground truth within 0.1 room units of the JAX run's, mean
    train PSNR within 3 dB."""
    jcfg, tcfg = cfgs(
        tmp_path, WEIGHTS, {"module": "synthetic3d", "n_frames": 22},
        image_size=[64, 96], filter_thresh=1.0, keyframe_thresh=2.0,
        frontend_thresh=16.0)
    (jtr, jmap, (jts, jc2w)), (ttr, tmap, (tts, tc2w)), tdir = run_both(
        tmp_path, jcfg, tcfg)
    assert tts == jts and 8 < len(tts) < 22
    gt = j_get_dataset(jcfg).load_gt_dict()
    jate = ate_rmse(jts, jc2w, gt["timestamps"], gt["c2ws"])
    tate = ate_rmse(tts, tc2w, gt["timestamps"], gt["c2ws"])
    assert abs(tate - jate) <= 0.1, (tate, jate)
    assert abs(ttr.psnr_mean - jtr.psnr_mean) <= 3.0, (ttr.psnr_mean,
                                                       jtr.psnr_mean)
    check_files(tdir, len(tts))


METRIC_WEIGHTS = ROOT / "vings_mono_tpu/weights/metric_depth_selftrained.npz"
SMALL = {"dataset": {"module": "synthetic", "n_frames": 12},
         "frontend": {"image_size": [32, 32], "buffer": 16, "ba_window": 8,
                      "filter_thresh": -1.0, "keyframe_thresh": 0.0},
         "training_args": {"iters": 4, "num_keyframe": 3},
         "mapper": {"capacity": 4096, "pair_capacity": 4096, "chunk": 64,
                    "kf_capacity": 4, "points_per_frame": 256,
                    "points_first_frame": 512},
         "middleware": {"max_depth": 1000.0, "cov_times": 1e9}}


def small_cfg(tmp_path, **extra):
    return load_config(overrides={**SMALL, **extra,
                                  "output": {"save_dir": str(tmp_path)}})


SESSION_FILES = ("video.npz", "save_buffers.npz", "graph.npz", "host.pkl",
                 "mapper.npz")


@pytest.mark.parametrize("what", ["use_metric", "resume",
                                  "checkpoint_every", "main_resume",
                                  "main_checkpoint_every"])
def test_ported_option_runs(what, tmp_path):
    """The options the runner took over in turn, each run on the CPU at
    32x32 through `run` or `main` with its effect checked: use_metric sets
    every keyframe's disps_sens from the self-trained DPT (stage `metric`);
    --checkpoint-every 10 writes the session before frame 10 (the frontend
    initialized at frame 7); --resume starts after the session's last frame
    and tracks on as an uninterrupted run does (the CPU's sums are
    deterministic: to 1e-6)."""
    import yaml
    if what == "use_metric":
        cfg = small_cfg(tmp_path, use_metric=True, metric={
            "backend": "flax", "weights": str(METRIC_WEIGHTS)})
        tracker, _, timer = run_vo.run(cfg, str(tmp_path / "run"),
                                       device="cpu")
        assert timer.counts["metric"] == 12
        ds = tracker.video.bufs.disps_sens[:tracker.video.counter]
        assert tracker.video.counter == 12 and bool((ds > 0).all())
        return
    cfg = small_cfg(tmp_path)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(SMALL | {
        "output": {"save_dir": str(tmp_path / "main")}}))
    if what.endswith("checkpoint_every"):
        if what == "main_checkpoint_every":
            run_vo.main([str(path), "--device", "cpu", "--prefix", "m_",
                         "--checkpoint-every", "10"])
            (run_dir,) = (tmp_path / "main").glob("m_*")
        else:
            run_dir = tmp_path / "run"
            run_vo.run(cfg, str(run_dir), device="cpu", checkpoint_every=10)
        session = run_dir / "session"
        assert sorted(p.name for p in session.iterdir()) == \
            sorted(SESSION_FILES)
        with np.load(session / "video.npz") as z:
            assert (z["tstamp"][:10] == np.arange(10)).all()
        with np.load(session / "graph.npz") as z:
            assert np.abs(z["weight"]).sum() > 0     # the GRU has run
        return
    run_vo.run(cfg, str(tmp_path / "first"), device="cpu",
               max_frames=11, checkpoint_every=10)
    session = str(tmp_path / "first" / "session")
    whole, _, _ = run_vo.run(cfg, str(tmp_path / "whole"), device="cpu")
    if what == "main_resume":
        run_vo.main([str(path), "--device", "cpu", "--prefix", "r_",
                     "--resume", session])
        (run_dir,) = (tmp_path / "main").glob("r_*")
        kfs = (run_dir / "keyframelist.txt").read_text().split()
        assert [float(t) for t in kfs] == list(range(12))
        return
    seen = []
    resumed, _, _ = run_vo.run(cfg, str(tmp_path / "resumed"), device="cpu",
                               resume=session,
                               on_frame=lambda i, *a: seen.append(i))
    assert seen == [10, 11]
    assert resumed.video.tstamps_host == whole.video.tstamps_host
    n = whole.video.counter
    np.testing.assert_allclose(resumed.video.bufs.poses[:n].numpy(),
                               whole.video.bufs.poses[:n].numpy(), atol=1e-6)


def test_resume_starts_at_the_keyframe_count(tmp_path):
    """The JAX package's resume rule, reproduced: the run restarts at frame
    `len(tstamps_host) + count_save`, the session's keyframe count. Where
    the motion filter drops frames that is earlier than the frame the
    session was saved at (here one keyframe by frame 10, so frames 1-9 are
    tracked again: ROADMAP §C)."""
    cfg = small_cfg(tmp_path)
    cfg["frontend"]["filter_thresh"] = 1e9     # no frame after the first
    run_vo.run(cfg, str(tmp_path / "first"), device="cpu", max_frames=11,
               checkpoint_every=10)
    session = str(tmp_path / "first" / "session")
    from vings_mono_tpu_torch.utils.checkpoint import load_host
    host = load_host(session)
    assert host["counter"] + host["count_save"] == 1
    seen = []
    run_vo.run(cfg, str(tmp_path / "resumed"), device="cpu", resume=session,
               on_frame=lambda i, *a: seen.append(i))
    assert seen == list(range(1, 12))


@pytest.mark.parametrize("what", ["mode_unknown", "dataset", "parallel_dp"])
def test_unported_option_raises(what, tmp_path, monkeypatch):
    base = {"dataset": {"module": "synthetic", "n_frames": 2},
            "frontend": {"image_size": [32, 32], "buffer": 12,
                         "ba_window": 8},
            "output": {"save_dir": str(tmp_path)}}
    # every dataset module of the JAX package is ported, so the dataset
    # case names a module neither package has
    calls = {
        "mode_unknown": (dict(base, mode="vio_gnss"), NotImplementedError,
                         "mode: vio_gnss"),
        "dataset": (dict(base, dataset={"module": "no_such_dataset"}),
                    ModuleNotFoundError, "no_such_dataset"),
        # parallel.dp and parallel.sp pass the check; dp = 2 on CUDA ranks
        # that the machine lacks raises: the port does not fall back to
        # the CPU (JAX does)
        "parallel_dp": (dict(base, parallel={"dp": 2, "sp": 2}),
                        RuntimeError, "does not fall back"),
    }
    over, exc, match = calls[what]
    if what == "parallel_dp":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        run_vo.check_ported(load_config(overrides=dict(
            base, parallel={"dp": 2, "sp": 2})))
    with pytest.raises(exc, match=match):
        run_vo.run(load_config(overrides=over), str(tmp_path / "run"),
                   device="cpu")


def test_main_runs_the_pipeline_config_end_to_end(tmp_path, capsys):
    """`python -m vings_mono_tpu_torch.runners.run <cfg> --device cpu`:
    the tests/test_pipeline.py configuration from a YAML file."""
    import yaml
    jcfg = j_make_cfg(tmp_path)
    over = {k: jcfg[k] for k in ("mode", "dataset", "frontend",
                                 "training_args", "middleware", "output")}
    over["mapper"] = {k: v for k, v in jcfg["mapper"].items()
                      if k != "impl"}
    over["frontend"]["bf16_gru"] = False
    path = tmp_path / "pipeline.yaml"
    path.write_text(yaml.safe_dump(over))
    run_vo.main([str(path), "--device", "cpu", "--prefix", "t_"])
    out = capsys.readouterr().out
    assert "done in" in out and "track:" in out
    (run_dir,) = [d for d in tmp_path.iterdir()
                  if d.is_dir() and d.name.startswith("t_")]
    check_files(run_dir, 14)
    assert (run_dir / "config.yaml").is_file()


def test_vo_nerfslam_mode_runs(tmp_path):
    """mode: vo_nerfslam is a VO mode of the port: the dirty-window
    packaging drives the mapper to a map."""
    cfg = load_config(overrides={
        "mode": "vo_nerfslam",
        "dataset": {"module": "synthetic3d", "n_frames": 12},
        "frontend": dict(j_make_cfg(tmp_path)["frontend"], bf16_gru=False),
        "training_args": {"iters": 4, "num_keyframe": 3},
        "mapper": {"capacity": 4096, "pair_capacity": 4096, "chunk": 64,
                   "kf_capacity": 4, "points_per_frame": 256,
                   "points_first_frame": 512},
        "middleware": {"max_depth": 1000.0, "cov_times": 1e9}})
    seen = []
    tracker, mapper, _ = run_vo.run(
        cfg, str(tmp_path / "run"), device="cpu",
        on_frame=lambda i, t, m, v: seen.append(
            None if v is None else list(v["valid_localkf_id"])))
    windows = [v for v in seen if v is not None]
    assert windows and windows[-1][-1] == tracker.frontend.t1 - 1
    assert mapper.initialized and mapper.n_alive > 100
    assert torch.isfinite(tracker.video.bufs.poses).all()
