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


FLAGS = ["use_metric"]


@pytest.mark.parametrize("flag", FLAGS)
def test_unported_flag_raises_its_name(flag, tmp_path):
    cfg = load_config(overrides={
        flag: True, "dataset": {"module": "synthetic", "n_frames": 2},
        "frontend": {"image_size": [32, 32]}})
    with pytest.raises(NotImplementedError, match=flag):
        run_vo.build(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=flag):
        run_vo.run(cfg, str(tmp_path), device="cpu")


@pytest.mark.parametrize("what", ["mode_unknown", "resume",
                                  "checkpoint_every", "dataset",
                                  "main_resume", "main_checkpoint_every",
                                  "parallel_dp"])
def test_unported_option_raises(what, tmp_path):
    base = {"dataset": {"module": "synthetic", "n_frames": 2},
            "frontend": {"image_size": [32, 32], "buffer": 12,
                         "ba_window": 8},
            "output": {"save_dir": str(tmp_path)}}
    run_dir = str(tmp_path / "run")
    if what.startswith("main_"):
        import yaml
        path = tmp_path / "cfg.yaml"
        path.write_text(yaml.safe_dump(base))
        extra = ["--resume", str(tmp_path)] if what == "main_resume" \
            else ["--checkpoint-every", "5"]
        name = "--" + what[len("main_"):].replace("_", "-")
        with pytest.raises(NotImplementedError, match=name):
            run_vo.main([str(path), "--device", "cpu"] + extra)
        return
    calls = {
        "mode_unknown": (dict(base, mode="vio_gnss"), {}, "mode: vio_gnss"),
        "resume": (base, {"resume": str(tmp_path)}, "--resume"),
        "checkpoint_every": (base, {"checkpoint_every": 5},
                             "--checkpoint-every"),
        "dataset": (dict(base, dataset={"module": "kitti_sync"}), {},
                    "kitti_sync"),
        "parallel_dp": (dict(base, parallel={"dp": 2}), {},
                        "parallel.dp"),
    }
    over, kwargs, match = calls[what]
    with pytest.raises(NotImplementedError, match=match):
        run_vo.run(load_config(overrides=over), run_dir, device="cpu",
                   **kwargs)


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
