"""Port parity for the evaluation harness: `runners/evaluate.py`
(`eval_trajectory`, `eval_psnr`, `main`), `utils/mfu.py` and the trace
half of `utils/profiling.py`, against the JAX package's on the same
inputs.

Tolerances: the ATE from the same trajectory files within 1e-9 (the same
f64 numpy math); the render PSNR over the same keyframes of a mapper state
mirrored from JAX's within 1e-3 dB (the JAX package renders through its
Pallas kernels interpreted, the port through their plain twins; the
renders differ by f32 sum order); the rasterizer's analytic FLOP term
exactly (integers in f64)."""

import gzip
import json
import types

import numpy as np
import pytest
import torch

from synthetic import make_viz_out
from test_torch_dynamic import mapper_configs, mirror_mapper
from vings_mono_tpu.datasets.base import get_dataset as j_get_dataset
from vings_mono_tpu.mapper.mapper import GaussianMapper as JMapper
from vings_mono_tpu.runners import evaluate as jeval
from vings_mono_tpu.utils import mfu as jmfu
from vings_mono_tpu.utils.config import load_config as j_load_config
from vings_mono_tpu_torch.datasets.base import get_dataset
from vings_mono_tpu_torch.ops import lie
from vings_mono_tpu_torch.runners import evaluate as teval
from vings_mono_tpu_torch.runners import run as run_t
from vings_mono_tpu_torch.utils import mfu as tmfu
from vings_mono_tpu_torch.utils import profiling
from vings_mono_tpu_torch.utils.config import load_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATASET = {"dataset": {"module": "synthetic3d", "n_frames": 12},
           "frontend": {"image_size": [48, 64]}}


def test_eval_trajectory_as_jax(tmp_path, capsys):
    """droid_c2w files of the room's true poses moved by a seeded drift,
    scale and offset, every other keyframe: the same ATE from both
    packages' eval_trajectory, and from the port's `main`."""
    ds = get_dataset(load_config(overrides=DATASET))
    gt = ds.load_gt_dict()
    rng = np.random.default_rng(3)
    (tmp_path / "droid_c2w").mkdir()
    for t, c2w in list(zip(gt["timestamps"], gt["c2ws"]))[::2]:
        m = np.array(c2w)
        m[:3, 3] = 0.7 * m[:3, 3] + 0.3 + rng.normal(0, 0.02, 3)
        np.savetxt(tmp_path / "droid_c2w" / f"{t:.6f}.txt", m)
    want = jeval.eval_trajectory(
        str(tmp_path), j_get_dataset(j_load_config(overrides=DATASET)))
    got = teval.eval_trajectory(str(tmp_path), ds)
    assert 0.0 < got < 0.1
    assert abs(got - want) < 1e-9
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(json.dumps(DATASET))
    teval.main([str(cfg), str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(out["ate_rmse_m"] - want) < 1e-9


@pytest.fixture(scope="module")
def mapped():
    """The JAX mapper after one window of tests/synthetic.py keyframes, the
    window, and the port mapper mirrored from it."""
    jc, tc = mapper_configs({"training_args": {"iters": 8,
                                                "num_keyframe": 8}})
    viz, _ = make_viz_out(np.random.default_rng(6), n_kf=3)
    viz["n_valid"] = 3
    jm = JMapper(jc)
    jm.run(viz)
    return jm, mirror_mapper(jm, tc), viz


def videos(viz, saved):
    """The JAX and the port tracker's video as eval_psnr reads it: the
    window's keyframes in the save buffers (saved) or in the live window,
    w2c poses in the tracker's layout, intrinsics at 1/8 with the
    intrinsic dict's fu/cu on the row axis."""
    w2c = torch.linalg.inv(torch.from_numpy(viz["poses"]).float())
    poses = lie.se3_from_matrix(w2c).numpy()
    images = viz["images"].astype(np.float32)
    disps_up = (viz["depths"][..., 0] > 0).astype(np.float32)
    it = viz["intrinsic"]
    intr = np.tile(np.asarray([it["fv"], it["fu"], it["cv"], it["cu"]],
                              np.float32) / 8.0, (len(poses), 1))
    n = len(poses)
    out = []
    for arr in (np.asarray, torch.from_numpy):
        bufs = types.SimpleNamespace(poses=arr(poses), images=arr(images),
                                     disps_up=arr(disps_up),
                                     intrinsics=arr(intr))
        v = types.SimpleNamespace(bufs=bufs, ht=it["H"], wd=it["W"],
                                  count_save=n if saved else 0,
                                  counter=0 if saved else n,
                                  poses_save=poses, images_save=images,
                                  disps_up_save=disps_up)
        out.append(types.SimpleNamespace(video=v))
    return out


@pytest.mark.parametrize("saved", [True, False], ids=["saved", "live"])
def test_eval_psnr_as_jax(mapped, saved):
    jm, tm, viz = mapped
    jtr, ttr = videos(viz, saved)
    want = jeval.eval_psnr(jm, jtr)
    got = teval.eval_psnr(tm, ttr)
    assert 5.0 < got < 60.0
    assert abs(got - want) < 1e-3


def test_bench_mfu_raster_term_as_jax():
    """With no counted program (a signature JAX cannot lower), JAX's train
    loop count is its analytic rasterizer term alone: the port's term is
    the same number."""
    for p_cap, iters in ((262144, 20), (4096, 6)):
        jm = types.SimpleNamespace(_mfu_sig=((), {}, iters),
                                   bin_kwargs={"p_cap": p_cap})
        jt = types.SimpleNamespace(graph=types.SimpleNamespace(
            _mfu_sig=None), cfg={"frontend": {}})
        want = jmfu.bench_mfu(jt, jm, 10, 5, 1.0)
        assert want["flops_fused_update"] == 0.0
        assert tmfu.raster_flops(p_cap, iters) == want["flops_train_loop"]


def test_bench_mfu_counts_a_port_run(tmp_path):
    """bench_mfu after a port run: JAX's keys, a train-loop count above the
    rasterizer term (SSIM convolutions and projection products), a
    fused-update count (GRU convolutions, BA products), the H100 peak as
    the denominator, and the live state untouched by the count."""
    from test_pipeline import make_cfg
    jcfg = make_cfg(tmp_path)
    over = {k: jcfg[k] for k in ("mode", "dataset", "frontend",
                                 "training_args", "middleware")}
    over["mapper"] = {k: v for k, v in jcfg["mapper"].items()
                      if k != "impl"}
    over["frontend"]["bf16_gru"] = False
    tr, mp, _ = run_t.run(load_config(overrides=over), str(tmp_path / "r"),
                          device="cpu", max_frames=10)
    xyz = mp.state.xyz.clone()
    out = tmfu.bench_mfu(tr, mp, 10, mp.time_idx, 2.0)
    keys = jmfu.bench_mfu(
        types.SimpleNamespace(graph=None, cfg={"frontend": {}}),
        types.SimpleNamespace(), 1, 1, 1.0).keys()
    assert out.keys() == keys
    term = tmfu.raster_flops(int(mp.bin_kwargs["p_cap"]), mp._mfu_sig[2])
    assert out["flops_train_loop"] > term > 0
    assert out["flops_fused_update"] > 0
    assert out["mfu"] == pytest.approx(out["achieved_flops_per_s"] /
                                       profiling.H100_PEAK_FLOPS)
    assert torch.equal(mp.state.xyz, xyz)


def test_device_events_reads_only_device_work(tmp_path):
    """A chrome trace the test writes (gzipped, in a subdirectory): kernels,
    memcpy and memset are summed by name; host ops and metadata are not. A
    CPU-only torch.profiler trace from `trace` has none."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "kernel", "name": "raster_forward", "dur": 170.0},
        {"ph": "X", "cat": "kernel", "name": "raster_forward", "dur": 172.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 5.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 900.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 4.0},
    ]
    (tmp_path / "a").mkdir()
    with gzip.open(tmp_path / "a" / "t.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    got = profiling.device_events(str(tmp_path))
    want = {"raster_forward": (0.342, 2), "Memcpy HtoD": (0.005, 1),
            "Memset": (0.001, 1)}
    assert got.keys() == want.keys()
    for k, (ms, n) in want.items():
        assert got[k][1] == n and got[k][0] == pytest.approx(ms, rel=1e-12)
    assert profiling.device_events(str(tmp_path / "none")) == {}
    with profiling.trace(str(tmp_path / "cpu")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "cpu" / "trace.json").is_file()
    assert profiling.device_events(str(tmp_path / "cpu")) == {}
    assert profiling.count_flops(torch.matmul, torch.ones(8, 4),
                                 torch.ones(4, 2)) == 2 * 8 * 4 * 2
