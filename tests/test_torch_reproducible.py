"""`utils.device.reproducible`, the numeric mode every runner and trainer
of the port runs in: PyTorch's deterministic algorithms (never warn-only),
cuDNN's deterministic algorithms without autotuning, and memory from
`torch.empty` filled with NaN. The flags are process-wide, so this holds
on the CPU as on a card: the block sets them and restores them across
nesting and two overlapping threads, as `true_f32` does; a spy shows
that `runners.run.run`, `run_tracking`, `run_mapping`, the threaded
runners' workers and all five trainers run inside it; dp ranks copy it
from the leader; `resolve_device` fixes cuBLAS's workspace for CUDA
only. Imports no JAX."""

import threading

import pytest
import torch

from vings_mono_tpu_torch.parallel import mesh
from vings_mono_tpu_torch.runners import self_training
from vings_mono_tpu_torch.utils import device as device_mod
from vings_mono_tpu_torch.utils.device import (DETERMINISTIC,
                                               read_deterministic,
                                               reproducible,
                                               resolve_device)

OFF = (False, False, False, False, True)   # PyTorch's defaults


@pytest.fixture(autouse=True)
def defaults():
    """Every test starts and ends at PyTorch's defaults."""
    saved = read_deterministic()
    device_mod.write_deterministic(OFF)
    yield
    assert read_deterministic() == OFF
    device_mod.write_deterministic(saved)


def test_the_block_sets_and_restores_the_flags():
    with reproducible():
        assert read_deterministic() == DETERMINISTIC
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert torch.utils.deterministic.fill_uninitialized_memory
        with reproducible():
            assert read_deterministic() == DETERMINISTIC
        assert read_deterministic() == DETERMINISTIC
        assert torch.empty(4).isnan().all()
    assert read_deterministic() == OFF
    with pytest.raises(ValueError):
        with reproducible():
            raise ValueError
    assert read_deterministic() == OFF


def test_overlapping_blocks_in_two_threads_restore_the_flags():
    """Thread a enters, b enters, a leaves while b is still inside, then
    b leaves: the mode holds until the last block ends, then the flags
    are what they were."""
    steps = [threading.Event() for _ in range(3)]
    seen = {}

    def a():
        with reproducible():
            steps[0].set()
            steps[1].wait(10)
        steps[2].set()

    def b():
        steps[0].wait(10)
        with reproducible():
            steps[1].set()
            steps[2].wait(10)
            seen["b_after_a_left"] = read_deterministic()
    threads = [threading.Thread(target=f, daemon=True) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
        assert not t.is_alive()
    assert seen["b_after_a_left"] == DETERMINISTIC
    assert read_deterministic() == OFF


def test_an_op_without_a_deterministic_form_raises_inside():
    """The block never downgrades the check to a warning (put_ without
    accumulate has no deterministic form on any device)."""
    x = torch.zeros(4)
    with reproducible():
        with pytest.raises(RuntimeError, match="deterministic"):
            x.put_(torch.tensor([1, 1]), torch.tensor([1.0, 2.0]))
    x.put_(torch.tensor([1]), torch.tensor([1.0]))


def spy(monkeypatch, module, name, result=None):
    """Replace module.name by a function that records the deterministic
    flags at its call and returns `result`."""
    seen = []

    def record(*a, **k):
        seen.append(read_deterministic())
        return result
    monkeypatch.setattr(module, name, record)
    return seen


def test_runners_run_inside_the_block(monkeypatch, tmp_path):
    from vings_mono_tpu_torch.runners import (run, run_mapping,
                                              run_multiprocess, run_tracking)
    seen = {"run": spy(monkeypatch, run, "_run"),
            "run_tracking": spy(monkeypatch, run_tracking, "_run"),
            "run_mapping": spy(monkeypatch, run_mapping, "_map_windows", []),
            "workers": []}
    run.run({}, str(tmp_path))
    run_tracking.run({}, str(tmp_path))

    class Mapper:
        def __init__(self, cfg, device=None):
            pass

        def close(self):
            pass
    from vings_mono_tpu_torch.datasets import replay
    from vings_mono_tpu_torch.mapper import mapper
    monkeypatch.setattr(replay, "ReplayDataset", lambda cfg: None)
    monkeypatch.setattr(mapper, "GaussianMapper", Mapper)
    run_mapping.run({}, str(tmp_path))
    workers = run_multiprocess.Workers()
    for _ in range(2):
        workers.start(lambda: seen["workers"].append(read_deterministic()),
                      torch.device("cpu"))
    workers.join(20)
    assert seen == {"run": [DETERMINISTIC], "run_tracking": [DETERMINISTIC],
                    "run_mapping": [DETERMINISTIC],
                    "workers": [DETERMINISTIC] * 2}


@pytest.mark.parametrize("name", ["superpoint", "lightglue", "fastsam",
                                  "metric_depth"])
def test_each_recipe_trains_inside_the_block(monkeypatch, tmp_path, name):
    import importlib
    trainer = importlib.import_module(
        f"vings_mono_tpu_torch.runners.train_{name}")
    seen = spy(monkeypatch, self_training, "train_loop", [])
    trainer.train(1, str(tmp_path / "w.npz"), device="cpu",
                  pool=self_training.SamplePool.fixed([]))
    assert seen == [DETERMINISTIC]


def test_the_droid_trainer_trains_inside_the_block(monkeypatch, tmp_path):
    from vings_mono_tpu_torch.runners import train_droid
    seen = spy(monkeypatch, train_droid, "_train", (None, []))
    train_droid.train(1, str(tmp_path / "w.npz"), device="cpu")
    assert seen == [DETERMINISTIC]


def test_dp_ranks_copy_the_mode_from_the_leader():
    """A follower sets what the leader had when it spawned it."""
    with reproducible():
        mode = mesh._numeric_mode()
    threads = torch.get_num_threads()
    try:
        mesh._set_numeric_mode(mode)
        assert read_deterministic() == DETERMINISTIC
    finally:
        device_mod.write_deterministic(OFF)
        torch.set_num_threads(threads)


def test_resolve_device_fixes_cublas_for_cuda_only(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    import os
    assert resolve_device("cpu").type == "cpu"
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None).type == "cuda"
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    resolve_device("cuda")
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
