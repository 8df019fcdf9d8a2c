"""The port's f32 networks run in true f32 (no TF32): PyTorch leaves
`torch.backends.cudnn.allow_tf32` on by default, so on a card every f32
convolution would run in TF32 unless the caller clears it. A spy on
`torch.nn.functional.conv2d` (and `linear`) records the flags at every
call while global BA, the tracker with an f32 network, and the loop and
dynamic nets run; each call must see both flags off, and the flags must
be back as they were afterwards. The flags are global, so this holds on
the CPU as on a card. Imports no JAX."""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vings_mono_tpu_torch.models.fastsam import load_fastsam, raw_maps
from vings_mono_tpu_torch.models.superpoint import extract, load_superpoint
from vings_mono_tpu_torch.tracker.backend import GlobalBA
from vings_mono_tpu_torch.tracker.tracker import Tracker
from vings_mono_tpu_torch.utils.config import load_config
from vings_mono_tpu_torch.utils.device import true_f32

H = W = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test worker: the lane runs several workers,
    and the JAX runs beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tf32_defaults(monkeypatch):
    """PyTorch's defaults: TF32 convolutions on, TF32 matmuls off."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@contextlib.contextmanager
def spy(*names):
    """Record (cudnn, matmul) allow_tf32 at each f32 call of F.<name>."""
    seen = []

    def wrap(fn):
        def spied(x, *a, **k):
            if x.dtype == torch.float32:
                seen.append((torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32))
            return fn(x, *a, **k)
        return spied

    mp = pytest.MonkeyPatch()
    for n in names:
        mp.setattr(F, n, wrap(getattr(F, n)))
    try:
        yield seen
    finally:
        mp.undo()


def small_tracker():
    cfg = load_config(overrides={
        "mode": "vo",
        "frontend": {"buffer": 12, "warm_up": 4, "filter_thresh": -1.0,
                     "keyframe_thresh": 0.0, "frontend_thresh": 1e9,
                     "frontend_window": 8, "frontend_radius": 2,
                     "frontend_nms": 1, "max_factors": 16,
                     "edge_capacity": 24, "inactive_capacity": 32,
                     "ba_window": 8, "iters1": 1, "iters2": 1,
                     "active_window": 8, "max_age": 6, "rollup_at": 100,
                     "rollup_n": 4, "save_buffer": 16, "bf16_gru": False},
        "backend": {"steps": 1, "iters": 1, "chunk": 8}})
    return Tracker(cfg, H, W, device="cpu",
                   generator=torch.Generator().manual_seed(0))


def frames(n):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for k in range(n):
        img = 0.5 + 0.5 * np.sin(0.3 * (xs + 2 * k)) * np.cos(0.2 * ys)
        yield {"timestamp": float(k), "rgb": np.stack(
            [img, 0.8 * img, 1 - img], -1).astype(np.float32),
            "intrinsic": np.asarray([30.0, 30.0, 16.0, 16.0], np.float32)}


def check(seen, n_min):
    assert len(seen) >= n_min
    assert not any(c or m for c, m in seen), \
        f"{sum(c for c, _ in seen)} of {len(seen)} calls allowed TF32"
    assert torch.backends.cudnn.allow_tf32     # restored


def test_global_ba_runs_its_network_in_true_f32():
    """GlobalBA.run's re-encode and GRU rounds (the f32 DroidNet)."""
    tr = small_tracker()
    for pkt in frames(6):
        tr.track(pkt)
    with spy("conv2d") as seen:
        stats = GlobalBA(tr).run()
    assert not stats["skipped"]
    check(seen, 20)


def test_tracker_f32_network_runs_in_true_f32():
    """Tracker.track with `bf16_gru` off: the motion filter's features and
    context and the frontend's GRU updates."""
    tr = small_tracker()
    with spy("conv2d") as seen:
        for pkt in frames(6):
            tr.track(pkt)
    assert tr.video.counter >= 4
    check(seen, 50)


def test_loop_and_dynamic_nets_run_in_true_f32():
    """SuperPoint's extract, FastSAM's raw maps and LightGlue's match."""
    from vings_mono_tpu_torch.loop.detect import LoopDetector
    from vings_mono_tpu_torch.models.lightglue import LightGlue
    rng = np.random.default_rng(0)
    sp = load_superpoint(generator=torch.Generator().manual_seed(0))
    fs = load_fastsam(generator=torch.Generator().manual_seed(0))
    with spy("conv2d") as seen:
        extract(sp, torch.rand(32, 48), max_kp=16)
        raw_maps(fs, rng.uniform(size=(32, 48, 3)).astype(np.float32))
    check(seen, 12 + 60)
    det = LoopDetector({})
    det.lg = LightGlue(layers=1, generator=torch.Generator().manual_seed(0))
    feat = (rng.uniform(0, 40, (16, 2)), None, np.ones(16, bool),
            rng.normal(size=(16, 256)).astype(np.float32))
    with spy("linear") as seen:
        det.match(feat, feat, img_hw=(32, 48))
    check(seen, 10)


def test_true_f32_restores_the_flags():
    torch.backends.cuda.matmul.allow_tf32 = True
    with true_f32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ValueError):
        with true_f32():
            raise ValueError
    assert torch.backends.cudnn.allow_tf32


def test_overlapping_blocks_in_two_threads_restore_the_flags():
    """The threaded runners' tracker and mapper threads may both be inside
    a true_f32 block: thread a enters, b enters, a leaves while b is still
    inside, then b leaves. The flags stay off until the last block ends
    and then return to what they were (a save and restore per block would
    turn TF32 back on under b and leave it off for good after)."""
    import threading
    steps = [threading.Event() for _ in range(3)]
    seen = {}

    def a():
        with true_f32():
            steps[0].set()
            steps[1].wait(10)
        steps[2].set()

    def b():
        steps[0].wait(10)
        with true_f32():
            steps[1].set()
            steps[2].wait(10)
            seen["b_after_a_left"] = (torch.backends.cudnn.allow_tf32,
                                      torch.backends.cuda.matmul.allow_tf32)
    threads = [threading.Thread(target=f, daemon=True) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
        assert not t.is_alive()
    assert seen["b_after_a_left"] == (False, False)
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is False
