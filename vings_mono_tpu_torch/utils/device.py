"""Device choice and numeric mode shared by the port's entry points."""

from __future__ import annotations

import contextlib
import os
import threading

import torch

# cuBLAS picks a reduction order per call unless its workspace is fixed;
# it reads this once, when the process makes its first handle
CUBLAS_WORKSPACE = ":4096:8"


def resolve_device(device):
    """torch.device for an entry point; CUDA unless the caller asks for
    another device, and an error when CUDA is asked for but absent. For
    CUDA it also fixes cuBLAS's workspace (CUBLAS_WORKSPACE_CONFIG, unless
    the environment sets it already), which `reproducible` needs before
    the first cuBLAS call."""
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    return device


class _ProcessFlags:
    """Process-wide flags held at `value` while any block is inside.
    Blocks may nest and may overlap across threads (the threaded runners'
    tracker and mapper): the first block in saves the flags and the last
    one out restores them, so no interleaving of two threads leaves them
    changed."""

    def __init__(self, read, write, value):
        self.read, self.write, self.value = read, write, value
        self.lock = threading.Lock()
        self.depth = 0
        self.saved = None

    @contextlib.contextmanager
    def block(self):
        with self.lock:
            if self.depth == 0:
                self.saved = self.read()
                self.write(self.value)
            self.depth += 1
        try:
            yield
        finally:
            with self.lock:
                self.depth -= 1
                if self.depth == 0:
                    self.write(self.saved)


def _read_tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _write_tf32(flags):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


_TRUE_F32 = _ProcessFlags(_read_tf32, _write_tf32, (False, False))


def true_f32():
    """Run f32 matmuls and cuDNN convolutions in true f32 (no TF32) inside
    the block, as the reference computes them: the BA's normal equations
    and the correlation volume need f32 conditioning, and the f32 networks
    (DroidNet in global BA or with `bf16_gru` off, SuperPoint, LightGlue,
    FastSAM) are held to the CPU's f32 results. PyTorch's default leaves
    `cudnn.allow_tf32` on, so every f32 network call runs inside this.

    The flags are process-wide; blocks nest and overlap across threads
    as `_ProcessFlags` says."""
    return _TRUE_F32.block()


def read_deterministic():
    """(deterministic algorithms, warn only, cudnn.deterministic,
    cudnn.benchmark, fill_uninitialized_memory)."""
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.utils.deterministic.fill_uninitialized_memory)


def write_deterministic(flags):
    det, warn_only, cudnn_det, benchmark, fill = flags
    torch.use_deterministic_algorithms(det, warn_only=warn_only)
    torch.backends.cudnn.deterministic = cudnn_det
    torch.backends.cudnn.benchmark = benchmark
    torch.utils.deterministic.fill_uninitialized_memory = fill


DETERMINISTIC = (True, False, True, False, True)
_REPRODUCIBLE = _ProcessFlags(read_deterministic, write_deterministic,
                              DETERMINISTIC)


def reproducible():
    """The same inputs give the same bits on every run inside the block,
    as the reference's runs do: PyTorch's deterministic algorithms (an op
    that has none raises; never a warning), cuDNN's deterministic
    algorithms without autotuning, and memory from `torch.empty` filled
    with NaN, so that a read of memory no one wrote shows instead of
    varying. cuBLAS also needs its workspace fixed before the process's
    first handle: `resolve_device` does that for CUDA. Every runner and
    trainer runs inside this block. The flags are process-wide; blocks
    nest and overlap across threads as `_ProcessFlags` says."""
    return _REPRODUCIBLE.block()
