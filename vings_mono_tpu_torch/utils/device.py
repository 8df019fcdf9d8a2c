"""Device choice and numeric mode shared by the port's entry points."""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device):
    """torch.device for an entry point; CUDA unless the caller asks for
    another device, and an error when CUDA is asked for but absent."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


_F32_LOCK = threading.Lock()
_F32 = {"depth": 0, "saved": None}


@contextlib.contextmanager
def true_f32():
    """Run f32 matmuls and cuDNN convolutions in true f32 (no TF32) inside
    the block, as the reference computes them: the BA's normal equations
    and the correlation volume need f32 conditioning, and the f32 networks
    (DroidNet in global BA or with `bf16_gru` off, SuperPoint, LightGlue,
    FastSAM) are held to the CPU's f32 results. PyTorch's default leaves
    `cudnn.allow_tf32` on, so every f32 network call runs inside this.

    The flags are process-wide. Blocks may nest and may overlap across
    threads (the threaded runners' tracker and mapper): the first block in
    saves the flags and the last one out restores them, so no interleaving
    of two threads leaves them changed."""
    with _F32_LOCK:
        if _F32["depth"] == 0:
            _F32["saved"] = (torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _F32["depth"] += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32["depth"] -= 1
            if _F32["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _F32["saved"]
