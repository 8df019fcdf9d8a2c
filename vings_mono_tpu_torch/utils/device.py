"""Device choice and numeric mode shared by the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device):
    """torch.device for an entry point; CUDA unless the caller asks for
    another device, and an error when CUDA is asked for but absent."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


@contextlib.contextmanager
def true_f32():
    """Run f32 matmuls and cuDNN convolutions in true f32 (no TF32) inside
    the block, as the reference computes them: the BA's normal equations
    and the correlation volume need f32 conditioning, and the f32 networks
    (DroidNet in global BA or with `bf16_gru` off, SuperPoint, LightGlue,
    FastSAM) are held to the CPU's f32 results. PyTorch's default leaves
    `cudnn.allow_tf32` on, so every f32 network call runs inside this."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
