"""Device resolution for the port's entry points.

Entry points (`init_params`, `Engine`, the serve CLI) default to the card.
Without CUDA that default raises instead of carrying on on the CPU: a CPU run
is only ever one the caller asked for.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False "
            "(no CUDA device or a CPU-only PyTorch build); pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev


def f32_numerics():
    """Full-f32 matmuls and convolutions: float32 is the port's numerics of
    record, so TF32 (about three decimal digits) is switched off for both
    cuBLAS and cuDNN instead of relying on their defaults."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
