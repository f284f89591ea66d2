"""Device selection: explicit, with no fallback.

The port never chooses a device for its caller. Code that needs the card
calls ``require_cuda`` and fails when there is none; CPU tensors are only
ever the caller's own choice (the tests use them).
"""

from __future__ import annotations

import torch


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this path runs on an NVIDIA GPU and has "
            "no CPU fallback"
        )
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, "
            f"{torch.cuda.device_count()} present"
        )
    return torch.device("cuda", index)
