"""Device selection for the package's entry points."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device that is not present is an
    error: entry points never fall back to the CPU on their own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return device
