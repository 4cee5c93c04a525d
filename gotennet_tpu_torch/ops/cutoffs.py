"""Smooth radial cutoff envelope (``gotennet_tpu/ops/cutoffs.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_cutoff"]


def cosine_cutoff(r: torch.Tensor, cutoff: float) -> torch.Tensor:
    """0.5 * (cos(pi r / rc) + 1) for r < rc, else 0."""
    c = 0.5 * (torch.cos(r * (math.pi / cutoff)) + 1.0)
    return c * (r < cutoff).to(r.dtype)
