"""Normalisation of steerable (degree-l) features.

Counterpart of ``gotennet_tpu/nn/norms.py``: ``TensorLayerNorm`` is the
VisNet-style max-min norm, branch-free.  Per degree block, each channel's
norm over the m axis is rescaled to [0, 1] across the channels of a node,
and the directions are applied again; all-zero input gives zeros.
"""

from __future__ import annotations

import torch
from torch import nn

from gotennet_tpu_torch.ops.spherical import degree_slices

__all__ = ["TensorLayerNorm", "tensor_max_min_norm"]

_EPS = 1e-12


def tensor_max_min_norm(block: torch.Tensor) -> torch.Tensor:
    """Max-min normalise one degree block ``[..., 2l+1, D]``."""
    dist = torch.clamp(torch.sqrt(torch.sum(block ** 2, dim=-2,
                                            keepdim=True)), min=_EPS)
    direct = block / dist
    max_val = torch.amax(dist, dim=-1, keepdim=True)
    min_val = torch.amin(dist, dim=-1, keepdim=True)
    delta = max_val - min_val
    delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    return torch.clamp((dist - min_val) / delta, min=0.0) * direct


class TensorLayerNorm(nn.Module):
    """Per-degree max-min norm of ``X [..., (lmax+1)^2-1, D]``, times a
    trainable channel ``weight`` (initialised to ones) with
    ``trainable``."""

    def __init__(self, hidden_channels: int, lmax: int,
                 trainable: bool = False):
        super().__init__()
        self.lmax = lmax
        self.weight = (nn.Parameter(torch.ones(hidden_channels))
                       if trainable else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([tensor_max_min_norm(x[..., lo:hi, :])
                         for lo, hi in degree_slices(self.lmax)], dim=-2)
        return out if self.weight is None else out * self.weight
