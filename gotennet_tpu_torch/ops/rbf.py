"""Radial basis expansions: Gaussian, Bessel, exponential-normal.

Counterpart of ``gotennet_tpu/ops/rbf.py`` with the basis parameters
held as constants (the reference's initial values).  Trainable bases
are not ported yet (ROADMAP.md Queue 1, item 3).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from gotennet_tpu_torch.ops.cutoffs import cosine_cutoff

__all__ = ["gaussian_rbf", "bessel_basis", "expnormal_smearing", "get_rbf"]


def gaussian_rbf(r: torch.Tensor, offsets: np.ndarray,
                 widths: np.ndarray) -> torch.Tensor:
    """exp(-(r - mu_k)^2 / (2 w_k^2)); input [...], output [..., n_rbf]."""
    offsets = torch.as_tensor(offsets, device=r.device)
    coeff = -0.5 / torch.as_tensor(widths, device=r.device) ** 2
    return torch.exp(coeff * (r[..., None] - offsets) ** 2)


def bessel_basis(r: torch.Tensor, freqs: np.ndarray) -> torch.Tensor:
    """sin(n pi r / rc) / r, with denominator 1 at r == 0."""
    ax = r[..., None] * torch.as_tensor(freqs, device=r.device)
    denom = torch.where(r == 0, torch.ones_like(r), r)[..., None]
    return torch.sin(ax) / denom


def expnormal_smearing(r: torch.Tensor, means: np.ndarray, betas: np.ndarray,
                       cutoff: float, alpha: float) -> torch.Tensor:
    """cutoff(r) * exp(-beta * (exp(-alpha r) - mu)^2)."""
    env = cosine_cutoff(r, cutoff)[..., None]
    arg = torch.exp(-alpha * r)[..., None] - torch.as_tensor(means,
                                                             device=r.device)
    return env * torch.exp(-torch.as_tensor(betas, device=r.device) * arg ** 2)


def get_rbf(name: str, n_rbf: int,
            cutoff: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve a basis by the reference's names ('expnorm', 'BesselBasis',
    'GaussianRBF') into ``fn(r) -> [..., n_rbf]``."""
    key = name.lower().replace("-", "").replace("_", "").replace(" ", "")
    if key == "expnorm":
        start = math.exp(-cutoff)
        means = np.linspace(start, 1.0, n_rbf, dtype=np.float32)
        betas = np.full(n_rbf, (2.0 / n_rbf * (1.0 - start)) ** -2,
                        np.float32)
        return lambda r: expnormal_smearing(r, means, betas, cutoff,
                                            5.0 / cutoff)
    if key == "besselbasis":
        freqs = np.arange(1, n_rbf + 1, dtype=np.float32) * math.pi / cutoff
        return lambda r: bessel_basis(r, freqs)
    if key == "gaussianrbf":
        offsets = np.linspace(0.0, cutoff, n_rbf, dtype=np.float32)
        width = abs(offsets[1] - offsets[0]) if n_rbf > 1 else 1.0
        widths = np.full(n_rbf, width, np.float32)
        return lambda r: gaussian_rbf(r, offsets, widths)
    raise ValueError(f"Unknown radial basis {name!r}")
