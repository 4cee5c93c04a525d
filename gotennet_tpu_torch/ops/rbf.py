"""Radial basis expansions: Gaussian, Bessel, exponential-normal.

Counterpart of ``gotennet_tpu/ops/rbf.py``.  ``get_rbf`` holds the basis
parameters as constants (the reference's initial values); the models hold a
``RadialBasis`` module, which with ``trainable`` makes the Gaussian
``offsets``/``widths`` or the exp-normal ``means``/``betas`` parameters
(``representation.radial_basis.*`` in the reference state dict) and keeps
them out of the state dict otherwise.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

from gotennet_tpu_torch.ops.cutoffs import cosine_cutoff

__all__ = ["gaussian_rbf", "bessel_basis", "expnormal_smearing", "get_rbf",
           "parameter_names", "RadialBasis"]


def gaussian_rbf(r: torch.Tensor, offsets, widths) -> torch.Tensor:
    """exp(-(r - mu_k)^2 / (2 w_k^2)); input [...], output [..., n_rbf]."""
    offsets = torch.as_tensor(offsets, device=r.device)
    coeff = -0.5 / torch.as_tensor(widths, device=r.device) ** 2
    return torch.exp(coeff * (r[..., None] - offsets) ** 2)


def bessel_basis(r: torch.Tensor, freqs) -> torch.Tensor:
    """sin(n pi r / rc) / r, with denominator 1 at r == 0."""
    ax = r[..., None] * torch.as_tensor(freqs, device=r.device)
    denom = torch.where(r == 0, torch.ones_like(r), r)[..., None]
    return torch.sin(ax) / denom


def expnormal_smearing(r: torch.Tensor, means, betas, cutoff: float,
                       alpha: float) -> torch.Tensor:
    """cutoff(r) * exp(-beta * (exp(-alpha r) - mu)^2)."""
    env = cosine_cutoff(r, cutoff)[..., None]
    arg = torch.exp(-alpha * r)[..., None] - torch.as_tensor(means,
                                                             device=r.device)
    return env * torch.exp(-torch.as_tensor(betas, device=r.device) * arg ** 2)


def _key(name: str) -> str:
    return name.lower().replace("-", "").replace("_", "").replace(" ", "")


def _initial(key: str, n_rbf: int, cutoff: float) -> dict:
    """The reference's initial basis parameters, float32 arrays by name."""
    if key == "expnorm":
        start = math.exp(-cutoff)
        return {"means": np.linspace(start, 1.0, n_rbf, dtype=np.float32),
                "betas": np.full(n_rbf, (2.0 / n_rbf * (1.0 - start)) ** -2,
                                 np.float32)}
    if key == "besselbasis":
        return {"freqs": np.arange(1, n_rbf + 1, dtype=np.float32)
                * math.pi / cutoff}
    if key == "gaussianrbf":
        offsets = np.linspace(0.0, cutoff, n_rbf, dtype=np.float32)
        width = abs(offsets[1] - offsets[0]) if n_rbf > 1 else 1.0
        return {"offsets": offsets,
                "widths": np.full(n_rbf, width, np.float32)}
    raise ValueError(f"Unknown radial basis {key!r}")


def parameter_names(name: str) -> Tuple[str, ...]:
    """Names of the basis ``name``'s parameters, in the state dict's
    order."""
    return tuple(_initial(_key(name), 2, 1.0))


def get_rbf(name: str, n_rbf: int,
            cutoff: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve a basis by the reference's names ('expnorm', 'BesselBasis',
    'GaussianRBF') into ``fn(r) -> [..., n_rbf]`` with constant
    parameters."""
    return RadialBasis(name, n_rbf, cutoff)


class RadialBasis(nn.Module):
    """The basis ``name`` as a module: ``forward(r) -> [..., n_rbf]``.
    With ``trainable`` its parameters are ``nn.Parameter``s (a Bessel basis
    has none and raises ``ValueError``, as in the JAX package); otherwise
    they are buffers outside the state dict."""

    def __init__(self, name: str, n_rbf: int, cutoff: float,
                 trainable: bool = False):
        super().__init__()
        self.key = _key(name)
        self.cutoff = cutoff
        init = _initial(self.key, n_rbf, cutoff)
        if trainable and self.key == "besselbasis":
            raise ValueError(
                f"radial basis {name!r} has no trainable parameters (the "
                "reference keeps BesselBasis frequencies as buffers)")
        for k, v in init.items():
            t = torch.from_numpy(v)
            if trainable:
                setattr(self, k, nn.Parameter(t))
            else:
                self.register_buffer(k, t, persistent=False)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        if self.key == "expnorm":
            return expnormal_smearing(r, self.means, self.betas, self.cutoff,
                                      5.0 / self.cutoff)
        if self.key == "besselbasis":
            return bessel_basis(r, self.freqs)
        return gaussian_rbf(r, self.offsets, self.widths)
