"""Real spherical harmonics of edge vectors, any degree, one recurrence.

Counterpart of ``gotennet_tpu/ops/spherical.py`` (same convention, same
numbers): y is the zenith axis, components of degree l are ordered
m = -l..l, degrees 1 and 2 are norm-normalised and l >= 3 carries the
extra factor sqrt(2l+1).  The outputs are homogeneous polynomials, so a
zero vector (a self-loop) gives exact zeros.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["spherical_harmonics", "num_sh_components", "degree_slices"]


def num_sh_components(lmax: int) -> int:
    """Size of the concatenated degree axis: sum_{l=1..lmax} (2l+1)."""
    return (lmax + 1) ** 2 - 1


def degree_slices(lmax: int) -> List[Tuple[int, int]]:
    """[start, stop) of each degree block l = 1..lmax along the SH axis."""
    return [(l * l - 1, (l + 1) ** 2 - 1) for l in range(1, lmax + 1)]


def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def spherical_harmonics(vec: torch.Tensor, lmax: int) -> torch.Tensor:
    """``[..., 3]`` vectors -> ``[..., (lmax+1)^2 - 1]`` components of
    degrees 1..lmax, degree-major, m = -l..l within each degree."""
    if lmax < 1:
        raise ValueError("lmax must be >= 1")
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r2 = x * x + y * y + z * z

    # azimuthal part: A_m + i B_m = (z + i x)^m
    A = [torch.ones_like(x)]
    B = [torch.zeros_like(x)]
    for m in range(1, lmax + 1):
        A.append(z * A[m - 1] - x * B[m - 1])
        B.append(x * A[m - 1] + z * B[m - 1])

    # homogenised semi-normalised associated Legendre polynomials
    P: Dict[int, Dict[int, torch.Tensor]] = {}
    for m in range(0, lmax + 1):
        P.setdefault(m, {})[m] = torch.full_like(x, _double_factorial(2 * m - 1))
        if m + 1 <= lmax:
            P.setdefault(m + 1, {})[m] = (2 * m + 1) * y * P[m][m]
        for l in range(m + 2, lmax + 1):
            P.setdefault(l, {})[m] = (
                (2 * l - 1) * y * P[l - 1][m]
                - (l - 1 + m) * r2 * P[l - 2][m]
            ) / (l - m)

    comps = []
    for l in range(1, lmax + 1):
        c_l = 1.0 if l <= 2 else math.sqrt(2 * l + 1)
        for m in range(l, 0, -1):
            n_lm = math.sqrt(2.0 * math.factorial(l - m) / math.factorial(l + m))
            comps.append((c_l * n_lm) * P[l][m] * B[m])
        comps.append(c_l * P[l][0])
        for m in range(1, l + 1):
            n_lm = math.sqrt(2.0 * math.factorial(l - m) / math.factorial(l + m))
            comps.append((c_l * n_lm) * P[l][m] * A[m])
    return torch.stack(comps, dim=-1)
