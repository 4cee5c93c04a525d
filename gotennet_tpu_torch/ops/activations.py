"""Activation functions and their string registry.

Counterpart of ``gotennet_tpu/ops/activations.py``: case-insensitive
lookup that ignores ``-``, ``_`` and spaces.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = ["shifted_softplus", "swish", "get_activation", "is_silu_like"]

_LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - ln 2 (SchNet's 'ssp', zero at the origin)."""
    return F.softplus(x) - _LOG2


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), identical to SiLU."""
    return x * torch.sigmoid(x)


def _normalize(s: str) -> str:
    return s.lower().replace("-", "").replace("_", "").replace(" ", "")


def is_silu_like(name) -> bool:
    """True when ``name`` resolves to silu/swish, the only activation the
    fused message kernel implements."""
    return isinstance(name, str) and _normalize(name) in ("silu", "swish")


_ACTIVATIONS = {
    "ssp": shifted_softplus,
    "softplus": shifted_softplus,  # the reference maps 'softplus' -> shifted
    "shiftedsoftplus": shifted_softplus,
    "silu": F.silu,
    "swish": swish,
    "relu": F.relu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "selu": F.selu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leakyrelu": F.leaky_relu,
    "softsign": F.softsign,
    "identity": lambda x: x,
}


def get_activation(
    name: Optional[str | Callable],
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """Resolve an activation by name; callables pass through, ``None`` or
    the empty string mean no activation."""
    if name is None or name == "":
        return None
    if callable(name):
        return name
    key = _normalize(name)
    if key not in _ACTIVATIONS:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]
