"""Dense / MLP modules with the reference's init registry.

Counterpart of ``gotennet_tpu/nn/dense.py``.  A layer is linear ->
optional LayerNorm (eps 1e-5) -> optional activation.  Weights are
stored in torch's ``[out, in]`` layout under the reference state-dict
names (``weight``, ``bias``, ``norm.weight``, ``norm.bias``).

``dtype`` is the compute type, as flax's ``Dense(dtype=...)``: input,
weight and bias are cast to it, the product comes out in it and the bias
is added in it.  ``None`` computes in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "MLP", "init_weight_"]


def init_weight_(w: torch.Tensor, name: Optional[str],
                 generator: torch.Generator, gain: Optional[float] = None
                 ) -> torch.Tensor:
    """Fill ``w`` in place by the reference registry's name.

    ``w`` is ``[out, in]`` for a weight and ``[out]`` for a bias; fan-in
    and fan-out follow the JAX package's ``[in, out]`` reading of the
    same numbers.  The orthogonal inits draw torch's ``orthogonal_`` on
    ``[out, in]``, as the JAX package does before it transposes: with
    ``glo_orthogonal`` rescaled to variance 2 / (fan_in + fan_out), with
    ``he_orthogonal`` standardised over the input axis and scaled by
    1 / sqrt(fan_in)."""
    with torch.no_grad():
        if name == "zeros":
            return w.zero_()
        if name in ("glo_orthogonal", "he_orthogonal"):
            if w.dim() != 2:
                raise ValueError(f"{name} initialises a matrix, got shape "
                                 f"{tuple(w.shape)}")
            fan_out, fan_in = w.shape
            q = nn.init.orthogonal_(torch.empty(fan_out, fan_in),
                                    generator=generator)
            if name == "glo_orthogonal":
                q = q * math.sqrt(2.0 / ((fan_in + fan_out)
                                         * torch.var(q, unbiased=False)))
            else:
                q = (q - q.mean(dim=1, keepdim=True)) / torch.sqrt(
                    q.var(dim=1, keepdim=True) + 1e-6) / math.sqrt(fan_in)
            return w.copy_(q)
        if name is None or name == "":
            # torch.nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
            fan_in = w.shape[-1] if w.dim() == 2 else w.shape[0]
            bound = 1.0 / math.sqrt(fan_in)
        elif name == "xavier_uniform":
            fan_out, fan_in = w.shape
            bound = (gain or 1.0) * math.sqrt(6.0 / (fan_in + fan_out))
        else:
            raise ValueError(f"Unknown initialization {name!r}")
        w.copy_(torch.rand(w.shape, generator=generator) * (2 * bound)
                - bound)
        return w


class Dense(nn.Module):
    """Linear -> optional LayerNorm -> optional activation."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True,
                 activation: Optional[Callable] = None,
                 weight_init: Optional[str] = "xavier_uniform",
                 bias_init: Optional[str] = "zeros", norm: str = "",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)
        if norm == "layer":
            self.norm = nn.LayerNorm(out_features, eps=1e-5)
        elif norm:
            raise ValueError(f"Unsupported norm {norm!r}")
        else:
            self.norm = None
        self.activation = activation
        self.weight_init = weight_init
        self.bias_init = bias_init
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_weight_(self.weight, self.weight_init, generator)
        if self.bias is not None:
            init_weight_(self.bias, self.bias_init, generator)
        if self.norm is not None:
            self.norm.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtype or torch.float32
        y = F.linear(x.to(cd), self.weight.to(cd))
        if self.bias is not None:
            y = y + self.bias.to(cd)
        if self.norm is not None:
            y = self.norm(y.float()).to(cd)
        if self.activation is not None:
            y = self.activation(y)
        return y


class MLP(nn.Module):
    """Dense stack over ``dims = [in, ..., out]``: hidden layers get
    ``activation`` and ``norm``, the last gets ``last_activation`` and no
    norm.  Layers are named ``dense_layers.{i}`` as in the reference."""

    def __init__(self, dims: Sequence[int],
                 activation: Optional[Callable] = None,
                 last_activation: Optional[Callable] = None,
                 weight_init: Optional[str] = "xavier_uniform",
                 bias_init: Optional[str] = "zeros", norm: str = "",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = list(dims)
        n = len(dims) - 1
        self.dense_layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1],
                  activation=activation if i < n - 1 else last_activation,
                  weight_init=weight_init, bias_init=bias_init,
                  norm=norm if i < n - 1 else "", dtype=dtype)
            for i in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.dense_layers:
            x = layer(x)
        return x
