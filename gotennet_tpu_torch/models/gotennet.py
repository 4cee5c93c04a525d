"""GotenNet configuration and the equivariant feed-forward block.

Counterpart of ``gotennet_tpu/models/gotennet.py``: ``GotenNetConfig``
keeps the JAX package's field names and defaults, with ``pair_dtype``
and ``node_dtype`` as ``torch.dtype``s.  Options whose code is not
ported yet raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from gotennet_tpu_torch.nn.dense import Dense
from gotennet_tpu_torch.ops.activations import get_activation, is_silu_like
from gotennet_tpu_torch.ops.spherical import num_sh_components

__all__ = ["GotenNetConfig", "EQFF", "parse_edge_updates", "not_ported"]

# ROADMAP.md Queue 1 items that port what this package still rejects
ROADMAP_ITEMS = {
    1: "Training step",
    2: "Unfused dense message",
    3: "Remaining primitives",
    4: "Data",
    5: "Edge-update variants",
    6: "Dipole and ESE heads",
    9: "Forces",
    10: "Edge-list layout",
    11: "ELL layout: the unfused update, large tables",
    13: "CLI, configs and tools",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, item {item}: "
        f"{ROADMAP_ITEMS[item]})")


def parse_edge_updates(edge_updates: Union[bool, str]) -> dict:
    """Parse the reference's ``edge_updates`` feature string into an
    update-info dict (same result as the JAX package's parser)."""
    info = {"gated": False, "rej": True, "mlp": False, "mlpa": False,
            "lin_w": 0, "lin_ln": 0}
    parts = edge_updates.split("_") if isinstance(edge_updates, str) else []
    allowed = {"gated", "gatedt", "norej", "norm", "mlp", "mlpa", "act",
               "linw", "linwa", "ln", "postln"}
    bad = [p for p in parts if p not in allowed]
    if bad:
        raise ValueError(
            f"Invalid edge update parts {bad}; allowed {sorted(allowed)}")
    for p, key, val in (("gated", "gated", "gated"),
                        ("gatedt", "gated", "gatedt"),
                        ("act", "gated", "act"), ("norej", "rej", False),
                        ("mlp", "mlp", True), ("mlpa", "mlpa", True),
                        ("linw", "lin_w", 1), ("linwa", "lin_w", 2),
                        ("ln", "lin_ln", 1), ("postln", "lin_ln", 2)):
        if p in parts:
            info[key] = val
    return info


@dataclasses.dataclass(frozen=True)
class GotenNetConfig:
    """Hyper-parameters; defaults follow the shipped reference config.

    ``fused`` defaults to True here (False in the JAX package): the fused
    message kernel is the only message path ported so far."""

    n_atom_basis: int = 256
    n_interactions: int = 4
    lmax: int = 2
    num_heads: int = 8
    n_rbf: int = 32
    cutoff: float = 5.0
    radial_basis: str = "expnorm"
    trainable_rbf: bool = False
    activation: str = "swish"
    max_z: int = 100
    epsilon: float = 1e-8
    weight_init: str = "xavier_uniform"
    bias_init: str = "zeros"
    layernorm: str = ""
    steerable_norm: str = ""
    attn_dropout: float = 0.0
    edge_updates: Union[bool, str] = True
    scale_edge: bool = False
    aggr: str = "add"
    evec_dim: Optional[int] = None
    emlp_dim: Optional[int] = None
    sep_htr: bool = True
    sep_dir: bool = True
    sep_tensor: bool = True
    edge_ln: str = ""
    max_num_neighbors: int = 32
    # storage type of the large per-pair tensors; reductions stay f32
    pair_dtype: torch.dtype = torch.float32
    # compute type of the per-layer node projections
    node_dtype: torch.dtype = torch.float32
    fused: bool = True
    # keep the inter-layer edge state t_ij in pair_dtype
    edge_state_pair_dtype: bool = False
    fused_htr: bool = False
    # ELL layout: the most node-table rows one fused kernel call takes;
    # larger tables need the chunked drivers, not ported yet
    fused_table_rows: int = 2048
    merge_proj: bool = True
    scan_layers: bool = False
    # position gradients through the fused message; None follows the
    # head (GotenModel resolves it from ``derivative``)
    pos_grads: Optional[bool] = None

    def __post_init__(self):
        if self.n_atom_basis % self.num_heads:
            raise ValueError(
                f"n_atom_basis={self.n_atom_basis} must be divisible by "
                f"num_heads={self.num_heads}")
        if self.lmax < 1:
            raise ValueError("lmax must be >= 1")
        if (self.n_atom_basis * self.multiplier) % self.num_heads:
            raise ValueError(
                "multiplier * n_atom_basis must be divisible by num_heads")
        if self.aggr not in ("add", "mean", "max"):
            raise ValueError(f"unknown aggr {self.aggr!r}")
        parse_edge_updates(self.edge_updates)
        for name in ("pair_dtype", "node_dtype"):
            if getattr(self, name) not in (torch.float32, torch.bfloat16):
                raise ValueError(f"{name} must be torch.float32 or "
                                 f"torch.bfloat16, got {getattr(self, name)}")
        if not self.fused:
            raise not_ported("fused=False (the unfused dense message)", 2)
        if not is_silu_like(self.activation):
            raise ValueError(
                "fused=True hardcodes silu in the message kernel; got "
                f"activation={self.activation!r}")
        if self.aggr != "add":
            raise not_ported(f"aggr={self.aggr!r}", 2)
        if self.layernorm:
            raise not_ported("layernorm", 3)
        if self.steerable_norm:
            raise not_ported("steerable_norm (TensorLayerNorm)", 3)
        if self.trainable_rbf:
            raise not_ported("trainable_rbf", 3)
        if self.edge_updates is not True:
            raise not_ported(f"edge_updates={self.edge_updates!r}", 5)
        if self.pos_grads:
            raise not_ported("pos_grads=True (position gradients through "
                             "the fused message)", 9)
        if self.scan_layers:
            raise not_ported("scan_layers (layer-stacked parameter trees)",
                             13)

    @property
    def sh_dim(self) -> int:
        return num_sh_components(self.lmax)

    @property
    def multiplier(self) -> int:
        m = 3
        if self.sep_dir:
            m += self.lmax - 1
        if self.sep_tensor:
            m += self.lmax - 1
        return m


class EQFF(nn.Module):
    """Equivariant feed-forward: context = [h ; ||X W_vu||], two-layer
    MLP, residual scalar and gated steerable updates."""

    def __init__(self, cfg: GotenNetConfig):
        super().__init__()
        act = get_activation(cfg.activation)
        D = cfg.n_atom_basis
        nd = None if cfg.node_dtype == torch.float32 else cfg.node_dtype
        kw = dict(weight_init=cfg.weight_init, bias_init=cfg.bias_init,
                  dtype=nd)
        self.epsilon = cfg.epsilon
        self.gamma_m = nn.ModuleList([
            Dense(2 * D, D, activation=act, **kw),
            Dense(D, 2 * D, **kw)])
        self.W_vu = Dense(D, D, use_bias=False, **kw)

    def forward(self, h: torch.Tensor, X: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        D = h.shape[-1]
        X_p = self.W_vu(X)
        # the norm reduction accumulates f32; X_p stays in node_dtype
        X_pn = torch.sqrt(torch.sum(X_p.float() ** 2, dim=-2) + self.epsilon)
        m = self.gamma_m[1](self.gamma_m[0](torch.cat([h, X_pn], dim=-1)))
        m1, m2 = m[..., :D], m[..., D:]
        return h + m1, X + m2[..., None, :].to(X.dtype) * X_p
