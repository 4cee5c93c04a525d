"""Representation + output head (``gotennet_tpu/models/model.py``),
dense layout.

``GotenModel`` returns ``{'property': [G, n_out], 'contributions',
'representation': [G*M, D], 'vector_representation': [G*M, L, D]}``
like the JAX model.  It is built on ``cuda`` unless ``device`` says
otherwise, from a seeded init or, through ``load_state_dict``, from
weights converted by ``utils.convert.state_dict_from_jax_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from gotennet_tpu_torch.graph.dense_batch import DenseBatch
from gotennet_tpu_torch.models.gotennet import GotenNetConfig, not_ported
from gotennet_tpu_torch.models.gotennet_dense import GotenNetDense
from gotennet_tpu_torch.models.heads import Atomwise
from gotennet_tpu_torch.nn.dense import Dense
from gotennet_tpu_torch.utils.device import resolve_device

__all__ = ["HeadConfig", "GotenModel", "init_parameters_"]


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Output-head selection and standardisation metadata (same fields
    as the JAX package's)."""

    kind: str = "atomwise"
    n_out: int = 1
    n_hidden: Optional[int] = None
    n_layers: int = 2
    activation: Any = "silu"
    mean: float = 0.0
    stddev: float = 1.0
    atomref: Optional[np.ndarray] = None
    aggregation: Optional[str] = "sum"
    derivative: bool = False
    negative_dr: bool = True
    predict_magnitude: bool = True

    def __hash__(self):  # the atomref array is identity-hashed
        return hash((self.kind, self.n_out, self.n_hidden, self.n_layers,
                     str(self.activation), self.mean, self.stddev,
                     id(self.atomref), self.aggregation, self.derivative,
                     self.negative_dr, self.predict_magnitude))


def init_parameters_(module: nn.Module, generator: torch.Generator,
                     embed_std: float = 1.0) -> None:
    """Seeded init on the CPU: every Dense by its registry names,
    embeddings N(0, 1); ``A_na`` row 0 is zero (padding index)."""
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Embedding) and m.weight.requires_grad:
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * embed_std)
                if name.endswith("A_na"):
                    m.weight[0].zero_()


class GotenModel(nn.Module):
    """GotenNet representation + one output head, dense layout."""

    def __init__(self, cfg: GotenNetConfig, head: HeadConfig,
                 layout: str = "dense", *, seed: int = 0,
                 device: Optional[str | torch.device] = None):
        super().__init__()
        if layout != "dense":
            raise not_ported(f"layout={layout!r}",
                             10 if layout == "edge" else 11)
        if head.kind != "atomwise":
            raise not_ported(f"head kind {head.kind!r}", 6)
        if head.derivative:
            raise not_ported("forces (derivative=True)", 9)
        if head.aggregation != "sum":
            raise ValueError(f"aggregation {head.aggregation!r}: the port's "
                             "Atomwise head sums per graph")
        device = resolve_device(device)
        # pos_grads=None follows the head: only force heads differentiate
        # positions (the JAX package resolves it the same way)
        if cfg.pos_grads is None:
            cfg = dataclasses.replace(cfg, pos_grads=head.derivative)
        self.cfg = cfg
        self.head = head
        self.representation = GotenNetDense(cfg)
        self.output_modules = nn.ModuleList([Atomwise(
            n_in=cfg.n_atom_basis, n_out=head.n_out, n_layers=head.n_layers,
            n_hidden=head.n_hidden, activation=head.activation,
            mean=head.mean, stddev=head.stddev, atomref=head.atomref)])
        init_parameters_(self, torch.Generator().manual_seed(seed))
        self.to(device)
        # serving mode after construction; training code calls .train()
        self.eval()

    def forward(self, batch: DenseBatch) -> Dict[str, torch.Tensor]:
        h, X = self.representation(batch)
        G, M = h.shape[:2]
        h = h.reshape(G * M, -1)
        X = X.reshape(G * M, X.shape[2], X.shape[3])
        out = self.output_modules[0](batch.z.reshape(-1), h,
                                     batch.mask.reshape(-1), G)
        out["representation"] = h
        out["vector_representation"] = X
        return out
