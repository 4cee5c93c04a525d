"""Representation + output head (``gotennet_tpu/models/model.py``) on the
edge-list, dense and ELL layouts, with forces by autograd through the
positions.

``GotenModel`` returns ``{'property': [G, n_out], ...,
'representation': [N, D], 'vector_representation': [N, L, D]}`` like the
JAX model, with ``N = G*M`` node slots in the dense layout; the head
(Atomwise, Dipole or ElectronicSpatialExtent) sees that flat node set
(``graph.dense_batch.flatten_nodes``: a packed batch's graphs are its
``G*P`` molecule slots).
The three layouts share one state dict.
It is built on ``cuda`` unless ``device`` says otherwise, from a seeded
init or, through ``load_state_dict``, from weights converted by
``utils.convert.state_dict_from_jax_params``.  ``apply_with_forces`` adds
``forces = -dE/dpos`` for a head with ``derivative``, differentiable when
the caller trains on them.  On a graph split over the ranks of
``cfg.edge_axis`` the forces are averaged over that axis, as JAX's are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from gotennet_tpu_torch.graph.batch import GraphBatch
from gotennet_tpu_torch.graph.dense_batch import DenseBatch, flatten_nodes
from gotennet_tpu_torch.graph.ell_batch import ELLBatch
from gotennet_tpu_torch.models.gotennet import GotenNet, GotenNetConfig
from gotennet_tpu_torch.models.gotennet_dense import GotenNetDense
from gotennet_tpu_torch.models.gotennet_ell import GotenNetELL
from gotennet_tpu_torch.models.heads import (Atomwise, Dipole,
                                            ElectronicSpatialExtent)
from gotennet_tpu_torch.nn.dense import Dense
from gotennet_tpu_torch.utils import profiling
from gotennet_tpu_torch.utils.device import resolve_device

__all__ = ["HeadConfig", "GotenModel", "init_parameters_",
           "apply_with_forces", "set_edge_axis"]


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


_LAYOUTS = {"edge": GotenNet, "dense": GotenNetDense, "ell": GotenNetELL}


class GotenModel(nn.Module):
    """GotenNet representation + one output head; ``layout`` is "edge"
    (``GraphBatch``), "dense" (``DenseBatch``) or "ell" (``ELLBatch``).
    ``dropout_generator`` (on the model's device, seeded with ``seed``)
    draws the attention keep masks in training."""

    def __init__(self, cfg: GotenNetConfig, head: HeadConfig,
                 layout: str = "dense", *, seed: int = 0,
                 device: Optional[str | torch.device] = None):
        super().__init__()
        if layout not in _LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; choose edge, dense "
                             "or ell")
        device = resolve_device(device)
        # pos_grads=None follows the head: only force heads differentiate
        # positions (the JAX package resolves it the same way)
        if cfg.pos_grads is None:
            cfg = dataclasses.replace(cfg, pos_grads=head.derivative)
        self.cfg = cfg
        self.head = head
        self.layout = layout
        self.representation = _LAYOUTS[layout](cfg)
        self.output_modules = nn.ModuleList([_build_head(cfg.n_atom_basis,
                                                         head)])
        init_parameters_(self, torch.Generator().manual_seed(seed))
        self.to(device)
        # attention dropout's keep masks (training with attn_dropout > 0);
        # the Trainer reseeds it and keeps its state in checkpoints
        self.dropout_generator = torch.Generator(device=device)
        self.dropout_generator.manual_seed(seed)
        # serving mode after construction; training code calls .train()
        self.eval()

    @profiling.traced("model.forward")
    def forward(self, batch: GraphBatch | DenseBatch | ELLBatch
                ) -> Dict[str, torch.Tensor]:
        h, X = self.representation(batch, self.dropout_generator)
        with profiling.span("model.head"):
            if self.layout == "dense":
                # the flat [G*M] node set; a packed batch's graph axis is
                # its [G*P] molecule slots
                G, M = h.shape[:2]
                h = h.reshape(G * M, -1)
                X = X.reshape(G * M, X.shape[2], X.shape[3])
                batch = flatten_nodes(batch)
            out = self.output_modules[0](batch.z, batch.pos, h, X,
                                         batch.node_mask, batch.node_graph,
                                         batch.num_graphs)
        out["representation"] = h
        out["vector_representation"] = X
        return out


def _build_head(n_in: int, head: HeadConfig) -> nn.Module:
    if head.kind == "atomwise":
        return Atomwise(n_in=n_in, n_out=head.n_out, n_layers=head.n_layers,
                        n_hidden=head.n_hidden, activation=head.activation,
                        aggregation=head.aggregation, mean=head.mean,
                        stddev=head.stddev, atomref=head.atomref)
    if head.kind == "dipole":
        return Dipole(n_in=n_in, n_hidden=head.n_hidden,
                      activation=head.activation,
                      predict_magnitude=head.predict_magnitude,
                      mean=head.mean, stddev=head.stddev)
    if head.kind == "electronic_spatial_extent":
        return ElectronicSpatialExtent(n_in=n_in, n_layers=head.n_layers,
                                       n_hidden=head.n_hidden,
                                       activation=head.activation)
    raise ValueError(f"unknown head kind {head.kind!r}")


def apply_with_forces(model: GotenModel,
                      batch: GraphBatch | DenseBatch | ELLBatch,
                      create_graph: Optional[bool] = None
                      ) -> Dict[str, torch.Tensor]:
    """Run the model and, when the head asks for derivatives, add
    ``forces = -dE/dpos`` (the sign flipped unless ``negative_dr`` is
    False), the gradient of ``property.sum()`` with respect to
    ``batch.pos`` alone, zero on padded atoms: ``[G, M, 3]`` on the dense
    layout, ``[N, 3]`` on the edge and ELL ones, as the JAX package's
    ``apply_with_forces``.  With ``create_graph`` the forces keep their
    graph, so a loss of them can be differentiated (training on forces);
    None means so in training (``model.training``, gradients enabled and a
    parameter that requires one).  Serving and evaluation take the forces
    without one, so a request's memory does not grow."""
    if not model.head.derivative:
        return model(batch)
    if create_graph is None:
        create_graph = (model.training and torch.is_grad_enabled()
                        and any(p.requires_grad for p in model.parameters()))
    pos = batch.pos.detach().requires_grad_(True)
    with torch.enable_grad():
        out = model(dataclasses.replace(batch, pos=pos))
        dy, = torch.autograd.grad(out["property"].sum(), pos,
                                  create_graph=create_graph)
    if model.cfg.edge_axis is not None:
        # a split graph: each rank's dE/dpos holds its own pairs' terms,
        # times the rank count through the all-reduces' backward; the mean
        # over the axis is the whole graph's
        from gotennet_tpu_torch.parallel.collectives import pmean
        dy = pmean(dy, model.cfg.edge_axis)
    sign = -1.0 if model.head.negative_dr else 1.0
    out["forces"] = sign * dy * batch.node_mask[..., None].to(dy.dtype)
    return out


def set_edge_axis(model: GotenModel, axis: Optional[str]) -> GotenModel:
    """Give ``model`` and every layer of it ``cfg.edge_axis = axis`` (in
    place): the mesh axis whose ranks split its graphs (the edge list, or
    the ELL destination rows), None for one device.  The parameters stay
    as they are, as the JAX package's serial and sharded variants of one
    model share one parameter tree."""
    for m in model.modules():
        cfg = getattr(m, "cfg", None)
        if isinstance(cfg, GotenNetConfig):
            m.cfg = dataclasses.replace(cfg, edge_axis=axis)
    return model
