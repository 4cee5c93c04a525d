"""Fixed-capacity edge-list batches of molecular graphs.

Counterpart of ``gotennet_tpu/graph/batch.py``: molecules are packed into
``num_nodes`` node slots, ``num_edges`` edge slots and ``num_graphs`` graph
slots; masks mark the real ones, and every reduction of the model masks
first, so padded slots add exact zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gotennet_tpu_torch.utils import profiling

__all__ = ["GraphBatch"]


@dataclasses.dataclass
class GraphBatch:
    """A fixed-capacity batch of molecular graphs (``N`` node, ``E`` edge
    and ``G`` graph slots).

    Attributes:
        z: ``[N]`` int32 atomic numbers; 0 marks a padded node.
        pos: ``[N, 3]`` float32 coordinates.
        node_graph: ``[N]`` int32 graph of each node (0 on padded nodes).
        edge_src: ``[E]`` int32 source node j (the neighbour).
        edge_dst: ``[E]`` int32 destination node i (the centre); edges are
            sorted by it.
        node_mask: ``[N]`` bool; edge_mask: ``[E]`` bool; graph_mask:
            ``[G]`` bool, true for real slots.
        y: ``[G, T]`` float32 graph targets (zeros when absent).
        dy: optional ``[N, 3]`` float32 force targets.
    """

    z: torch.Tensor
    pos: torch.Tensor
    node_graph: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_mask: torch.Tensor
    y: torch.Tensor
    dy: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.z.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_src.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def n_real_graphs(self) -> torch.Tensor:
        return torch.sum(self.graph_mask.to(torch.int32))

    @profiling.traced("batch.to_device", wait=True)
    def to(self, device) -> "GraphBatch":
        return GraphBatch(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})
