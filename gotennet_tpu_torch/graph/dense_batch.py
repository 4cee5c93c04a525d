"""Dense per-graph batch layout: ``[num_graphs, max_atoms]`` blocks.

Counterpart of ``gotennet_tpu/graph/dense_batch.py`` (unpacked layout,
one molecule per slab).  Every pairwise quantity of the model lives in a
``[G, M, M, ...]`` block, so neighbourhood reductions are reductions
over the j axis.  Block-diagonal packing is not ported yet (ROADMAP.md
Queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["DenseBatch", "collate_dense"]


@dataclasses.dataclass
class DenseBatch:
    """Fixed-capacity dense molecule batch.

    Attributes:
        z: ``[G, M]`` int32 atomic numbers, 0 = padded atom slot.
        pos: ``[G, M, 3]`` float32 coordinates.
        mask: ``[G, M]`` bool real-atom mask.
        graph_mask: ``[G]`` bool real-graph mask.
        y: ``[G, T]`` float32 targets.
        dy: optional ``[G, M, 3]`` float32 force targets.
    """

    z: torch.Tensor
    pos: torch.Tensor
    mask: torch.Tensor
    graph_mask: torch.Tensor
    y: torch.Tensor
    dy: Optional[torch.Tensor] = None

    @property
    def num_graphs(self) -> int:
        return self.z.shape[0]

    @property
    def max_atoms(self) -> int:
        return self.z.shape[1]

    @property
    def node_mask(self) -> torch.Tensor:
        """``mask``, by the name the ELL batch gives it."""
        return self.mask

    def to(self, device) -> "DenseBatch":
        return DenseBatch(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})


def collate_dense(graphs: Sequence[dict], num_graphs: int, max_atoms: int,
                  y_dim: int = 1, with_forces: bool = False) -> DenseBatch:
    """Pack molecules (dicts with ``z``, ``pos`` and optionally ``y`` and,
    with ``with_forces``, ``dy``) into a dense batch on the host; capacity
    errors are loud."""
    if len(graphs) > num_graphs:
        raise ValueError(f"{len(graphs)} graphs > capacity {num_graphs}")
    z = np.zeros((num_graphs, max_atoms), np.int32)
    pos = np.zeros((num_graphs, max_atoms, 3), np.float32)
    mask = np.zeros((num_graphs, max_atoms), bool)
    gmask = np.zeros(num_graphs, bool)
    y = np.zeros((num_graphs, y_dim), np.float32)
    dy = (np.zeros((num_graphs, max_atoms, 3), np.float32) if with_forces
          else None)
    for g_idx, g in enumerate(graphs):
        gz = np.asarray(g["z"], np.int32)
        m = gz.shape[0]
        if m > max_atoms:
            raise ValueError(f"molecule with {m} atoms > capacity {max_atoms}")
        z[g_idx, :m] = gz
        pos[g_idx, :m] = np.asarray(g["pos"], np.float32)
        mask[g_idx, :m] = True
        gmask[g_idx] = True
        if g.get("y") is not None:
            y[g_idx] = np.asarray(g["y"], np.float32).reshape(-1)[:y_dim]
        if with_forces and g.get("dy") is not None:
            dy[g_idx, :m] = np.asarray(g["dy"], np.float32)
    return DenseBatch(
        z=torch.from_numpy(z), pos=torch.from_numpy(pos),
        mask=torch.from_numpy(mask), graph_mask=torch.from_numpy(gmask),
        y=torch.from_numpy(y),
        dy=torch.from_numpy(dy) if with_forces else None)
