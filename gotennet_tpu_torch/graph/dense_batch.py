"""Dense per-graph batch layout: ``[num_graphs, max_atoms]`` blocks.

Counterpart of ``gotennet_tpu/graph/dense_batch.py``.  Every pairwise
quantity of the model lives in a ``[G, M, M, ...]`` block, so neighbourhood
reductions are reductions over the j axis.  Two layouts share the
container: one molecule per slab, or several packed block-diagonally into
each slab (``collate_dense_packed``, first-fit decreasing), the model
masking the pairs of different molecules by ``seg``.  ``flatten_nodes``
views either as a flat node set for the output heads.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from gotennet_tpu_torch.graph.batch import GraphBatch
from gotennet_tpu_torch.utils import profiling

__all__ = ["DenseBatch", "collate_dense", "collate_dense_packed",
           "pack_molecules", "flatten_nodes"]


@dataclasses.dataclass
class DenseBatch:
    """Fixed-capacity dense molecule batch.

    Unpacked (``seg`` None): one molecule a slab, ``y [G, T]`` and
    ``graph_mask [G]``.  Packed (``seg`` set): up to ``P`` molecules a slab,
    ``seg [G, M]`` each atom slot's molecule within its slab (0 on padded
    slots), ``y [G, P, T]`` and ``graph_mask [G, P]`` one molecule slot per
    (slab, local) pair.

    Attributes:
        z: ``[G, M]`` int32 atomic numbers, 0 = padded atom slot.
        pos: ``[G, M, 3]`` float32 coordinates.
        mask: ``[G, M]`` bool real-atom mask.
        graph_mask: ``[G]`` (``[G, P]`` packed) bool real-graph mask.
        y: ``[G, T]`` (``[G, P, T]`` packed) float32 targets.
        dy: optional ``[G, M, 3]`` float32 force targets.
        seg: optional ``[G, M]`` int32 molecule of each slot (packed).
    """

    z: torch.Tensor
    pos: torch.Tensor
    mask: torch.Tensor
    graph_mask: torch.Tensor
    y: torch.Tensor
    dy: Optional[torch.Tensor] = None
    seg: Optional[torch.Tensor] = None

    @property
    def num_graphs(self) -> int:
        return self.z.shape[0]

    @property
    def max_atoms(self) -> int:
        return self.z.shape[1]

    @property
    def mols_per_slab(self) -> int:
        """Molecule slots a slab (1 unless packed)."""
        return 1 if self.seg is None else self.graph_mask.shape[1]

    @property
    def node_mask(self) -> torch.Tensor:
        """``mask``, by the name the ELL batch gives it."""
        return self.mask

    @profiling.traced("batch.to_device", wait=True)
    def to(self, device) -> "DenseBatch":
        return DenseBatch(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})


def _count_pairs(sizes, num_slabs: int, max_atoms: int) -> None:
    """The tracer's pair counters of one collated batch: its padded pairs
    (every slab's ``M^2``) and its molecules' atom pairs, ``n (n - 1)``
    each."""
    if profiling.active():
        profiling.count("pairs.padded", num_slabs * max_atoms * max_atoms)
        profiling.count("pairs.atom", sum(m * (m - 1) for m in sizes))


@profiling.traced("loader.collate")
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
    _count_pairs((len(g["z"]) for g in graphs), num_graphs, max_atoms)
    return DenseBatch(
        z=torch.from_numpy(z), pos=torch.from_numpy(pos),
        mask=torch.from_numpy(mask), graph_mask=torch.from_numpy(gmask),
        y=torch.from_numpy(y),
        dy=torch.from_numpy(dy) if with_forces else None)


def pack_molecules(sizes: Sequence[int], max_atoms: int,
                   mols_per_slab: int) -> List[List[int]]:
    """First-fit-decreasing packing of molecules of ``sizes`` atoms into
    slabs of ``max_atoms`` slots, at most ``mols_per_slab`` a slab: the
    molecule indices of each slab.  Largest first, ties by index, so the
    assignment is the JAX package's."""
    order = sorted(range(len(sizes)), key=lambda i: (-int(sizes[i]), i))
    slabs: List[List[int]] = []
    free: List[int] = []
    for i in order:
        m = int(sizes[i])
        if m > max_atoms:
            raise ValueError(
                f"molecule with {m} atoms > slab capacity {max_atoms}")
        for s, f in enumerate(free):
            if f >= m and len(slabs[s]) < mols_per_slab:
                slabs[s].append(i)
                free[s] -= m
                break
        else:
            slabs.append([i])
            free.append(max_atoms - m)
    return slabs


@profiling.traced("loader.collate")
def collate_dense_packed(graphs: Sequence[dict], num_slabs: int,
                         max_atoms: int, mols_per_slab: int,
                         y_dim: int = 1, with_forces: bool = False
                         ) -> DenseBatch:
    """Pack molecules block-diagonally into ``num_slabs`` slabs of
    ``max_atoms`` slots (``pack_molecules``), each
    molecule's atoms contiguous from the slab's first free slot.  Raises
    ``ValueError('slab capacity ...')`` when the packing needs more than
    ``num_slabs`` slabs (the loader grows it on that)."""
    sizes = [len(np.asarray(g["z"])) for g in graphs]
    slabs = pack_molecules(sizes, max_atoms, mols_per_slab)
    if len(slabs) > num_slabs:
        raise ValueError(
            f"slab capacity {num_slabs} exceeded: packing {len(graphs)} "
            f"molecules needs {len(slabs)} slabs of {max_atoms}")
    z = np.zeros((num_slabs, max_atoms), np.int32)
    pos = np.zeros((num_slabs, max_atoms, 3), np.float32)
    mask = np.zeros((num_slabs, max_atoms), bool)
    seg = np.zeros((num_slabs, max_atoms), np.int32)
    gmask = np.zeros((num_slabs, mols_per_slab), bool)
    y = np.zeros((num_slabs, mols_per_slab, y_dim), np.float32)
    dy = (np.zeros((num_slabs, max_atoms, 3), np.float32) if with_forces
          else None)
    for s, members in enumerate(slabs):
        off = 0
        for local, i in enumerate(members):
            g, m = graphs[i], sizes[i]
            sl = slice(off, off + m)
            z[s, sl] = np.asarray(g["z"], np.int32)
            pos[s, sl] = np.asarray(g["pos"], np.float32)
            mask[s, sl] = True
            seg[s, sl] = local
            gmask[s, local] = True
            if g.get("y") is not None:
                y[s, local] = np.asarray(g["y"], np.float32).reshape(-1)[:y_dim]
            if with_forces and g.get("dy") is not None:
                dy[s, sl] = np.asarray(g["dy"], np.float32)
            off += m
    _count_pairs(sizes, num_slabs, max_atoms)
    return DenseBatch(
        z=torch.from_numpy(z), pos=torch.from_numpy(pos),
        mask=torch.from_numpy(mask), graph_mask=torch.from_numpy(gmask),
        y=torch.from_numpy(y),
        dy=torch.from_numpy(dy) if with_forces else None,
        seg=torch.from_numpy(seg))


def flatten_nodes(batch: DenseBatch) -> GraphBatch:
    """The dense batch as a flat node set (no edges), for the output heads
    and graph reductions: ``[G * M]`` nodes, and a packed batch's
    (slab, local) molecule slots as a ``[G * P]`` graph axis,
    ``node_graph = slab * P + seg``."""
    g, m = batch.z.shape
    dev = batch.z.device
    if batch.seg is None:
        node_graph = torch.arange(g, device=dev).repeat_interleave(m)
        y, gmask = batch.y, batch.graph_mask
    else:
        p = batch.graph_mask.shape[1]
        node_graph = (torch.arange(g, device=dev)[:, None] * p
                      + batch.seg.long()).reshape(-1)
        y = batch.y.reshape(g * p, -1)
        gmask = batch.graph_mask.reshape(-1)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    return GraphBatch(
        z=batch.z.reshape(-1), pos=batch.pos.reshape(-1, 3),
        node_graph=node_graph.to(torch.int32), edge_src=empty,
        edge_dst=empty, node_mask=batch.mask.reshape(-1),
        edge_mask=torch.zeros(0, dtype=torch.bool, device=dev),
        graph_mask=gmask, y=y,
        dy=batch.dy.reshape(-1, 3) if batch.dy is not None else None)
