"""ELL (padded-neighbour) batches: a row of ``K`` neighbour slots per node.

Counterpart of ``gotennet_tpu/graph/ell_batch.py``.  Nodes of all the
batch's molecules are concatenated; node ``r``'s incident edges (``r`` is
the destination) fill the first slots of row ``r`` of ``nbr``, in the
edge builder's order, the self-loop last.  The softmax over a node's
neighbours is a masked softmax over its K slots, and every aggregation a
sum over them.  Padded slots and padded rows point at their own row, so a
gather never leaves the table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gotennet_tpu_torch.graph.native import build_edges
from gotennet_tpu_torch.graph.neighborlist import spatial_order
from gotennet_tpu_torch.utils import profiling

__all__ = ["ELLBatch", "collate_ell", "frame_graph", "ell_from_graph_batch"]

# (perm, src, dst): a frame's atom order and the edges of the reordered frame
FrameGraph = Tuple[np.ndarray, np.ndarray, np.ndarray]

_STATIC = ("gather_window", "block_rows", "gather_halo")


@dataclasses.dataclass
class ELLBatch:
    """Fixed-capacity batch of ``N`` node rows of ``K`` slots, ``G`` graphs.

    Attributes:
        z: ``[N]`` int32 atomic numbers, 0 = padded node.
        pos: ``[N, 3]`` float32 coordinates.
        node_graph: ``[N]`` int32 graph of each node.
        nbr: ``[N, K]`` int32 source node of each slot.
        nbr_mask: ``[N, K]`` bool, true for real edges.
        node_mask: ``[N]`` bool; graph_mask: ``[G]`` bool.
        y: ``[G, T]`` float32 targets.
        atom: ``[N]`` int32, each row's atom index within its molecule as
            the caller gave it (the spatial sort permutes rows); 0 on
            padded rows.
        dy: optional ``[N, 3]`` float32 force targets, permuted with the
            rows.
        gather_window, block_rows: with spatially sorted atoms, the
            neighbour indices of every ``block_rows``-row block lie in a
            window of ``gather_window`` rows; the model then rounds
            gathered node features to the pair type, as the JAX package's
            windowed one-hot gathers do.  None: plain gathers.
        gather_halo: how far any block's neighbour indices stray outside
            its own rows (the window bound of the chunked drivers).
    """

    z: torch.Tensor
    pos: torch.Tensor
    node_graph: torch.Tensor
    nbr: torch.Tensor
    nbr_mask: torch.Tensor
    node_mask: torch.Tensor
    graph_mask: torch.Tensor
    y: torch.Tensor
    atom: torch.Tensor
    dy: Optional[torch.Tensor] = None
    gather_window: Optional[int] = None
    block_rows: Optional[int] = None
    gather_halo: Optional[int] = None

    @property
    def num_nodes(self) -> int:
        return self.z.shape[0]

    @property
    def max_neighbors(self) -> int:
        return self.nbr.shape[1]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    @profiling.traced("batch.to_device", wait=True)
    def to(self, device) -> "ELLBatch":
        return ELLBatch(**{
            f.name: (getattr(self, f.name)
                     if f.name in _STATIC or getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})


@profiling.traced("graph.neighbors")
def frame_graph(pos: np.ndarray, cutoff: float, max_num_neighbors: int,
                spatial_sort: bool) -> FrameGraph:
    """One frame's atom order (its spatial order with ``spatial_sort``, else
    the order given) and the radius graph of the reordered frame,
    self-loops included (``graph.native.build_edges``)."""
    pos = np.asarray(pos, np.float32)
    perm = (spatial_order(pos, cutoff) if spatial_sort
            else np.arange(pos.shape[0]))
    return (perm,) + build_edges(pos[perm], cutoff, True, max_num_neighbors)


@profiling.traced("loader.collate")
def collate_ell(graphs: Sequence[dict], num_nodes: int, max_neighbors: int,
                num_graphs: int, cutoff: float = 5.0,
                max_num_neighbors: int = 32, y_dim: int = 1,
                block_rows: Optional[int] = None,
                spatial_sort: bool = False,
                with_forces: bool = False,
                frames: Optional[Sequence[FrameGraph]] = None) -> ELLBatch:
    """Pack molecules (dicts with ``z``, ``pos`` and optionally ``y`` and,
    with ``with_forces``, ``dy``) into one ``ELLBatch`` on the host,
    self-loops included.  With ``spatial_sort`` each molecule's atoms (and
    forces) are put in cell order first, and ``atom`` keeps each row's
    place in the molecule as given; with ``block_rows`` the window fields
    are measured on the batch.  ``frames`` gives each molecule's
    ``frame_graph`` when the caller has built it already (the loader's
    degree probe); by default it is built here.
    Raises on a node degree above ``max_neighbors`` ("neighbor capacity")
    and on other overflows."""
    if len(graphs) > num_graphs:
        raise ValueError(f"{len(graphs)} graphs > capacity {num_graphs}")
    z = np.zeros(num_nodes, np.int32)
    pos = np.zeros((num_nodes, 3), np.float32)
    node_graph = np.zeros(num_nodes, np.int32)
    node_mask = np.zeros(num_nodes, bool)
    nbr = np.tile(np.arange(num_nodes, dtype=np.int32)[:, None],
                  (1, max_neighbors))
    nbr_mask = np.zeros((num_nodes, max_neighbors), bool)
    graph_mask = np.zeros(num_graphs, bool)
    y = np.zeros((num_graphs, y_dim), np.float32)
    atom = np.zeros(num_nodes, np.int32)
    dy = np.zeros((num_nodes, 3), np.float32) if with_forces else None

    n_off = 0
    for g_idx, g in enumerate(graphs):
        gpos = np.asarray(g["pos"], np.float32)
        perm, src, dst = (frames[g_idx] if frames is not None else
                          frame_graph(gpos, cutoff, max_num_neighbors,
                                      spatial_sort))
        gz, gpos = np.asarray(g["z"], np.int32)[perm], gpos[perm]
        m = gz.shape[0]
        if n_off + m > num_nodes:
            raise ValueError("node capacity exceeded")
        counts = np.bincount(dst, minlength=m)
        if counts.max(initial=0) > max_neighbors:
            raise ValueError(f"node degree {counts.max()} exceeds neighbor "
                             f"capacity {max_neighbors}")
        # dst-sorted edges: a slot is the running offset within its row
        slot = np.arange(len(dst)) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        nbr[n_off + dst, slot] = src + n_off
        nbr_mask[n_off + dst, slot] = True
        z[n_off:n_off + m] = gz
        pos[n_off:n_off + m] = gpos
        node_graph[n_off:n_off + m] = g_idx
        node_mask[n_off:n_off + m] = True
        atom[n_off:n_off + m] = perm
        graph_mask[g_idx] = True
        if g.get("y") is not None:
            y[g_idx] = np.asarray(g["y"], np.float32).reshape(-1)[:y_dim]
        if with_forces and g.get("dy") is not None:
            dy[n_off:n_off + m] = np.asarray(g["dy"], np.float32)[perm]
        n_off += m
    if profiling.active():
        # the table's slots and the real edges in them, self-loops included
        profiling.count("pairs.ell_slot", num_nodes * max_neighbors)
        profiling.count("pairs.ell_edge", int(nbr_mask.sum()))

    gather_window = gather_halo = None
    if block_rows:
        if num_nodes % block_rows:
            raise ValueError(f"num_nodes ({num_nodes}) must be a multiple of "
                             f"block_rows ({block_rows}) for windowed "
                             "gathers")
        nb = nbr.reshape(num_nodes // block_rows, -1)
        width = int((nb.max(axis=1) - nb.min(axis=1) + 1).max())
        gather_window = min(num_nodes, -(-width // 128) * 128)
        rows = np.arange(num_nodes).reshape(-1, block_rows)
        gather_halo = int(max(0, (rows[:, 0] - nb.min(axis=1)).max(initial=0),
                              (nb.max(axis=1) - rows[:, -1]).max(initial=0)))
    return ELLBatch(
        z=torch.from_numpy(z), pos=torch.from_numpy(pos),
        node_graph=torch.from_numpy(node_graph), nbr=torch.from_numpy(nbr),
        nbr_mask=torch.from_numpy(nbr_mask),
        node_mask=torch.from_numpy(node_mask),
        graph_mask=torch.from_numpy(graph_mask), y=torch.from_numpy(y),
        atom=torch.from_numpy(atom),
        dy=torch.from_numpy(dy) if with_forces else None,
        gather_window=gather_window,
        block_rows=block_rows if gather_window else None,
        gather_halo=gather_halo)


def ell_from_graph_batch(batch, max_neighbors: int) -> ELLBatch:
    """A ``GraphBatch`` (destination-sorted edge list) as ELL rows on the
    host, its real edges in edge-list order filling each row's first slots;
    ``atom`` counts each real node's place in its molecule.  For tests and
    layout comparisons."""
    src = batch.edge_src.cpu().numpy()
    dst = batch.edge_dst.cpu().numpy()
    em = batch.edge_mask.cpu().numpy()
    n = batch.num_nodes
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, max_neighbors))
    nbr_mask = np.zeros((n, max_neighbors), bool)
    fill = np.zeros(n, np.int32)
    for s, d in zip(src[em], dst[em]):
        nbr[d, fill[d]] = s
        nbr_mask[d, fill[d]] = True
        fill[d] += 1
    graph = batch.node_graph.cpu().numpy()
    real = batch.node_mask.cpu().numpy()
    first = {}
    atom = np.zeros(n, np.int32)
    for i in np.nonzero(real)[0]:
        atom[i] = i - first.setdefault(int(graph[i]), i)
    device = batch.z.device
    return ELLBatch(
        z=batch.z, pos=batch.pos, node_graph=batch.node_graph,
        nbr=torch.from_numpy(nbr).to(device),
        nbr_mask=torch.from_numpy(nbr_mask).to(device),
        node_mask=batch.node_mask, graph_mask=batch.graph_mask, y=batch.y,
        atom=torch.from_numpy(atom).to(device), dy=batch.dy)
