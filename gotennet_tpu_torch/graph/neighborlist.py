"""Radius graph of one molecule on the host, the spatial atom order, and
the collation of molecules into an edge-list batch, and a radius graph of a
padded node set on its tensors' device.

Counterpart of ``build_edges_np``, ``spatial_order``, ``collate_graphs`` and
``radius_graph_jax`` (here ``radius_graph``) in
``gotennet_tpu/graph/neighborlist.py`` (same arrays for the same input):
a cutoff-radius neighbourhood capped to the nearest ``max_num_neighbors``
sources, destination-sorted, with each node's self-loop appended last.
``build_edges_np`` is the plain all-pairs version, O(N^2); the loaders call
the native cell list of ``graph/native.py``, which gives the same arrays.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from gotennet_tpu_torch.graph.batch import GraphBatch
from gotennet_tpu_torch.utils import profiling

__all__ = ["build_edges_np", "spatial_order", "collate_graphs",
           "radius_graph"]


def spatial_order(pos: np.ndarray, cell: float) -> np.ndarray:
    """Permutation sorting atoms by spatial cell (lexicographic grid order,
    cells of side ``cell``, in-cell order by original index).  With atoms
    in this order every block of rows has its neighbour indices in a
    bounded window (``ELLBatch.gather_window``)."""
    p = np.asarray(pos, np.float64)
    c = np.floor((p - p.min(axis=0, keepdims=True)) / max(cell, 1e-6))
    c = c.astype(np.int64)
    return np.lexsort((np.arange(len(p)), c[:, 2], c[:, 1], c[:, 0]))


def build_edges_np(pos: np.ndarray, cutoff: float, loop: bool = True,
                   max_num_neighbors: int = 32
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``(src, dst)`` int32 edges of one molecule: ``dst`` is the centre
    whose neighbourhood the edge belongs to, dst-sorted; sources within
    ``cutoff`` (nearest ``max_num_neighbors`` when more, then in index
    order), and with ``loop`` the self-loop of every node last, outside
    the cap."""
    n = pos.shape[0]
    if n == 0:
        return (np.zeros(0, np.int32),) * 2
    diff = pos[None, :, :] - pos[:, None, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    within = dist < cutoff
    np.fill_diagonal(within, False)
    src_list: List[np.ndarray] = []
    dst_list: List[np.ndarray] = []
    for i in range(n):
        nbrs = np.nonzero(within[i])[0]
        if len(nbrs) > max_num_neighbors:
            order = np.argsort(dist[i, nbrs], kind="stable")
            nbrs = np.sort(nbrs[order[:max_num_neighbors]])
        if loop:
            nbrs = np.concatenate([nbrs, [i]])
        src_list.append(nbrs.astype(np.int32))
        dst_list.append(np.full(len(nbrs), i, np.int32))
    return np.concatenate(src_list), np.concatenate(dst_list)


@profiling.traced("loader.collate")
def collate_graphs(graphs: Sequence[dict], num_nodes: int, num_edges: int,
                   num_graphs: int, cutoff: float = 5.0, loop: bool = True,
                   max_num_neighbors: int = 32, y_dim: int = 1,
                   with_forces: bool = False) -> GraphBatch:
    """Pack molecules (dicts with ``z [M]``, ``pos [M, 3]`` and optionally
    ``y [T]`` and ``dy [M, 3]``) into one fixed-capacity ``GraphBatch``, each
    molecule's edges from the native cell list (``graph/native.py``), sorted
    by destination.  Raises ``ValueError`` when a capacity is exceeded (the
    loader grows its edge capacity on "edge capacity")."""
    from gotennet_tpu_torch.graph.native import build_edges

    if len(graphs) > num_graphs:
        raise ValueError(f"{len(graphs)} graphs > capacity {num_graphs}")
    z = np.zeros(num_nodes, np.int32)
    pos = np.zeros((num_nodes, 3), np.float32)
    node_graph = np.zeros(num_nodes, np.int32)
    node_mask = np.zeros(num_nodes, bool)
    src = np.zeros(num_edges, np.int32)
    dst = np.zeros(num_edges, np.int32)
    edge_mask = np.zeros(num_edges, bool)
    graph_mask = np.zeros(num_graphs, bool)
    y = np.zeros((num_graphs, y_dim), np.float32)
    dy = np.zeros((num_nodes, 3), np.float32) if with_forces else None
    n_off = e_off = 0
    for g_idx, g in enumerate(graphs):
        gz = np.asarray(g["z"], np.int32)
        gpos = np.asarray(g["pos"], np.float32)
        m = gz.shape[0]
        es, ed = build_edges(gpos, cutoff, loop, max_num_neighbors)
        ne = es.shape[0]
        if n_off + m > num_nodes:
            raise ValueError("node capacity exceeded")
        if e_off + ne > num_edges:
            raise ValueError("edge capacity exceeded")
        z[n_off:n_off + m] = gz
        pos[n_off:n_off + m] = gpos
        node_graph[n_off:n_off + m] = g_idx
        node_mask[n_off:n_off + m] = True
        src[e_off:e_off + ne] = es + n_off
        dst[e_off:e_off + ne] = ed + n_off
        edge_mask[e_off:e_off + ne] = True
        graph_mask[g_idx] = True
        if g.get("y") is not None:
            y[g_idx] = np.asarray(g["y"], np.float32).reshape(-1)[:y_dim]
        if with_forces and g.get("dy") is not None:
            dy[n_off:n_off + m] = np.asarray(g["dy"], np.float32)
        n_off += m
        e_off += ne
    t = torch.from_numpy
    return GraphBatch(z=t(z), pos=t(pos), node_graph=t(node_graph),
                      edge_src=t(src), edge_dst=t(dst), node_mask=t(node_mask),
                      edge_mask=t(edge_mask), graph_mask=t(graph_mask),
                      y=t(y), dy=None if dy is None else t(dy))


def radius_graph(pos: torch.Tensor, node_graph: torch.Tensor,
                 node_mask: torch.Tensor, cutoff: float, max_degree: int,
                 loop: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The radius graph of a padded node set (``pos [N, 3]``,
    ``node_graph [N]``, ``node_mask [N]``) on the tensors' device:
    ``(src, dst, mask)`` of exactly ``N * max_degree`` edge slots (``+ N``
    self-loops with ``loop``), destination-sorted.  Row ``i`` holds the
    nearest ``max_degree`` candidates within ``cutoff`` in the same graph,
    both ends real, ties in index order (a stable sort, as ``jnp.argsort``
    sorts); with ``loop`` each node's self-loop follows its block, masked
    as the node is; dead slots are masked self-loops.  O(N^2) distance
    work, for molecular N."""
    n = pos.shape[0]
    diff = pos[None, :, :] - pos[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)                          # [i, j]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    valid = ((node_graph[:, None] == node_graph[None, :])
             & (node_mask[:, None] & node_mask[None, :]) & ~eye
             & (d2 < cutoff ** 2))
    big = torch.tensor(1e30, dtype=d2.dtype, device=pos.device)
    masked = torch.where(valid, d2, big)
    order = torch.argsort(masked, dim=1, stable=True)[:, :max_degree]
    picked = torch.gather(masked, 1, order)
    idx = torch.arange(n, dtype=torch.int32, device=pos.device)
    src = order.to(torch.int32)
    dst = idx[:, None].expand(n, max_degree)
    mask = picked < big / 2
    if loop:
        src = torch.cat([src, idx[:, None]], dim=1)
        dst = torch.cat([dst, idx[:, None]], dim=1)
        mask = torch.cat([mask, node_mask[:, None]], dim=1)
    src, dst, mask = src.reshape(-1), dst.reshape(-1), mask.reshape(-1)
    return torch.where(mask, src, dst), dst, mask
