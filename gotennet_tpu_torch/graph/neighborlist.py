"""Radius graph of one molecule on the host, and the spatial atom order.

Counterpart of ``build_edges_np`` and ``spatial_order`` in
``gotennet_tpu/graph/neighborlist.py`` (same arrays for the same input):
a cutoff-radius neighbourhood capped to the nearest ``max_num_neighbors``
sources, destination-sorted, with each node's self-loop appended last.
``build_edges_np`` is the plain all-pairs version, O(N^2); the loaders call
the native cell list of ``graph/native.py``, which gives the same arrays.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["build_edges_np", "spatial_order"]


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
