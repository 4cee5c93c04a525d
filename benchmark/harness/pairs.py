"""Real atoms and edges of the benchmark's own molecules, counted on the
host from the molecules themselves (not from anything the program made).

An edge is a pair within the cutoff, each atom keeping its ``cap`` nearest
neighbours, plus one self-loop an atom, as an edge list counts them."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def real_edges(pos: np.ndarray, cutoff: float, cap: int) -> int:
    p = np.asarray(pos, np.float32)
    d2 = ((p[None, :, :] - p[:, None, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    within = (d2 < np.float32(cutoff) ** 2).sum(1)
    return int(np.minimum(within, cap).sum()) + len(p)


def count(pool: Sequence[tuple], cutoff: float, cap: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """``(atoms [n], edges [n])`` int64 of every molecule of ``pool``."""
    atoms = np.asarray([len(m[0]) for m in pool], np.int64)
    edges = np.asarray([real_edges(m[1], cutoff, cap) for m in pool],
                       np.int64)
    return atoms, edges
