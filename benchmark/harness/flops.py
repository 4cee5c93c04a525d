"""The model's FLOP, the same whatever layout, padding or kernel runs it.

The forward counts 2 x the multiply-adds of every projection (every Dense
layer) of the published model over the real atoms and the real edges
(``harness.pairs``), nothing else: the attention's products, the sums and
the elementwise work are left out.  Per real edge: ``W_ndp`` and ``W_erp``
(R x D each), then in each interaction ``W_re`` (D x D) and ``W_rs``
(D x C), and ``gamma_t`` (D x D) in all but the last.  Per real atom:
``W_nrd_nru`` (2D x D + D x D); in each interaction ``gamma_s`` and
``gamma_v`` (D x D + D x C each), ``W_q`` and ``W_k`` (D x D each), in all
but the last ``W_vq`` and ``W_vk`` (L components of D x D each), and the
EQFF (2D x D, D x 2D, and ``W_vu`` over L components); the head (D x H_h +
H_h x 1).  C = multiplier x D, L the spherical components.

``MULTIPLIER`` turns one forward into a unit of work, derived once:
- ``forward`` (a request): 1.
- ``force`` (a request with forces): the forward, then the backward with
  respect to the positions, which takes one product per projection (the
  input's cotangent, no weight's): 2.
- ``train`` (a training step): the forward, then the backward's two
  products per projection (the input's and the weight's cotangents): 3.
- ``force_train`` (a step on a force loss): the forward (1) and the forces'
  backward kept for differentiation (1), then the backward through both:
  two products per projection of the forward (2) and two per product of the
  forces' backward (2): 6.
Recomputation (``remat``) is the program's choice and is not counted.
"""

from __future__ import annotations

import numpy as np

from reference.model import multiplier, sh_dim

MULTIPLIER = {"forward": 1, "force": 2, "train": 3, "force_train": 6}


def forward_flop(m: dict, atoms: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Forward FLOP of each molecule (float64 array)."""
    D, R, n = m["n_atom_basis"], m["n_rbf"], m["n_interactions"]
    C, L, Hh = multiplier(m) * D, sh_dim(m), m["head_hidden"]
    per_edge = 2 * R * D + n * (D * D + D * C) + (n - 1) * D * D
    per_atom = (3 * D * D + n * (2 * (D * D + D * C) + 2 * D * D)
                + (n - 1) * (2 * L * D * D)
                + n * (4 * D * D + L * D * D) + D * Hh + Hh)
    return 2.0 * (per_edge * np.asarray(edges, np.float64)
                  + per_atom * np.asarray(atoms, np.float64))
