"""Traffic generators, frozen here so that a later change to the program
cannot change the benchmark's inputs.

``pair_potential`` and ``synthetic_trajectory`` are copied from
``gotennet_tpu_torch/data/dataset.py``; ``synthetic_molecules`` is copied
from there too, with one change: the molecule sizes are given
(``sizes``) instead of drawn one by one, so that every seed gets the same
set of sizes in another order and the work of a run does not depend on its
seed.  Molecules are ``(z [n] int32, pos [n, 3] float32, y float,
dy [n, 3] float32 or None)``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

TYPES = np.asarray([1, 6, 7, 8, 9])
PROBS = np.asarray([0.5, 0.3, 0.1, 0.08, 0.02])


def pair_potential(z: np.ndarray, pos: np.ndarray, forces: bool = False):
    """The synthetic target: ``0.01 * sum_{i != j} z_i z_j exp(-|r_ij|^2)``
    (float64 positions), and with ``forces`` its negative gradient
    ``[n, 3]`` float32 (else None)."""
    diff = pos[:, None] - pos[None, :]
    d2 = (diff ** 2).sum(-1)
    w = z[:, None] * z[None, :]
    np.fill_diagonal(d2, np.inf)
    e = float((w * np.exp(-d2)).sum()) * 0.01
    if not forces:
        return e, None
    k = w[..., None] * np.exp(-d2)[..., None] * (-2.0 * diff)
    g = 0.01 * 2.0 * np.nansum(
        np.where(np.isfinite(d2)[..., None], k, 0.0), axis=1)
    return e, (-g).astype(np.float32)


def balanced_sizes(n: int, min_atoms: int, max_atoms: int, seed) -> np.ndarray:
    """``n`` sizes spread evenly over ``min_atoms..max_atoms`` (the same
    multiset for every seed), in an order drawn from ``seed``."""
    span = max_atoms - min_atoms + 1
    sizes = min_atoms + np.arange(n) % span
    return np.random.default_rng([seed, 7]).permutation(sizes)


def synthetic_molecules(sizes: Sequence[int], seed, box: float = 4.0,
                        with_forces: bool = False) -> List[tuple]:
    """Random QM9-like molecules of the given sizes: organic atom types,
    positions spread so typical neighbour counts match a 5 A cutoff, and
    the smooth synthetic target ``pair_potential``."""
    rng = np.random.default_rng(seed)
    out = []
    for m in sizes:
        m = int(m)
        z = rng.choice(TYPES, size=m, p=PROBS).astype(np.int32)
        pos = (rng.random((m, 3)) - 0.5) * box * (m / 12.0) ** (1 / 3)
        e, f = pair_potential(z, pos, with_forces)
        out.append((z, pos.astype(np.float32), e, f))
    return out


def synthetic_trajectory(n_frames: int, n_atoms: int, seed,
                         box: float = 6.3, jitter: float = 0.1
                         ) -> List[tuple]:
    """Frames of one molecule, as an MD trajectory gives them: one draw of
    atom types and positions as ``synthetic_molecules`` makes them, then
    each frame moves every atom by a Gaussian step of ``jitter`` A; energies
    and forces from ``pair_potential``."""
    (z, base, _, _), = synthetic_molecules([n_atoms], seed, box=box)
    rng = np.random.default_rng([seed, 1])
    out = []
    for _ in range(n_frames):
        pos = base.astype(np.float64) + jitter * rng.standard_normal(
            (n_atoms, 3))
        e, f = pair_potential(z, pos, True)
        out.append((z, pos.astype(np.float32), e, f))
    return out


def make_pool(spec: dict, seed) -> List[tuple]:
    """The molecules a traffic file's ``pool`` asks for."""
    kind = spec["kind"]
    if kind == "molecules":
        sizes = balanced_sizes(spec["n"], spec["min_atoms"],
                               spec["max_atoms"], seed)
        return synthetic_molecules(sizes, seed, box=spec["box"],
                                   with_forces=spec.get("forces", False))
    if kind == "trajectory":
        return synthetic_trajectory(spec["n"], spec["n_atoms"], seed,
                                    box=spec["box"], jitter=spec["jitter"])
    raise ValueError(f"unknown pool kind {kind!r}")


def energy_stats(pool: Sequence[tuple]) -> tuple:
    """(mean, std with ddof 1) of the pool's energies: the head's
    standardisation where a configuration asks for it."""
    y = np.asarray([m[2] for m in pool], np.float64)
    return float(y.mean()), float(y.std(ddof=1))
