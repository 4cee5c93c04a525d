"""Molecule3D: ground-state geometries and their properties
(``gotennet_tpu/data/molecule3d.py``).

Molecule3D ships some 3.9 million PubChemQC molecules as SDF files and a
CSV of properties.  Two layouts load: the raw SDF files (with
``properties.csv``, whose rows follow the molecules in file order), for
subsets and trials, and a directory of fixed-size NPZ shards
(``save_shards``), from which each rank of a multi-process run reads only
its own contiguous range of shards (``shard_range_for_host``).  Nothing is
downloaded: ``root`` points at a local copy.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional

import numpy as np

from gotennet_tpu_torch.data.dataset import MoleculeDataset
from gotennet_tpu_torch.data.qm9 import (_load_processed, _parse_sdf_coords,
                                         save_processed_qm9)

__all__ = ["load_molecule3d", "load_molecule3d_sdf", "save_shards",
           "iter_shards", "shard_range_for_host", "is_shard_dir"]


def is_shard_dir(root: str) -> bool:
    """Whether ``root`` holds NPZ shards (``shard_*.npz``, as
    ``save_shards`` writes them)."""
    return bool(glob.glob(os.path.join(root, "shard_*.npz")))


def _read_column(csv: str, label: Optional[str], n: int) -> np.ndarray:
    """The first ``n`` rows of ``label``'s column of ``csv`` (the second
    column when ``label`` is None), as ``[n, 1]`` float32."""
    with open(csv) as f:
        header = f.readline().strip().split(",")
        col = header.index(label) if label else 1
        vals = [[float(f.readline().strip().split(",")[col])]
                for _ in range(n)]
    return np.asarray(vals, np.float32)


def load_molecule3d(root: str, label: Optional[str] = None,
                    max_molecules: Optional[int] = None,
                    host: int = 0, n_hosts: int = 1) -> MoleculeDataset:
    """Molecule3D from ``root``, the command line's reader: the NPZ shards
    of ``host``'s range when ``root`` holds shards, else every ``*.sdf``
    in name order with ``label``'s column of ``properties.csv`` (no
    targets without that file); at most ``max_molecules``."""
    if is_shard_dir(root):
        zs: List[np.ndarray] = []
        poss: List[np.ndarray] = []
        ys: List[np.ndarray] = []
        for part in iter_shards(root, host, n_hosts):
            zs.extend(part.z)
            poss.extend(part.pos)
            if part.y is not None:
                ys.append(np.asarray(part.y))
            if max_molecules is not None and len(zs) >= max_molecules:
                break
        y = np.concatenate(ys)[:len(zs)] if ys else None
        if max_molecules is not None:
            zs, poss = zs[:max_molecules], poss[:max_molecules]
            y = y[:max_molecules] if y is not None else None
        return MoleculeDataset(z=zs, pos=poss, y=y)

    sdfs = sorted(glob.glob(os.path.join(root, "*.sdf")))
    if not sdfs:
        raise FileNotFoundError(
            f"no Molecule3D data under {root!r}: expected shard_*.npz "
            f"or *.sdf (+ properties.csv)")
    zs, poss = [], []
    for p in sdfs:
        remaining = (None if max_molecules is None
                     else max_molecules - len(zs))
        if remaining is not None and remaining <= 0:
            break
        part = load_molecule3d_sdf(p, max_molecules=remaining)
        zs.extend(part.z)
        poss.extend(part.pos)
    csv = os.path.join(root, "properties.csv")
    y = _read_column(csv, label, len(zs)) if os.path.exists(csv) else None
    return MoleculeDataset(z=zs, pos=poss, y=y)


def load_molecule3d_sdf(sdf_path: str, properties_csv: Optional[str] = None,
                        target_col: Optional[str] = None,
                        max_molecules: Optional[int] = None
                        ) -> MoleculeDataset:
    """One SDF file (molecules with an unknown element are left out), with
    ``target_col`` of ``properties_csv`` as targets when that file
    exists."""
    with open(sdf_path) as f:
        lines = f.read().split("\n")
    zs, poss = [], []
    i = 0
    while i < len(lines) - 4:
        z, pos, i = _parse_sdf_coords(lines, i)
        if z is None:
            continue
        if (z > 0).all():
            zs.append(z)
            poss.append(pos)
        if max_molecules is not None and len(zs) >= max_molecules:
            break
    y = None
    if properties_csv is not None and os.path.exists(properties_csv):
        y = _read_column(properties_csv, target_col, len(zs))
    return MoleculeDataset(z=zs, pos=poss, y=y)


def save_shards(ds: MoleculeDataset, out_dir: str,
                shard_size: int = 50_000) -> List[str]:
    """Write ``ds`` as NPZ shards of ``shard_size`` molecules
    (``shard_00000.npz``, ...); returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for s, off in enumerate(range(0, len(ds), shard_size)):
        sub = ds.subset(range(off, min(off + shard_size, len(ds))))
        path = os.path.join(out_dir, f"shard_{s:05d}.npz")
        save_processed_qm9(path, sub)
        paths.append(path)
    return paths


def shard_range_for_host(n_shards: int, host: int, n_hosts: int) -> range:
    """The contiguous shards ``host`` of ``n_hosts`` reads: disjoint, and
    together every shard."""
    per = (n_shards + n_hosts - 1) // n_hosts
    return range(host * per, min((host + 1) * per, n_shards))


def iter_shards(shard_dir: str, host: int = 0,
                n_hosts: int = 1) -> Iterator[MoleculeDataset]:
    """``host``'s shards, in order, each as a ``MoleculeDataset``."""
    paths = sorted(glob.glob(os.path.join(shard_dir, "shard_*.npz")))
    for idx in shard_range_for_host(len(paths), host, n_hosts):
        yield _load_processed(paths[idx])
