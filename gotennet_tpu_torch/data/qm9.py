"""QM9 from a local root (``gotennet_tpu/data/qm9.py``).

12 regression targets in the PyG column order and the atomref tables.
``load_qm9`` reads, in order:

  1. ``qm9_processed.npz`` under ``root`` (concatenated z/pos with a ptr
     index and the ``[n, 19]`` target matrix), or
  2. the raw GDB-9 distribution, ``gdb9.sdf`` + ``gdb9.sdf.csv`` (+
     ``uncharacterized.txt``, whose molecules are skipped), with the JAX
     package's unit conversion (energies Hartree -> eV, atomization
     energies kcal/mol -> eV); the result is written back as
     ``qm9_processed.npz``.

Nothing is downloaded: a root with neither raises ``FileNotFoundError``
naming the files to place there.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from gotennet_tpu_torch.data.dataset import MoleculeDataset

__all__ = ["QM9_TARGETS", "qm9_atomref", "load_qm9", "save_processed_qm9"]

QM9_TARGETS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
               "U0", "U", "H", "G", "Cv"]

_HAR2EV = 27.211386246
_KCALMOL2EV = 0.04336414

# Per-target unit conversion in the reordered (mu-first) column order;
# 19 columns = 12 regression targets + U0_atom..G_atom + A, B, C.
_CONVERSION = np.asarray(
    [1.0, 1.0, _HAR2EV, _HAR2EV, _HAR2EV, 1.0, _HAR2EV, _HAR2EV, _HAR2EV,
     _HAR2EV, _HAR2EV, 1.0, _KCALMOL2EV, _KCALMOL2EV, _KCALMOL2EV,
     _KCALMOL2EV, 1.0, 1.0, 1.0], np.float64)

# Single-atom reference energies (eV) for H, C, N, O, F at z=1,6,7,8,9:
# the QM9 distribution's atomref table for zpve/U0/U/H/G/Cv.
_ATOMREF_RAW: Dict[str, list] = {
    "zpve": [0.0, 0.0, 0.0, 0.0, 0.0],
    "U0": [-13.61312172, -1029.86312267, -1485.30251237, -2042.61123593,
           -2713.48485589],
    "U": [-13.5745904, -1029.82456413, -1485.26398105, -2042.5727046,
          -2713.44632457],
    "H": [-13.54887564, -1029.79887659, -1485.2382935, -2042.54701705,
          -2713.42063702],
    "G": [-13.90303183, -1030.25891228, -1485.71166277, -2043.01812778,
          -2713.88796536],
    "Cv": [0.0, 0.0, 0.0, 0.0, 0.0],
}
_ATOMREF_Z = [1, 6, 7, 8, 9]

_SYMBOL_TO_Z = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}


def qm9_atomref(label: str, max_z: int = 100) -> Optional[np.ndarray]:
    """``[max_z, 1]`` atomref table for a target (zero-padded), or None."""
    if label not in _ATOMREF_RAW:
        return None
    table = np.zeros((max_z, 1), np.float32)
    for z, v in zip(_ATOMREF_Z, _ATOMREF_RAW[label]):
        table[z, 0] = v
    return table


def save_processed_qm9(path: str, ds: MoleculeDataset) -> None:
    ptr = np.cumsum([0] + [len(z) for z in ds.z])
    np.savez_compressed(
        path,
        z=np.concatenate(ds.z).astype(np.int32),
        pos=np.concatenate(ds.pos).astype(np.float32),
        ptr=ptr.astype(np.int64),
        y=ds.y.astype(np.float32))


def _load_processed(path: str) -> MoleculeDataset:
    f = np.load(path)
    ptr = f["ptr"]
    z = [f["z"][ptr[i]:ptr[i + 1]] for i in range(len(ptr) - 1)]
    pos = [f["pos"][ptr[i]:ptr[i + 1]] for i in range(len(ptr) - 1)]
    return MoleculeDataset(z=z, pos=pos, y=f["y"])


def _parse_sdf_coords(lines, start):
    """One V2000 mol block from ``lines[start]``: ``(z, pos, next index)``,
    or ``(None, None, start + 1)`` where no block parses."""
    try:
        n_atoms = int(lines[start + 3][:3])
    except (IndexError, ValueError):
        return None, None, start + 1
    z = np.zeros(n_atoms, np.int32)
    pos = np.zeros((n_atoms, 3), np.float32)
    for i in range(n_atoms):
        ln = lines[start + 4 + i]
        pos[i] = [float(ln[0:10]), float(ln[10:20]), float(ln[20:30])]
        z[i] = _SYMBOL_TO_Z.get(ln[31:34].strip(), 0)
    # advance to the end-of-record marker
    j = start + 4 + n_atoms
    while j < len(lines) and lines[j].strip() != "$$$$":
        j += 1
    return z, pos, j + 1


def _load_raw(root: str) -> MoleculeDataset:
    with open(os.path.join(root, "gdb9.sdf.csv")) as f:
        rows = f.read().strip().split("\n")[1:]
    target = np.asarray([[float(x) for x in r.split(",")[1:20]]
                         for r in rows], np.float64)
    # reorder: [mu..Cv, U0_atom.., A, B, C] then unit conversion
    target = np.concatenate([target[:, 3:], target[:, :3]], axis=1)
    target = (target * _CONVERSION[None, :]).astype(np.float32)

    skip = set()
    unchar = os.path.join(root, "uncharacterized.txt")
    if os.path.exists(unchar):
        with open(unchar) as f:
            for ln in f.read().split("\n")[9:-2]:
                parts = ln.split()
                if parts:
                    skip.add(int(parts[0]) - 1)

    with open(os.path.join(root, "gdb9.sdf")) as f:
        lines = f.read().split("\n")
    zs, poss, keep = [], [], []
    i = mol_idx = 0
    while i < len(lines) - 4:
        z, pos, i = _parse_sdf_coords(lines, i)
        if z is None:
            continue
        if mol_idx not in skip and (z > 0).all():
            zs.append(z)
            poss.append(pos)
            keep.append(mol_idx)
        mol_idx += 1
    return MoleculeDataset(z=zs, pos=poss, y=target[np.asarray(keep)])


def load_qm9(root: str, label: Optional[str] = None,
             max_z: int = 100) -> MoleculeDataset:
    """QM9 from ``root``; ``y`` is ``[n, 19]`` (12 targets + extras), or the
    one column of ``label`` with its atomref table."""
    processed = os.path.join(root, "qm9_processed.npz")
    if os.path.exists(processed):
        ds = _load_processed(processed)
    else:
        raw = [os.path.join(root, f) for f in ("gdb9.sdf", "gdb9.sdf.csv")]
        if not all(os.path.exists(p) for p in raw):
            raise FileNotFoundError(
                f"No QM9 data under {root}: place qm9_processed.npz, or "
                "gdb9.sdf + gdb9.sdf.csv (+ optional uncharacterized.txt), "
                "there (this package downloads nothing)")
        ds = _load_raw(root)
        save_processed_qm9(processed, ds)
    if label is not None:
        idx = QM9_TARGETS.index(label)
        ds = MoleculeDataset(z=ds.z, pos=ds.pos, y=ds.y[:, idx:idx + 1],
                             atomref=qm9_atomref(label, max_z))
    return ds
