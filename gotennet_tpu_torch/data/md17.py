"""rMD17, MD17 and MD22 trajectories: energies and forces
(``gotennet_tpu/data/md17.py``).

Nothing is downloaded: ``root`` points at a local copy in one of these
forms, each one topology over many frames:

  * revised-MD17 NPZ: ``nuclear_charges [N]``, ``coords [S, N, 3]``,
    ``energies [S]``, ``forces [S, N, 3]``;
  * sGDML NPZ (the MD17 and MD22 distributions): ``z [N]``,
    ``R [S, N, 3]``, ``E [S, 1]``, ``F [S, N, 3]``;
  * XYZ: repeated blocks of ``N``, a comment line (``E=...`` or
    ``energy=...`` gives the energy) and ``N`` atom lines (no forces).

Each reader returns a ``MoleculeDataset`` with per-frame positions,
energies and (NPZ) forces.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from gotennet_tpu_torch.data.dataset import MoleculeDataset

__all__ = ["load_md_npz", "load_xyz", "load_md_dataset", "MD17_MOLECULES",
           "MD22_MOLECULES"]

MD17_MOLECULES = ["aspirin", "azobenzene", "benzene", "ethanol",
                  "malonaldehyde", "naphthalene", "paracetamol",
                  "salicylic", "toluene", "uracil"]
MD22_MOLECULES = ["Ac-Ala3-NHMe", "DHA", "stachyose", "AT-AT",
                  "AT-AT-CG-CG", "buckyball-catcher",
                  "double-walled_nanotube"]

_SYMBOL_TO_Z = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20,
}
_E_RE = re.compile(r"(?:E|energy)\s*=\s*([-+0-9.eE]+)")


def load_md_npz(path: str, max_frames: Optional[int] = None
                ) -> MoleculeDataset:
    """An rMD17- or sGDML-format NPZ trajectory, its first ``max_frames``
    frames (None: all)."""
    with np.load(path) as f:
        if "nuclear_charges" in f:       # revised MD17
            z = np.asarray(f["nuclear_charges"], np.int32)
            coords = np.asarray(f["coords"], np.float32)
            energies = np.asarray(f["energies"], np.float64).reshape(-1)
            forces = np.asarray(f["forces"], np.float32)
        elif "z" in f and "R" in f:      # sGDML (MD17, MD22)
            z = np.asarray(f["z"], np.int32).reshape(-1)
            coords = np.asarray(f["R"], np.float32)
            energies = np.asarray(f["E"], np.float64).reshape(-1)
            forces = np.asarray(f["F"], np.float32)
        else:
            raise ValueError(f"{path}: unrecognised NPZ keys "
                             f"{sorted(f.keys())}")
    s = coords.shape[0] if max_frames is None else min(coords.shape[0],
                                                       max_frames)
    return MoleculeDataset(
        z=[z] * s,
        pos=[coords[i] for i in range(s)],
        y=energies[:s, None].astype(np.float32),
        dy=[forces[i] for i in range(s)])


def load_xyz(path: str, max_frames: Optional[int] = None
             ) -> MoleculeDataset:
    """A multi-frame XYZ file; the energy comes from the comment line when
    it has one (0 otherwise); atoms by symbol or atomic number."""
    zs, poss, ys = [], [], []
    with open(path) as fh:
        lines = fh.read().split("\n")
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].strip())
        m = _E_RE.search(lines[i + 1])
        z = np.zeros(n, np.int32)
        pos = np.zeros((n, 3), np.float32)
        for a in range(n):
            parts = lines[i + 2 + a].split()
            sym = parts[0]
            z[a] = int(sym) if sym.isdigit() else _SYMBOL_TO_Z[sym]
            pos[a] = [float(x) for x in parts[1:4]]
        zs.append(z)
        poss.append(pos)
        ys.append([float(m.group(1)) if m else 0.0])
        i += 2 + n
        if max_frames is not None and len(zs) >= max_frames:
            break
    return MoleculeDataset(z=zs, pos=poss, y=np.asarray(ys, np.float32))


def load_md_dataset(root: str, molecule: str,
                    max_frames: Optional[int] = None) -> MoleculeDataset:
    """The trajectory of ``molecule`` under ``root``, found by the usual
    file names: ``rmd17_<m>.npz``, ``md17_<m>.npz``, ``md22_<m>.npz``,
    ``<m>.npz``, ``<m>.xyz``, in that order."""
    names = [f"rmd17_{molecule}.npz", f"md17_{molecule}.npz",
             f"md22_{molecule}.npz", f"{molecule}.npz", f"{molecule}.xyz"]
    for name in names:
        path = os.path.join(root, name)
        if os.path.exists(path):
            if path.endswith(".npz"):
                return load_md_npz(path, max_frames)
            return load_xyz(path, max_frames)
    raise FileNotFoundError(f"no trajectory for {molecule!r} under {root} "
                            f"(tried {names})")
