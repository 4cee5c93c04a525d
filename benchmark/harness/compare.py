"""The numbers that decide ``correct``, each held against its limit.

Training: ``loss_gap``, the largest gap of a step's loss over the first
steps, over the largest reference loss of those steps (``loss_step_gap``:
over that step's own loss), and ``loss1_gap``, the first step's relative
gap; ``grad_gap``, the worst leaf's gap between the norms of the first
step's gradient as the optimizer got it (after the clip), over the larger
of that leaf's reference norm and the median leaf's (``grad_gap_median``:
the median leaf's gap); ``change_gap`` and ``change_gap_median``, the same
of each leaf's change over the first steps, leaving out the leaves whose
reference gradient is under a thousandth of the median leaf's (they move by
round-off alone under Adam).

Answers: ``energy_gap``, the largest gap of an energy over the largest
reference energy of the sample; ``force_gap``, the same of a force
component; ``energy_rms_gap`` and ``force_rms_gap``, the root mean square
of the gaps over that of the reference's values; ``energy_atom_gap``, the
largest gap of an energy a molecule's atom (in the energies' units)."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of the norms of ``prog`` against ``ref``."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
            for k in (keys if keys is not None else rn)}


def _worst(gaps: Dict[str, float]) -> tuple:
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses``, ``grad1`` and ``change`` (per
    leaf)."""
    diffs = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"])]
    gaps = [d / max(abs(b), 1e-30) for d, b in zip(diffs, ref["losses"])]
    scale = max(max(abs(b) for b in ref["losses"]), 1e-30)
    grads = leaf_gaps(prog["grad1"], ref["grad1"])
    grad_gap, grad_leaf = _worst(grads)
    rn = _norms(ref["grad1"])
    med = statistics.median(rn.values())
    moving = [k for k, v in rn.items() if v >= 1e-3 * med]
    changes = leaf_gaps(prog["change"], ref["change"], moving)
    change_gap, change_leaf = _worst(changes)
    return {"loss_gap": max(diffs) / scale, "loss_step_gap": max(gaps),
            "loss1_gap": gaps[0], "grad_gap": grad_gap,
            "grad_gap_median": statistics.median(grads.values()),
            "change_gap": change_gap,
            "change_gap_median": statistics.median(changes.values()),
            "_grad_leaf": grad_leaf, "_change_leaf": change_leaf,
            "_left_out": len(rn) - len(moving),
            "_losses": [list(map(float, prog["losses"])),
                        list(map(float, ref["losses"]))]}


def answer_numbers(e_prog: np.ndarray, e_ref: np.ndarray,
                   f_prog: Optional[List[np.ndarray]] = None,
                   f_ref: Optional[List[np.ndarray]] = None,
                   n_atoms: Optional[Sequence[int]] = None
                   ) -> Dict[str, float]:
    e_prog, e_ref = np.asarray(e_prog, np.float64), np.asarray(e_ref,
                                                               np.float64)
    out = {"energy_gap": float(np.abs(e_prog - e_ref).max()
                               / max(np.abs(e_ref).max(), 1e-30)),
           "energy_rms_gap": _rms_gap(e_prog, e_ref),
           "_energy_scale": float(np.abs(e_ref).max())}
    if n_atoms is not None:
        out["energy_atom_gap"] = float(
            (np.abs(e_prog - e_ref) / np.asarray(n_atoms)).max())
    if f_ref:
        fp, fr = np.concatenate(f_prog), np.concatenate(f_ref)
        out["force_gap"] = float(np.abs(fp - fr).max()
                                 / max(np.abs(fr).max(), 1e-30))
        out["force_rms_gap"] = _rms_gap(fp, fr)
    return out


def _rms_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((prog - ref) ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-30))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, ``{name: {"value", "limit"}}``) over the numbers that have
    a limit; a number that is not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = float(numbers[name])
        checks[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, checks
