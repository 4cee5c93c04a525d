"""The plain reference's training step: the task's loss, its gradient
(through the forces' gradient for a force loss), the global-norm clip by
optax's rule, and ``torch.optim.AdamW``.

A batch is worked in blocks of molecules so that it fits: each block adds
its share of the batch's mean losses, so the gradient is the whole batch's
up to the order of the sums.  ``dtype`` is the compute type: float32, or
bfloat16 for the lower-precision control (the weights stay float32 in the
optimizer and are cast for each forward)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference.model import energy, energy_forces, trainable


def collate(mols: Sequence[tuple], M: int, device, dtype=torch.float32):
    """``(z, pos, mask, y, dy)`` of molecules ``(z, pos, e, f)`` padded to
    ``M`` atoms; the positions float32, the targets in ``dtype``."""
    G = len(mols)
    z = np.zeros((G, M), np.int64)
    pos = np.zeros((G, M, 3), np.float32)
    mask = np.zeros((G, M), bool)
    y = np.zeros(G, np.float32)
    dy = np.zeros((G, M, 3), np.float32)
    for g, (zz, pp, e, f) in enumerate(mols):
        n = len(zz)
        z[g, :n], pos[g, :n], mask[g, :n], y[g] = zz, pp, True, e
        if f is not None:
            dy[g, :n] = f
    t = lambda a: torch.from_numpy(a).to(device)
    return t(z), t(pos), t(mask), t(y).to(dtype), t(dy).to(dtype)


def step_loss(P, m: dict, task: dict, mols, M: int, keeps, device,
              dtype, n_graphs: int, n_atoms: int, backward: bool,
              pair_type=None):
    """This block's share of the batch's loss (the mean losses' numerators
    over ``n_graphs`` molecules and ``n_atoms`` atoms), differentiated into
    the leaves of ``P`` when ``backward``."""
    z, pos, mask, y, dy = collate(mols, M, device, dtype)
    if task["kind"] == "force":
        e, f = energy_forces(P, m, z, pos, mask, keeps,
                             create_graph=backward, pair_type=pair_type)
        le = ((e - y) ** 2).sum() / n_graphs
        lf = (((f - dy) ** 2) * mask[..., None]).sum() / n_atoms
        loss = task["energy_weight"] * le + task["force_weight"] * lf
    else:
        e = energy(P, m, z, pos, mask, keeps, pair_type)
        loss = ((e - y) ** 2).sum() / n_graphs
    if backward:
        loss.backward()
    return float(loss.detach())


def train(weights: Dict[str, torch.Tensor], m: dict, task: dict, opt: dict,
          steps: Sequence[dict], device, dtype=torch.float32,
          block: int = 64, pair_type=None) -> dict:
    """Follow the program's first steps from ``weights``.  Each step is
    ``{"chunks": [...]}``, its accumulation chunks in order, each
    ``{"mols": [...], "M": int, "keeps": [per layer [G, M, M, H]] or
    None}`` (row g of a keep mask belongs to ``mols[g]``); a step's loss is
    the mean of its chunks' mean losses.  Returns the losses, the first
    step's clipped gradient and the change of every leaf after the steps.
    ``dtype`` and ``pair_type`` as ``answers``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leaves = {k: v.detach().clone().float().requires_grad_(trainable(k))
              for k, v in weights.items()}
    params = [v for v in leaves.values() if v.requires_grad]
    adamw = torch.optim.AdamW(params, lr=opt["lr"], eps=opt["eps"],
                              weight_decay=opt["weight_decay"])
    start = {k: v.detach().clone() for k, v in leaves.items()}
    losses: List[float] = []
    g1: Optional[Dict[str, torch.Tensor]] = None
    for st in steps:
        for p in params:
            p.grad = None
        P = {k: v.to(dtype) for k, v in leaves.items()}
        parts = st["chunks"]
        total = 0.0
        for ch in parts:
            # the mean over the chunks of each chunk's mean losses
            mols = ch["mols"]
            n_graphs = len(mols) * len(parts)
            n_atoms = sum(len(x[0]) for x in mols) * len(parts)
            for r0 in range(0, len(mols), block):
                keeps = (None if ch["keeps"] is None else
                         [k[r0:r0 + block].to(device) for k in ch["keeps"]])
                total += step_loss(P, m, task, mols[r0:r0 + block], ch["M"],
                                   keeps, device, dtype, n_graphs, n_atoms,
                                   True, pair_type)
        losses.append(total)
        with torch.no_grad():
            norm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                                  for p in params))
            if norm >= opt["grad_clip"]:
                for p in params:
                    p.grad.mul_(opt["grad_clip"] / norm)
        if g1 is None:
            g1 = {k: v.grad.detach().clone() for k, v in leaves.items()
                  if v.requires_grad}
        adamw.step()
    change = {k: (leaves[k].detach() - start[k]) for k in g1}
    return {"losses": losses, "grad1": g1, "change": change}


@torch.no_grad()
def answers(weights, m: dict, mols, device, forces: bool,
            dtype=torch.float32, block: int = 256, pair_type=None):
    """Energies ``[n]`` (and, with ``forces``, per-molecule ``[n_i, 3]``
    forces) of ``mols``, in blocks, computed in ``dtype`` with the pair
    tensors rounded through ``pair_type`` (None: not rounded)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = {k: v.to(device=device, dtype=dtype) for k, v in weights.items()}
    es, fs = [], []
    for r0 in range(0, len(mols), block):
        part = mols[r0:r0 + block]
        M = -(-max(len(x[0]) for x in part) // 8) * 8
        z, pos, mask, _, _ = collate(part, M, device, dtype)
        if forces:
            e, f = energy_forces(P, m, z, pos, mask, pair_type=pair_type)
            f = f.float().cpu().numpy()
            fs += [f[g, :len(x[0])] for g, x in enumerate(part)]
        else:
            e = energy(P, m, z, pos, mask, pair_type=pair_type)
        es.append(e.float().cpu().numpy())
    return np.concatenate(es), fs
