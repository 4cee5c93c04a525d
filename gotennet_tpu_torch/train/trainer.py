"""Training step (the counterpart of ``bench.py``'s ``one_step`` and of
``make_loss_fn`` / ``_accum_grads`` in ``gotennet_tpu/train/trainer.py``).

One step takes a batch cut into accumulation chunks: the loss of each
chunk is differentiated (through the fused kernels' backward on the
card), the gradients are summed and divided by the number of chunks that
hold a real graph, clipped by their global norm, and AdamW steps.

    losses = train_steps(cfg, head, molecules, n_steps=3)   # on cuda

The ``Trainer`` class, checkpoints, the LR schedulers' state, metrics
and the loss EMA are not ported yet (ROADMAP.md Queue 1, item 1).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gotennet_tpu_torch.data.dataset import (DenseLoader, ELLLoader,
                                             MoleculeDataset)
from gotennet_tpu_torch.graph.dense_batch import DenseBatch
from gotennet_tpu_torch.graph.ell_batch import ELLBatch
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.tasks.base import Task
from gotennet_tpu_torch.train.optim import clip_by_global_norm, make_optimizer

__all__ = ["make_loss_fn", "make_chunks", "accum_grads", "train_step",
           "train_steps"]


def make_loss_fn(model: GotenModel, task: Task) -> Callable:
    """``loss_fn(batch) -> (total, logs, out)``: the weighted sum of the
    task's losses on one batch."""
    specs = task.get_losses()

    def loss_fn(batch: DenseBatch):
        out = model(batch)
        targets = task.get_targets(batch)
        total = torch.zeros((), dtype=torch.float32, device=batch.z.device)
        logs = {}
        for spec in specs:
            pred = out[spec["prediction"]]
            tgt, mask = targets[spec["target"]]
            li = spec["loss_fn"](pred.reshape(tgt.shape), tgt, mask)
            logs[spec["name"]] = li.detach()
            total = total + spec["loss_weight"] * li
        return total, logs, out

    return loss_fn


def make_chunks(molecules: Sequence[dict], chunk: int,
                device: Optional[str | torch.device] = None,
                bucket: bool = True, layout: str = "dense",
                cutoff: float = 5.0, max_num_neighbors: int = 32
                ) -> List[DenseBatch | ELLBatch]:
    """The accumulation chunks of one batch, as ``bench.py`` cuts them:
    ``chunk`` graphs each, on ``device``.  Dense: with ``bucket`` the
    molecules are sorted by size over one window spanning the batch and each
    chunk is padded to its own largest molecule; without it (``bench.py``'s
    MD22 mode) they keep their order and every chunk is padded to the
    batch's largest molecule (rounded up to a multiple of 8).  ELL
    (``bench.py``'s large mode): in order, atoms spatially sorted, 64-row
    gather windows, every chunk at the batch's node and neighbour capacity,
    as ``Predictor(layout="ell")`` cuts a request."""
    ds = MoleculeDataset(
        z=[np.asarray(m["z"], np.int32) for m in molecules],
        pos=[np.asarray(m["pos"], np.float32) for m in molecules],
        y=np.asarray([np.asarray(m["y"], np.float32).reshape(-1)
                      for m in molecules]))
    if layout == "ell":
        loader = ELLLoader(ds, batch_size=chunk, cutoff=cutoff,
                           max_num_neighbors=max_num_neighbors,
                           spatial_sort=True, block_rows=64)
    else:
        loader = DenseLoader(ds, batch_size=chunk, bucket=bucket,
                             bucket_window=math.ceil(len(molecules) / chunk))
    return [b.to(device) for b in loader]


def accum_grads(model: GotenModel, loss_fn: Callable,
                chunks: Sequence[DenseBatch]) -> torch.Tensor:
    """Gradients of the mean loss over ``chunks`` into ``p.grad``.  Chunks
    without a real graph add zero and are left out of the divisor, as in
    the JAX package's ``_accum_grads``.  Returns the mean loss (a tensor
    on the model's device)."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.grad = None
    l_sum = n_real = 0.0
    for batch in chunks:
        loss, _, _ = loss_fn(batch)
        loss.backward()
        l_sum = l_sum + loss.detach()
        n_real = n_real + batch.graph_mask.any().to(torch.float32)
    n_real = torch.clamp(torch.as_tensor(n_real), min=1.0)
    for p in params:
        p.grad.div_(n_real)
    return l_sum / n_real


def train_step(model: GotenModel, optimizer: torch.optim.Optimizer,
               chunks: Sequence[DenseBatch], grad_clip: Optional[float] = 5.0,
               *, loss_fn: Optional[Callable] = None) -> float:
    """One optimizer step over the accumulation ``chunks``: mean gradient,
    global-norm clip at ``grad_clip`` (None: none), then
    ``optimizer.step()``.  ``loss_fn`` defaults to the base task's L1
    loss on the property.  Returns the mean loss."""
    model.train()
    if loss_fn is None:
        loss_fn = make_loss_fn(model, Task(None))
    loss = accum_grads(model, loss_fn, chunks)
    if grad_clip is not None:
        clip_by_global_norm(model.parameters(), grad_clip)
    optimizer.step()
    return float(loss)


def train_steps(cfg: GotenNetConfig, head: HeadConfig,
                molecules: Sequence[dict], n_steps: int, *, chunk: int = 16,
                lr: float = 1e-4, seed: int = 0,
                state_dict: Optional[Dict[str, torch.Tensor]] = None,
                device: Optional[str | torch.device] = None,
                bucket: bool = True, layout: str = "dense") -> List[float]:
    """Train a model from a seeded init (or ``state_dict``) for
    ``n_steps`` steps on one batch of ``molecules`` (dicts with ``z``,
    ``pos`` and ``y``), cut into ``chunk``-graph accumulation chunks
    (see ``make_chunks``; ``bucket`` applies to the dense layout), with
    AdamW(lr, eps=1e-7, no weight decay) after a global-norm clip at 5.0.
    ``layout`` is "dense" or "ell".  ``device=None`` means ``cuda``.
    Returns the loss of each step."""
    model = GotenModel(cfg, head, layout, seed=seed, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    chunks = make_chunks(molecules, chunk, next(model.parameters()).device,
                         bucket, layout, cfg.cutoff, cfg.max_num_neighbors)
    optimizer = make_optimizer(model.parameters(), lr)
    loss_fn = make_loss_fn(model, Task(None))
    return [train_step(model, optimizer, chunks, optimizer.grad_clip,
                       loss_fn=loss_fn) for _ in range(n_steps)]
