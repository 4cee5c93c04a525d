"""Data- and edge-parallel training steps, one process per device
(``gotennet_tpu/parallel/data_parallel.py``).

The JAX package stacks a batch per device along a leading axis, shards it
over the ``data`` mesh axis (and, on the edge-list layout, its edge arrays
over ``edge``) and runs one ``shard_map``-wrapped step.  Here each rank
holds its own batch: ``shard_graph_batch`` cuts out the rank's piece of it
along the edge axis, and ``make_parallel_train_step`` gives a step whose
gradients, loss and logs are averaged over the mesh before the clip and
AdamW, as JAX's ``pmean`` over both axes does.  Parameters stay equal on
every rank because every rank applies the same averaged update.

No counterpart is needed of ``stack_batches`` / ``pad_stack`` (no leading
device axis: a rank holds one batch, and accumulation chunks stay a list)
or of ``make_global_batch`` (a rank's own batch is its whole input).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence

import torch

from gotennet_tpu_torch.parallel.mesh import Axes, Mesh

__all__ = ["pspec_for_layout", "shard_graph_batch", "pmean_grads",
           "make_parallel_train_step"]

_EDGE_FIELDS = ("edge_src", "edge_dst", "edge_mask")


def pspec_for_layout(layout: str, edge_axis: Optional[str] = None
                     ) -> Dict[str, str]:
    """The batch fields split along a mesh axis, by the axis: the edge-list
    layout's edge arrays along ``edge_axis``; nothing on the dense and ELL
    layouts (the ELL model cuts its own destination rows).  Every other
    field is whole on every rank of the edge axis."""
    if layout == "edge":
        return {f: edge_axis for f in _EDGE_FIELDS} if edge_axis else {}
    if layout in ("ell", "dense"):
        return {}
    raise ValueError(f"Unknown layout {layout!r}")


def shard_graph_batch(batch, mesh: Mesh, edge_axis: Optional[str] = "edge",
                      layout: str = "edge"):
    """This rank's piece of ``batch``: each field ``pspec_for_layout``
    names cut into equal contiguous blocks along the axis, the rank's
    block kept."""
    spec = pspec_for_layout(layout, edge_axis)
    if not spec:
        return batch
    cut = {}
    for name, axis in spec.items():
        x = getattr(batch, name)
        n, i = mesh.size(axis), mesh.index(axis)
        if x.shape[0] % n:
            raise ValueError(f"{name} has {x.shape[0]} rows, not divisible "
                             f"by the {axis!r} axis's {n} ranks")
        per = x.shape[0] // n
        cut[name] = x[i * per:(i + 1) * per]
    return dataclasses.replace(batch, **cut)


def pmean_grads(params: Sequence[torch.nn.Parameter], axes: Axes) -> None:
    """Average ``p.grad`` over the ranks of ``axes``, in place, with one
    all-reduce of the gradients laid end to end (a missing gradient counts
    as zeros, so every rank sends the same number of values)."""
    from gotennet_tpu_torch.parallel.collectives import axis_size, psum
    n = axis_size(axes)
    if n == 1:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = psum(torch.cat([g.reshape(-1).to(torch.float32) for g in grads]),
                axes) / n
    off = 0
    for p, g in zip(params, grads):
        k = g.numel()
        p.grad = flat[off:off + k].view_as(g).to(g.dtype)
        off += k


def make_parallel_train_step(model: torch.nn.Module, optimizer,
                             loss_fn: Callable, mesh: Mesh,
                             grad_clip: Optional[float] = 5.0) -> Callable:
    """``step(chunks, grad_scale=1.0, logs=None) -> loss``: the gradients of
    the mean loss over this rank's accumulation ``chunks`` (run through
    ``loss_fn``, whose model takes its collectives over the mesh's edge
    axis), times ``grad_scale``, averaged over every axis of ``mesh`` with
    the loss and ``logs``, clipped and stepped (``train.trainer.
    train_step``)."""
    from gotennet_tpu_torch.train.trainer import train_step
    return functools.partial(train_step, model, optimizer,
                             grad_clip=grad_clip, loss_fn=loss_fn,
                             axes=mesh.axis_names)
