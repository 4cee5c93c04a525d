"""Collectives over a named mesh axis: ``psum``, ``pmean``, ``pmax``.

The port's counterparts of ``jax.lax.psum`` / ``pmean`` / ``pmax`` inside
the JAX package's ``shard_map(check_vma=False)``.  ``psum``'s backward is
the all-reduce of the cotangent, the transpose JAX takes of ``psum`` there;
it is a ``torch.autograd.Function`` of its own (differentiable again, for a
force loss), not the deprecated ``torch.distributed.nn`` one.  ``pmax`` has
no gradient, as JAX's has no JVP: a tensor that asks for one raises.  Only
``all_reduce`` is used, which Gloo offers on CUDA tensors as well as NCCL.
An axis is resolved in the current mesh (``parallel.mesh``); along an axis
of one rank each is the identity (``pmax``: a detached copy).
"""

from __future__ import annotations

import torch

from gotennet_tpu_torch.parallel.mesh import Axes, current_mesh

__all__ = ["psum", "pmean", "pmax", "axis_size", "axis_index"]

_EXACT = (torch.float32, torch.float64, torch.int32, torch.int64)


def axis_size(axis: Axes) -> int:
    return current_mesh().size(axis)


def axis_index(axis: str) -> int:
    return current_mesh().index(axis)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A reduced copy of ``x``; other types reduce in float32."""
    import torch.distributed as dist
    y = x.to(torch.float32) if x.dtype not in _EXACT else x
    y = y.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.dtype)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.group), None


def psum(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a name or a tuple of
    names), on every one of them."""
    mesh = current_mesh()
    if mesh.size(axis) == 1:
        return x
    return _PSum.apply(x, mesh.group(axis))


def pmean(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    return psum(x, axis) / axis_size(axis)


def pmax(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axis``; no
    gradient flows through it."""
    import torch.distributed as dist
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "pmax over a mesh axis has no gradient (nor has JAX's: pmax has "
            "no JVP rule); aggr='max' under edge_parallel cannot train")
    mesh = current_mesh()
    if mesh.size(axis) == 1:
        return x.detach().clone()
    return _all_reduce(x.detach(), dist.ReduceOp.MAX, mesh.group(axis))
