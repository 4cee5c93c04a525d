"""Masked segment reductions and the segment softmax, over axis 0.

Counterpart of ``gotennet_tpu/graph/segment.py``.  Each function takes an optional mask over the rows, so the padded slots of
a fixed-capacity edge list add exact zeros; ``data`` may carry trailing
axes.  Sums go through ``index_add_``, maxima through ``scatter_reduce``
(``amax``, which shares the gradient among equal maxima, as the JAX
package's ``segment_max`` does).  On the card ``index_add_`` adds with
atomics, so its sums may move in the last bits between runs.  Rows are
gathered by segment with ``index_select``, whose backward is an
``index_add_`` (the transpose JAX takes of a gather), not the sorting
backward of advanced indexing.

Edge partitioning: every function takes an optional ``psum_axis``, a mesh
axis (``parallel.mesh``) along whose ranks the edge list is split, node
features whole on each.  Each rank reduces its own edges into the full node
range and the partial results are combined by one all-reduce (a sum; the
maximum for ``segment_max``) over the axis.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_softmax"]

# PyG softmax's denominator guard
_SOFTMAX_EPS = 1e-16


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    m = mask
    while m.dim() < like.dim():
        m = m[..., None]
    return m


def _apply_mask(data: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    if mask is None:
        return data
    return torch.where(_expand(mask, data), data, torch.zeros_like(data))


def _psum(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    if axis is None:
        return x
    from gotennet_tpu_torch.parallel.collectives import psum
    return psum(x, axis)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                psum_axis: Optional[str] = None) -> torch.Tensor:
    """Sum the rows of ``data`` into ``num_segments`` buckets by
    ``segment_ids``; masked rows add zero."""
    data = _apply_mask(data, mask)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return _psum(out.index_add_(0, segment_ids.long(), data), psum_axis)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: Optional[torch.Tensor] = None,
                 psum_axis: Optional[str] = None) -> torch.Tensor:
    """Mean of the (unmasked) rows per segment; an empty segment gives
    zeros."""
    total = segment_sum(data, segment_ids, num_segments, mask, psum_axis)
    ones = (torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
            if mask is None else mask.to(data.dtype))
    counts = torch.clamp(segment_sum(ones, segment_ids, num_segments,
                                     psum_axis=psum_axis), min=1)
    return total / _expand(counts, total)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                psum_axis: Optional[str] = None) -> torch.Tensor:
    """Maximum of the rows per segment.  Masked rows take the type's most
    negative finite value; a segment no row reaches gives -inf for a
    floating type and the type's minimum for an integer one, as
    ``jax.ops.segment_max``."""
    floating = data.is_floating_point()
    info = torch.finfo(data.dtype) if floating else torch.iinfo(data.dtype)
    if mask is not None:
        data = torch.where(_expand(mask, data), data,
                           torch.full_like(data, info.min))
    out = torch.full((num_segments,) + tuple(data.shape[1:]),
                     -torch.inf if floating else info.min,
                     dtype=data.dtype, device=data.device)
    idx = _expand(segment_ids.long(), data).expand_as(data)
    out = out.scatter_reduce(0, idx, data, "amax", include_self=True)
    if psum_axis is None:
        return out
    from gotennet_tpu_torch.parallel.collectives import pmax
    return pmax(out, psum_axis)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: Optional[torch.Tensor] = None,
                    psum_axis: Optional[str] = None) -> torch.Tensor:
    """Softmax within each segment over axis 0 (PyG's ``softmax(src,
    index)``): each entry shifted by its segment's maximum, exponentiated
    and divided by the segment's sum (+1e-16).  Masked entries come out
    exactly zero and touch no real one; an all-masked segment gives zero
    gradients, not NaN."""
    # the shift only keeps exp in range: softmax does not depend on it (its
    # input is detached, so the maximum over the axis takes no gradient)
    seg_max = segment_max(logits.detach(), segment_ids, num_segments, mask,
                          psum_axis)
    # a dead segment's max stays at the type's minimum (or -inf)
    seg_max = torch.clamp(seg_max, min=torch.finfo(logits.dtype).min / 2)
    ids = segment_ids.long()
    shifted = logits - seg_max.index_select(0, ids)
    # masked BEFORE exp: in an all-masked segment the shift is near the
    # type's maximum and exp overflows, and the zero cotangent times inf
    # would be NaN in the backward pass
    expd = _apply_mask(torch.exp(_apply_mask(shifted, mask)), mask)
    denom = segment_sum(expd, segment_ids, num_segments,
                        psum_axis=psum_axis)
    return expd / (denom.index_select(0, ids) + _SOFTMAX_EPS)
