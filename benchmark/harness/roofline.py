"""The least time an H100 could take for one kernel launch, copied from
``chip_smoke.py`` (``bound_ms``, ``n_bytes``): each input byte read once and
each output byte written once at the HBM rate, against the launch's
projection FLOP at the pair type's peak; the larger of the two."""

from __future__ import annotations

import torch

from harness.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S


def bound_ms(n_bytes, flops, pair_dtype) -> tuple:
    """Least time an H100 SXM could take for one launch: the larger of
    ``n_bytes`` / 3.35 TB/s and ``flops`` / the pair type's peak (989
    TFLOP/s bf16, 67 TFLOP/s float32)."""
    peak = BF16_FLOPS if pair_dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def n_bytes(tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors
               if a is not None)


def count_valid(args, i, valid):
    """The valid pairs of a launch: ``valid`` where the caller counted
    them, else counted from ``args[i]`` as ``chip_smoke.py`` does."""
    return valid if valid is not None else int((args[i] >= 0).sum())
