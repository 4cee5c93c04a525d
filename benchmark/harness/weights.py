"""Seeded weights, made on the device in a few large calls.

The names and shapes come from the plain reference's ``param_spec``; the
same dict loads into the program (``load_state_dict``) and drives the
reference.  Dense weights are drawn Xavier-uniform, biases and LayerNorm
shifts are zeros, LayerNorm scales ones, embeddings standard normal (the
centre embedding's row 0, the padding type, zero): the published
initialisation."""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference.model import param_spec


def make_weights(model: dict, seed: int, device, mean: float = 0.0,
                 stddev: float = 1.0) -> Dict[str, torch.Tensor]:
    """float32 weights of ``model`` (a configuration's ``model`` group)
    from ``seed``, on ``device``; ``mean`` and ``stddev`` are the head's
    standardisation."""
    spec = param_spec(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n_uni = sum(math.prod(s) for _, s, k in spec if k == "xavier")
    n_nrm = sum(math.prod(s) for _, s, k in spec if k.startswith("normal"))
    uni = torch.rand(n_uni, generator=gen, device=device)
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind == "xavier":
            fan_out, fan_in = shape
            b = math.sqrt(6.0 / (fan_in + fan_out))
            w = uni[iu:iu + n].view(shape) * (2 * b) - b
            iu += n
        elif kind.startswith("normal"):
            w = nrm[inn:inn + n].view(shape).clone()
            inn += n
            if kind == "normal_pad0":
                w[0].zero_()
        elif kind == "zeros":
            w = torch.zeros(shape, device=device)
        elif kind == "ones":
            w = torch.ones(shape, device=device)
        elif kind == "mean":
            w = torch.full(shape, mean, device=device)
        elif kind == "stddev":
            w = torch.full(shape, stddev, device=device)
        else:
            raise ValueError(f"unknown init {kind!r} of {name}")
        out[name] = w.contiguous()
    return out
