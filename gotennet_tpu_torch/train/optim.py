"""Optimizer and learning-rate multipliers (``gotennet_tpu/train/optim.py``).

The JAX package's recipe is optax's ``chain(clip_by_global_norm(clip),
adamw(lr, eps=1e-7, weight_decay))``.  Here it is ``torch.optim.AdamW``
with the same hyper-parameters, and ``clip_by_global_norm`` applied to
the gradients before ``step()``, with optax's rule: gradients are scaled
by ``max_norm / g_norm`` only when ``g_norm >= max_norm``.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

__all__ = ["make_optimizer", "clip_by_global_norm", "warmup_scale",
           "cosine_scale"]


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.0,
                   grad_clip: Optional[float] = 5.0,
                   eps: float = 1e-7) -> torch.optim.AdamW:
    """AdamW(eps=1e-7); ``optimizer.grad_clip`` keeps the global-norm
    clip that ``train.trainer.train_step`` applies before each step (None:
    no clip)."""
    opt = torch.optim.AdamW(params, lr=lr, eps=eps,
                            weight_decay=weight_decay)
    opt.grad_clip = grad_clip
    return opt


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.nn.Parameter],
                        max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by ``max_norm / g_norm``
    when their global norm ``g_norm`` is not below ``max_norm`` (optax's
    ``clip_by_global_norm``; torch's ``clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead).  Returns ``g_norm``, on the gradients'
    device, without waiting for it."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm * max_norm))
    return g_norm


def warmup_scale(step: int, warmup_steps: int) -> float:
    """Linear warmup multiplier."""
    if warmup_steps <= 0:
        return 1.0
    return min(1.0, float(step + 1) / float(warmup_steps))


def cosine_scale(step: int, t_max: int, eta_min_ratio: float = 0.0) -> float:
    """CosineAnnealingLR multiplier over ``t_max`` steps."""
    if t_max <= 0:
        return 1.0
    c = 0.5 * (1 + math.cos(math.pi * min(step, t_max) / t_max))
    return eta_min_ratio + (1 - eta_min_ratio) * c
