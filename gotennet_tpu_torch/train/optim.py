"""Optimizer and learning-rate multipliers (``gotennet_tpu/train/optim.py``).

The JAX package's recipe is optax's ``chain(clip_by_global_norm(clip),
adamw(lr, eps=1e-7, weight_decay))``.  Here it is ``torch.optim.AdamW``
with the same hyper-parameters, and ``clip_by_global_norm`` applied to
the gradients before ``step()``, with optax's rule: gradients are scaled
by ``max_norm / g_norm`` only when ``g_norm >= max_norm``.  The learning
rate of a step is the base rate times ``Trainer.lr_scale(step)`` (warm-up
times the plateau or cosine multiplier), written into the param groups
before ``step()`` (``set_lr``); ``PlateauState`` / ``plateau_update`` are
ReduceLROnPlateau on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import torch

__all__ = ["make_optimizer", "clip_by_global_norm", "set_lr", "warmup_scale",
           "cosine_scale", "PlateauState", "plateau_update"]


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


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every param group (optax's injected
    ``learning_rate`` hyper-parameter)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


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


@dataclasses.dataclass
class PlateauState:
    """Host-side ReduceLROnPlateau state (mode 'min', relative threshold),
    torch's semantics: improvement means ``metric < best * (1 -
    threshold)``; ``num_bad > patience`` reduces the scale and resets."""

    factor: float = 0.8
    patience: int = 15
    min_lr: float = 1e-7
    best: float = float("inf")
    num_bad: int = 0
    scale: float = 1.0
    threshold: float = 1e-4


def plateau_update(state: PlateauState, metric: float,
                   base_lr: float) -> PlateauState:
    """Advance the plateau scheduler by one validation epoch."""
    if math.isinf(state.best):
        better = metric < state.best
    else:
        better = metric < state.best * (1.0 - state.threshold)
    if better:
        return dataclasses.replace(state, best=metric, num_bad=0)
    num_bad = state.num_bad + 1
    if num_bad > state.patience:
        new_scale = max(state.scale * state.factor,
                        state.min_lr / max(base_lr, 1e-30))
        return dataclasses.replace(state, num_bad=0, scale=new_scale)
    return dataclasses.replace(state, num_bad=num_bad)
