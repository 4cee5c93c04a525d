"""Task interface (``gotennet_tpu/tasks/base.py``): head construction,
losses and targets for a graph-level scalar property.

A loss spec is a dict ``{'name', 'prediction', 'target', 'loss_fn',
'loss_weight'}``: ``prediction`` keys into the model's result dict and
``target`` into ``get_targets``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from gotennet_tpu_torch.models.model import HeadConfig

__all__ = ["Task", "l1_loss", "mse_loss"]


def mse_loss(pred, target, mask):
    """Masked mean-squared error (mean over real entries)."""
    se = (pred - target) ** 2 * mask
    return torch.sum(se) / torch.clamp(torch.sum(mask), min=1)


def l1_loss(pred, target, mask):
    """Masked mean absolute error (mean over real entries)."""
    ae = torch.abs(pred - target) * mask
    return torch.sum(ae) / torch.clamp(torch.sum(mask), min=1)


_LOSSES = {"MSELoss": mse_loss, "L1Loss": l1_loss}


class Task:
    """Base task: single graph-level scalar property."""

    name = "base"

    def __init__(self, label: Any, dataset_meta: Optional[Dict] = None,
                 task_config: Optional[Dict] = None):
        self.label = label
        self.dataset_meta = dataset_meta or {}
        self.task_config = task_config or {}

    def get_losses(self) -> List[dict]:
        loss_name = self.task_config.get("task_loss", "L1Loss")
        return [{
            "name": loss_name,
            "prediction": "property",
            "target": "y",
            "loss_fn": _LOSSES[loss_name],
            "loss_weight": 1.0,
        }]

    def build_head(self) -> HeadConfig:
        mean = float(self.dataset_meta.get("mean") or 0.0)
        std = float(self.dataset_meta.get("std") or 1.0)
        return HeadConfig(kind="atomwise", mean=mean, stddev=std,
                          atomref=self.dataset_meta.get("atomref"))

    def get_targets(self, batch) -> Dict[str, tuple]:
        """Target name -> ``(values [G, 1], mask [G, 1])`` from a dense
        batch; padded graphs have mask 0."""
        if batch.y.dim() == 3:
            from gotennet_tpu_torch.models.gotennet import not_ported
            raise not_ported("packed dense batches (y with 3 dimensions)", 4)
        gm = batch.graph_mask.to(torch.float32)[:, None]
        return {"y": (batch.y[:, :1], gm)}
