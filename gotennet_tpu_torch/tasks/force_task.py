"""Energy and force tasks, rMD17 and MD22
(``gotennet_tpu/tasks/force_task.py``).

The loss is the weighted sum ``rho_E * L(E) + rho_F * L(F)``, with the
forces ``-dE/dpos`` from ``models.model.apply_with_forces``; training on it
differentiates the forces, on the unfused paths (``fused=False``, see
``train.trainer.check_force_training``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from gotennet_tpu_torch.models.model import HeadConfig
from gotennet_tpu_torch.tasks.base import _LOSSES, Task, l1_loss, mse_loss

__all__ = ["MD17Task", "MD22Task"]


class MD17Task(Task):
    name = "rMD17"

    def __init__(self, label: Any, dataset_meta: Optional[Dict] = None,
                 task_config: Optional[Dict] = None):
        super().__init__(label, dataset_meta, task_config)
        self.energy_weight = float(self.task_config.get("energy_weight", 0.05))
        self.force_weight = float(self.task_config.get("force_weight", 0.95))

    def get_losses(self) -> List[dict]:
        loss_name = self.task_config.get("task_loss", "MSELoss")
        fn = _LOSSES[loss_name]
        return [
            {"name": f"energy_{loss_name}", "prediction": "property",
             "target": "y", "loss_fn": fn,
             "loss_weight": self.energy_weight},
            {"name": f"force_{loss_name}", "prediction": "forces",
             "target": "dy", "loss_fn": fn,
             "loss_weight": self.force_weight},
        ]

    def get_metrics(self) -> List[dict]:
        return [
            {"name": "MeanAbsoluteError_energy", "prediction": "property",
             "target": "y", "loss_fn": l1_loss, "kind": "mae"},
            {"name": "MeanAbsoluteError_force", "prediction": "forces",
             "target": "dy", "loss_fn": l1_loss, "kind": "mae"},
            {"name": "MeanSquaredError_energy", "prediction": "property",
             "target": "y", "loss_fn": mse_loss, "kind": "mse"},
        ]

    def build_head(self) -> HeadConfig:
        mean = float(self.dataset_meta.get("mean") or 0.0)
        std = float(self.dataset_meta.get("std") or 1.0)
        return HeadConfig(
            kind="atomwise", mean=mean, stddev=std,
            atomref=self.dataset_meta.get("atomref"),
            activation="silu", derivative=True)

    def get_targets(self, batch) -> Dict[str, tuple]:
        """``y``: ``([G, 1], graph mask [G, 1])``; ``dy``, when the batch
        carries forces: ``([G, M, 3] or [N, 3], atom mask [..., 1])``."""
        out = super().get_targets(batch)
        if batch.dy is not None:
            nm = batch.node_mask.to(torch.float32)[..., None]
            out["dy"] = (batch.dy, nm)
        return out


class MD22Task(MD17Task):
    """MD22 large molecules: the same energy and force losses; the longer
    cutoff and the larger graphs belong to the data and the config."""

    name = "MD22"
