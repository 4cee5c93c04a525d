"""QM9 task (``gotennet_tpu/tasks/qm9.py``): 12 molecular targets in the
PyG column order.  'mu' builds the Dipole head (its magnitude), 'r2' the
electronic-spatial-extent head, every other target the Atomwise head."""

from __future__ import annotations

from typing import Any, Dict, Optional

from gotennet_tpu_torch.models.model import HeadConfig
from gotennet_tpu_torch.tasks.base import Task

__all__ = ["QM9Task", "QM9_TARGETS"]

QM9_TARGETS = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
               "U0", "U", "H", "G", "Cv"]


class QM9Task(Task):
    name = "QM9"

    def __init__(self, label: Any, dataset_meta: Optional[Dict] = None,
                 task_config: Optional[Dict] = None):
        super().__init__(label, dataset_meta, task_config)
        if isinstance(label, str):
            if label not in QM9_TARGETS:
                raise ValueError(f"unknown QM9 target {label!r}; choose one "
                                 f"of {QM9_TARGETS}")
            self.label_idx = QM9_TARGETS.index(label)
            self.label_name = label
        else:
            self.label_idx = int(label)
            self.label_name = QM9_TARGETS[self.label_idx]

    def build_head(self) -> HeadConfig:
        mean = self.dataset_meta.get("mean")
        std = self.dataset_meta.get("std")
        if self.label_name == "mu":
            return HeadConfig(
                kind="dipole",
                mean=float(mean) if mean is not None else None,
                stddev=float(std) if std is not None else None,
                activation="silu")
        if self.label_name == "r2":
            return HeadConfig(kind="electronic_spatial_extent",
                              activation="ssp")
        return HeadConfig(
            kind="atomwise",
            mean=float(mean or 0.0), stddev=float(std or 1.0),
            atomref=self.dataset_meta.get("atomref"),
            activation="silu")
