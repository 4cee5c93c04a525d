"""Molecule3D ground-state property task (``gotennet_tpu/tasks/molecule3d.py``):
graph-level scalar regression over the Molecule3D property columns with
the Atomwise head and the base task's losses and metrics."""

from __future__ import annotations

from typing import Any, Dict, Optional

from gotennet_tpu_torch.models.model import HeadConfig
from gotennet_tpu_torch.tasks.base import Task

__all__ = ["Molecule3DTask", "MOLECULE3D_TARGETS"]

# property columns of the Molecule3D distribution's properties CSV
MOLECULE3D_TARGETS = ["dipole_x", "dipole_y", "dipole_z",
                      "homo", "lumo", "gap", "scf_energy"]


class Molecule3DTask(Task):
    name = "Molecule3D"

    def __init__(self, label: Any, dataset_meta: Optional[Dict] = None,
                 task_config: Optional[Dict] = None):
        super().__init__(label, dataset_meta, task_config)
        if isinstance(label, str):
            if label not in MOLECULE3D_TARGETS:
                raise ValueError(
                    f"unknown Molecule3D target {label!r}; choose one "
                    f"of {MOLECULE3D_TARGETS}")
            self.label_name = label
        else:
            self.label_name = MOLECULE3D_TARGETS[int(label)]

    def build_head(self) -> HeadConfig:
        mean = self.dataset_meta.get("mean")
        std = self.dataset_meta.get("std")
        return HeadConfig(
            kind="atomwise",
            mean=float(mean or 0.0), stddev=float(std or 1.0),
            atomref=self.dataset_meta.get("atomref"),
            activation="silu")
