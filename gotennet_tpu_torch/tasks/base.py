"""Task interface (``gotennet_tpu/tasks/base.py``): head construction
for a graph-level scalar property."""

from __future__ import annotations

from typing import Any, Dict, Optional

from gotennet_tpu_torch.models.model import HeadConfig

__all__ = ["Task"]


class Task:
    """Base task: single graph-level scalar property."""

    name = "base"

    def __init__(self, label: Any, dataset_meta: Optional[Dict] = None,
                 task_config: Optional[Dict] = None):
        self.label = label
        self.dataset_meta = dataset_meta or {}
        self.task_config = task_config or {}

    def build_head(self) -> HeadConfig:
        mean = float(self.dataset_meta.get("mean") or 0.0)
        std = float(self.dataset_meta.get("std") or 1.0)
        return HeadConfig(kind="atomwise", mean=mean, stddev=std,
                          atomref=self.dataset_meta.get("atomref"))
