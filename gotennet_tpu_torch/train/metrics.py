"""Streaming metric accumulators in float64 (``gotennet_tpu/train/metrics.py``).

Sums of ``|e|`` and ``e^2`` and the count of real entries accumulate on
the host across batches; ``compute`` divides.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["MetricAccumulator"]


@dataclasses.dataclass
class MetricAccumulator:
    """Accumulates masked absolute and squared error sums."""

    abs_sum: float = 0.0
    sq_sum: float = 0.0
    count: float = 0.0

    def update(self, pred: np.ndarray, target: np.ndarray,
               mask: np.ndarray) -> None:
        p = np.asarray(pred, np.float64)
        t = np.asarray(target, np.float64)
        m = np.asarray(mask, np.float64)
        err = (p - t) * m
        self.abs_sum += float(np.abs(err).sum())
        self.sq_sum += float((err ** 2).sum())
        self.count += float(m.sum())

    def compute(self) -> Dict[str, float]:
        n = max(self.count, 1.0)
        return {"mae": self.abs_sum / n, "mse": self.sq_sum / n}

    def reset(self) -> None:
        self.abs_sum = self.sq_sum = self.count = 0.0
