"""Logging helpers and the metric logger (``gotennet_tpu/utils/logging.py``).

``get_logger`` is rank-zero aware: in a ``torch.distributed`` run only
rank 0 logs at info level.  ``MetricLogger`` always writes
``metrics.jsonl`` and can mirror each record to CSV (one file per phase),
W&B, MLflow, Neptune, Comet and TensorBoard; a comma-separated backend
string turns on several.  The tracking services import when asked for;
an import or set-up that fails raises (nothing is skipped silently).
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Dict

import numpy as np

__all__ = ["get_logger", "is_main_process", "MetricLogger", "make_logger"]

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def is_main_process() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def get_logger(name: str = "gotennet_tpu_torch") -> logging.Logger:
    """Rank-zero-aware logger (other ranks log warnings and up)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO if is_main_process()
                        else logging.WARNING)
        logger.propagate = False
    return logger


def _scalarize(record: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in record.items():
        if isinstance(v, (int, np.integer)):
            out[k] = int(v)
        elif isinstance(v, (float, np.floating)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _finite_numbers(rec: Dict[str, Any]) -> Dict[str, float]:
    return {k: v for k, v in rec.items()
            if isinstance(v, (int, float)) and np.isfinite(v)}


class MetricLogger:
    """Structured metric sink: JSONL always, CSV / W&B / MLflow / Neptune /
    Comet / TensorBoard on request.  Writes nothing on ranks other than 0."""

    def __init__(self, workdir: str, backend: str = "jsonl",
                 tensorboard: bool = False):
        self.workdir = workdir
        self._main = is_main_process()
        self._jsonl = None
        self._csv_enabled = False
        self._csv_files: Dict[str, Any] = {}   # phase -> (file, columns)
        self._wandb = self._mlflow = self._neptune = None
        self._comet = self._tb = None
        if not self._main:
            return
        os.makedirs(workdir, exist_ok=True)
        self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a")
        backends = {b.strip() for b in backend.split(",") if b.strip()}
        self._csv_enabled = "csv" in backends
        if "wandb" in backends:
            import wandb
            self._wandb = wandb.init(
                project=os.environ.get("WANDB_PROJECT", "gotennet_tpu"),
                dir=workdir, resume="allow")
        if "mlflow" in backends:
            import mlflow
            mlflow.set_tracking_uri(os.environ.get(
                "MLFLOW_TRACKING_URI",
                "file://" + os.path.join(workdir, "mlruns")))
            mlflow.set_experiment(os.environ.get("MLFLOW_EXPERIMENT",
                                                 "gotennet_tpu"))
            self._mlflow = mlflow
            mlflow.start_run()
        if "neptune" in backends:
            import neptune
            self._neptune = neptune.init_run(
                project=os.environ.get("NEPTUNE_PROJECT"),
                name=os.environ.get("NEPTUNE_RUN_NAME"))
        if "comet" in backends:
            import comet_ml
            self._comet = comet_ml.Experiment(
                project_name=os.environ.get("COMET_PROJECT", "gotennet_tpu"))
        if tensorboard or "tensorboard" in backends:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(os.path.join(workdir, "tb"))

    def log(self, record: Dict[str, Any]) -> None:
        if not self._main:
            return
        rec = _scalarize(record)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        step = int(rec.get("step", 0))
        phase = rec.get("phase", "misc")
        if self._csv_enabled:
            # one CSV per phase: train and val_epoch records have
            # different keys
            entry = self._csv_files.get(phase)
            if entry is None:
                f = open(os.path.join(self.workdir, f"metrics_{phase}.csv"),
                         "a")
                cols = sorted(rec)
                f.write(",".join(cols) + "\n")
                entry = self._csv_files[phase] = (f, cols)
            f, cols = entry
            f.write(",".join(str(rec.get(c, "")) for c in cols) + "\n")
            f.flush()
        if self._wandb is not None:
            self._wandb.log({f"{phase}/{k}": v for k, v in rec.items()
                             if isinstance(v, (int, float))}, step=step)
        if self._mlflow is not None:
            self._mlflow.log_metrics(
                {f"{phase}/{k}": float(v)
                 for k, v in _finite_numbers(rec).items()}, step=step)
        if self._neptune is not None:
            for k, v in _finite_numbers(rec).items():
                self._neptune[f"{phase}/{k}"].append(v, step=step)
        if self._comet is not None:
            self._comet.log_metrics(_finite_numbers(rec), prefix=phase,
                                    step=step)
        if self._tb is not None:
            for k, v in _finite_numbers(rec).items():
                if k not in ("phase", "step", "epoch"):
                    self._tb.add_scalar(f"{phase}/{k}", v, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        for f, _ in self._csv_files.values():
            f.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._mlflow is not None:
            self._mlflow.end_run()
        if self._neptune is not None:
            self._neptune.stop()
        if self._comet is not None:
            self._comet.end()


def make_logger(workdir: str, backend: str = "jsonl",
                tensorboard: bool = False) -> MetricLogger:
    return MetricLogger(workdir, backend, tensorboard=tensorboard)
