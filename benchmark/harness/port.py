"""The program under test, built from a configuration file: its model
configuration, head, task and dataset.  The only module of the harness
that imports the program besides the loops under ``traffic/``."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

PORT_MODEL_KEYS = ("n_atom_basis", "n_interactions", "lmax", "num_heads",
                   "n_rbf", "cutoff", "radial_basis", "activation", "max_z",
                   "weight_init", "bias_init", "attn_dropout",
                   "edge_updates", "scale_edge", "aggr", "sep_htr",
                   "sep_dir", "sep_tensor", "max_num_neighbors")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def model_config(cfg: dict, path: str):
    """The program's ``GotenNetConfig`` of the configuration's ``path``
    (``train`` or ``serve``)."""
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    m, p = cfg["model"], cfg["paths"][path]
    kw = {k: m[k] for k in PORT_MODEL_KEYS}
    kw.update(fused=p["fused"], fused_htr=p["fused_htr"], remat=p["remat"],
              pair_dtype=DTYPES[p["pair_dtype"]],
              node_dtype=DTYPES[p["node_dtype"]])
    return GotenNetConfig(**kw)


def head_config(cfg: dict, mean: float, stddev: float):
    from gotennet_tpu_torch.models.model import HeadConfig
    h = cfg["head"]
    return HeadConfig(kind=h["kind"], n_hidden=cfg["model"]["head_hidden"],
                      activation=h["activation"], mean=mean, stddev=stddev,
                      derivative=h["derivative"])


def task(cfg: dict):
    t = cfg["task"]
    if t["kind"] == "force":
        from gotennet_tpu_torch.tasks.force_task import MD22Task
        return MD22Task(t["label"], task_config={
            "task_loss": t["loss"], "energy_weight": t["energy_weight"],
            "force_weight": t["force_weight"]})
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    return QM9Task(t["label"], task_config={"task_loss": t["loss"]})


def dataset(pool: Sequence[tuple], forces: bool):
    from gotennet_tpu_torch.data.dataset import MoleculeDataset
    return MoleculeDataset(
        z=[m[0] for m in pool], pos=[m[1] for m in pool],
        y=np.asarray([[m[2]] for m in pool], np.float32),
        dy=[m[3] for m in pool] if forces else None)
