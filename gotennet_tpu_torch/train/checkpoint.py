"""Checkpoints in the JAX package's NPZ form (``gotennet_tpu/train/checkpoint.py``).

A checkpoint directory describes itself:

  * ``params.npz``: the JAX parameter tree (``utils.convert``'s
    ``jax_params_from_state_dict``), paths joined with ``/``; a dense model
    with ``scan_layers`` keeps its n-1 homogeneous layers under
    ``representation/layers/{gata,eqff}/...`` with a leading axis n-1, as
    the JAX package's scanned model does;
  * ``meta.json``: ``format_version`` 2, ``step``, the model
    (``representation``: exactly the JAX ``GotenNetConfig`` fields without
    dtypes; ``head``, ``layout``, ``has_atomref``), ``task``, ``label`` and
    the trainer's ``train_state``;
  * ``atomref.npz``: the head's atomref table, when it has one.

So the JAX package's ``load_checkpoint`` reads what this module writes,
and this module reads the NPZ form the JAX package writes in multi-process
runs.  The orbax directory a single-process JAX run writes cannot be read
here and raises.

What the JAX package does not read stays out of its way:
``has_opt_state`` is False (the AdamW moments are torch's, in
``torch_opt_state.pt``), the dropout generator's state is ``train_state``'s
``generator`` (JAX keeps a key under ``rng``), and ``dtypes`` records the
pair and node types, which the JAX package leaves to the caller (its
checkpoints load as float32).  ``fused`` is always written: its default is
True here and False in the JAX package, so a checkpoint without it reads
as False.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.utils.convert import (jax_params_from_state_dict,
                                              state_dict_from_jax_params)

__all__ = ["save_checkpoint", "load_checkpoint", "load_meta",
           "load_train_state"]

OPT_STATE_FILE = "torch_opt_state.pt"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _flatten_dict(d: dict, prefix: str = ""):
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flatten_dict(v, key)
        else:
            yield key, np.asarray(v)


def _unflatten_dict(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _config_to_json(model: GotenModel) -> dict:
    """The model's part of ``meta.json``."""
    cfg = dataclasses.asdict(model.cfg)
    # the sharding axis is how a run was laid out, not the model: a
    # checkpoint loads on any number of devices
    cfg.pop("edge_axis", None)
    dtypes = {k: str(cfg.pop(k)).replace("torch.", "")
              for k in ("pair_dtype", "node_dtype")}
    head = dataclasses.asdict(model.head)
    head.pop("atomref", None)
    if not isinstance(head["activation"], str):
        head["activation"] = str(head["activation"])
    return {"representation": cfg, "head": head, "layout": model.layout,
            "has_atomref": model.head.atomref is not None, "dtypes": dtypes}


def save_checkpoint(path: str, model: GotenModel, step: int = 0,
                    extra_meta: Optional[dict] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    train_state: Optional[dict] = None) -> None:
    """Write ``model`` (and the optimizer's state, and ``train_state``: a
    JSON-able dict) into the directory ``path``.  ``extra_meta`` carries
    the run's task and label."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    params = jax_params_from_state_dict(model.state_dict(), model.cfg,
                                        model.layout)
    np.savez(os.path.join(path, "params.npz"), **dict(_flatten_dict(params)))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(path, OPT_STATE_FILE))
    meta = {"step": int(step), "format_version": 2, "has_opt_state": False}
    if train_state is not None:
        meta["train_state"] = train_state
    meta.update(_config_to_json(model))
    if model.head.atomref is not None:
        np.savez(os.path.join(path, "atomref.npz"),
                 atomref=np.asarray(model.head.atomref))
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_meta(path: str) -> dict:
    with open(os.path.join(os.path.abspath(path), "meta.json")) as f:
        return json.load(f)


def _load_params(path: str) -> dict:
    npz = os.path.join(path, "params.npz")
    if not os.path.exists(npz):
        if os.path.isdir(os.path.join(path, "params")):
            raise ValueError(
                f"{path} holds its parameters as an orbax directory, which "
                "this package cannot read; save the checkpoint in the NPZ "
                "form (params.npz), as the JAX package does in "
                "multi-process runs")
        raise FileNotFoundError(f"no params.npz under {path}")
    with np.load(npz) as f:
        return _unflatten_dict({k: f[k] for k in f.files})


def load_checkpoint(path: str,
                    device: Optional[str | torch.device] = None
                    ) -> Tuple[Optional[GotenModel], Dict, int]:
    """``(model, state_dict, step)``.  The model is rebuilt from the
    checkpoint's own config on ``device`` (None means ``cuda``) with its
    weights loaded; a checkpoint without a config gives ``(None, the JAX
    parameter tree, step)``."""
    path = os.path.abspath(path)
    meta = load_meta(path)
    params = _load_params(path)
    if "representation" not in meta:
        return None, params, meta.get("step", 0)
    rep = dict(meta["representation"])
    rep.setdefault("fused", False)   # the JAX package's default
    for key, name in (meta.get("dtypes") or {}).items():
        rep[key] = _DTYPES[name]
    cfg = GotenNetConfig(**rep)
    head_kw = dict(meta["head"])
    if meta.get("has_atomref"):
        head_kw["atomref"] = np.load(
            os.path.join(path, "atomref.npz"))["atomref"]
    head = HeadConfig(**head_kw)
    model = GotenModel(cfg, head, meta.get("layout", "edge"), device=device)
    state_dict = state_dict_from_jax_params(params, cfg, head)
    model.load_state_dict(state_dict)
    return model, model.state_dict(), meta.get("step", 0)


def load_train_state(path: str,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> Optional[dict]:
    """The checkpoint's ``train_state``; with ``optimizer``, its AdamW state
    is restored too (a checkpoint without one leaves it as it is)."""
    path = os.path.abspath(path)
    opt_file = os.path.join(path, OPT_STATE_FILE)
    if optimizer is not None and os.path.exists(opt_file):
        device = optimizer.param_groups[0]["params"][0].device
        optimizer.load_state_dict(torch.load(opt_file, map_location=device))
    return load_meta(path).get("train_state")
