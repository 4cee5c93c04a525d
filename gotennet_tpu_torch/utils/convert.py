"""Weights between the JAX package and this package.

``state_dict_from_jax_params`` maps a flax parameter tree (nested dicts
of arrays, as ``GotenModel.init`` returns it) onto this package's state
dict, whose keys are the reference checkpoint's
(``representation.gata_list.0.W_q.weight``, ...).  Kernels are
transposed from JAX's ``[in, out]`` to torch's ``[out, in]``.  The
mapping is a local copy of ``_mapping`` / ``head_mapping`` in
``gotennet_tpu/utils/torch_convert.py``, every option of the
representation included (a trainable radial basis, ``layernorm``, the
update's MLP, ``edge_ln``, ``gamma_w`` and ``W_edp``, any ``evec_dim``);
one state dict serves the edge, dense and ELL layouts.  The head's mean,
stddev and atomref (Atomwise) and mass table (ESE) come from the
``HeadConfig``.  ``jax_params_from_state_dict``
is its inverse: a state dict back to the JAX package's parameter tree
(``{'params': {...}}`` of numpy arrays), which is what a checkpoint of
either package stores; the head it maps is the one
``head_config_from_state_dict`` reads off the state dict's keys and
shapes.  A dense model with ``scan_layers`` has its n-1 homogeneous layers
stacked under ``layers`` in the JAX package (``utils.params``):
``state_dict_from_jax_params`` takes either form, and
``jax_params_from_state_dict`` gives the stacked one for that layout.

``load_reference_checkpoint`` and ``load_reference_model`` read a
reference Lightning ``.ckpt`` (``gotennet_tpu/utils/torch_convert.py``):
its state dict already has this package's names, and its hyper-parameters
give the config.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gotennet_tpu_torch.models.gotennet import (GotenNetConfig,
                                               parse_edge_updates)
from gotennet_tpu_torch.ops.rbf import parameter_names
from gotennet_tpu_torch.models.heads import ATOMIC_MASSES
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.utils.params import (roll_layer_params,
                                             unroll_layer_params)

__all__ = ["state_dict_from_jax_params", "jax_params_from_state_dict",
           "head_config_from_state_dict", "stacked_layers",
           "load_reference_checkpoint", "load_reference_model"]

# the tasks whose heads differentiate the energy (forces)
_FORCE_TASKS = ("rMD17", "MD17", "MD22")


def stacked_layers(cfg: GotenNetConfig, layout: str) -> bool:
    """Whether the JAX package keeps this model's layers in the stacked
    form: ``scan_layers`` on the dense layout with more than one layer (its
    edge and ELL stacks ignore the flag)."""
    return cfg.scan_layers and layout == "dense" and cfg.n_interactions > 1


Entry = Tuple[str, tuple, bool]   # (torch key, flax path, transpose)


def _dense(torch_name: str, jax_path: tuple, bias: bool = True,
           norm: bool = False) -> List[Entry]:
    out = [(f"{torch_name}.weight", jax_path + ("linear", "kernel"), True)]
    if bias:
        out.append((f"{torch_name}.bias", jax_path + ("linear", "bias"), False))
    if norm:
        out.append((f"{torch_name}.norm.weight", jax_path + ("norm", "scale"),
                    False))
        out.append((f"{torch_name}.norm.bias", jax_path + ("norm", "bias"),
                    False))
    return out


def _mlp(torch_name: str, jax_path: tuple, n_layers: int,
         norm_hidden: bool = False) -> List[Entry]:
    out = []
    for i in range(n_layers):
        out += _dense(f"{torch_name}.dense_layers.{i}",
                      jax_path + (f"layers_{i}",),
                      norm=norm_hidden and i < n_layers - 1)
    return out


def _mapping(cfg: GotenNetConfig) -> List[Entry]:
    """Representation entries (keys without the 'representation.'
    prefix, paths from the representation subtree)."""
    info = parse_edge_updates(cfg.edge_updates)
    m: List[Entry] = [("A_na.weight", ("A_na",), False)]
    if cfg.trainable_rbf:
        for f in parameter_names(cfg.radial_basis):
            m.append((f"radial_basis.{f}", ("radial_basis", f), False))
    m.append(("node_init.A_nbr.weight", ("node_init", "A_nbr"), False))
    m += _dense("node_init.W_ndp.dense_layers.0", ("node_init", "W_ndp"))
    m += _mlp("node_init.W_nrd_nru", ("node_init", "W_nrd_nru"), 2,
              norm_hidden=True)
    m += _dense("edge_init.W_erp", ("edge_init", "W_erp"))
    for i in range(cfg.n_interactions):
        g, j = f"gata_list.{i}", (f"gata_{i}",)
        for t_name, j_name in (("gamma_s.0", "gamma_s_0"),
                               ("gamma_s.1", "gamma_s_1"), ("W_q", "W_q"),
                               ("W_k", "W_k"), ("gamma_v.0", "gamma_v_0"),
                               ("gamma_v.1", "gamma_v_1"), ("W_re", "W_re"),
                               ("W_rs", "W_rs")):
            m += _dense(f"{g}.{t_name}", j + (j_name,))
        if i < cfg.n_interactions - 1 and cfg.edge_updates:
            m += _mlp(f"{g}.gamma_t", j + ("gamma_t",),
                      2 if info["mlp"] or info["mlpa"] else 1,
                      norm_hidden=bool(cfg.edge_ln))
            m += _dense(f"{g}.W_vq", j + ("W_vq",), bias=False)
            if cfg.sep_htr:
                for l in range(cfg.lmax):
                    m += _dense(f"{g}.W_vk.{l}", j + (f"W_vk_{l}",),
                                bias=False)
            else:
                m += _dense(f"{g}.W_vk", j + ("W_vk",), bias=False)
            if info["lin_w"]:
                if info["lin_ln"] == 1:
                    # the reference's gamma_w Sequential, its LayerNorm at 0
                    m.append((f"{g}.gamma_w.0.weight",
                              j + ("gamma_w_ln", "scale"), False))
                    m.append((f"{g}.gamma_w.0.bias",
                              j + ("gamma_w_ln", "bias"), False))
                m += _dense(f"{g}.W_edp", j + ("W_edp",),
                            norm=info["lin_ln"] == 2)
        if cfg.layernorm:
            m.append((f"{g}.layernorm.weight", j + ("layernorm", "scale"),
                      False))
            m.append((f"{g}.layernorm.bias", j + ("layernorm", "bias"),
                      False))
        e, je = f"eqff_list.{i}", (f"eqff_{i}",)
        m += _dense(f"{e}.gamma_m.0", je + ("gamma_m_0",))
        m += _dense(f"{e}.gamma_m.1", je + ("gamma_m_1",))
        m += _dense(f"{e}.W_vu", je + ("W_vu",), bias=False)
    return m


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


_HEAD = "output_modules.0."


def _head_entries(kind: str, n_layers: int) -> List[Entry]:
    """The head's entries (torch keys with their prefix, flax paths from
    the model tree): the Atomwise and ESE MLP, or the Dipole's two gated
    blocks."""
    out: List[Entry] = []
    if kind == "dipole":
        for k in range(2):
            g, j = f"{_HEAD}equivariant_layers.{k}", ("head", f"eq_{k}")
            out += _dense(f"{g}.mix_vectors", j + ("mix_vectors",),
                          bias=False)
            out += _dense(f"{g}.scalar_net.0", j + ("scalar_net_0",))
            out += _dense(f"{g}.scalar_net.1", j + ("scalar_net_1",))
        return out
    if kind not in ("atomwise", "electronic_spatial_extent"):
        raise ValueError(f"unknown head kind {kind!r}")
    for i in range(n_layers):
        out += _dense(f"{_HEAD}out_net.1.out_net.{i}",
                      ("head", "out_net", f"dense_{i}"))
    return out


def head_config_from_state_dict(state_dict: Dict,
                                derivative: bool = False) -> HeadConfig:
    """The ``HeadConfig`` a state dict's head was built with, as far as its
    keys and shapes tell (the JAX package's ``head_config_from_state_dict``):
    the kind from its parameters (the Dipole's ``equivariant_layers``, the
    ESE's ``atomic_mass``), the MLP's depth and widths, the Atomwise
    standardisation and atomref; activations as the QM9 task wires them
    (silu, shifted softplus for the ESE).  ``derivative``: the head of a
    force task (its energy is differentiated), which the keys cannot
    tell."""
    pre = _HEAD
    key = f"{pre}equivariant_layers.0.mix_vectors.weight"
    if key in state_dict:
        return HeadConfig(kind="dipole",
                          n_hidden=int(state_dict[key].shape[0]) // 2,
                          activation="silu")
    kind = ("electronic_spatial_extent" if f"{pre}atomic_mass" in state_dict
            else "atomwise")
    widths = []
    while f"{pre}out_net.1.out_net.{len(widths)}.weight" in state_dict:
        widths.append(int(state_dict[
            f"{pre}out_net.1.out_net.{len(widths)}.weight"].shape[0]))
    if not widths:
        raise ValueError("the state dict has no recognisable output head")
    n_in = int(state_dict[f"{pre}out_net.1.out_net.0.weight"].shape[1])
    # pyramidal (n_hidden=None) where each hidden width halves the input
    pyramidal = all(w == n_in // 2 ** (j + 1)
                    for j, w in enumerate(widths[:-1]))
    hidden = None if pyramidal else tuple(widths[:-1])

    def scalar(name, default):
        t = state_dict.get(f"{pre}{name}")
        return default if t is None else float(np.asarray(
            t.detach().cpu() if isinstance(t, torch.Tensor) else t)[0])

    atomref = state_dict.get(f"{pre}atomref.weight")
    if isinstance(atomref, torch.Tensor):
        atomref = atomref.detach().cpu().numpy()
    return HeadConfig(
        kind=kind, n_out=widths[-1], n_layers=len(widths), n_hidden=hidden,
        mean=scalar("standardize.mean", 0.0),
        stddev=scalar("standardize.stddev", 1.0),
        atomref=None if atomref is None else np.asarray(atomref, np.float32),
        activation="silu" if kind == "atomwise" else "ssp",
        derivative=derivative)


def state_dict_from_jax_params(params: Dict, cfg: GotenNetConfig,
                               head: HeadConfig) -> Dict[str, torch.Tensor]:
    """Flax ``GotenModel`` params (with or without the outer 'params'
    key), its layers unrolled or stacked, -> this package's ``GotenModel``
    state dict."""
    tree = unroll_layer_params(params.get("params", params),
                               cfg.n_interactions)
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr, transpose):
        arr = np.array(arr, np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(
            arr.T if transpose else arr))

    for key, path, tr in _mapping(cfg):
        put("representation." + key, _get(tree["representation"], path), tr)
    head_tree = tree["head"]
    n_layers = len(head_tree["out_net"]) if "out_net" in head_tree else 0
    for key, path, tr in _head_entries(head.kind, n_layers):
        put(key, _get(tree, path), tr)
    if head.kind == "atomwise":
        put(f"{_HEAD}standardize.mean", [head.mean], False)
        put(f"{_HEAD}standardize.stddev", [head.stddev], False)
        if head.atomref is not None:
            table = np.asarray(head.atomref, np.float32)
            put(f"{_HEAD}atomref.weight", table[:, None] if table.ndim == 1
                else table, False)
    elif head.kind == "electronic_spatial_extent":
        put(f"{_HEAD}atomic_mass", ATOMIC_MASSES, False)
    return out


def jax_params_from_state_dict(state_dict: Dict[str, torch.Tensor],
                               cfg: GotenNetConfig,
                               layout: str = "dense") -> Dict:
    """This package's ``GotenModel`` state dict -> the JAX package's
    parameter tree ``{'params': {'representation': ..., 'head': ...}}`` of
    float32 numpy arrays (kernels transposed back to ``[in, out]``), the
    layers stacked where the JAX package's model of ``layout`` stacks them
    (``stacked_layers``).  The head's buffers (mean, stddev, atomref, the
    mass table) are not parameters there."""
    tree: Dict = {}

    def put(path, key, transpose):
        arr = state_dict[key].detach().cpu().to(torch.float32).numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if transpose else arr)

    for key, path, tr in _mapping(cfg):
        put(("representation",) + path, "representation." + key, tr)
    head = head_config_from_state_dict(state_dict)
    for key, path, tr in _head_entries(head.kind, head.n_layers):
        put(path, key, tr)
    if stacked_layers(cfg, layout):
        tree = roll_layer_params(tree, cfg.n_interactions)
    return {"params": tree}


def _parse_reference_ckpt(path: str):
    """``(cfg, state dict, hyper_parameters)`` of a reference Lightning
    ``.ckpt``: the config from ``hyper_parameters['representation']``
    (its ``_target_``, ``__target__`` and ``cutoff_fn`` dropped, the cutoff
    from ``hyper_parameters['cutoff']``, default 5.0; fields this package
    does not know left out; the rest at the JAX package's defaults, so
    ``fused`` is False)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    hp = ckpt.get("hyper_parameters", {})
    rep = dict(hp.get("representation", {}))
    for key in ("_target_", "__target__", "cutoff_fn"):
        rep.pop(key, None)
    rep.setdefault("cutoff", float(hp.get("cutoff", 5.0)))
    rep.setdefault("fused", False)
    known = {f.name for f in dataclasses.fields(GotenNetConfig)}
    cfg = GotenNetConfig(**{k: v for k, v in rep.items() if k in known})
    state_dict = {k: torch.as_tensor(v) for k, v in
                  ckpt["state_dict"].items()}
    return cfg, state_dict, hp


def load_reference_checkpoint(path: str
                              ) -> Tuple[GotenNetConfig,
                                         Dict[str, torch.Tensor]]:
    """``(cfg, state dict)`` of a reference Lightning ``.ckpt``: the whole
    state dict, representation and head, on the CPU."""
    cfg, state_dict, _ = _parse_reference_ckpt(path)
    return cfg, state_dict


def load_reference_model(path: str,
                         device: Optional[str | torch.device] = None
                         ) -> Tuple[GotenModel, Dict]:
    """A reference Lightning ``.ckpt`` as a ``GotenModel`` on the edge-list
    layout (the JAX package's default) with its weights, representation and
    head, on ``device`` (None means ``cuda``), and the checkpoint's
    ``hyper_parameters``.  The head comes from the state dict's keys; a
    force task's (rMD17, MD17, MD22) differentiates the energy."""
    cfg, state_dict, hp = _parse_reference_ckpt(path)
    head = head_config_from_state_dict(
        state_dict, derivative=str(hp.get("task", "QM9")) in _FORCE_TASKS)
    model = GotenModel(cfg, head, "edge", device=device)
    # keys the model has no use for are left out, as the JAX package's
    # converter reads only the ones it maps; a missing one raises
    missing, _ = model.load_state_dict(state_dict, strict=False)
    if missing:
        raise KeyError(f"{path} lacks {missing}")
    return model, hp
