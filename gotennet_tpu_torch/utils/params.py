"""Parameter trees between the unrolled and the layer-stacked forms.

Counterpart of ``gotennet_tpu/utils/params.py``, on trees of numpy arrays.
``GotenNetConfig.scan_layers`` makes the JAX package's dense stack one
``lax.scan`` over the n-1 homogeneous (GATA + EQFF) layers, whose
parameters live under one ``layers`` collection with a leading layer axis:

    unrolled:   rep/gata_0 ... rep/gata_{n-2}, rep/eqff_0 ...    (+ last)
    stacked:    rep/layers/gata [n-1, ...], rep/layers/eqff [n-1, ...]

The last layer (no edge update) keeps its ``gata_{n-1}`` / ``eqff_{n-1}``
names in both forms.  This package keeps one module per layer in either
case; the stacked form lives only where its trees meet the JAX package's
(``utils.convert``, checkpoints).
"""

from __future__ import annotations

import numpy as np

__all__ = ["roll_layer_params", "unroll_layer_params",
           "convert_layer_params"]


def _rep_view(tree):
    """The representation subtree of ``{'params': {'representation': ...}}``,
    ``{'representation': ...}`` or the subtree itself, and its path."""
    node, path = tree, []
    for key in ("params", "representation"):
        if isinstance(node, dict) and key in node:
            path.append(key)
            node = node[key]
    return node, path


def _replace(tree, path, new_rep):
    if not path:
        return new_rep
    out = dict(tree)
    cur = out
    for key in path[:-1]:
        cur[key] = dict(cur[key])
        cur = cur[key]
    cur[path[-1]] = new_rep
    return out


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested dicts)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def roll_layer_params(params, n_interactions: int):
    """Unrolled ``gata_i`` / ``eqff_i`` (i < n-1) -> the stacked ``layers``
    collection (leading axis n-1).  The last layer is untouched; a tree
    already stacked comes back as it is."""
    rep, path = _rep_view(params)
    if "layers" in rep:
        return params
    rep = dict(rep)
    n = n_interactions
    gata = [rep.pop(f"gata_{i}") for i in range(n - 1)]
    eqff = [rep.pop(f"eqff_{i}") for i in range(n - 1)]
    stack = lambda *xs: np.stack([np.asarray(x) for x in xs])
    rep["layers"] = {"gata": _map(stack, *gata), "eqff": _map(stack, *eqff)}
    return _replace(params, path, rep)


def unroll_layer_params(params, n_interactions: int):
    """Inverse of :func:`roll_layer_params`; a tree already unrolled comes
    back as it is."""
    rep, path = _rep_view(params)
    if "layers" not in rep:
        return params
    rep = dict(rep)
    layers = rep.pop("layers")
    for i in range(n_interactions - 1):
        rep[f"gata_{i}"] = _map(lambda x, i=i: np.asarray(x)[i],
                                layers["gata"])
        rep[f"eqff_{i}"] = _map(lambda x, i=i: np.asarray(x)[i],
                                layers["eqff"])
    return _replace(params, path, rep)


def convert_layer_params(params, n_interactions: int, scan_layers: bool):
    """``params`` in the form ``scan_layers`` asks for."""
    if scan_layers:
        return roll_layer_params(params, n_interactions)
    return unroll_layer_params(params, n_interactions)
