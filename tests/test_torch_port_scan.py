"""``scan_layers`` in the port against the JAX package.

``utils.params``' roll and unroll against JAX's on one tree; the port's
dense model with ``scan_layers=True`` (fused and unfused) from JAX's
scanned init (the stacked tree ``state_dict_from_jax_params`` takes)
against JAX's scanned ``GotenModel``: outputs at 1e-5 of their scale in
float32 (the same math, sums in another order) and parameter gradients in
the stacked form at JAX's own tolerance between its scanned and unrolled
stacks (rtol 2e-4, atol 2e-5, ``tests/test_dense.py``); the edge and ELL
layouts keep unrolled trees with the flag set, as JAX's; NPZ checkpoints of
a scanned dense model both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.graph.neighborlist import collate_graphs as j_collate
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.train import checkpoint as jckpt
from gotennet_tpu.utils import params as jparams

from gotennet_tpu_torch.data.dataset import DenseLoader, synthetic_molecules
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.train import checkpoint
from gotennet_tpu_torch.utils import params
from gotennet_tpu_torch.utils.convert import (jax_params_from_state_dict,
                                              state_dict_from_jax_params,
                                              stacked_layers)

SMALL = dict(n_atom_basis=32, n_interactions=3, lmax=2, num_heads=4,
             n_rbf=8)
SIZES = dict(min_atoms=4, max_atoms=12)
HEAD = dict(mean=0.5, stddev=2.0)


def _flat(tree, prefix=""):
    return dict(jckpt._flatten_dict(tree, prefix))


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(value), err_msg=key)


def _dense_batches(n=3):
    return (next(iter(JDenseLoader(j_synthetic(n, seed=2, **SIZES), n))),
            next(iter(DenseLoader(synthetic_molecules(n, seed=2, **SIZES),
                                  n))))


def _jax_init(cfg_kw, layout="dense", seed=0):
    jmodel = JModel(JConfig(**cfg_kw), JHead(**HEAD), layout=layout)
    jbatch, _ = _dense_batches()
    if layout == "ell":
        jbatch = next(iter(JELLLoader(j_synthetic(2, seed=2, **SIZES), 2,
                                      neighbor_probe="full")))
    elif layout == "edge":
        jbatch = j_collate(j_synthetic(2, seed=2, **SIZES).graph_dicts(
            range(2)), 32, 512, 2)
    return jmodel, jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jbatch))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_roll_and_unroll_match_jax(n):
    _, tree = _jax_init({**SMALL, "n_interactions": n})
    rolled = params.roll_layer_params(tree, n)
    _assert_same_tree(rolled, jparams.roll_layer_params(tree, n))
    rep = rolled["params"]["representation"]
    assert {f"gata_{n - 1}", f"eqff_{n - 1}", "layers"} <= set(rep)
    assert not any(f"gata_{i}" in rep for i in range(n - 1))
    for leaf in _flat(rep["layers"]).values():
        assert leaf.shape[0] == n - 1
    # the representation subtree alone, and either form from the other
    _assert_same_tree(params.roll_layer_params(
        tree["params"]["representation"], n), rep)
    _assert_same_tree(params.unroll_layer_params(rolled, n), tree)
    _assert_same_tree(params.unroll_layer_params(rolled, n),
                      jparams.unroll_layer_params(rolled, n))
    assert params.roll_layer_params(rolled, n) is rolled
    assert params.unroll_layer_params(tree, n) is tree
    _assert_same_tree(params.convert_layer_params(tree, n, True), rolled)
    _assert_same_tree(params.convert_layer_params(rolled, n, False), tree)


def _port_grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("kw", [dict(fused=True), dict(fused=False),
                                dict(fused=True, fused_htr=True,
                                     remat=False)])
def test_scanned_dense_model_matches_jax(kw):
    """JAX's scanned init (stacked) -> the port; outputs, then the gradients
    of the same loss, the port's stacked by ``jax_params_from_state_dict``
    against JAX's scanned gradients."""
    cfg_kw = {**SMALL, **kw, "scan_layers": True}
    jmodel, jtree = _jax_init(cfg_kw, seed=3)
    assert "layers" in jtree["params"]["representation"]
    jbatch, batch = _dense_batches()
    cfg = GotenNetConfig(**cfg_kw)
    model = GotenModel(cfg, HeadConfig(**HEAD), "dense", device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jtree, cfg,
                                                     HeadConfig(**HEAD)))
    jout = jax.jit(jmodel.apply)(jtree, jbatch)
    model.train()
    out = model(batch)
    for key in ("property", "representation", "vector_representation"):
        want = np.asarray(jout[key])
        got = out[key].detach().numpy()
        assert got.shape == want.shape, key
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key

    def loss(p):
        return jnp.sum(jmodel.apply(p, jbatch)["property"] ** 2)

    jgrads = jax.device_get(jax.jit(jax.grad(loss))(jtree))
    torch.sum(out["property"] ** 2).backward()
    grads = jax_params_from_state_dict(_port_grads(model), cfg, "dense")
    got, want = _flat(grads), _flat(jgrads)
    assert got.keys() == want.keys()
    assert any(k.startswith("params/representation/layers/gata/")
               for k in got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=2e-4, atol=2e-5,
                                   err_msg=key)


@pytest.mark.parametrize("layout", ["edge", "ell"])
def test_edge_and_ell_trees_stay_unrolled_as_jax(layout):
    cfg_kw = {**SMALL, "scan_layers": True, "fused": False}
    _, jtree = _jax_init(cfg_kw, layout=layout)
    rep = jtree["params"]["representation"]
    assert "layers" not in rep and "gata_0" in rep
    cfg = GotenNetConfig(**cfg_kw)
    assert not stacked_layers(cfg, layout) and stacked_layers(cfg, "dense")
    head = HeadConfig(**HEAD)
    model = GotenModel(cfg, head, layout, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jtree, cfg, head))
    _assert_same_tree(
        jax_params_from_state_dict(model.state_dict(), cfg, layout), jtree)
    # one layer: nothing to scan, as JAX's ``n > 1`` condition
    assert not stacked_layers(dataclasses.replace(cfg, n_interactions=1),
                              "dense")


def test_jax_loads_a_scanned_port_checkpoint(tmp_path):
    cfg = GotenNetConfig(**SMALL, scan_layers=True)
    model = GotenModel(cfg, HeadConfig(**HEAD), "dense", device="cpu", seed=4)
    checkpoint.save_checkpoint(str(tmp_path), model, step=2,
                               extra_meta={"task": "QM9", "label": "U0"})
    with np.load(tmp_path / "params.npz") as f:
        keys = set(f.files)
        kernel = f["params/representation/layers/gata/W_q/linear/kernel"]
    assert kernel.shape == (2, 32, 32)
    assert "params/representation/gata_2/W_q/linear/kernel" in keys
    assert not any(k.startswith("params/representation/gata_0/") for k in keys)
    jmodel, jtree, _ = jckpt.load_checkpoint(str(tmp_path))
    assert jmodel.cfg.scan_layers and jmodel.layout == "dense"
    jbatch, batch = _dense_batches()
    want = np.asarray(jax.jit(jmodel.apply)(jtree, jbatch)["property"])
    with torch.no_grad():
        got = model(batch)["property"].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    loaded, state, _ = checkpoint.load_checkpoint(str(tmp_path), "cpu")
    assert loaded.cfg.scan_layers
    for key, value in model.state_dict().items():
        assert torch.equal(state[key], value), key


def test_a_scanned_jax_npz_checkpoint_loads_into_the_port(tmp_path,
                                                         monkeypatch):
    cfg_kw = {**SMALL, "scan_layers": True, "fused": True}
    jmodel, jtree = _jax_init(cfg_kw, seed=5)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    jckpt.save_checkpoint(str(tmp_path), jtree, step=3, model=jmodel,
                          extra_meta={"task": "QM9", "label": "U0"})
    model, _, step = checkpoint.load_checkpoint(str(tmp_path), "cpu")
    assert step == 3 and model.cfg.scan_layers and model.layout == "dense"
    jbatch, batch = _dense_batches()
    want = np.asarray(jax.jit(jmodel.apply)(jtree, jbatch)["property"])
    with torch.no_grad():
        got = model(batch)["property"].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    _assert_same_tree(jax_params_from_state_dict(model.state_dict(),
                                                 model.cfg, "dense"), jtree)
