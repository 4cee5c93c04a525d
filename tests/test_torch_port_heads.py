"""The port's output heads against the JAX package's.

The Dipole head (QM9's 'mu': its magnitude, and the vector), the
electronic spatial extent (QM9's 'r2') and the per-atom Atomwise output
(``aggregation=None``), each from one JAX init carried across by
``state_dict_from_jax_params``, on the dense and the ELL layout; the weight
conversion both ways; ``Trainer.evaluate`` of the two QM9 tasks; a 'mu'
checkpoint read by JAX's ``load_checkpoint``; ``cli train`` / ``cli test``
of ``qm9_u0_tpu`` with ``label=mu`` and ``label=r2``.  Float32 throughout:
the same arithmetic, sums in another order, so outputs agree at 1e-5 of
their scale and the evaluations at rtol 1e-5.
"""

import json

import jax
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.tasks.qm9 import QM9Task as JQM9Task
from gotennet_tpu.train import checkpoint as jckpt
from gotennet_tpu.train.trainer import Trainer as JTrainer
from gotennet_tpu.train.trainer import TrainerConfig as JTrainerConfig
from gotennet_tpu.utils import torch_convert as jconvert

from gotennet_tpu_torch import cli
from gotennet_tpu_torch.data.dataset import (DenseLoader, ELLLoader,
                                             synthetic_molecules)
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.heads import ATOMIC_MASSES
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.tasks.qm9 import QM9Task
from gotennet_tpu_torch.train import checkpoint
from gotennet_tpu_torch.train.trainer import Trainer, TrainerConfig
from gotennet_tpu_torch.utils.convert import (head_config_from_state_dict,
                                              jax_params_from_state_dict,
                                              state_dict_from_jax_params)

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
SIZES = dict(min_atoms=5, max_atoms=12)
META = {"mean": 0.3, "std": 2.0}
HEADS = {
    "mu": dict(kind="dipole", mean=0.3, stddev=2.0, activation="silu"),
    "dipole_vector": dict(kind="dipole", predict_magnitude=False,
                          n_hidden=16),
    "r2": dict(kind="electronic_spatial_extent", activation="ssp",
               n_hidden=24),
    "per_atom": dict(kind="atomwise", aggregation=None, mean=0.5, stddev=2.0,
                     atomref=np.linspace(-2.0, 1.0, 100, dtype=np.float32)),
}
# what each head returns beside 'property'
EXTRAS = {"dipole": "property_vector", "electronic_spatial_extent":
          "contributions", "atomwise": "contributions"}

_PARAMS = {}


def _batches(layout, n=3, seed=1):
    ds_j, ds = (j_synthetic(n, seed=seed, **SIZES),
                synthetic_molecules(n, seed=seed, **SIZES))
    if layout == "dense":
        return next(iter(JDenseLoader(ds_j, 4))), next(iter(DenseLoader(ds,
                                                                          4)))
    return (next(iter(JELLLoader(ds_j, n, neighbor_probe="full"))),
            next(iter(ELLLoader(ds, n))))


def jax_params(name):
    """One JAX init per head; the dense and ELL models share its tree."""
    if name not in _PARAMS:
        jbatch, _ = _batches("dense")
        model = JModel(JConfig(**SMALL), JHead(**HEADS[name]),
                       layout="dense")
        _PARAMS[name] = jax.jit(model.init)(jax.random.PRNGKey(0), jbatch)
    return _PARAMS[name]


def _port_model(name, params, layout="dense", cfg=None):
    cfg = cfg or GotenNetConfig(**SMALL)
    head = HeadConfig(**HEADS[name])
    model = GotenModel(cfg, head, layout, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg, head))
    return model


def _assert_scaled(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("layout", ["dense", "ell"])
@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_jax(name, layout):
    jbatch, batch = _batches(layout)
    params = jax_params(name)
    jout = jax.jit(JModel(JConfig(**SMALL), JHead(**HEADS[name]),
                          layout=layout).apply)(params, jbatch)
    model = _port_model(name, params, layout)
    with torch.no_grad():
        out = model(batch)
    extra = EXTRAS[model.head.kind]
    for key in ("property", extra, "representation"):
        _assert_scaled(out[key].numpy(), jout[key], 1e-5, key)
    n_nodes = out["representation"].shape[0]
    if name == "per_atom":
        assert out["property"].shape == (n_nodes, 1)
    elif name == "dipole_vector":
        assert out["property"].shape == (batch.num_graphs, 3)
    else:
        assert out["property"].shape == (batch.num_graphs, 1)


@pytest.mark.parametrize("name", list(HEADS))
def test_weight_conversion_there_and_back(name):
    """state_dict_from_jax_params then jax_params_from_state_dict gives the
    JAX tree back bit for bit, and the head read off the state dict is the
    one JAX reads off the reference state dict."""
    params = jax_params(name)
    cfg, head = GotenNetConfig(**SMALL), HeadConfig(**HEADS[name])
    sd = state_dict_from_jax_params(params, cfg, head)
    back = jax_params_from_state_dict(sd, cfg)["params"]
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    # the reference state dict (JAX's converter) names the same tensors;
    # the ESE carries its mass table and no standardisation there
    jhead = JHead(**HEADS[name])
    jsd = jconvert.model_params_to_state_dict(params, JConfig(**SMALL), jhead)
    if head.kind == "electronic_spatial_extent":
        jsd = {k: v for k, v in jsd.items() if "standardize" not in k}
        jsd["output_modules.0.atomic_mass"] = ATOMIC_MASSES
    assert set(sd) == set(jsd)
    for key, value in jsd.items():
        np.testing.assert_array_equal(sd[key].numpy(), value)
    got = head_config_from_state_dict(sd)
    want = jconvert.head_config_from_state_dict(jsd)
    for field in ("kind", "n_out", "n_layers", "n_hidden", "activation",
                  "mean", "stddev"):
        assert getattr(got, field) == getattr(want, field), field
    model = GotenModel(cfg, got, device="cpu")
    model.load_state_dict(sd)       # the recovered head takes the weights


@pytest.mark.parametrize("label", ["mu", "r2"])
def test_trainer_evaluate_matches_jax(tmp_path, label):
    """QM9Task's head for the label and its loss and metrics over two
    batches, against JAX's Trainer.evaluate (rtol 1e-5)."""
    n = 10
    jds, ds = (j_synthetic(n, seed=4, **SIZES),
               synthetic_molecules(n, seed=4, **SIZES))
    jtask, task = JQM9Task(label, dataset_meta=META), QM9Task(
        label, dataset_meta=META)
    jhead, head = jtask.build_head(), task.build_head()
    assert head == HeadConfig(**{k: getattr(jhead, k) for k in (
        "kind", "mean", "stddev", "activation")})
    jloader = JDenseLoader(jds, 5)
    jmodel = JModel(JConfig(**SMALL), jhead, layout="dense")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2),
                                  next(iter(jloader)))
    want = JTrainer(jmodel, jtask, JTrainerConfig(
        workdir=str(tmp_path / "jax"))).evaluate(params, jloader)
    cfg = GotenNetConfig(**SMALL)
    model = GotenModel(cfg, head, device="cpu")
    got = Trainer(model, task, TrainerConfig(
        workdir=str(tmp_path / "port"))).evaluate(
            state_dict_from_jax_params(params, cfg, head),
            DenseLoader(ds, 5))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)


def test_jax_loads_a_mu_checkpoint(tmp_path):
    jbatch, batch = _batches("dense")
    task = QM9Task("mu", dataset_meta=META)
    model = GotenModel(GotenNetConfig(**SMALL), task.build_head(),
                       device="cpu", seed=5)
    checkpoint.save_checkpoint(str(tmp_path), model, step=3,
                               extra_meta={"task": "QM9", "label": "mu"})
    jmodel, params, step = jckpt.load_checkpoint(str(tmp_path))
    assert step == 3 and jmodel.head.kind == "dipole"
    assert jmodel.head.mean == META["mean"]
    want = jax.jit(jmodel.apply)(params, jbatch)["property"]
    with torch.no_grad():
        _assert_scaled(model(batch)["property"].numpy(), want, 1e-5, "mu")
    again, _, _ = checkpoint.load_checkpoint(str(tmp_path), "cpu")
    assert again.head == model.head
    with torch.no_grad():
        assert torch.equal(again(batch)["property"],
                           model(batch)["property"])


@pytest.mark.parametrize("label,kind", [
    ("mu", "dipole"), ("r2", "electronic_spatial_extent")])
def test_cli_trains_and_tests_the_label(tmp_path, label, kind):
    """``cli train experiment=qm9_u0_tpu label=...`` builds the label's
    head, and ``cli test`` of its ``ckpt_best`` gives the run's results."""
    ovs = ["experiment=qm9_u0_tpu", f"label={label}",
           "datamodule.dataset=synthetic", "datamodule.n_molecules=24",
           "datamodule.min_atoms=5", "datamodule.max_atoms=12",
           "datamodule.train_size=16", "datamodule.val_size=4",
           "datamodule.test_size=4", "datamodule.batch_size=8",
           "trainer.grad_accum_steps=1", "trainer.max_epochs=1",
           "model.representation.n_atom_basis=32",
           "model.representation.n_interactions=2",
           "model.representation.n_rbf=8",
           "model.representation.num_heads=4", "model.output.n_hidden=16",
           "device=cpu"]
    run = tmp_path / "run"
    cli.main(["train", *ovs, f"workdir={run}"])
    meta = json.loads((run / "ckpt_best" / "meta.json").read_text())
    assert meta["head"]["kind"] == kind and meta["label"] == label
    results = json.loads((run / "test_results.json").read_text())
    assert all(np.isfinite(v) for v in results.values())
    cli.main(["test", f"checkpoint={run / 'ckpt_best'}", *ovs,
              f"workdir={tmp_path / 'test'}"])
    again = json.loads((tmp_path / "test" / "test_results.json").read_text())
    assert again == pytest.approx(results, rel=1e-6)
