"""Checkpoints shared with the JAX package.

The port writes the JAX package's NPZ form (``params.npz`` under JAX's
parameter paths, ``meta.json``, ``atomref.npz``); JAX's ``load_checkpoint``
must rebuild the same model from it, and the port must load what JAX
writes in that form (JAX writes it in multi-process runs, so the test
calls JAX's ``save_checkpoint`` with ``jax.process_count`` patched to 2).
Outputs agree at 1e-5 of their scale in float32 (the same arithmetic, sums
in another order); the weight conversion both ways is exact.
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
from gotennet_tpu.train import checkpoint as jckpt

from gotennet_tpu_torch.data.dataset import (DenseLoader, ELLLoader,
                                             synthetic_molecules)
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.train import checkpoint
from gotennet_tpu_torch.train.optim import make_optimizer
from gotennet_tpu_torch.utils.convert import (jax_params_from_state_dict,
                                              state_dict_from_jax_params)

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
SIZES = dict(min_atoms=5, max_atoms=14)
FRAMES = dict(min_atoms=40, max_atoms=60, box=6.3)
ATOMREF = np.linspace(-3.0, 1.0, 100, dtype=np.float32)[:, None]


def _batches(layout):
    if layout == "dense":
        return (next(iter(JDenseLoader(j_synthetic(4, seed=2, **SIZES), 4))),
                next(iter(DenseLoader(synthetic_molecules(4, seed=2, **SIZES),
                                      4))))
    return (next(iter(JELLLoader(j_synthetic(2, seed=2, **FRAMES), 2,
                                 neighbor_probe="full"))),
            next(iter(ELLLoader(synthetic_molecules(2, seed=2, **FRAMES), 2))))


def _assert_scaled(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _port_out(model, batch):
    with torch.no_grad():
        return model(batch)["property"].numpy()


@pytest.mark.parametrize("layout,kw", [("dense", {}),
                                       ("ell", {"fused": False})])
def test_jax_loads_a_port_checkpoint(tmp_path, layout, kw):
    jbatch, batch = _batches(layout)
    cfg = GotenNetConfig(**SMALL, **kw)
    model = GotenModel(cfg, HeadConfig(mean=0.5, stddev=2.0, atomref=ATOMREF,
                                       activation="silu"), layout,
                       device="cpu", seed=4)
    checkpoint.save_checkpoint(str(tmp_path), model, step=7,
                               extra_meta={"task": "QM9", "label": "U0"})
    jmodel, params, step = jckpt.load_checkpoint(str(tmp_path))
    assert step == 7 and jmodel.layout == layout
    assert jmodel.cfg.fused == cfg.fused and jmodel.cfg.remat == cfg.remat
    np.testing.assert_array_equal(jmodel.head.atomref, ATOMREF)
    assert jckpt.load_meta(str(tmp_path))["label"] == "U0"
    want = jax.jit(jmodel.apply)(params, jbatch)["property"]
    _assert_scaled(_port_out(model, batch), want)


@pytest.mark.parametrize("layout,kw", [("dense", {"fused": True}),
                                       ("ell", {})])
def test_a_jax_npz_checkpoint_loads_into_the_port(tmp_path, monkeypatch,
                                                  layout, kw):
    jbatch, batch = _batches(layout)
    jmodel = JModel(JConfig(**SMALL, **kw), JHead(mean=-1.0, stddev=3.0,
                                                  atomref=ATOMREF),
                    layout=layout)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(5), jbatch)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    jckpt.save_checkpoint(str(tmp_path), params, step=3, model=jmodel,
                          extra_meta={"task": "QM9", "label": "U0"})
    assert (tmp_path / "params.npz").exists()
    model, state, step = checkpoint.load_checkpoint(str(tmp_path), "cpu")
    assert step == 3 and model.layout == layout
    assert model.cfg.fused == jmodel.cfg.fused   # JAX's default: False
    assert model.head.mean == -1.0 and model.head.stddev == 3.0
    assert state.keys() == model.state_dict().keys()
    want = jax.jit(jmodel.apply)(params, jbatch)["property"]
    _assert_scaled(_port_out(model, batch), want)


def test_a_checkpoint_without_fused_reads_as_jax_default(tmp_path):
    model = GotenModel(GotenNetConfig(**SMALL, fused=False), HeadConfig(),
                       "ell", device="cpu")
    checkpoint.save_checkpoint(str(tmp_path), model)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["representation"]["fused"] is False
    assert meta["has_opt_state"] is False
    assert "pair_dtype" not in meta["representation"]
    assert set(meta["representation"]) == {
        f for f in JConfig.__dataclass_fields__
        if f not in ("dtype", "pair_dtype", "node_dtype", "edge_axis")}
    del meta["representation"]["fused"]
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    loaded, _, _ = checkpoint.load_checkpoint(str(tmp_path), "cpu")
    assert loaded.cfg.fused is False


def test_dtypes_travel_in_the_port_meta(tmp_path):
    cfg = GotenNetConfig(**SMALL, pair_dtype=torch.bfloat16,
                         node_dtype=torch.bfloat16)
    model = GotenModel(cfg, HeadConfig(), device="cpu")
    checkpoint.save_checkpoint(str(tmp_path), model)
    loaded, _, _ = checkpoint.load_checkpoint(str(tmp_path), "cpu")
    assert loaded.cfg == model.cfg
    assert loaded.cfg.pair_dtype == loaded.cfg.node_dtype == torch.bfloat16
    jmodel, _, _ = jckpt.load_checkpoint(str(tmp_path))
    assert jmodel.cfg.pair_dtype == jax.numpy.float32   # JAX's own policy


@pytest.mark.parametrize("layout,kw", [
    ("dense", {"fused": True}), ("ell", {}),
    ("dense", {"fused": True, "sep_htr": False, "lmax": 1})])
def test_convert_round_trip_is_exact(layout, kw):
    jbatch, _ = _batches(layout)
    cfg_kw = {**SMALL, **kw}
    jmodel = JModel(JConfig(**cfg_kw), JHead(atomref=ATOMREF), layout=layout)
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(6),
                                                 jbatch))
    cfg = GotenNetConfig(**{k: v for k, v in cfg_kw.items()})
    head = HeadConfig(atomref=ATOMREF)
    back = jax_params_from_state_dict(
        state_dict_from_jax_params(params, cfg, head), cfg)
    flat = dict(jckpt._flatten_dict(params))
    flat_back = dict(jckpt._flatten_dict(back))
    assert flat.keys() == flat_back.keys()
    for key, value in flat.items():
        assert flat_back[key].dtype == np.float32
        np.testing.assert_array_equal(flat_back[key], value, err_msg=key)


def test_an_orbax_directory_raises(tmp_path):
    """JAX's single-process save writes orbax, which the port cannot read:
    a clear error that names the NPZ form."""
    jbatch, _ = _batches("ell")
    jmodel = JModel(JConfig(**SMALL), JHead(), layout="ell")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    jckpt.save_checkpoint(str(tmp_path), params, model=jmodel)
    assert (tmp_path / "params").is_dir()
    with pytest.raises(ValueError, match="orbax.*params.npz"):
        checkpoint.load_checkpoint(str(tmp_path), "cpu")


def test_the_optimizer_state_restores(tmp_path):
    _, batch = _batches("dense")
    model = GotenModel(GotenNetConfig(**SMALL), HeadConfig(), device="cpu")
    opt = make_optimizer(model.parameters(), 1e-3, weight_decay=0.01)
    for _ in range(2):
        model.train()
        opt.zero_grad()
        model(batch)["property"].sum().backward()
        opt.step()
    ts = {"epoch": 4, "ema": {"train_loss": 0.25}}
    checkpoint.save_checkpoint(str(tmp_path), model, step=2, optimizer=opt,
                               train_state=ts)
    loaded, state, step = checkpoint.load_checkpoint(str(tmp_path), "cpu")
    assert step == 2
    assert all(torch.equal(state[k], v) for k, v in
               model.state_dict().items())
    opt2 = make_optimizer(loaded.parameters(), 1e-3, weight_decay=0.01)
    assert checkpoint.load_train_state(str(tmp_path), opt2) == ts
    want, got = opt.state_dict(), opt2.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, s in want["state"].items():
        for key, value in s.items():
            assert torch.equal(got["state"][i][key], value), (i, key)
