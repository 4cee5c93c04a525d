"""``cli train`` and ``cli test`` of the experiments that run on the
edge-list layout (a YAML with no ``layout``, or ``layout: edge``) against
the JAX package's ``cli``: ``smoke`` (synthetic molecules), ``qm9_u0`` (the
reference's QM9 recipe, on small GDB-9 files the test writes) and
``md17_aspirin`` (energies and forces, on an rMD17 NPZ the test writes).

Both packages start from the same weights (JAX's init, handed to the port's
``Trainer.fit``); every field of every logged record and the test results
must agree at rtol 1e-5 (float32: the same arithmetic, sums in another
order), and ``cli test`` of the port's ``ckpt_best`` must give the run's
test results.  The overrides cut the data and the epochs, and the QM9 and
rMD17 models to D = 32 with 2 layers (rMD17: 1) and no attention dropout
(the two packages' dropout bits cannot match; the dropout itself is held
against JAX with the same keep masks in tests/test_torch_port_edge.py).
"""

import json

import numpy as np
import pytest

from gotennet_tpu import cli as jcli
from gotennet_tpu.train import trainer as jtrainer

from gotennet_tpu_torch import cli
from gotennet_tpu_torch.data.dataset import synthetic_trajectory
from gotennet_tpu_torch.train import trainer as ptrainer
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

from test_torch_port_cli import _write_qm9

SMALL = ["model.representation.n_atom_basis=32",
         "model.representation.n_interactions=2",
         "model.representation.n_rbf=8", "model.representation.num_heads=4",
         "model.representation.attn_dropout=0.0"]


def _data(experiment, root):
    """The experiment's overrides, its data written under ``root``."""
    if experiment == "smoke":
        return ["experiment=smoke", "datamodule.n_molecules=16",
                "datamodule.train_size=8", "datamodule.val_size=4",
                "datamodule.test_size=4"]
    if experiment == "qm9_u0":
        _write_qm9(str(root))
        return ["experiment=qm9_u0", f"datamodule.dataset_root={root}",
                "datamodule.train_size=1", "datamodule.val_size=1",
                "datamodule.test_size=1", *SMALL]
    t = synthetic_trajectory(24, 12, seed=3, box=4.0)
    np.savez(root / "rmd17_aspirin.npz", nuclear_charges=t.z[0],
             coords=np.stack(t.pos), energies=t.y[:, 0].astype(np.float64),
             forces=np.stack(t.dy))
    # one layer: JAX's compilation of the force step dominates the test
    return ["experiment=md17_aspirin", f"datamodule.dataset_root={root}",
            "datamodule.train_size=16", "datamodule.val_size=4", *SMALL,
            "model.representation.n_interactions=1"]


def _records(d):
    with open(d / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _close(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key == "epoch_time_s":
            continue
        if isinstance(value, float):
            np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                       err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("experiment,epochs", [
    ("smoke", 1), ("qm9_u0", 2), ("md17_aspirin", 1)])
def test_cli_experiment_matches_jax(tmp_path, monkeypatch, experiment,
                                    epochs):
    root = tmp_path / "data"
    root.mkdir()
    ovs = _data(experiment, root) + [f"trainer.max_epochs={epochs}",
                                     "trainer.log_every=1"]
    seen = {}
    jfit, pfit = jtrainer.Trainer.fit, ptrainer.Trainer.fit

    def jax_fit(self, params, *args, **kwargs):
        seen["params"] = params
        return jfit(self, params, *args, **kwargs)

    def port_fit(self, state, *args, **kwargs):
        assert self.model.layout == "edge"
        state = state_dict_from_jax_params(seen["params"], self.model.cfg,
                                           self.model.head)
        return pfit(self, state, *args, **kwargs)

    monkeypatch.setattr(jtrainer.Trainer, "fit", jax_fit)
    monkeypatch.setattr(ptrainer.Trainer, "fit", port_fit)
    jcli.main(["train", *ovs, f"workdir={tmp_path / 'jax'}"])
    cli.main(["train", *ovs, "device=cpu", f"workdir={tmp_path / 'port'}"])
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert len(got) == len(want) and sum(
        r["phase"] == "val_epoch" for r in got) == epochs
    for g, w in zip(got, want):
        _close(g, w)
    results = [json.loads((tmp_path / d / "test_results.json").read_text())
               for d in ("jax", "port")]
    _close(results[1], results[0])
    cli.main(["test", f"checkpoint={tmp_path / 'port' / 'ckpt_best'}", *ovs,
              "device=cpu", f"workdir={tmp_path / 'test'}"])
    _close(json.loads((tmp_path / "test" / "test_results.json").read_text()),
           results[1])
