"""The port's command line, config tree and data helpers against the JAX
package's.

The YAML reader against PyYAML, every composed experiment and its model
config against JAX's, the QM9 reader on files the test writes, the split
and standardisation helpers, and ``cli train`` then ``cli test`` on the
CPU (``device=cpu``): the port's ``ckpt_best``, read and evaluated by the
JAX package's ``load_checkpoint`` and ``Trainer.evaluate`` on the JAX
package's own loader, must give the port's ``test_results.json`` at rtol
1e-5 (float32: the same arithmetic, sums in another order).
"""

import dataclasses
import glob
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gotennet_tpu import cli as jcli
from gotennet_tpu.data import dataset as jdataset
from gotennet_tpu.data.qm9 import QM9_TARGETS as J_QM9_TARGETS
from gotennet_tpu.data.qm9 import load_qm9 as j_load_qm9
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.tasks import TASK_DICT as J_TASK_DICT
from gotennet_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from gotennet_tpu.train.trainer import Trainer as JTrainer
from gotennet_tpu.utils.config import _parse_scalar as j_parse_scalar
from gotennet_tpu.utils.config import load_config as j_load_config

from gotennet_tpu_torch import cli
from gotennet_tpu_torch.data import dataset
from gotennet_tpu_torch.data.prefetch import prefetch
from gotennet_tpu_torch.data.qm9 import QM9_TARGETS, load_qm9, qm9_atomref
from gotennet_tpu_torch.utils.config import load_config, parse_scalar, yaml_load

EXPERIMENTS = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(cli.CONFIG_DIR, "experiment", "*.yaml")))
SMALL = ["model.representation.n_atom_basis=32",
         "model.representation.n_interactions=2",
         "model.representation.n_rbf=8", "model.representation.num_heads=4"]


def _lines(text, comments):
    return [ln for ln in text.splitlines()
            if ln.lstrip().startswith("#") == comments]


def test_the_config_tree_is_a_copy_of_the_jax_one():
    """The same files with the same content line for line; only comment
    lines may differ, in two files: ``model/gotennet.yaml`` names the
    reference's config without a machine's path, and
    ``experiment/qm9_u0_tpu.yaml`` says how the port's Trainer keeps an
    accumulation group of mixed M (JAX's pads and stacks it)."""
    files = sorted(glob.glob(os.path.join(cli.CONFIG_DIR, "**", "*.yaml"),
                             recursive=True))
    want = sorted(glob.glob(os.path.join(jcli.CONFIG_DIR, "**", "*.yaml"),
                            recursive=True))
    assert len(files) == len(want) == 11 and len(EXPERIMENTS) == 7
    differ = set()
    for path in files:
        rel = os.path.relpath(path, cli.CONFIG_DIR)
        got = open(path).read()
        with open(os.path.join(jcli.CONFIG_DIR, rel)) as f:
            text = f.read()
        assert _lines(got, False) == _lines(text, False), rel
        assert len(_lines(got, True)) == len(_lines(text, True)), rel
        if got != text:
            differ.add(rel)
    assert differ <= {"model/gotennet.yaml", "experiment/qm9_u0_tpu.yaml"}


def test_yaml_reader_matches_pyyaml():
    for path in glob.glob(os.path.join(cli.CONFIG_DIR, "**", "*.yaml"),
                          recursive=True):
        text = open(path).read()
        assert yaml_load(text) == yaml.safe_load(text), path
    doc = ("a:\n  b: [1, x, 2.5]\n  c: {d: null, e: 'q # r'}\n"
           "l:\n  - k: v\n    w: 2\n  - plain\n  -\n    n: 1\n# end\n")
    assert yaml_load(doc) == yaml.safe_load(doc)
    for raw in ("1e-5", "3e-4", "1.0e-7", "1.0e7", "5.", ".5", "-3", "+4",
                "0", "007", "08", "0x1f", "0b101", "1_000", "1:30", "1:30.5",
                ".inf", "-.inf", "true", "True", "yes", "Off", "y", "null",
                "~", "", "abc", "'quoted'", '"dq"', "'it''s'", "a #b",
                "a#b", "bf16", "runs/x", "[1, 2, a]", "{a: 1}", "[]",
                "qm9_u0_tpu", "1.5e+3", "-1E-3"):
        want = yaml.safe_load(raw)
        got = yaml_load(raw)
        assert type(got) is type(want) and got == want, raw
        # overrides also read bare scientific notation as a float
        assert parse_scalar(raw) == j_parse_scalar(raw), raw
    assert math.isnan(yaml_load(".nan"))
    with pytest.raises(ValueError):
        yaml_load("a: &anchor 1")


@pytest.mark.parametrize("experiment", [None] + EXPERIMENTS)
def test_composed_config_and_model_config_match_jax(experiment, monkeypatch):
    monkeypatch.setenv("DATA_DIR", "/data/here")
    ovs = ([f"experiment={experiment}"] if experiment else []) + [
        "label=homo", "model.lr=3e-4", "trainer.log_every=7"]
    cfg = load_config(cli.CONFIG_DIR, "train.yaml", ovs)
    assert cfg == j_load_config(jcli.CONFIG_DIR, "train.yaml", ovs)
    # the model config, fields the YAML leaves out at JAX's defaults (the
    # JAX package's own construction, cli._build_model_and_trainer)
    rep = dict(cfg["model"]["representation"])
    for key in ("pair_dtype", "node_dtype"):
        if rep.get(key) in ("bf16", "bfloat16"):
            rep[key] = jnp.bfloat16
        else:
            rep.pop(key, None)
    rep.setdefault("max_num_neighbors",
                   cfg["datamodule"].get("max_num_neighbors", 32))
    want = dataclasses.asdict(JConfig(**rep))
    got = dataclasses.asdict(cli.model_config(cfg))
    want.pop("dtype")
    dtypes = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    for key in ("pair_dtype", "node_dtype"):
        got[key] = dtypes[got[key]]
    assert got == want


def test_md22_atat_composes_the_force_recipe(monkeypatch):
    """``experiment=md22_atat`` composes to JAX's config and builds the
    force recipe: dense layout, ``fused`` absent (False, as JAX's default),
    bf16 pairs, MSE at energy 0.05 / force 0.95, standardised energies, an
    MD22 force head."""
    from gotennet_tpu_torch.tasks import TASK_DICT
    monkeypatch.setenv("DATA_DIR", "/data/here")
    cfg = load_config(cli.CONFIG_DIR, "train.yaml", ["experiment=md22_atat"])
    assert cfg == j_load_config(jcli.CONFIG_DIR, "train.yaml",
                                ["experiment=md22_atat"])
    mc, dm = cfg["model"], cfg["datamodule"]
    assert (cfg["task"], cfg["label"]) == ("MD22", "AT-AT-CG-CG")
    assert mc["layout"] == "dense" and "fused" not in mc["representation"]
    gcfg = cli.model_config(cfg)
    assert not gcfg.fused and gcfg.pair_dtype == torch.bfloat16
    assert (gcfg.n_atom_basis, gcfg.n_interactions, gcfg.n_rbf) == (256, 4,
                                                                    64)
    assert mc["task_loss"] == "MSELoss" and mc["task_config"] == {
        "energy_weight": 0.05, "force_weight": 0.95}
    assert dm["dataset"] == "MD22" and dm["standardize"] is True
    assert dm["dataset_root"] == "/data/here/md22"
    task = TASK_DICT[cfg["task"]](cfg["label"], {"mean": 0.0, "std": 1.0},
                                  {"task_loss": mc["task_loss"],
                                   **mc["task_config"]})
    assert task.build_head().derivative
    assert [(s["name"], s["loss_weight"]) for s in task.get_losses()] == [
        ("energy_MSELoss", 0.05), ("force_MSELoss", 0.95)]


# cases of items ported since, whose commands now train for an epoch and
# test (10: the edge-list layout the YAMLs without a layout and md17_aspirin
# run on; 5: the gates on the dense plain update; 4: the Molecule3D reader,
# on files the test writes, with and without packed dense batches); item
# 12's case (more than one device) now asks for the process group it needs;
# item 13's run a 2-trial grid sweep and a parity table of two reference
# .ckpt files the test writes, everything under the test's tmp dir
PORTED = (4, 5, 10)
M3D = ["trainer.max_epochs=1", "datamodule.train_size=8",
       "datamodule.val_size=2", "datamodule.test_size=2",
       "datamodule.batch_size=4", "datamodule.inference_batch_size=4"]
SHORT = ["trainer.max_epochs=1", "datamodule.n_molecules=12",
         "datamodule.train_size=8", "datamodule.val_size=2",
         "datamodule.test_size=2", "datamodule.batch_size=4",
         "datamodule.inference_batch_size=4"]


@pytest.mark.parametrize("argv,item", [
    (["train", "experiment=smoke", *SHORT], 10),  # layout absent: "edge"
    (["train", "experiment=qm9_u0", "datamodule.dataset=synthetic", *SHORT],
     10),
    (["train", "experiment=qm9_u0", "datamodule.dataset=synthetic",
      "model.layout=dense", "model.representation.edge_updates=gated",
      *SHORT], 5),                                # fused absent: False
    (["train", "experiment=md17_aspirin", "datamodule.dataset=synthetic",
      "datamodule.with_forces=true", "model.representation.remat=false",
      *SHORT], 10),                               # layout: "edge"
    (["train", "experiment=molecule3d", "datamodule.pack=true", *M3D], 4),
    (["train", "experiment=molecule3d", *M3D], 4),
    (["train", "experiment=smoke", "model.layout=ell",
      "trainer.data_parallel=2"], 12),
    (["sweep", "experiment=smoke", "model.lr=1e-4,2e-4", *SHORT], 13),
    (["parity", "experiment=smoke", *SHORT], 13)])
def test_what_is_not_ported_raises_its_item(tmp_path, argv, item):
    argv = argv + SMALL + ["device=cpu", f"workdir={tmp_path}"]
    if "experiment=molecule3d" in argv:
        from test_torch_port_molecule3d import write_molecule3d
        write_molecule3d(str(tmp_path / "m3d"), n=12)
        argv.append(f"datamodule.dataset_root={tmp_path / 'm3d'}")
    if item == 12:
        with pytest.raises(ValueError, match="one process per device"):
            cli.main(argv)
        return
    if item in PORTED:
        cli.main(argv)
        results = json.loads((tmp_path / "test_results.json").read_text())
        assert results and all(np.isfinite(v) for v in results.values())
        return
    if argv[0] == "sweep":
        cli.main(argv + [f"sweep_dir={tmp_path / 'sweep'}"])
        recs = [json.loads(line) for line in
                (tmp_path / "sweep" / "sweep.jsonl").read_text().splitlines()]
        assert len(recs) == 3 and [r["trial"] for r in recs[:2]] == [0, 1]
        # the sweep owns each trial's workdir
        assert not any(o.startswith("workdir=") for r in recs[:2]
                       for o in r["overrides"])
        assert all(np.isfinite(r["metric"]) for r in recs[:2])
        assert "best_overrides" in recs[2]
        for i in range(2):
            assert (tmp_path / "sweep" / f"trial_{i}" /
                    "test_results.json").exists()
        return
    from test_torch_port_tools import write_reference_ckpt
    cks = [write_reference_ckpt(str(tmp_path / f"{n}.ckpt"), seed=seed)
           for n, seed in (("a", 1), ("b", 2))]
    out = tmp_path / "parity.md"
    cli.main(argv + [f"checkpoints={','.join(cks)}", f"out={out}"])
    rows = [ln for ln in out.read_text().splitlines()
            if ln.startswith("| ") and ".ckpt" in ln]
    assert [r.split(" | ")[0][2:] for r in rows] == cks


def test_unknown_keys_and_modes_raise(tmp_path):
    base = ["experiment=smoke", "model.layout=ell", "device=cpu",
            f"workdir={tmp_path}"]
    with pytest.raises(ValueError, match="unknown config key"):
        cli.main(["train", *base, "trainer.max_epoch=2"])
    with pytest.raises(ValueError, match="unknown config key"):
        cli.main(["train", *base, "model.output.width=2"])
    with pytest.raises(SystemExit):
        cli.main(["serve"])
    assert cli.main(["--help"]) == 0


def _write_qm9(root):
    """Five molecules in the GDB-9 distribution's files: the third is
    listed in uncharacterized.txt, the fifth has an atom that is not H, C,
    N, O or F; both are skipped."""
    rng = np.random.default_rng(0)
    blocks, rows = [], []
    for i in range(5):
        syms = list(rng.choice(["H", "C", "N", "O", "F"], size=3 + i))
        if i == 4:
            syms[0] = "Cl"
        pos = rng.normal(size=(len(syms), 3)) * 1.5
        atoms = "\n".join(f"{x:10.4f}{y:10.4f}{z:10.4f} {s:<3} 0  0  0  0"
                          for (x, y, z), s in zip(pos, syms))
        blocks.append(f"gdb_{i + 1}\n  prog\n\n{len(syms):3d}  0  0  0  0  "
                      f"0  0  0  0  0999 V2000\n{atoms}\nM  END\n$$$$\n")
        rows.append(f"gdb_{i + 1}," + ",".join(
            f"{v:.6f}" for v in rng.normal(size=19)))
    with open(os.path.join(root, "gdb9.sdf"), "w") as f:
        f.write("".join(blocks))
    with open(os.path.join(root, "gdb9.sdf.csv"), "w") as f:
        f.write("mol_id," + ",".join(f"c{i}" for i in range(19)) + "\n"
                + "\n".join(rows) + "\n")
    with open(os.path.join(root, "uncharacterized.txt"), "w") as f:
        f.write("\n".join(["header"] * 9 + ["  3  reason"] + ["end", ""]))


def test_load_qm9_matches_jax(tmp_path):
    for pkg in ("port", "jax"):
        os.makedirs(tmp_path / pkg)
        _write_qm9(str(tmp_path / pkg))
    for label in (None, "U0", "homo"):
        got = load_qm9(str(tmp_path / "port"), label=label)
        want = j_load_qm9(str(tmp_path / "jax"), label=label, download=False)
        assert len(got) == len(want) == 3
        for a, b in zip(got.z + got.pos, want.z + want.pos):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.y, want.y)
        if label is None or want.atomref is None:
            assert got.atomref is None and want.atomref is None
        else:
            np.testing.assert_array_equal(got.atomref, want.atomref)
    assert os.path.exists(tmp_path / "port" / "qm9_processed.npz")
    assert QM9_TARGETS == J_QM9_TARGETS
    assert qm9_atomref("homo") is None and qm9_atomref("U0")[6, 0] < 0
    with pytest.raises(FileNotFoundError, match="gdb9.sdf"):
        load_qm9(str(tmp_path / "empty"))


def test_splits_and_helpers_match_jax(tmp_path):
    for sizes in ((20, 5, 5), (0.6, 0.2, None), (None, 4, 6), (10, 5, None)):
        got = dataset.make_splits(40, *sizes, 3, str(tmp_path / "s.npz"))
        want = jdataset.make_splits(40, *sizes, 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        again = dataset.make_splits(40, 1, 1, 1, 0,
                                    splits_path=str(tmp_path / "s.npz"))
        for a, b in zip(again, got):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        dataset.make_splits(40, None, None, 5, 0)
    ds = dataset.synthetic_molecules(12, seed=4)
    jds = jdataset.synthetic_molecules(12, seed=4)
    ds.atomref = jds.atomref = qm9_atomref("U0")
    for use in (True, False):
        assert dataset.standardize_energy(ds, range(2, 10), use_atomref=use) \
            == jdataset.standardize_energy(jds, range(2, 10),
                                           use_atomref=use)
    got, want = dataset.center_positions(ds), jdataset.center_positions(jds)
    for a, b in zip(got.pos, want.pos):
        np.testing.assert_array_equal(a, b)
    sub, jsub = ds.subset([3, 1]), jds.subset([3, 1])
    np.testing.assert_array_equal(sub.y, jsub.y)
    assert sub.atomref is ds.atomref


def test_loaders_shuffle_by_epoch_as_jax():
    """set_epoch makes the order a function of (seed, epoch), the same as
    JAX's; the ELL loader's probed K and drop_last as JAX's."""
    ds = dataset.synthetic_molecules(30, seed=2, min_atoms=4, max_atoms=20)
    jds = jdataset.synthetic_molecules(30, seed=2, min_atoms=4, max_atoms=20)
    got = dataset.DenseLoader(ds, 4, shuffle=True, seed=9, bucket=True)
    want = jdataset.DenseLoader(jds, 4, shuffle=True, seed=9, bucket=True)
    for epoch in (0, 1, 0):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.z.numpy(), np.asarray(b.z))
            np.testing.assert_array_equal(a.y.numpy(), np.asarray(b.y))
    frames = dict(min_atoms=40, max_atoms=60, box=6.3)
    ds = dataset.synthetic_molecules(7, seed=2, **frames)
    jds = jdataset.synthetic_molecules(7, seed=2, **frames)
    for probe in (3, "full"):
        kw = dict(shuffle=True, seed=4, drop_last=True, neighbor_probe=probe)
        got = dataset.ELLLoader(ds, 2, **kw)
        want = jdataset.ELLLoader(jds, 2, **kw)
        assert got.max_neighbors == want.max_neighbors
        assert len(got) == len(want) == 3
        got.set_epoch(1)
        want.set_epoch(1)
        batches = list(want)
        assert len(batches) == 3
        for a, b in zip(got, batches):
            np.testing.assert_array_equal(a.y.numpy(), np.asarray(b.y))


def test_prefetch_reraises_the_producers_error():
    assert list(prefetch(iter(range(5)), buffer_size=2)) == list(range(5))

    def broken():
        yield 1
        raise RuntimeError("producer failed")

    it = prefetch(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def _run_both(tmp_path, overrides):
    """cli train and cli test in the port; JAX's evaluation of the port's
    ckpt_best on JAX's own test loader."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    cli.main(["train", *overrides, "device=cpu", f"workdir={port_dir}"])
    for name in ("ckpt_best", "ckpt_last", "splits.npz", "metrics.jsonl",
                 "test_results.json", "config.json"):
        assert (port_dir / name).exists(), name
    results = json.loads((port_dir / "test_results.json").read_text())
    cli.main(["test", f"checkpoint={port_dir / 'ckpt_best'}", *overrides,
              "device=cpu", f"workdir={tmp_path / 'test'}"])
    assert json.loads((tmp_path / "test" / "test_results.json")
                      .read_text()) == results

    cfg = j_load_config(jcli.CONFIG_DIR, "train.yaml",
                        [*overrides, f"workdir={jax_dir}"])
    jmodel, params, _ = j_load_checkpoint(str(port_dir / "ckpt_best"))
    _, _, test_loader, meta = jcli._build_data(cfg, cfg["label"])
    task = J_TASK_DICT[cfg["task"]](cfg["label"], dataset_meta=meta,
                                    task_config={"task_loss": cfg["model"].get(
                                        "task_loss", "L1Loss")})
    want = JTrainer(jmodel, task, jcli._build_trainer_config(cfg)).evaluate(
        params, test_loader, phase="test")
    assert results.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(results[key], want[key], rtol=1e-5,
                                   err_msg=key)


def test_cli_train_and_test_dense_match_jax(tmp_path):
    """qm9_u0_tpu (dense, fused, bucketed, 2-batch accumulation with a
    partial group, attention dropout 0.1) in float32 on 40 synthetic
    molecules, 2 epochs."""
    _run_both(tmp_path, [
        "experiment=qm9_u0_tpu", "datamodule.dataset=synthetic",
        "datamodule.n_molecules=40", "datamodule.min_atoms=4",
        "datamodule.max_atoms=14", "datamodule.train_size=24",
        "datamodule.val_size=8", "datamodule.test_size=8",
        "datamodule.batch_size=8", "datamodule.inference_batch_size=8",
        "model.representation.pair_dtype=float32",
        "model.representation.node_dtype=float32",
        "trainer.max_epochs=2", "trainer.grad_accum_steps=2",
        "trainer.log_every=1", *SMALL])


def test_cli_train_and_test_ell_match_jax(tmp_path):
    """large_molecule (ELL, the fused message with the unfused update,
    spatially sorted frames with gather windows, dropout) on 8 frames of
    40-60 atoms, one epoch."""
    _run_both(tmp_path, [
        "experiment=large_molecule", "datamodule.n_molecules=8",
        "datamodule.min_atoms=40", "datamodule.max_atoms=60",
        "datamodule.train_size=4", "datamodule.val_size=2",
        "datamodule.test_size=2", "datamodule.batch_size=2",
        "datamodule.inference_batch_size=2", "datamodule.block_rows=16",
        "model.representation.pair_dtype=float32", *SMALL])


def test_metric_logger_writes_what_jax_writes(tmp_path):
    """The JSONL and per-phase CSV sinks, record for record, against the
    JAX package's MetricLogger; a tracking sink that cannot import
    raises."""
    from gotennet_tpu.utils.logging import MetricLogger as JMetricLogger

    from gotennet_tpu_torch.utils.logging import MetricLogger, get_logger

    records = [{"phase": "train", "step": 1, "loss": np.float32(0.5),
                "grad_norm": 2.0},
               {"phase": "val_epoch", "step": 1, "epoch": np.int64(0),
                "val_loss": 0.25, "MeanAbsoluteError": float("nan")},
               {"phase": "train", "step": 2, "loss": 0.125, "grad_norm": 1}]
    for cls, name in ((MetricLogger, "port"), (JMetricLogger, "jax")):
        logger = cls(str(tmp_path / name), "jsonl,csv")
        for rec in records:
            logger.log(dict(rec))
        logger.close()
    for fname in ("metrics.jsonl", "metrics_train.csv",
                  "metrics_val_epoch.csv"):
        assert ((tmp_path / "port" / fname).read_text()
                == (tmp_path / "jax" / fname).read_text()), fname
    with pytest.raises(ImportError):
        MetricLogger(str(tmp_path / "x"), "jsonl,neptune")
    assert get_logger().name == "gotennet_tpu_torch"
