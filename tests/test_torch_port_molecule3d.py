"""The port's Molecule3D reader and ``cli train experiment=molecule3d``
against the JAX package's.

Each test writes its own files: synthetic molecules (the same seed gives
the same molecules in both packages) as V2000 SDF files with a
``properties.csv``, or as NPZ shards.  Both readers must give the same
arrays; the shard ranges of every host the same shards; and the port's
``cli train`` on either root, its ``ckpt_best`` read and evaluated by the
JAX package on JAX's own loader, its test results at rtol 1e-5 (float32:
the same arithmetic, sums in another order).
"""

import json
import os

import numpy as np
import pytest

from gotennet_tpu import cli as jcli
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.data.molecule3d import iter_shards as j_iter_shards
from gotennet_tpu.data.molecule3d import load_molecule3d as j_load
from gotennet_tpu.data.molecule3d import save_shards as j_save_shards
from gotennet_tpu.data.molecule3d import \
    shard_range_for_host as j_shard_range
from gotennet_tpu.tasks import TASK_DICT as J_TASK_DICT
from gotennet_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from gotennet_tpu.train.trainer import Trainer as JTrainer
from gotennet_tpu.utils.config import load_config as j_load_config

from gotennet_tpu_torch import cli
from gotennet_tpu_torch.data.dataset import synthetic_molecules
from gotennet_tpu_torch.data.molecule3d import (is_shard_dir, iter_shards,
                                                load_molecule3d,
                                                load_molecule3d_sdf,
                                                save_shards,
                                                shard_range_for_host)

_SYM = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F"}
SMALL = ["model.representation.n_atom_basis=32",
         "model.representation.n_interactions=2",
         "model.representation.n_rbf=8", "model.representation.num_heads=4",
         "model.representation.lmax=1"]


def _write_sdf(path, ds, start, stop):
    """V2000 blocks as the SDF reader parses them (4 decimals)."""
    with open(path, "w") as f:
        for i in range(start, stop):
            f.write("mol\n written by the test\n\n")
            f.write(f"{len(ds.z[i]):3d}{0:3d}  0  0  0  0  0  0  0  0999 "
                    "V2000\n")
            for zj, p in zip(ds.z[i], ds.pos[i]):
                f.write(f"{p[0]:10.4f}{p[1]:10.4f}{p[2]:10.4f} "
                        f"{_SYM[int(zj)]:<3}" + " 0" * 12 + "\n")
            f.write("M  END\n$$$$\n")


def write_molecule3d(root, n=60, seed=3, min_atoms=5, max_atoms=12):
    """Two SDF files of ``n`` molecules and a ``properties.csv`` whose
    ``gap`` column is the synthetic target; returns the dataset."""
    ds = synthetic_molecules(n, seed=seed, min_atoms=min_atoms,
                             max_atoms=max_atoms)
    os.makedirs(root, exist_ok=True)
    _write_sdf(os.path.join(root, "combined_mols_0.sdf"), ds, 0, n // 2)
    _write_sdf(os.path.join(root, "combined_mols_1.sdf"), ds, n // 2, n)
    with open(os.path.join(root, "properties.csv"), "w") as f:
        f.write("index,dipole_x,dipole_y,dipole_z,homo,lumo,gap,"
                "scf_energy\n")
        for i in range(n):
            gap = float(ds.y[i, 0])
            f.write(f"{i},0,0,0,-0.3,{-0.3 + gap},{gap},-40.0\n")
    return ds


@pytest.fixture
def m3d_root(tmp_path):
    root = str(tmp_path / "molecule3d")
    return root, write_molecule3d(root)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got.z + got.pos, want.z + want.pos):
        np.testing.assert_array_equal(a, b)
    if want.y is None:
        assert got.y is None
    else:
        np.testing.assert_array_equal(got.y, np.asarray(want.y))


def test_molecule3d_sdf_ingestion_matches_jax(m3d_root):
    root, ds = m3d_root
    for label in ("gap", "homo", None):
        full = load_molecule3d(root, label=label)
        _same(full, j_load(root, label=label))
    full = load_molecule3d(root, label="gap")
    assert len(full) == 60 and full.y.shape == (60, 1)
    np.testing.assert_allclose(full.y[:, 0], ds.y[:, 0], rtol=1e-5)
    np.testing.assert_allclose(full.pos[7], ds.pos[7], atol=1e-3)
    _same(load_molecule3d(root, "gap", max_molecules=37),
          j_load(root, "gap", max_molecules=37))
    one = os.path.join(root, "combined_mols_1.sdf")
    csv = os.path.join(root, "properties.csv")
    from gotennet_tpu.data.molecule3d import load_molecule3d_sdf as j_sdf
    _same(load_molecule3d_sdf(one, csv, "lumo", max_molecules=9),
          j_sdf(one, csv, "lumo", max_molecules=9))
    with pytest.raises(FileNotFoundError, match="no Molecule3D data"):
        load_molecule3d(os.path.dirname(root) + "/nothing")


def test_molecule3d_shards_and_host_assignment_match_jax(m3d_root, tmp_path):
    """The port's shards read by JAX and JAX's by the port, host by host:
    2 hosts over 3 shards give host 0 shards {0, 1}, host 1 shard {2}."""
    root, _ = m3d_root
    full = load_molecule3d(root, label="gap")
    ports = save_shards(full, str(tmp_path / "port"), shard_size=20)
    jaxs = j_save_shards(j_load(root, label="gap"), str(tmp_path / "jax"),
                         shard_size=20)
    assert [os.path.basename(p) for p in ports] == [
        os.path.basename(p) for p in jaxs]
    assert is_shard_dir(str(tmp_path / "port")) and not is_shard_dir(root)
    for host, n_hosts, n in ((0, 2, 40), (1, 2, 20), (0, 1, 60)):
        got = load_molecule3d(str(tmp_path / "jax"), host=host,
                              n_hosts=n_hosts)
        want = j_load(str(tmp_path / "port"), host=host, n_hosts=n_hosts)
        assert len(got) == n
        _same(got, want)
    _same(load_molecule3d(str(tmp_path / "port"), max_molecules=25),
          j_load(str(tmp_path / "port"), max_molecules=25))


def test_molecule3d_shards_roundtrip_matches_jax(tmp_path):
    ds = synthetic_molecules(25, seed=7)
    paths = save_shards(ds, str(tmp_path), shard_size=10)
    assert len(paths) == 3
    for n_shards in (1, 3, 7, 10):
        for n_hosts in (1, 2, 3, 4):
            ranges = [shard_range_for_host(n_shards, h, n_hosts)
                      for h in range(n_hosts)]
            assert ranges == [j_shard_range(n_shards, h, n_hosts)
                              for h in range(n_hosts)]
            covered = [i for r in ranges for i in r]
            assert covered == list(range(n_shards))
    for host in (0, 1):
        got = list(iter_shards(str(tmp_path), host, 2))
        want = list(j_iter_shards(str(tmp_path), host, 2))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    assert sum(len(s) for s in iter_shards(str(tmp_path))) == 25
    jds = j_synthetic(25, seed=7)
    np.testing.assert_array_equal(next(iter_shards(str(tmp_path))).z[0],
                                  jds.z[0])


@pytest.mark.parametrize("root_kind", ["sdf", "shards"])
def test_molecule3d_cli_train_matches_jax(m3d_root, tmp_path, root_kind):
    """``cli train experiment=molecule3d`` (dense, standardised, L1) for 2
    epochs on either root, then ``cli test`` of ``ckpt_best``; JAX's
    evaluation of that checkpoint on JAX's loader gives the same test
    results."""
    root, _ = m3d_root
    if root_kind == "shards":
        full = load_molecule3d(root, label="gap")
        root = str(tmp_path / "npz_root")
        save_shards(full, root, shard_size=25)
    overrides = [
        "experiment=molecule3d", f"datamodule.dataset_root={root}",
        "datamodule.batch_size=8", "datamodule.train_size=40",
        "datamodule.val_size=10", "datamodule.test_size=10",
        "trainer.max_epochs=2", "trainer.log_every=100", *SMALL]
    port_dir = tmp_path / "port"
    cli.main(["train", *overrides, "device=cpu", f"workdir={port_dir}"])
    results = json.loads((port_dir / "test_results.json").read_text())
    assert np.isfinite(results["MeanAbsoluteError"])
    cli.main(["test", f"checkpoint={port_dir / 'ckpt_best'}", *overrides,
              "device=cpu", f"workdir={tmp_path / 'test'}"])
    assert json.loads((tmp_path / "test" / "test_results.json")
                      .read_text()) == results
    cfg = j_load_config(jcli.CONFIG_DIR, "train.yaml",
                        [*overrides, f"workdir={tmp_path / 'jax'}"])
    jmodel, params, _ = j_load_checkpoint(str(port_dir / "ckpt_best"))
    _, _, test_loader, meta = jcli._build_data(cfg, cfg["label"])
    task = J_TASK_DICT[cfg["task"]](cfg["label"], dataset_meta=meta,
                                    task_config={"task_loss": "L1Loss"})
    want = JTrainer(jmodel, task, jcli._build_trainer_config(cfg)).evaluate(
        params, test_loader, phase="test")
    assert results.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(results[key], want[key], rtol=1e-5,
                                   err_msg=key)
