"""The port's tools against the JAX package's.

Reference Lightning ``.ckpt`` files (written here as the JAX package's own
test writes one, head included): ``load_reference_model`` predicts as
JAX's at rtol 1e-5 and ``cli test checkpoint=x.ckpt`` gives JAX's
``test_results.json`` at rtol 1e-5 (float32, sums in another order).  The
hub: JAX's alias errors, cached aliases and local paths, a ``file://``
download into the cache, a failed one leaving no ``.partial``.  Sweeps:
``expand_grid``, ``sample_overrides`` and the random and adaptive searches'
``sweep.jsonl`` records equal to JAX's.  ``radius_graph`` and
``ell_from_graph_batch`` give exactly JAX's arrays.  Every name of JAX's
two ``__all__`` lists resolves in the port.  ``profile_fn`` and
``multichip_bench`` run on the CPU (no JAX comparison: the profilers
differ, and times are not comparable).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import gotennet_tpu
import gotennet_tpu.graph as jgraph
from gotennet_tpu import cli as jcli
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.graph.ell_batch import \
    ell_from_graph_batch as j_ell_from_graph_batch
from gotennet_tpu.graph.neighborlist import collate_graphs as j_collate
from gotennet_tpu.graph.neighborlist import radius_graph_jax
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.utils import hub as jhub
from gotennet_tpu.utils import sweep as jsweep
from gotennet_tpu.utils import torch_convert as jconvert
from gotennet_tpu.utils.config import load_config as j_load_config

import gotennet_tpu_torch
import gotennet_tpu_torch.graph as pgraph
from gotennet_tpu_torch import cli
from gotennet_tpu_torch.data.dataset import synthetic_molecules
from gotennet_tpu_torch.graph.ell_batch import ell_from_graph_batch
from gotennet_tpu_torch.graph.neighborlist import (collate_graphs,
                                                   radius_graph)
from gotennet_tpu_torch.utils import hub, sweep
from gotennet_tpu_torch.utils.bench_multichip import MODES, multichip_bench
from gotennet_tpu_torch.utils.convert import (load_reference_checkpoint,
                                              load_reference_model)
from gotennet_tpu_torch.utils.profiling import profile_fn

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
SIZES = dict(min_atoms=4, max_atoms=12)


# ---- reference Lightning .ckpt files ----------------------------------------
def write_reference_ckpt(path, seed=4, task="QM9", label=7, mean=0.5,
                         stddev=2.0):
    """A reference-form ``.ckpt``: the JAX converter's state dict of a
    seeded JAX edge model with an Atomwise head, and hyper-parameters in the
    reference's shape (a ``__target__``, a ``cutoff_fn``, the cutoff
    outside the representation)."""
    cfg, head = JConfig(**SMALL), JHead(mean=mean, stddev=stddev)
    graphs = j_synthetic(2, seed=1, **SIZES).graph_dicts(range(2))
    jmodel = JModel(cfg, head)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), j_collate(graphs, 32, 512, 2)))
    sd = jconvert.model_params_to_state_dict(params, cfg, head)
    torch.save({
        "hyper_parameters": {
            "cutoff": 5.0, "task": task, "label": label,
            "representation": {
                "__target__": "gotennet.models.representation.gotennet."
                              "GotenNetWrapper",
                "cutoff_fn": {"_target_": "CosineCutoff"},
                "unknown_field": 1, **SMALL}},
        "state_dict": {k: torch.as_tensor(np.array(v)) for k, v in
                       sd.items()}}, path)
    return path


def test_a_reference_ckpt_predicts_as_jax(tmp_path):
    path = write_reference_ckpt(str(tmp_path / "ref.ckpt"))
    cfg, state = load_reference_checkpoint(path)
    jmodel, jparams, hp = jconvert.load_reference_model(path)
    got_cfg = dataclasses.asdict(cfg)
    want_cfg = dataclasses.asdict(jmodel.cfg)
    for key in ("dtype", "pair_dtype", "node_dtype"):
        got_cfg.pop(key, None)
        want_cfg.pop(key, None)
    assert got_cfg == want_cfg and not cfg.fused
    assert "representation.gata_list.0.W_q.weight" in state
    model, port_hp = load_reference_model(path, "cpu")
    assert port_hp == hp and model.layout == jmodel.layout == "edge"
    assert model.head == dataclasses.replace(model.head, mean=0.5,
                                             stddev=2.0, derivative=False)
    graphs = synthetic_molecules(3, seed=6, **SIZES).graph_dicts(range(3))
    jgraphs = j_synthetic(3, seed=6, **SIZES).graph_dicts(range(3))
    want = np.asarray(jax.jit(jmodel.apply)(
        jparams, j_collate(jgraphs, 48, 1024, 3))["property"])
    with torch.no_grad():
        got = model(collate_graphs(graphs, 48, 1024, 3))["property"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # a force task's head differentiates the energy, as JAX's
    path = write_reference_ckpt(str(tmp_path / "md.ckpt"), task="rMD17",
                                label="aspirin")
    model, _ = load_reference_model(path, "cpu")
    assert model.head.derivative
    assert jconvert.load_reference_model(path)[0].head.derivative


TEST_DATA = ["experiment=smoke", "datamodule.n_molecules=24",
             "datamodule.train_size=8", "datamodule.val_size=8",
             "datamodule.test_size=8", "datamodule.batch_size=4",
             "datamodule.inference_batch_size=4"]


def test_cli_test_of_a_reference_ckpt_matches_jax(tmp_path):
    """The label comes from the hyper-parameters (7: 'U0'), the layout is the
    edge list's; JAX's ``cli test`` of the same file on the same data."""
    path = write_reference_ckpt(str(tmp_path / "ref.ckpt"))
    cli.main(["test", f"checkpoint={path}", *TEST_DATA, "device=cpu",
              f"workdir={tmp_path / 'port'}"])
    jcli.test(j_load_config(jcli.CONFIG_DIR, "train.yaml", [
        f"checkpoint={path}", *TEST_DATA, f"workdir={tmp_path / 'jax'}"]))
    got, want = (json.loads((tmp_path / d / "test_results.json").read_text())
                 for d in ("port", "jax"))
    assert got.keys() == want.keys() and got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)


# ---- the hub ----------------------------------------------------------------
@pytest.mark.parametrize("name", ["bogus", "a_b", "QM9_huge_U0",
                                  "XYZ_small_U0", "QM9_small_foo",
                                  "rMD17_small_aspirin"])
def test_alias_errors_are_jax_ones(name, tmp_path, monkeypatch):
    monkeypatch.setenv("CHECKPOINT_PATH", str(tmp_path))
    with pytest.raises(ValueError) as want:
        jhub.resolve_checkpoint(name)
    with pytest.raises(ValueError) as got:
        hub.resolve_checkpoint(name)
    assert str(got.value) == str(want.value)


def test_cached_aliases_and_local_paths_resolve(tmp_path, monkeypatch):
    monkeypatch.setenv("CHECKPOINT_PATH", str(tmp_path / "cache"))
    local = tmp_path / "mine.ckpt"
    local.write_bytes(b"x")
    assert hub.resolve_checkpoint(str(local)) == str(local)
    os.makedirs(tmp_path / "cache")
    (tmp_path / "cache" / "QM9_small_homo.ckpt").write_bytes(b"y")
    got = hub.resolve_checkpoint("QM9_small_homo")
    assert got == jhub.resolve_checkpoint("QM9_small_homo")
    assert got == str(tmp_path / "cache" / "QM9_small_homo.ckpt")
    url = "https://example.org/pretrained/QM9/base/gotennet_U0.ckpt"
    monkeypatch.setenv("GOTENNET_TPU_CHECKPOINT_MIRRORS",
                       "file:///m1/,file:///m2")
    assert hub._mirror_urls(url) == jhub._mirror_urls(url)


def test_a_file_url_download_lands_in_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("CHECKPOINT_PATH", str(tmp_path / "cache"))
    monkeypatch.setattr(hub, "HUB_URL", "file://" + str(tmp_path) +
                        "/hub/{task}/{size}/gotennet_{label}.ckpt")
    src = tmp_path / "hub" / "QM9" / "base"
    src.mkdir(parents=True)
    (src / "gotennet_homo.ckpt").write_bytes(b"weights" * 1000)
    got = hub.resolve_checkpoint("QM9_base_homo")
    assert got == str(tmp_path / "cache" / "QM9_base_homo.ckpt")
    assert open(got, "rb").read() == b"weights" * 1000
    # the primary missing: a mirror serves it
    mirror = tmp_path / "mirror" / str(tmp_path).lstrip("/") / "hub" / \
        "QM9" / "large"
    mirror.mkdir(parents=True)
    (mirror / "gotennet_U0.ckpt").write_bytes(b"m")
    monkeypatch.setenv("GOTENNET_TPU_CHECKPOINT_MIRRORS",
                       "file://" + str(tmp_path / "mirror"))
    assert open(hub.resolve_checkpoint("QM9_large_U0"), "rb").read() == b"m"
    assert sorted(os.listdir(tmp_path / "cache")) == [
        "QM9_base_homo.ckpt", "QM9_large_U0.ckpt"]


def test_a_failed_download_leaves_no_partial_file(tmp_path, monkeypatch):
    monkeypatch.setenv("CHECKPOINT_PATH", str(tmp_path / "cache"))
    monkeypatch.setattr(hub, "HUB_URL", "file://" + str(tmp_path) +
                        "/hub/{task}/{size}/gotennet_{label}.ckpt")
    with pytest.raises(FileNotFoundError, match="all 1 source"):
        hub.resolve_checkpoint("QM9_base_gap")   # no such file
    src = tmp_path / "hub" / "QM9" / "base"
    src.mkdir(parents=True)
    (src / "gotennet_gap.ckpt").write_bytes(b"z" * 4096)

    def broken(fsrc, fdst, length=0):
        fdst.write(fsrc.read(100))
        raise IOError("connection reset")

    monkeypatch.setattr(hub.shutil, "copyfileobj", broken)
    with pytest.raises(FileNotFoundError, match="gotennet_gap.ckpt"):
        hub.resolve_checkpoint("QM9_base_gap")
    assert os.listdir(tmp_path / "cache") == []


# ---- sweeps -----------------------------------------------------------------
DISTS = ["model.lr=loguniform(1e-5,1e-3)", "model.weight_decay=uniform(0,0.1)",
         "model.representation.lmax=int(1,3)",
         "model.representation.aggr=choice(add,mean,max)", "label=U0"]


def test_grid_and_samples_match_jax():
    for ovs in (["a=1,2", "b=x"], ["a=1,2,3", "b=x,y", "c=z"], []):
        assert sweep.expand_grid(ovs) == jsweep.expand_grid(ovs)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(5):
        assert (sweep.sample_overrides(DISTS, rng)
                == jsweep.sample_overrides(DISTS, jrng))


def _fake_train(cfg):
    """A deterministic stand-in for ``train``: a metric from the trial's
    overrides; lmax 3 fails (the sweep records it and goes on)."""
    ovs = dict(o.split("=", 1) for o in cfg["overrides"])
    if ovs["model.representation.lmax"] == "3":
        raise RuntimeError("lmax 3 refused")
    lr = float(ovs["model.lr"])
    return {"MeanAbsoluteError": (np.log(lr) + 8.0) ** 2
            + float(ovs["model.weight_decay"])
            + 0.1 * (ovs["model.representation.aggr"] == "max"),
            "val_loss": lr}


@pytest.mark.parametrize("search", ["run_random_search",
                                    "run_adaptive_search"])
def test_searches_write_jax_records(tmp_path, search):
    records = []
    for pkg, d in ((sweep, "port"), (jsweep, "jax")):
        getattr(pkg, search)(_fake_train, lambda extra: {"overrides": extra},
                             DISTS + ["workdir=elsewhere"], n_trials=9,
                             seed=3, sweep_dir=str(tmp_path / d),
                             metric="MeanAbsoluteError")
        lines = (tmp_path / d / "sweep.jsonl").read_text().splitlines()
        recs = [json.loads(line) for line in lines]
        for r in recs:
            r.pop("traceback", None)   # the two packages' file paths
        records.append(recs)
    assert records[0] == records[1]
    assert len(records[0]) == 10 and "best_overrides" in records[0][-1]
    assert any("error" in r for r in records[0][:-1])


# ---- graph tools --------------------------------------------------------------
def _padded_nodes(seed):
    """Three molecules and four padded nodes, as a collated batch lays
    them out (padded nodes in graph 0 at the origin)."""
    ds = synthetic_molecules(3, seed=seed, min_atoms=5, max_atoms=16)
    pos = np.concatenate([np.asarray(p, np.float32) for p in ds.pos]
                         + [np.zeros((4, 3), np.float32)])
    graph = np.concatenate([np.full(len(p), g, np.int32)
                            for g, p in enumerate(ds.pos)]
                           + [np.zeros(4, np.int32)])
    mask = np.arange(len(pos)) < len(pos) - 4
    return pos, graph, mask


@pytest.mark.parametrize("loop,max_degree,seed", [
    (True, 4, 0), (False, 4, 1), (True, 16, 2), (False, 16, 3)])
def test_radius_graph_is_jax_radius_graph(loop, max_degree, seed):
    pos, graph, mask = _padded_nodes(seed)
    want = radius_graph_jax(jax.numpy.asarray(pos), jax.numpy.asarray(graph),
                            jax.numpy.asarray(mask), 3.0, max_degree, loop)
    got = radius_graph(torch.from_numpy(pos), torch.from_numpy(graph),
                       torch.from_numpy(mask), 3.0, max_degree, loop)
    for g, w in zip(got, want):
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    src, dst, m = (t.numpy() for t in got)
    assert np.all(np.diff(dst) >= 0) and np.all(src[~m] == dst[~m])


def test_ell_from_graph_batch_is_jax_one():
    graphs = synthetic_molecules(3, seed=7, **SIZES).graph_dicts(range(3))
    jgraphs = j_synthetic(3, seed=7, **SIZES).graph_dicts(range(3))
    batch = collate_graphs(graphs, 40, 1024, 4)
    got = ell_from_graph_batch(batch, 12)
    want = j_ell_from_graph_batch(j_collate(jgraphs, 40, 1024, 4), 12)
    for f in ("z", "pos", "node_graph", "nbr", "nbr_mask", "node_mask",
              "graph_mask", "y"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.dy is None and want.dy is None
    sizes = [len(g["z"]) for g in graphs]
    np.testing.assert_array_equal(
        got.atom.numpy(), np.concatenate([np.arange(n) for n in sizes]
                                         + [np.zeros(40 - sum(sizes))]))


# ---- public names ---------------------------------------------------------------
def test_every_jax_public_name_resolves_in_the_port():
    for name in gotennet_tpu.__all__:
        assert getattr(gotennet_tpu_torch, name) is not None, name
    assert gotennet_tpu_torch.__version__ == gotennet_tpu.__version__
    assert set(gotennet_tpu_torch.__all__) == set(gotennet_tpu.__all__)
    rename = {"radius_graph_jax": "radius_graph"}
    want = {rename.get(n, n) for n in jgraph.__all__} - {"pad_sizes_for"}
    assert set(pgraph.__all__) == want
    for name in want:
        assert getattr(pgraph, name) is not None, name
    with pytest.raises(AttributeError):
        gotennet_tpu_torch.not_a_name


# ---- profiling and the multi-device bench ---------------------------------------
def test_profile_fn_on_a_cpu_forward(capsys):
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
    model = GotenModel(GotenNetConfig(**SMALL), HeadConfig(), "edge",
                       device="cpu")
    batch = collate_graphs(synthetic_molecules(2, seed=1, **SIZES)
                           .graph_dicts(range(2)), 32, 512, 2)
    with torch.no_grad():
        s = profile_fn(lambda: model(batch)["property"].sum().item(),
                       top_k=5)
    assert s["total_us"] > 0 and s["by_category_us"]["CPU ops"] > 0
    assert 0 < len(s["top_ops"]) <= 5
    assert all(op["name"] and op["us"] >= 0 for op in s["top_ops"])
    assert "CPU total:" in capsys.readouterr().out


def test_multichip_bench_at_world_size_one():
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    records = multichip_bench(
        cfg=GotenNetConfig(n_atom_basis=32, n_interactions=2, lmax=1,
                           n_rbf=8, num_heads=4), steps=1, batch_size=2,
        n_mol_min=4, n_mol_max=10, device="cpu")
    assert [r["mode"] for r in records] == list(MODES)
    for r in records:
        # the JAX package's record fields
        assert set(r) == {"mode", "n_devices", "mesh", "step_ms",
                          "per_chip_edges_per_s", "per_chip_edges_per_s_1dev",
                          "efficiency"}
        assert r["n_devices"] == 1 and r["mesh"] == {"data": 1, "edge": 1}
        assert r["step_ms"] > 0 and r["efficiency"] > 0
