"""More than one device: the port's ranks over Gloo on the CPU against the
JAX package on its virtual 8-device CPU mesh (or its one-device run).

Each test starts 2 or 4 ranks (``torch_port_ranks.spawn_ranks``: one
process each, one torch thread, ``file://`` rendezvous in the test's temp
dir, killed at a time limit) from one converted JAX init, and compares
what they give with the JAX package:
- the mesh's rank grid with JAX's device grid, and the collectives (psum's
  backward is the all-reduce of the cotangent, JAX's transpose of psum);
- edge partitioning (4 ranks) and ELL row sharding (2 ranks: the plain
  gathers, the windowed ones and the fused kernels' plain twins) against
  the one-device forward, forces included, at JAX's own 2e-5;
- one data x edge parallel step at (2, 1) and (2, 2) against JAX's serial
  step (JAX's rtol 5e-4 / atol 5e-6);
- the ``Trainer``: data parallelism against JAX's gradient accumulation,
  edge partitioning and row sharding against JAX's one-device fit, sharded
  evaluation with a partial trailing group, the fused dense and ELL models,
  and ``distributed`` with ``set_shard`` loaders against JAX's one-process
  ``data_parallel=2``, at JAX's tolerances (rtol 1e-4 / atol 1e-6; 2e-4 /
  1e-5 for the fused paths; 1e-5 for evaluation);
- ``set_shard``'s batches against JAX's, and ``aggr="max"`` under
  ``edge_parallel``, which cannot train (JAX's pmax has no JVP).
Every rank must end with the same parameters, bit for bit.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gotennet_tpu.data import dataset as jdataset
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.models.model import apply_with_forces as j_forces
from gotennet_tpu.parallel import make_mesh as j_make_mesh
from gotennet_tpu.tasks.qm9 import QM9Task as JQM9Task
from gotennet_tpu.train.optim import make_optimizer as j_make_optimizer
from gotennet_tpu.train.trainer import Trainer as JTrainer
from gotennet_tpu.train.trainer import TrainerConfig as JTrainerConfig
from gotennet_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from gotennet_tpu_torch.data import dataset
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import HeadConfig
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_ranks import Ranks, spawn_ranks  # noqa: E402

# fused False as JAX's default (the port's config defaults to True); no
# remat, which changes no value and would slow JAX's compilation
CFG = dict(n_atom_basis=32, n_interactions=2, lmax=1, n_rbf=8, num_heads=4,
           fused=False, remat=False)
LOADERS = {"edge": (jdataset.BatchLoader, "BatchLoader"),
           "dense": (jdataset.DenseLoader, "DenseLoader"),
           "ell": (jdataset.ELLLoader, "ELLLoader")}


def _state(params, cfg, head=None):
    return state_dict_from_jax_params(params, GotenNetConfig(**cfg),
                                      head or HeadConfig())


def _close_states(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def _same_on_every_rank(outs, key="state"):
    for o in outs[1:]:
        assert all(torch.equal(o[key][k], outs[0][key][k])
                   for k in outs[0][key])


# ---- the mesh and the collectives ---------------------------------------------
def test_mesh_grid_and_collectives(tmp_path):
    outs = spawn_ranks("collectives", tmp_path, 4, {})
    jgrid = np.vectorize(lambda d: d.id)(j_make_mesh((2, 2)).devices)
    assert j_make_mesh((-1, 2)).devices.shape == (4, 2)
    for r, o in enumerate(outs):
        assert o["shape"] == (2, 2)
        assert o["devices"] == (jgrid - jgrid.min()).tolist()
        d, e = divmod(r, 2)
        assert o["coords"] == (d, e)
        lines = {"data": [e, 2 + e], "edge": [2 * d, 2 * d + 1],
                 "both": [0, 1, 2, 3]}
        for key, ranks in lines.items():
            want = sum(torch.tensor([float(q), 1.0]) * (q + 1) for q in ranks)
            assert torch.equal(o[f"psum_{key}"], want), key
            # psum transposes to psum: each rank's cotangent is the sum of
            # the axis's ones, times its own factor
            assert torch.equal(o[f"grad_{key}"],
                               torch.full((2,), float(len(ranks) * (r + 1))))
            assert torch.allclose(o[f"pmean_{key}"], sum(
                torch.tensor([float(q), 1.0]) for q in ranks) / len(ranks))
            assert torch.equal(o[f"pmax_{key}"], torch.stack([
                torch.tensor([float(q), 1.0]) * (1 - 2 * (q % 2))
                for q in ranks]).amax(0))
        assert "no gradient" in o["pmax_grad_error"]


# ---- sharded forwards -------------------------------------------------------------
def _forward_case(layout, variant="take", n=6, force=True):
    """A JAX one-device forward (and forces) from its init, and the port's
    inputs for the same batch and weights."""
    cfg = dict(CFG, lmax=2 if layout == "edge" else 1)
    if variant == "fused":
        cfg.update(fused=True)
    ds = dataset.synthetic_molecules(n, seed=0, min_atoms=6, max_atoms=10)
    jds = jdataset.synthetic_molecules(n, seed=0, min_atoms=6, max_atoms=10)
    if layout == "edge":
        kw = dict(cutoff=5.0, node_capacity=40, edge_capacity=512)
        bs = 4
    else:
        kw = dict(cutoff=5.0, spatial_sort=variant == "windowed",
                  block_rows=8 if variant == "windowed" else None)
        bs = n
    jbatch = next(iter(LOADERS[layout][0](jds, bs, **kw)))
    batch = next(iter(getattr(dataset, LOADERS[layout][1])(ds, bs, **kw)))
    head = dict(derivative=force)
    jmodel = JModel(JConfig(**cfg), JHead(**head), layout=layout)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    inp = dict(cfg=cfg, head=head, layout=layout, batch=batch,
               state_dict=_state(params, cfg, HeadConfig(**head)))
    return (lambda: jax.jit(lambda p, b: j_forces(jmodel, p, b))(
        params, jbatch)), inp


def _hold_forward(outs, want):
    for o in outs:
        for key, name in (("property", "property"), ("h", "representation"),
                          ("X", "vector_representation"),
                          ("forces", "forces")):
            np.testing.assert_allclose(o[key].numpy(), np.asarray(want[name]),
                                       rtol=2e-5, atol=2e-5, err_msg=key)


def test_edge_parallel_forward_matches_jax(tmp_path):
    """The edge list split over 4 ranks: representation, property and
    forces equal JAX's one-device forward."""
    want, inp = _forward_case("edge")
    ranks = Ranks("forward", tmp_path, 4, inp)
    want = want()
    _hold_forward(ranks.wait(), want)


@pytest.mark.parametrize("variant", ["take", "windowed", "fused"])
def test_ell_row_sharded_forward_matches_jax(tmp_path, variant):
    """Destination rows split over 2 ranks (NR = N / 2 rows a rank over the
    whole table, the fused kernels' twins included) == JAX's one-device
    forward, forces too."""
    want, inp = _forward_case("ell", variant)
    assert inp["batch"].num_nodes % 2 == 0
    ranks = Ranks("forward", tmp_path, 2, inp)
    want = want()
    _hold_forward(ranks.wait(), want)


# ---- one parallel step against JAX's serial one -----------------------------------
@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_parallel_train_step_matches_jax_serial(tmp_path, mesh_shape):
    import optax
    n_data = mesh_shape[0]
    kw = dict(cutoff=5.0, node_capacity=40, edge_capacity=512)
    jds = jdataset.synthetic_molecules(n_data * 4, seed=0, min_atoms=5,
                                       max_atoms=9)
    ds = dataset.synthetic_molecules(n_data * 4, seed=0, min_atoms=5,
                                     max_atoms=9)
    jbatches = list(jdataset.BatchLoader(jds, 4, **kw))[:n_data]
    batches = list(dataset.BatchLoader(ds, 4, **kw))[:n_data]
    cfg = dict(CFG, lmax=2)
    task = JQM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0})
    jmodel = JModel(JConfig(**cfg), task.build_head())
    params = jmodel.init(jax.random.PRNGKey(0), jbatches[0])
    loss_fn = j_make_loss_fn(jmodel, task)
    ranks = Ranks("step", tmp_path, n_data * mesh_shape[1], dict(
        cfg=cfg, layout="edge", mesh=mesh_shape, lr=1e-3, batches=batches,
        state_dict=_state(params, cfg)))

    def total(p):
        return sum(loss_fn(p, b, jax.random.PRNGKey(0), True)[0]
                   for b in jbatches) / n_data

    loss_ref, grads = jax.jit(jax.value_and_grad(total))(params)
    tx = j_make_optimizer(1e-3, 0.0, grad_clip=None)
    updates, _ = tx.update(grads, tx.init(params), params)
    p_ref = optax.apply_updates(params, updates)
    outs = ranks.wait()
    _same_on_every_rank(outs)
    for o in outs:
        np.testing.assert_allclose(o["loss"], float(loss_ref), rtol=1e-5,
                                   atol=1e-6)
    _close_states(outs[0]["state"], _state(p_ref, cfg), 5e-4, 5e-6)


# ---- the Trainer -------------------------------------------------------------------
def _trainer_case(layout, n=16, bs=4, cfg_kw=None, loader=None, seed=0):
    """JAX's model, init and loader, and the port's inputs for the same
    molecules (training and validation on the same ones, as JAX's tests
    run them)."""
    cfg = dict(CFG, **(cfg_kw or {}))
    jds = jdataset.synthetic_molecules(n, seed=0, min_atoms=5, max_atoms=10)
    meta = {"mean": float(jds.y.mean()), "std": float(jds.y.std())}
    task = JQM9Task("U0", dataset_meta=meta)
    lkw = dict(loader or {})
    if layout != "dense":
        lkw.setdefault("cutoff", 5.0)
    jloader = LOADERS[layout][0](jds, bs, **lkw)
    jmodel = JModel(JConfig(**cfg), task.build_head(), layout=layout)
    params = jmodel.init(jax.random.PRNGKey(seed), next(iter(jloader)))
    ds = dataset.synthetic_molecules(n, seed=0, min_atoms=5, max_atoms=10)
    head = HeadConfig(mean=meta["mean"], stddev=meta["std"])
    inp = dict(cfg=cfg, head=dataclasses.asdict(head), layout=layout,
               state_dict=_state(params, cfg, head), z=ds.z, pos=ds.pos,
               y=ds.y, train_idx=list(range(n)), val_idx=list(range(n)),
               batch_size=bs, meta=meta, loader=lkw)
    return jmodel, task, jloader, params, inp


def _jax_fit(jmodel, task, loader, params, tmp_path, **kw):
    t = JTrainer(jmodel, task, JTrainerConfig(
        lr=1e-3, max_epochs=1, scheduler="none", workdir=str(tmp_path),
        **kw))
    return t.fit(params, loader, loader)


def _runs(inp, tmp_path, world, runs) -> Ranks:
    """The ranks running each of ``runs`` (trainer overrides, or input
    overrides with their own ``trainer``), started."""
    inp = dict(inp, workdir=str(tmp_path / "runs"), runs=[
        dict(trainer={**dict(lr=1e-3, max_epochs=1, scheduler="none"), **r})
        if "trainer" not in r else r for r in runs])
    return Ranks("trainer", tmp_path / "ranks", world, inp)


def test_data_parallel_matches_jax_grad_accum(tmp_path):
    """dp=2 over pairs of batches == JAX's 2-batch accumulation (both
    average two batches' gradients before one AdamW update); only rank 0
    writes its checkpoints."""
    jmodel, task, jloader, params, inp = _trainer_case("edge")
    ranks = _runs(inp, tmp_path, 2, [dict(data_parallel=2)])
    p_acc, h_acc = _jax_fit(jmodel, task, jloader, params, tmp_path / "j",
                            grad_accum_steps=2)
    runs = [o[0] for o in ranks.wait()]
    _same_on_every_rank(runs)
    _close_states(runs[0]["state"], _state(p_acc, inp["cfg"], HeadConfig(
        **inp["head"])), 1e-4, 1e-6)
    for r in runs:
        assert np.isclose(r["history"][-1]["val_loss"],
                          h_acc[-1]["val_loss"], rtol=1e-4)
        assert {"ckpt_best", "ckpt_last", "metrics.jsonl"} <= set(r["files"])


def test_edge_parallel_matches_jax_single_device(tmp_path):
    """Edge partitioning over 2 ranks == JAX's one-device fit; the same with
    aggr='max' cannot train (JAX's pmax has no JVP) and says so before its
    first step."""
    jmodel, task, jloader, params, inp = _trainer_case("edge")
    ranks = _runs(inp, tmp_path, 2, [
        dict(edge_parallel=2),
        dict(trainer=dict(lr=1e-3, max_epochs=1, edge_parallel=2),
             cfg=dict(inp["cfg"], aggr="max"), state_dict=None)])
    p_ser, _ = _jax_fit(jmodel, task, jloader, params, tmp_path / "j")
    outs = ranks.wait()
    _same_on_every_rank([o[0] for o in outs])
    _close_states(outs[0][0]["state"], _state(p_ser, inp["cfg"], HeadConfig(
        **inp["head"])), 1e-4, 1e-6)
    for o in outs:
        assert "aggr='max' under edge_parallel" in o[1]["error"]


def test_parallel_eval_matches_jax(tmp_path):
    """Evaluation over dp=2 and over a (2, 2) mesh, 5 batches: 2 full groups
    and a trailing one padded with a repeat that is not counted == JAX's
    one-device metrics."""
    jmodel, task, jloader, params, inp = _trainer_case("edge", n=20)
    ranks = [(world, _runs(dict(inp, eval_only=True), tmp_path / str(world),
                           world, runs))
             for world, runs in ((2, [dict(data_parallel=2)]),
                                 (4, [dict(data_parallel=2,
                                           edge_parallel=2)]))]
    want = JTrainer(jmodel, task, JTrainerConfig(
        lr=1e-3, workdir=str(tmp_path / "j"))).evaluate(params, jloader)
    for world, started in ranks:
        for o in started.wait():
            for k in want:
                np.testing.assert_allclose(o[0]["metrics"][k], want[k],
                                           rtol=1e-5, err_msg=k)


def test_data_parallel_fused_dense_matches_jax(tmp_path):
    """The fused dense model (its kernels' plain twins) under dp=2 ==
    JAX's 2-batch accumulation (its XLA message: the same math)."""
    jmodel, task, jloader, params, inp = _trainer_case(
        "dense", cfg_kw=dict(remat=False))
    inp["cfg"] = dict(inp["cfg"], fused=True)
    ranks = _runs(inp, tmp_path, 2, [dict(data_parallel=2)])
    p_acc, h_acc = _jax_fit(jmodel, task, jloader, params, tmp_path / "j",
                            grad_accum_steps=2)
    outs = ranks.wait()
    _same_on_every_rank([o[0] for o in outs])
    _close_states(outs[0][0]["state"], _state(p_acc, CFG, HeadConfig(
        **inp["head"])), 2e-4, 1e-5)
    assert np.isclose(outs[0][0]["history"][-1]["val_loss"],
                      h_acc[-1]["val_loss"], rtol=2e-4)


@pytest.mark.parametrize("spatial", [False, True], ids=["take", "windowed"])
def test_ell_data_parallel_matches_jax_grad_accum(tmp_path, spatial):
    """ELL batches under dp=2 == JAX's 2-batch accumulation: the plain
    message, and the fused one (its twins) with both gather modes."""
    loader = dict(spatial_sort=spatial, block_rows=8 if spatial else None)
    jmodel, task, jloader, params, inp = _trainer_case(
        "ell", n=8, bs=2, loader=loader, cfg_kw=dict(remat=False))
    ranks = _runs(inp, tmp_path, 2, [
        dict(data_parallel=2),
        dict(trainer=dict(lr=1e-3, max_epochs=1, scheduler="none",
                          data_parallel=2),
             cfg=dict(inp["cfg"], fused=True))])
    p_acc, _ = _jax_fit(jmodel, task, jloader, params, tmp_path / "j",
                        grad_accum_steps=2)
    want = _state(p_acc, CFG, HeadConfig(**inp["head"]))
    outs = ranks.wait()
    for i, (rtol, atol) in enumerate(((1e-4, 1e-6), (2e-4, 1e-5))):
        _same_on_every_rank([o[i] for o in outs])
        _close_states(outs[0][i]["state"], want, rtol, atol)


def test_ell_row_sharded_trainer_matches_jax(tmp_path):
    """Row sharding over 2 ranks (edge_parallel=2 on the ELL layout) ==
    JAX's one-device fit."""
    jmodel, task, jloader, params, inp = _trainer_case("ell", n=8)
    ranks = _runs(inp, tmp_path, 2, [dict(edge_parallel=2)])
    p_ser, _ = _jax_fit(jmodel, task, jloader, params, tmp_path / "j")
    outs = ranks.wait()
    _same_on_every_rank([o[0] for o in outs])
    _close_states(outs[0][0]["state"], _state(p_ser, CFG, HeadConfig(
        **inp["head"])), 1e-4, 1e-6)


def test_two_distributed_ranks_match_jax_data_parallel(tmp_path):
    """JAX's test_distributed claim: two ranks with ``distributed=True``,
    each reading its ``set_shard`` of a shuffled loader, give the
    parameters and the validation records of JAX's one process with
    ``data_parallel=2``.  That run is held here through its equal, JAX's
    2-batch accumulation over the same loader (JAX's
    test_trainer_parallel holds the two equal; its mesh step alone takes
    some 15 s more to compile).  lr 1e-3 for one epoch: at JAX's lr 5e-3
    over two epochs, AdamW's normalisation turns the float32 rounding
    differences of near-zero gradient entries between the two frameworks
    into update differences of order lr, past the 1e-6 atol that JAX's
    test holds between two runs of its own arithmetic."""
    jmodel, task, _, params, inp = _trainer_case("edge", n=32, bs=8)
    ranks = _runs(dict(inp, train_loader=dict(shuffle=True, seed=1),
                       shard=True), tmp_path, 2, [
        dict(lr=1e-3, max_epochs=1, data_parallel=2, distributed=True)])
    jds = jdataset.synthetic_molecules(32, seed=0, min_atoms=5, max_atoms=10)
    train = jdataset.BatchLoader(jds, 8, cutoff=5.0, shuffle=True, seed=1)
    val = jdataset.BatchLoader(jds, 8, cutoff=5.0)
    jt = JTrainer(jmodel, task, JTrainerConfig(
        lr=1e-3, max_epochs=1, scheduler="none", grad_accum_steps=2,
        workdir=str(tmp_path / "j")))
    p_dp, h_dp = jt.fit(params, train, val)
    outs = ranks.wait()
    _same_on_every_rank([o[0] for o in outs])
    _close_states(outs[0][0]["state"], _state(p_dp, CFG, HeadConfig(
        **inp["head"])), 1e-4, 1e-6)
    for o in outs:
        for got, want in zip(o[0]["history"], h_dp):
            for key in ("val_loss", "MeanAbsoluteError", "train_loss"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                           err_msg=key)


@pytest.mark.parametrize("kind", ["edge", "dense", "ell"])
def test_set_shard_matches_jax(kind):
    """Each rank's batches under ``set_shard`` (training: trailing batches
    left out; evaluation: wrapped round) equal JAX's, for 2 and 3 ranks."""
    ds = dataset.synthetic_molecules(22, seed=4, min_atoms=5, max_atoms=12)
    jds = jdataset.synthetic_molecules(22, seed=4, min_atoms=5, max_atoms=12)
    kw = dict(shuffle=True, seed=2)
    if kind != "dense":
        kw["cutoff"] = 5.0
    for world in (2, 3):
        for pad in (False, True):
            seen = []
            for rank in range(world):
                got = getattr(dataset, LOADERS[kind][1])(ds, 4, **kw)
                want = LOADERS[kind][0](jds, 4, **kw)
                got.set_shard(world, rank, pad=pad)
                want.set_shard(world, rank, pad=pad)
                assert got._shard_batch_indices(6) == \
                    want._shard_batch_indices(6)
                got.set_epoch(1)
                want.set_epoch(1)
                pairs = list(zip(got, want))
                assert len(pairs) == len(list(want))
                for a, b in pairs:
                    np.testing.assert_array_equal(a.y.numpy(),
                                                  np.asarray(b.y))
                seen += got._shard_batch_indices(6)
            assert sorted(set(seen)) == list(range(6 if pad else 6 - 6
                                                   % world))
    with pytest.raises(ValueError, match="bad shard"):
        getattr(dataset, LOADERS[kind][1])(ds, 4, **kw).set_shard(2, 2)
