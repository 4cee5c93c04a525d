"""The port's edge-list layout against the JAX package's default path.

The segment reductions (values and gradients, with masks, empty segments
and ties under max), ``collate_graphs`` and ``BatchLoader`` (every array of
every batch, a rebucket included), the edge ``GotenModel`` (``aggr`` add,
mean and max, ``scale_edge``, the ``sep_*`` options off, bf16 nodes,
attention dropout with the same keep masks), its forces, three training
steps against JAX's ``one_step`` loop, the force-training gradients, and
the ``Predictor`` and ``train_steps`` entry points.  Every model starts
from a JAX init converted by ``state_dict_from_jax_params``.  D = 32, 2
layers, synthetic molecules of 5-14 atoms.

Tolerances: float32 runs the same arithmetic with sums in another order
-> 1e-5 of each output's scale; bf16 node projections round at the same
points, but XLA on the CPU keeps some bf16 chains in float32 where torch
rounds each product -> 2e-2, as the dense and ELL tests hold them; the
gradients of a gradient (force training) go through two backward passes
-> 5e-4 of each gradient's scale, the tolerance the JAX package holds its
own gradients to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gotennet_tpu.data.dataset import BatchLoader as JBatchLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.graph import segment as jseg
from gotennet_tpu.graph.neighborlist import collate_graphs as j_collate
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.models.model import apply_with_forces as j_apply_with_forces
from gotennet_tpu.tasks.force_task import MD17Task as JMD17Task
from gotennet_tpu.tasks.qm9 import QM9Task as JQM9Task
from gotennet_tpu.train import optim as joptim
from gotennet_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from gotennet_tpu_torch.data.dataset import BatchLoader, synthetic_molecules
from gotennet_tpu_torch.graph import segment
from gotennet_tpu_torch.graph.neighborlist import collate_graphs
from gotennet_tpu_torch.models import gotennet
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import (GotenModel, HeadConfig,
                                             apply_with_forces)
from gotennet_tpu_torch.serve import Predictor
from gotennet_tpu_torch.tasks.force_task import MD17Task
from gotennet_tpu_torch.tasks.qm9 import QM9Task
from gotennet_tpu_torch.train import optim
from gotennet_tpu_torch.train.trainer import (accum_grads, make_loss_fn,
                                              train_step, train_steps)
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
MOLS = dict(min_atoms=5, max_atoms=14)
FIELDS = ("z", "pos", "node_graph", "edge_src", "edge_dst", "node_mask",
          "edge_mask", "graph_mask", "y", "dy")


def _scaled(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def _same_batch(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), f)


# ---- segment reductions -----------------------------------------------------
def _segment_inputs(seed=0):
    """12 rows with two trailing axes into 5 segments: segment 3 has no row,
    segment 4 only masked ones; rows 0-2 of segment 0 tie for the max.  The
    cotangents: one a segment, and one a row for the softmax (whose
    gradient a per-segment one would make zero)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((12, 3, 2)).astype(np.float32)
    data[1] = data[0]
    data[2] = data[0]
    ids = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 4, 4, 2], np.int32)
    mask = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 1], bool)
    cot = rng.standard_normal((5, 3, 2)).astype(np.float32)
    row_cot = rng.standard_normal((12, 3, 2)).astype(np.float32)
    return data, ids, mask, cot, row_cot


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("op", ["sum", "mean", "max", "softmax"])
def test_segments_match_jax(op, masked):
    """Values and the gradient of a random projection of them, against the
    JAX package's, to 1e-6 of scale (float32, a few summands)."""
    data, ids, mask, cot, row_cot = _segment_inputs()
    m = mask if masked else None
    if op == "softmax":
        cot = row_cot
    jfn = getattr(jseg, f"segment_{op}")
    pfn = getattr(segment, f"segment_{op}")

    def jloss(x):
        out = jfn(x, jnp.asarray(ids), 5,
                  None if m is None else jnp.asarray(m))
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_(True)
    out = pfn(x, torch.from_numpy(ids), 5,
              None if m is None else torch.from_numpy(m))
    torch.sum(torch.where(torch.isfinite(out), out, 0.0)
              * torch.from_numpy(cot)).backward()
    jout = np.asarray(jout)
    # an empty segment's max is -inf in both
    assert np.array_equal(np.isfinite(jout), np.isfinite(out.detach()
                                                         .numpy()))
    fin = np.isfinite(jout)
    _scaled(out.detach().numpy()[fin], jout[fin], 1e-6, op)
    _scaled(x.grad.numpy(), jgrad, 1e-6, f"{op} gradient")
    if masked:      # masked rows get no gradient
        assert np.all(x.grad.numpy()[~mask] == 0)


def test_softmax_of_an_all_masked_segment_has_zero_gradients():
    logits = torch.randn(4, 2, 1, requires_grad=True)
    ids = torch.tensor([0, 0, 1, 1])
    mask = torch.tensor([True, True, False, False])
    out = segment.segment_softmax(logits, ids, 2, mask)
    out.sum().backward()
    assert torch.all(out[2:] == 0) and torch.isfinite(logits.grad).all()
    assert torch.all(logits.grad[2:] == 0)


def test_empty_segments_aggregate_to_zeros_under_max():
    data = torch.randn(4, 3)
    ids = torch.tensor([0, 0, 2, 2])
    mask = torch.tensor([True, True, False, False])
    out = gotennet._segment_aggregate("max", data, ids, 3, mask)
    assert torch.all(out[1:] == 0)
    assert torch.equal(out[0], torch.amax(data[:2], dim=0))


# ---- collation and the loader ----------------------------------------------
@pytest.mark.parametrize("loop,cap", [(True, 32), (False, 3)])
def test_collate_graphs_matches_jax(loop, cap):
    ds = synthetic_molecules(3, seed=2, with_forces=True, **MOLS)
    jds = j_synthetic(3, seed=2, with_forces=True, **MOLS)
    kw = dict(num_nodes=48, num_edges=1024, num_graphs=4, loop=loop,
              max_num_neighbors=cap, with_forces=True)
    _same_batch(collate_graphs(ds.graph_dicts(range(3)), **kw),
                j_collate(jds.graph_dicts(range(3)), **kw))
    with pytest.raises(ValueError, match="edge capacity"):
        collate_graphs(ds.graph_dicts(range(3)), 48, 64, 4)
    with pytest.raises(ValueError, match="node capacity"):
        collate_graphs(ds.graph_dicts(range(3)), 8, 1024, 4)


@pytest.mark.parametrize("kw", [
    dict(neighbor_probe=4, shuffle=True, seed=3),
    dict(neighbor_probe="full", drop_last=True),
    dict(edge_capacity=128, node_capacity=64),     # rebuckets
])
def test_batch_loader_matches_jax(kw):
    """Capacities, and every array of every batch over two epochs."""
    ds = synthetic_molecules(11, seed=4, with_forces=True, **MOLS)
    jds = j_synthetic(11, seed=4, with_forces=True, **MOLS)
    got, want = BatchLoader(ds, 3, **kw), JBatchLoader(jds, 3, **kw)
    assert len(got) == len(want)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        pairs = list(zip(got.batches(), want))
        assert len(pairs) == len(want)
        for (_, a), b in pairs:
            _same_batch(a, b)
        assert (got.node_capacity, got.edge_capacity) == (
            want.node_capacity, want.edge_capacity)
    if "edge_capacity" in kw:
        assert got.edge_capacity > 128
    # sharded over 2 processes (training: the trailing batch left out)
    got.set_shard(2, 1)
    want.set_shard(2, 1)
    pairs = list(zip(got.batches(), want))
    assert len(pairs) == len(list(want)) == len(got) // 2
    for (_, a), b in pairs:
        _same_batch(a, b)


# ---- the model ---------------------------------------------------------------
_INIT = {}


def _loaders(n=3, seed=1, batch=3, forces=False):
    kw = dict(with_forces=forces, **MOLS)
    return (JBatchLoader(j_synthetic(n, seed=seed, **kw), batch),
            BatchLoader(synthetic_molecules(n, seed=seed, **kw), batch))


def _pair(kw, bf16=False, jhead=None, head=None, remat=True):
    """(jax model, params, port model) from one JAX init (made once per
    configuration) on the first batch of ``_loaders()``."""
    jhead, head = jhead or JHead(), head or HeadConfig()
    jcfg = JConfig(**SMALL, **kw, remat=remat,
                   **(dict(node_dtype=jnp.bfloat16) if bf16 else {}))
    jmodel = JModel(jcfg, jhead, layout="edge")
    if (jcfg, jhead) not in _INIT:
        jbatch = next(iter(_loaders()[0]))
        _INIT[jcfg, jhead] = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                  jbatch)
    params = _INIT[jcfg, jhead]
    cfg = GotenNetConfig(**SMALL, **{"fused": False, **kw}, remat=remat,
                         **(dict(node_dtype=torch.bfloat16) if bf16 else {}))
    model = GotenModel(cfg, head, "edge", device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg, head))
    return jmodel, params, model


CONFIGS = {
    "add": dict(),
    "mean": dict(aggr="mean"),
    "max_ssp": dict(aggr="max", activation="ssp"),
    "scale_edge_gaussian": dict(scale_edge=True, radial_basis="GaussianRBF"),
    "joint": dict(sep_dir=False, sep_tensor=False, sep_htr=False),
}


@pytest.mark.parametrize("name,bf16", [(n, False) for n in CONFIGS]
                         + [("add", True)])
def test_edge_model_matches_jax(name, bf16):
    jmodel, params, model = _pair(CONFIGS[name], bf16)
    jloader, loader = _loaders()
    jout = jax.jit(jmodel.apply)(params, next(iter(jloader)))
    with torch.inference_mode():
        pout = model(next(iter(loader)))
    for key in ("property", "representation", "vector_representation"):
        _scaled(pout[key].numpy(), jout[key], 2e-2 if bf16 else 1e-5, key)


def test_the_edge_layout_ignores_the_kernel_options():
    """The port's default config (``fused=True``, bf16 pairs, ``fused_htr``)
    builds the same edge model, with the same answer bits, as
    ``fused=False``: the edge layer reaches no kernel, as in JAX."""
    _, _, model = _pair({})
    batch = next(iter(_loaders()[1]))
    cfg = GotenNetConfig(**SMALL, fused=True, fused_htr=True,
                         pair_dtype=torch.bfloat16)
    other = GotenModel(cfg, HeadConfig(), "edge", device="cpu")
    other.load_state_dict(model.state_dict())
    with torch.inference_mode():
        assert torch.equal(model(batch)["property"],
                           other(batch)["property"])


def test_edge_dropout_matches_jax(monkeypatch):
    """The same ``[E, H]`` keep mask a layer on both sides (JAX's flax
    Dropout draws ``[E, H, 1]`` through the patched bernoulli): outputs at
    1e-5 of scale, parameter gradients at 5e-4."""
    rate = 0.1
    jloader, loader = _loaders()
    jbatch, batch = next(iter(jloader)), next(iter(loader))
    shape = (batch.num_edges, SMALL["num_heads"])
    rng = np.random.default_rng(0)
    masks = [rng.random(shape) < 1.0 - rate
             for _ in range(SMALL["n_interactions"])]
    jmodel, params, model = _pair(dict(attn_dropout=rate), remat=False)
    queue = list(masks)

    def bernoulli(key, p=0.5, shape=None):
        mask = queue.pop(0)
        assert tuple(shape) == mask.shape + (1,)
        return jnp.asarray(mask[..., None])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    def energy(p):
        out = jmodel.apply(p, jbatch, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out["property"]), out["property"]

    (_, want), jgrads = jax.jit(jax.value_and_grad(energy, has_aux=True))(
        params)
    assert not queue
    queue = list(masks)
    monkeypatch.setattr(gotennet, "attention_keep_mask",
                        lambda shape, rate, gen, dev: torch.from_numpy(
                            queue.pop(0)))
    model.train()
    got = model(batch)["property"]
    got.sum().backward()
    assert not queue
    _scaled(got.detach().numpy(), want, 1e-5, "property")
    want_g = state_dict_from_jax_params(jax.device_get(jgrads), model.cfg,
                                        model.head)
    for name, p in model.named_parameters():
        _scaled(p.grad.numpy(), want_g[name].numpy(), 5e-4, name)


def test_edge_forces_match_jax():
    """Energies and forces of a derivative head, 1e-4 of each output's scale
    (float32 through one backward pass, as tests/test_torch_port_forces.py);
    zero on padded nodes."""
    head = HeadConfig(derivative=True)
    jmodel, params, model = _pair({}, jhead=JHead(derivative=True),
                                  head=head)
    jloader, loader = _loaders()
    jbatch, batch = next(iter(jloader)), next(iter(loader))
    jout = jax.jit(lambda p, b: j_apply_with_forces(jmodel, p, b))(params,
                                                                 jbatch)
    pout = apply_with_forces(model, batch)
    for key in ("property", "forces"):
        _scaled(pout[key].detach().numpy(), jout[key], 1e-4, key)
    mask = batch.node_mask.numpy()
    assert np.all(pout["forces"].numpy()[~mask] == 0)


N_STEPS, LR = 3, 1e-4


def test_three_training_steps_match_jax():
    """``bench.py``'s ``one_step`` loop (two 2-graph chunks a step, L1 on
    the property, clip 5.0, AdamW) in JAX against the port's
    ``train_step``: the first step's gradients at 1e-5 of each gradient's
    scale, three losses at rtol 1e-5, the parameters with the tolerance
    and its reason of tests/test_torch_port_train.py (Adam moves an element
    whose gradient sits at rounding level by up to 2 lr a step)."""
    meta = {"mean": 0.0, "std": 1.0}
    jtask, task = JQM9Task("U0", dataset_meta=meta), QM9Task("U0", meta)
    jloader, loader = _loaders(n=4, seed=7, batch=2)
    jchunks, chunks = list(jloader), list(loader)
    jmodel, params, model = _pair({}, jhead=jtask.build_head(),
                                  head=task.build_head(), remat=False)
    grad_fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jmodel, jtask),
                                         has_aux=True), static_argnums=(3,))
    tx = joptim.make_optimizer(LR, weight_decay=0.0)
    state, jp, jlosses, first = tx.init(params), params, [], None
    for _ in range(N_STEPS):
        outs = [grad_fn(jp, c, jax.random.PRNGKey(1), False)
                for c in jchunks]
        jlosses.append(sum(float(l) for (l, _), _ in outs) / len(outs))
        grads = jax.tree.map(lambda *g: sum(g) / len(g),
                             *[g for _, g in outs])
        first = grads if first is None else first
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)

    loss_fn = make_loss_fn(model, task)
    model.train()
    loss = accum_grads(model, loss_fn, chunks)
    np.testing.assert_allclose(float(loss), jlosses[0], rtol=1e-5)
    want = state_dict_from_jax_params(first, model.cfg, model.head)
    for name, p in model.named_parameters():
        _scaled(p.grad.numpy(), want[name].numpy(), 1e-5, name)
    model.load_state_dict(state_dict_from_jax_params(params, model.cfg,
                                                     model.head))
    opt = optim.make_optimizer(model.parameters(), LR)
    losses = [train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)
              for _ in range(N_STEPS)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = state_dict_from_jax_params(jp, model.cfg, model.head)
    n_off = n_all = 0
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        diff = np.abs(got - w)
        assert diff.max() <= 2 * LR * N_STEPS, (name, diff.max())
        n_off += int(np.sum(diff > 1e-3 * LR + 1e-6 * np.abs(w)))
        n_all += w.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_force_training_gradients_match_jax():
    """The MD17Task loss (MSE, energy 0.05 / force 0.95) and its parameter
    gradients, a gradient of a gradient, against ``jax.value_and_grad`` of
    JAX's ``make_loss_fn``: the loss at rtol 1e-5, each gradient at 5e-4 of
    its scale."""
    meta, tc = {"mean": 0.0, "std": 1.0}, {"task_loss": "MSELoss"}
    jtask, task = JMD17Task("x", meta, tc), MD17Task("x", meta, tc)
    jloader, loader = _loaders(forces=True)
    jbatch, batch = next(iter(jloader)), next(iter(loader))
    jmodel, params, model = _pair({}, jhead=jtask.build_head(),
                                  head=task.build_head(), remat=False)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        j_make_loss_fn(jmodel, jtask), has_aux=True), static_argnums=(3,))(
            params, jbatch, None, True)
    model.train()
    loss = accum_grads(model, make_loss_fn(model, task), [batch])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = state_dict_from_jax_params(jax.device_get(jgrads), model.cfg,
                                      model.head)
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        _scaled(p.grad.numpy(), want[name].numpy(), 5e-4, name)


# ---- the entry points ------------------------------------------------------
def test_predictor_and_train_steps_on_the_edge_layout():
    """``Predictor(layout="edge")`` answers each molecule as the model does
    alone (f32; padding and chunking change only the order of sums), in
    request order, forces included; ``train_steps(layout="edge")`` trains
    on forces (the edge layout runs no kernel)."""
    mols = synthetic_molecules(5, seed=6, with_forces=True,
                               **MOLS).graph_dicts(range(5))
    head = HeadConfig(derivative=True)
    cfg = GotenNetConfig(**SMALL, remat=False)
    pred = Predictor(cfg, head, seed=2, device="cpu", chunk=3, layout="edge")
    energies, forces = pred.predict_with_forces(mols)
    np.testing.assert_allclose(pred.predict(mols), energies, rtol=1e-5,
                               atol=1e-6)
    for i in (0, 4):
        m = mols[i]
        alone = apply_with_forces(pred.model, collate_graphs([m], 16, 512, 1))
        np.testing.assert_allclose(energies[i],
                                   alone["property"][0].detach().numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            forces[i], alone["forces"][:len(m["z"])].detach().numpy(),
            rtol=1e-4, atol=1e-4)
    task = MD17Task("x", {"mean": 0.0, "std": 1.0}, {"task_loss": "MSELoss"})
    losses = train_steps(cfg, task.build_head(), mols[:3], 2, chunk=3,
                         lr=1e-3, device="cpu", layout="edge", task=task)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
