"""Packed dense batches (several molecules to a slab) against the JAX
package.

``pack_molecules`` gives JAX's slabs exactly; ``collate_dense_packed``,
``flatten_nodes`` and ``DenseLoader(pack=True)`` (its slab estimate and
its rebucket on overflow included) give JAX's arrays epoch by epoch; a
packed batch reproduces the unpacked one molecule by molecule (property,
forces and loss, as JAX's own test holds its packing); and the packed
model, from a converted JAX init, matches JAX's on the same packed batch:
at 1e-5 of each output's scale in float32 (the same math, sums in another
order) and 2e-2 with bf16 pair and node types (the bound the unpacked
dense model is held to, ``test_torch_port_model.py``), through the fused
message's plain twin against JAX's XLA message and against its Pallas
kernel in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.graph.dense_batch import \
    collate_dense_packed as j_collate_packed
from gotennet_tpu.graph.dense_batch import flatten_nodes as j_flatten
from gotennet_tpu.graph.dense_batch import pack_molecules as j_pack
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead

from gotennet_tpu_torch.data.dataset import DenseLoader, synthetic_molecules
from gotennet_tpu_torch.graph.dense_batch import (collate_dense,
                                                  collate_dense_packed,
                                                  flatten_nodes,
                                                  pack_molecules)
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import (GotenModel, HeadConfig,
                                             apply_with_forces)
from gotennet_tpu_torch.tasks.qm9 import QM9Task
from gotennet_tpu_torch.train.trainer import make_loss_fn
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
META = {"mean": 0.0, "std": 1.0}


def _graphs(rng, sizes):
    out = []
    for i, m in enumerate(sizes):
        out.append({"z": rng.integers(1, 10, size=m).astype(np.int32),
                    "pos": (rng.random((m, 3)) * 3.0).astype(np.float32),
                    "y": [float(i + 1)],
                    "dy": rng.standard_normal((m, 3)).astype(np.float32)})
    return out


def _same_batch(got, want):
    for name in ("z", "pos", "mask", "graph_mask", "y", "dy", "seg"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("seed,max_atoms,per_slab", [
    (0, 16, 3), (1, 32, 8), (2, 24, 2), (3, 29, 4)])
def test_pack_molecules_gives_jax_slabs(seed, max_atoms, per_slab):
    sizes = np.random.default_rng(seed).integers(1, max_atoms + 1, size=40)
    assert pack_molecules(sizes, max_atoms, per_slab) == j_pack(
        sizes, max_atoms, per_slab)
    with pytest.raises(ValueError, match="slab capacity"):
        pack_molecules([max_atoms + 1], max_atoms, per_slab)


def test_collate_and_flatten_match_jax():
    rng = np.random.default_rng(11)
    graphs = _graphs(rng, (5, 7, 9, 4, 6))
    got = collate_dense_packed(graphs, 3, 16, 3, with_forces=True)
    _same_batch(got, j_collate_packed(graphs, 3, 16, 3, with_forces=True))
    assert got.mols_per_slab == 3 and got.num_graphs == 3
    for g, w in ((got, j_collate_packed(graphs, 3, 16, 3, with_forces=True)),
                 (collate_dense(graphs, 5, 16), None)):
        flat = flatten_nodes(g)
        if w is None:
            from gotennet_tpu.graph.dense_batch import collate_dense as jcd
            w = jcd(graphs, 5, 16)
        want = j_flatten(w)
        for name in ("z", "pos", "node_graph", "node_mask", "graph_mask",
                     "y"):
            np.testing.assert_array_equal(getattr(flat, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        assert flat.num_graphs == want.num_graphs
    with pytest.raises(ValueError, match="slab capacity 1 exceeded"):
        collate_dense_packed(graphs, 1, 16, 3)


@pytest.mark.parametrize("kw", [
    dict(batch_size=8, shuffle=True, seed=5, max_atoms=32),
    dict(batch_size=6, shuffle=True, seed=1, bucket=True, mols_per_slab=3),
    dict(batch_size=16, max_atoms=24, bucket=True, bucket_window=4)])
def test_packed_loader_matches_jax_and_covers_the_dataset(kw):
    """Every epoch's batches equal JAX's, every molecule once with its
    target in its (slab, local) slot; in the last case bucketing gathers
    the largest molecules into one batch, which the estimate does not fit,
    so both loaders grow it on the way."""
    n = 37
    ds = synthetic_molecules(n, seed=3, min_atoms=6, max_atoms=24)
    jds = j_synthetic(n, seed=3, min_atoms=6, max_atoms=24)
    got = DenseLoader(ds, pack=True, **kw)
    want = JDenseLoader(jds, pack=True, **kw)
    assert (got.num_slabs, got.mols_per_slab) == (want.num_slabs,
                                                   want.mols_per_slab)
    start = got.num_slabs
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        pairs = list(zip(got.batches(), want))
        assert len(pairs) == len(want) == len(got)
        seen = []
        for (idx, a), b in pairs:
            _same_batch(a, b)
            gm = a.graph_mask.numpy().reshape(-1)
            assert ((idx >= 0) == gm).all()
            np.testing.assert_array_equal(
                a.y.numpy().reshape(-1)[gm], ds.y[idx[gm], 0])
            seen.extend(idx[gm].tolist())
        assert sorted(seen) == list(range(n))
        assert got.num_slabs == want.num_slabs
    if kw["batch_size"] == 16:
        assert got.num_slabs > start


def test_packed_batch_reproduces_the_unpacked_one():
    """Property and forces molecule by molecule (graph slot s * P + local),
    and the loss, as JAX's test_dense_packing_matches_unpacked holds them
    (property rtol 2e-4, forces 2e-3)."""
    sizes = (5, 7, 9, 4, 6)
    graphs = _graphs(np.random.default_rng(11), sizes)
    unpacked = collate_dense(graphs, len(graphs), 12, with_forces=True)
    packed = collate_dense_packed(graphs, 3, 16, 3, with_forces=True)
    model = GotenModel(GotenNetConfig(**SMALL, scale_edge=True),
                       HeadConfig(derivative=True), "dense", seed=2,
                       device="cpu")
    out_u = apply_with_forces(model, unpacked)
    out_p = apply_with_forces(model, packed)
    f_u, f_p = out_u["forces"].detach(), out_p["forces"].detach()
    for s, members in enumerate(pack_molecules(sizes, 16, 3)):
        off = 0
        for local, i in enumerate(members):
            m = sizes[i]
            np.testing.assert_allclose(
                out_p["property"][s * 3 + local].detach(),
                out_u["property"][i].detach(), rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(f_p[s, off:off + m], f_u[i, :m],
                                       rtol=2e-3, atol=2e-4)
            off += m
    e_model = GotenModel(GotenNetConfig(**SMALL, scale_edge=True),
                         HeadConfig(), "dense", seed=2, device="cpu")
    loss_fn = make_loss_fn(e_model, QM9Task("U0", dataset_meta=META))
    with torch.no_grad():
        np.testing.assert_allclose(float(loss_fn(packed)[0]),
                                   float(loss_fn(unpacked)[0]), rtol=2e-4)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("dtypes,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_packed_model_matches_jax(dtypes, tol):
    """The fused dense model (its message's plain twin) on a packed batch
    against JAX's XLA model from the same init: property and both
    representations."""
    kw = dict(fused=True)
    jkw = {}
    if dtypes == "bf16":
        kw.update(pair_dtype=torch.bfloat16, node_dtype=torch.bfloat16)
        jkw = dict(pair_dtype=jnp.bfloat16, node_dtype=jnp.bfloat16)
    head_kw = dict(mean=0.5, stddev=2.0)
    graphs = _graphs(np.random.default_rng(11), (5, 7, 9, 4, 6))
    jbatch = j_collate_packed(graphs, 3, 16, 3)
    jmodel = JModel(JConfig(**SMALL, **jkw), JHead(**head_kw),
                    layout="dense")
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    pcfg = GotenNetConfig(**SMALL, **kw)
    head = HeadConfig(**head_kw)
    model = GotenModel(pcfg, head, "dense", device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, pcfg, head))
    want = jax.jit(jmodel.apply)(params, jbatch)
    with torch.no_grad():
        got = model(collate_dense_packed(graphs, 3, 16, 3))
    for key in ("property", "representation", "vector_representation"):
        assert _scaled_err(got[key].numpy(), want[key]) <= tol, key


def test_fused_twins_on_a_packed_batch_match_jax_interpret():
    """The fused message (and HTR update) plain twins on a packed batch
    against JAX's Pallas kernels in interpret mode (``fused=True,
    fused_htr=True`` in both packages), float32, at 1e-5 of the scale:
    the pair mask's cross-molecule holes reach the kernels only through
    ``env_signed``'s sign."""
    kw = dict(fused=True, fused_htr=True, remat=False)
    jbatch = j_collate_packed(_graphs(np.random.default_rng(5),
                                      (6, 3, 8, 5)), 2, 16, 3)
    jmodel = JModel(JConfig(**SMALL, **kw), JHead(), layout="dense")
    params = jmodel.init(jax.random.PRNGKey(3), jbatch)
    pcfg = GotenNetConfig(**SMALL, **kw)
    model = GotenModel(pcfg, HeadConfig(), "dense", device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, pcfg,
                                                     HeadConfig()))
    batch = collate_dense_packed(_graphs(np.random.default_rng(5),
                                         (6, 3, 8, 5)), 2, 16, 3)
    want = jax.jit(jmodel.apply)(params, jbatch)
    with torch.no_grad():
        got = model(batch)
    for key in ("property", "representation", "vector_representation"):
        assert _scaled_err(got[key].numpy(), want[key]) <= 1e-5, key
    assert dataclasses.replace(batch, seg=None).mols_per_slab == 1
