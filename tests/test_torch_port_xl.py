"""Node tables above ``fused_table_rows``: the port against the JAX
package's chunked path, and the loader at 4,000-4,200 atoms.

Where the JAX package cuts its fused ELL kernels into halo-windowed chunks
(``make_fused_ell_chunked``, ``make_fused_htr_ell_chunked``) the port calls
its kernels on the whole table; on the frames of the JAX package's own
chunked test (tests/test_ell.py, 155-160 atoms, ``block_rows=8``,
``fused_table_rows=256``) the two agree in values and in the gradients with
respect to the parameters and the positions.  Where JAX finds no chunking
(a halo too wide, or no ``gather_halo``) both take the unfused paths.  The
port's ``ELLLoader`` gives every array of JAX's at 600-700 and 4,000-4,200
atoms.  Sizes are small: D = 32, 2 layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.graph.ell_batch import collate_ell as j_collate_ell
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.ops.pallas.fused_ell import pick_chunking as j_pick_chunking

from gotennet_tpu_torch.data.dataset import ELLLoader, synthetic_molecules
from gotennet_tpu_torch.graph.ell_batch import collate_ell
from gotennet_tpu_torch.models.gotennet import GotenNetConfig, kernel_paths
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.ops import fused_ell, fused_htr
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

from test_torch_port_ell import _assert_batches_equal

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
# tests/test_ell.py's chunked-path frames and cut
FRAMES = dict(min_atoms=155, max_atoms=160, box=6.3)
N_NODES, BLOCK_ROWS, LIMIT = 320, 8, 256


def _pair():
    """(port batch, JAX batch) of the two frames, collated the same way."""
    jds = j_synthetic(2, seed=0, **FRAMES)
    jloader = JELLLoader(jds, batch_size=2, cutoff=5.0, node_capacity=N_NODES,
                         neighbor_probe="full", spatial_sort=True,
                         block_rows=BLOCK_ROWS)
    jbatch = next(iter(jloader))
    graphs = synthetic_molecules(2, seed=0, **FRAMES).graph_dicts(range(2))
    batch = collate_ell(graphs, N_NODES, jloader.max_neighbors, 2,
                        block_rows=BLOCK_ROWS, spatial_sort=True)
    _assert_batches_equal(batch, jbatch)
    return batch, jbatch


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _models(params, fused_htr_on, rows, **kw):
    jcfg = JConfig(**SMALL, fused=True, fused_htr=fused_htr_on,
                   fused_table_rows=rows, remat=False, **kw)
    cfg = GotenNetConfig(**SMALL, fused_htr=fused_htr_on,
                         fused_table_rows=rows, **kw)
    model = GotenModel(cfg, HeadConfig(), layout="ell", device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg,
                                                     HeadConfig()))
    return JModel(jcfg, JHead(), layout="ell"), model, cfg


@pytest.fixture(scope="module")
def params(pair):
    return jax.jit(JModel(JConfig(**SMALL), JHead(), layout="ell").init)(
        jax.random.PRNGKey(0), pair[1])


def _count_launches(monkeypatch):
    calls = {"msg": 0, "htr": 0}
    for key, module, name in (("msg", fused_ell, "fused_ell_forward"),
                              ("htr", fused_htr, "fused_htr_ell_forward")):
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("fused_htr_on", [False, True])
def test_whole_table_matches_jax_chunked(pair, params, fused_htr_on,
                                         monkeypatch):
    """Values at 1e-5 of the scale (the same math, float32 sums in another
    order); gradients of sum(h^2) + sum(X^2) with respect to the parameters
    and the positions at JAX's own chunked-vs-whole bound (rtol 5e-4, atol
    5e-5, tests/test_ell.py)."""
    batch, jbatch = pair
    N, halo = batch.num_nodes, batch.gather_halo
    cr, W, C = fused_ell.pick_chunking(N, N, halo, LIMIT)
    assert (cr, W, C) == j_pick_chunking(N, N, halo, LIMIT)
    assert C > 1 and W < N            # JAX really chunks here
    jmodel, model, cfg = _models(params, fused_htr_on, LIMIT)
    assert kernel_paths(cfg, "ell", N, N, halo) == (True, fused_htr_on)

    def j_loss(p, pos):
        out = jmodel.apply(p, dataclasses.replace(jbatch, pos=pos))
        return (jnp.sum(out["representation"] ** 2)
                + jnp.sum(out["vector_representation"] ** 2)), out

    (_, jout), (jg_p, jg_pos) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(params, jbatch.pos)

    calls = _count_launches(monkeypatch)
    pos = batch.pos.clone().requires_grad_(True)
    out = model(dataclasses.replace(batch, pos=pos))
    assert calls == {"msg": 2, "htr": fused_htr_on}   # one layer updates
    for key in ("representation", "vector_representation", "property"):
        want = np.asarray(jout[key], np.float32)
        got = out[key].detach().numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key
    loss = (out["representation"] ** 2).sum() \
        + (out["vector_representation"] ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(pos.grad.numpy(), np.asarray(jg_pos),
                               rtol=5e-4, atol=5e-5)
    want = state_dict_from_jax_params(jg_p, cfg, HeadConfig())
    for name, p in model.named_parameters():
        if name.startswith("representation."):
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       rtol=5e-4, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("case", ["no_chunking", "no_halo"])
def test_unchunkable_table_takes_the_unfused_paths(pair, params, case,
                                                   monkeypatch):
    """A table above fused_table_rows that JAX cannot chunk: a limit below
    any window the halo allows, or a batch without gather windows (no
    halo).  The JAX package takes its unfused message and update there; the
    port matches it (1e-5 of the scale).  With fused_htr the JAX package
    means to take the unfused update too (gotennet_ell.py:473-477), but its
    fused update has already declared ``gamma_t`` and the unfused one's
    ``gamma_t`` fails with flax's NameInUseError; the port gives the
    unfused answer there, the same bits as without fused_htr."""
    batch, jbatch = pair
    rows = LIMIT
    if case == "no_chunking":
        rows = 128
    else:
        graphs = synthetic_molecules(2, seed=0, **FRAMES).graph_dicts(
            range(2))
        batch = collate_ell(graphs, N_NODES, batch.max_neighbors, 2)
        jbatch = j_collate_ell(j_synthetic(2, seed=0, **FRAMES).graph_dicts(
            range(2)), N_NODES, batch.max_neighbors, 2)
        assert batch.gather_halo is None
    N = batch.num_nodes
    assert N > rows
    if batch.gather_halo is not None:
        assert fused_ell.pick_chunking(N, N, batch.gather_halo, rows) is None
    jmodel, model, cfg = _models(params, False, rows)
    _, model_htr, cfg_htr = _models(params, True, rows)
    for c in (cfg, cfg_htr):
        assert kernel_paths(c, "ell", N, N, batch.gather_halo) == (False, False)
    calls = _count_launches(monkeypatch)
    jout = jax.jit(jmodel.apply)(params, jbatch)
    with torch.inference_mode():
        out, out_htr = model(batch), model_htr(batch)
    assert calls == {"msg": 0, "htr": 0}
    for key in ("representation", "vector_representation", "property"):
        want = np.asarray(jout[key], np.float32)
        got = out[key].numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key
        assert torch.equal(out[key], out_htr[key]), key


@pytest.mark.parametrize("sizes", [(600, 700, 3), (4000, 4200, 2)],
                         ids=["600-700", "4000-4200"])
def test_loader_matches_jax_at_large_frames(sizes):
    """bench.py's large and xl cuts (one frame per chunk, spatially sorted,
    64-row windows): every array, the window fields and K equal JAX's
    ``ELLLoader(neighbor_probe="full")``."""
    lo, hi, n = sizes
    kw = dict(min_atoms=lo, max_atoms=hi, box=6.3)
    lkw = dict(batch_size=1, spatial_sort=True, block_rows=64)
    loader = ELLLoader(synthetic_molecules(n, seed=0, **kw), **lkw)
    jloader = JELLLoader(j_synthetic(n, seed=0, **kw), neighbor_probe="full",
                         **lkw)
    assert (loader.node_capacity, loader.max_neighbors) == \
        (jloader.node_capacity, jloader.max_neighbors)
    batches = list(loader)
    assert len(batches) == n
    for got, want in zip(batches, jloader):
        _assert_batches_equal(got, want)
