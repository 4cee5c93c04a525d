"""The port's dense model with the fused HTR update against the JAX package's.

One JAX init of a small dense model with ``fused=True, fused_htr=True`` (the
Pallas kernels in interpret mode), carried across by
``state_dict_from_jax_params``; the same synthetic frames of 30-40 atoms go
through both, unbucketed as ``bench.py``'s MD22 mode runs them.  The port
runs on the CPU, where both fused ops run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.tasks.qm9 import QM9Task as JQM9Task
from gotennet_tpu.train import optim as joptim
from gotennet_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from gotennet_tpu_torch.data.dataset import DenseLoader, synthetic_molecules
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.gotennet_dense import GATADense
from gotennet_tpu_torch.models.model import (GotenModel, HeadConfig,
                                             init_parameters_)
from gotennet_tpu_torch.ops import fused_htr
from gotennet_tpu_torch.tasks.qm9 import QM9Task
from gotennet_tpu_torch.train import optim
from gotennet_tpu_torch.train.trainer import (accum_grads, make_chunks,
                                              make_loss_fn, train_step)
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

from test_torch_port_model import _compare

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
FRAMES = dict(min_atoms=30, max_atoms=40)
META = {"mean": 0.0, "std": 1.0}


def _jax_model(**kw):
    return JModel(JConfig(**SMALL, fused=True, fused_htr=True, **kw),
                  JHead(), layout="dense")


def _jax_batch(n, seed, batch_size):
    jds = j_synthetic(n, seed=seed, **FRAMES)
    return list(JDenseLoader(jds, batch_size=batch_size))


# f32: the same math in both frameworks, only the order of the sums differs
# -> 1e-5 of the output's scale.  bf16 pair/node types: both round at the
# same cast points, but XLA on the CPU fuses bf16 elementwise chains and
# keeps some float32 intermediates, so single values differ by a few bf16
# ulps that the layers carry on: 2e-2 of the scale, as
# tests/test_torch_port_model.py holds the unfused model.
@pytest.mark.parametrize("dtypes,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_fused_htr_model_matches_jax(dtypes, tol):
    kw, pkw = {}, {}
    if dtypes == "bf16":
        kw = dict(pair_dtype=jnp.bfloat16, node_dtype=jnp.bfloat16)
        pkw = dict(pair_dtype=torch.bfloat16, node_dtype=torch.bfloat16)
    jmodel = _jax_model(**kw)
    jbatch = _jax_batch(3, 3, 3)[0]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    jout = jax.jit(jmodel.apply)(params, jbatch)

    cfg = GotenNetConfig(**SMALL, fused_htr=True, **pkw)
    model = GotenModel(cfg, HeadConfig(), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg,
                                                     HeadConfig()))
    ds = synthetic_molecules(3, seed=3, **FRAMES)
    batch = next(iter(DenseLoader(ds, batch_size=3)))
    assert batch.max_atoms == jbatch.max_atoms == 40
    with torch.inference_mode():
        pout = model(batch)
    _compare(jout, pout, tol)


def test_fused_htr_weights_cross_unchanged():
    """The JAX fused HTR path keeps the XLA path's parameter tree
    (gamma_t/layers_0/linear), so one converter serves both, and the port's
    model with ``fused_htr`` has the same state-dict keys as without."""
    jbatch = _jax_batch(2, 0, 2)[0]
    key = jax.random.PRNGKey(0)
    fused = jax.eval_shape(_jax_model().init, key, jbatch)
    plain = jax.eval_shape(
        JModel(JConfig(**SMALL), JHead(), layout="dense").init, key, jbatch)
    assert (jax.tree_util.tree_structure(fused)
            == jax.tree_util.tree_structure(plain))
    assert all(a.shape == b.shape for a, b in zip(
        jax.tree_util.tree_leaves(fused), jax.tree_util.tree_leaves(plain)))
    keys = [set(GotenModel(GotenNetConfig(**SMALL, fused_htr=f), HeadConfig(),
                           device="cpu").state_dict()) for f in (True, False)]
    assert keys[0] == keys[1]
    assert "representation.gata_list.0.gamma_t.dense_layers.0.weight" in keys[0]


def test_gata_layer_routes_htr_through_the_fused_op(monkeypatch):
    """With fused_htr the layer's update is one FusedHTR node whose backward
    reaches fused_htr_backward; without it the plain update runs and the op
    is never called."""
    rng = np.random.default_rng(0)
    G, M, D, L = 2, 8, 32, 8

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    pair_mask = torch.from_numpy(rng.random((G, M, M)) > 0.3)
    inputs = (rand(G, M, D), rand(G, M, L, D), rand(G, M, M, D),
              rand(G, M, M, L), torch.from_numpy(
                  rng.random((G, M, M)).astype(np.float32) * 4),
              pair_mask, torch.ones(G, M, M))
    calls = []
    for name in ("fused_htr_forward", "fused_htr_backward"):
        real = getattr(fused_htr, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(fused_htr, name, counted)
    for kw, used in ((dict(fused_htr=True), True), (dict(), False)):
        calls.clear()
        layer = GATADense(GotenNetConfig(**SMALL, **kw))
        init_parameters_(layer, torch.Generator().manual_seed(0))
        h, X, t = layer(*inputs)
        t.sum().backward()
        assert calls == (["fused_htr_forward", "fused_htr_backward"]
                         if used else [])
        assert (type(t.grad_fn).__name__ == "FusedHTRBackward") == used
        gamma_t = layer.gamma_t.dense_layers[0]
        assert float(gamma_t.weight.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# Training: bench.py's one_step with the fused kernels on both sides
N_MOLS, CHUNK, LR, N_STEPS = 8, 4, 1e-4, 3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, once: initial params, the first step's gradients, and
    the losses and params of N_STEPS steps of bench.py's one_step, on
    unbucketed 4-frame chunks."""
    jtask = JQM9Task("U0", dataset_meta=META)
    jchunks = _jax_batch(N_MOLS, 0, CHUNK)
    jmodel = JModel(JConfig(**SMALL, fused=True, fused_htr=True),
                    jtask.build_head(), layout="dense")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jchunks[0])
    grad_fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jmodel, jtask),
                                         has_aux=True), static_argnums=(3,))
    tx = joptim.make_optimizer(LR, weight_decay=0.0)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    state = tx.init(params)
    jp, losses, first = params, [], None
    for _ in range(N_STEPS):
        outs = [grad_fn(jp, c, jax.random.PRNGKey(1), False) for c in jchunks]
        loss = sum(float(l) for (l, _), _ in outs) / len(outs)
        grads = jax.tree.map(lambda *g: sum(g) / len(g),
                             *[g for _, g in outs])
        first = grads if first is None else first
        jp, state = update(grads, state, jp)
        losses.append(loss)
    return dict(params=params, chunk_m=[c.max_atoms for c in jchunks],
                first_grads=first, losses=losses, final=jp)


@pytest.fixture
def port(jax_run):
    """(model with the JAX init, its unbucketed chunks, cfg, head,
    loss_fn)."""
    cfg = GotenNetConfig(**SMALL, fused_htr=True)
    head = QM9Task("U0", dataset_meta=META).build_head()
    model = GotenModel(cfg, head, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax_run["params"], cfg,
                                                     head))
    ds = synthetic_molecules(N_MOLS, seed=0, **FRAMES)
    chunks = make_chunks(ds.graph_dicts(range(N_MOLS)), CHUNK, "cpu",
                         bucket=False)
    assert [c.max_atoms for c in chunks] == jax_run["chunk_m"] == [40, 40]
    return model, chunks, cfg, head, make_loss_fn(model, QM9Task("U0", META))


def test_first_step_gradients_match_jax(jax_run, port):
    """Each parameter's mean gradient over the chunks, float32: the same
    math, sums in another order -> 1e-5 of each gradient's scale."""
    model, chunks, cfg, head, loss_fn = port
    model.train()
    loss = accum_grads(model, loss_fn, chunks)
    np.testing.assert_allclose(float(loss), jax_run["losses"][0], rtol=1e-5)
    want = state_dict_from_jax_params(jax_run["first_grads"], cfg, head)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-30), (name, err)


def test_three_steps_match_jax(jax_run, port):
    """Losses to 1e-5 and parameters after three steps, with the tolerance
    and its reason of tests/test_torch_port_train.py: Adam moves an element
    whose gradient sits at rounding level by up to 2 lr per step."""
    model, chunks, cfg, head, loss_fn = port
    opt = optim.make_optimizer(model.parameters(), LR)
    losses = [train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)
              for _ in range(N_STEPS)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    want = state_dict_from_jax_params(jax_run["final"], cfg, head)
    n_off = n_all = 0
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        diff = np.abs(got - w)
        assert diff.max() <= 2 * LR * N_STEPS, (name, diff.max())
        n_off += int(np.sum(diff > 1e-3 * LR + 1e-6 * np.abs(w)))
        n_all += w.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
