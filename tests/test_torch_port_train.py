"""The port's training step against the JAX package's.

One JAX init of a small dense model, carried across by
``state_dict_from_jax_params``; the same synthetic molecules, bucketed
into the same 16-graph accumulation chunks, go through ``bench.py``'s
``one_step`` in JAX and ``train.trainer.train_step`` in the port (on the
CPU, where the fused message's backward is its plain version).
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
from gotennet_tpu.tasks import base as jbase
from gotennet_tpu.tasks.qm9 import QM9Task as JQM9Task
from gotennet_tpu.train import optim as joptim
from gotennet_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from gotennet_tpu_torch.data.dataset import synthetic_molecules
from gotennet_tpu_torch.graph.dense_batch import collate_dense
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel
from gotennet_tpu_torch.tasks import base
from gotennet_tpu_torch.tasks.qm9 import QM9Task
from gotennet_tpu_torch.train import optim
from gotennet_tpu_torch.train.trainer import (accum_grads, make_chunks,
                                              make_loss_fn, train_step,
                                              train_steps)
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
N_MOLS, CHUNK, LR, N_STEPS = 32, 16, 1e-4, 3
# QM9-like molecules kept small here (one padded size, M = 16)
MIN_ATOMS, MAX_ATOMS = 5, 14
META = {"mean": 0.0, "std": 1.0}


def test_losses_and_targets_match_jax():
    rng = np.random.default_rng(0)
    pred, tgt = rng.standard_normal((2, 6, 1)).astype(np.float32)
    mask = (rng.random((6, 1)) > 0.3).astype(np.float32)
    for name in ("l1_loss", "mse_loss"):
        want = getattr(jbase, name)(pred, tgt, mask)
        got = getattr(base, name)(*map(torch.from_numpy, (pred, tgt, mask)))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    task = QM9Task("U0", dataset_meta=META)
    assert [s["name"] for s in task.get_losses()] == ["L1Loss"]
    mols = synthetic_molecules(3, seed=0).graph_dicts(range(3))
    batch = collate_dense(mols, 4, 32)
    y, m = task.get_targets(batch)["y"]
    assert y.shape == (4, 1) and m[:, 0].tolist() == [1, 1, 1, 0]
    batch.y = batch.y[:, None]
    with pytest.raises(NotImplementedError, match="item 4"):
        task.get_targets(batch)


def test_lr_multipliers_match_jax():
    for step in (0, 3, 9, 40):
        assert optim.warmup_scale(step, 10) == joptim.warmup_scale(step, 10)
        assert optim.cosine_scale(step, 30, 0.1) == pytest.approx(
            joptim.cosine_scale(step, 30, 0.1), rel=1e-12)


def test_optimizer_matches_optax():
    """Global-norm clip at 5 + AdamW(1e-4, eps 1e-7, no decay) over three
    updates whose gradients are above, below and above the clip."""
    rng = np.random.default_rng(1)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in (("w", (7, 5)), ("b", (5,)))}
    grads = [{n: rng.standard_normal(p.shape).astype(np.float32) * f
              for n, p in params.items()} for f in (3.0, 0.1, 10.0)]
    tx = joptim.make_optimizer(LR, weight_decay=0.0)
    state = tx.init(params)
    jp = dict(params)
    tp = {n: torch.nn.Parameter(torch.from_numpy(p.copy()))
          for n, p in params.items()}
    opt = optim.make_optimizer(tp.values(), LR)
    norms = []
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n].copy())
        norms.append(float(optim.clip_by_global_norm(tp.values(),
                                                     opt.grad_clip)))
        opt.step()
        for n, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-6)
    assert norms[0] > 5 > norms[1] and norms[2] > 5


def _jax_grads(grad_fn, params, jchunks):
    """Mean loss and mean gradient over the chunks, as bench.py's
    one_step takes them."""
    rng = jax.random.PRNGKey(1)
    outs = [grad_fn(params, c, rng, False) for c in jchunks]
    loss = sum(float(l) for (l, _), _ in outs) / len(outs)
    grads = jax.tree.map(lambda *g: sum(g) / len(g), *[g for _, g in outs])
    return loss, grads


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, once: initial params, the first step's gradients, and
    the losses and params of N_STEPS steps of bench.py's one_step."""
    jtask = JQM9Task("U0", dataset_meta=META)
    jds = j_synthetic(N_MOLS, seed=0, min_atoms=MIN_ATOMS,
                      max_atoms=MAX_ATOMS)
    jchunks = list(JDenseLoader(jds, batch_size=CHUNK, bucket=True,
                                bucket_window=N_MOLS // CHUNK))
    # the XLA path (fused=False): the same math as the port's fused one
    jmodel = JModel(JConfig(**SMALL), jtask.build_head(), layout="dense")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jchunks[0])
    grad_fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jmodel, jtask),
                                         has_aux=True), static_argnums=(3,))
    tx = joptim.make_optimizer(LR, weight_decay=0.0)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    state = tx.init(params)
    jp, losses, grads_1 = params, [], []
    for _ in range(N_STEPS):
        loss, grads = _jax_grads(grad_fn, jp, jchunks)
        grads_1.append(grads)
        jp, state = update(grads, state, jp)
        losses.append(loss)
    return dict(params=params, chunk_m=[c.max_atoms for c in jchunks],
                first_grads=grads_1[0], losses=losses, final=jp)


@pytest.fixture
def port(jax_run):
    """(model with the JAX init, its chunks, cfg, head, loss_fn)."""
    cfg = GotenNetConfig(**SMALL)
    head = QM9Task("U0", dataset_meta=META).build_head()
    model = GotenModel(cfg, head, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax_run["params"], cfg,
                                                     head))
    ds = synthetic_molecules(N_MOLS, seed=0, min_atoms=MIN_ATOMS,
                             max_atoms=MAX_ATOMS)
    chunks = make_chunks(ds.graph_dicts(range(N_MOLS)), CHUNK, "cpu")
    assert [c.max_atoms for c in chunks] == jax_run["chunk_m"]
    return model, chunks, cfg, head, make_loss_fn(model, QM9Task("U0", META))


def test_first_step_gradients_match_jax(jax_run, port):
    """Each parameter's mean gradient over the chunks, float32: the same
    math, sums in another order -> 1e-5 of each gradient's scale."""
    model, chunks, cfg, head, loss_fn = port
    model.train()
    loss = accum_grads(model, loss_fn, chunks)
    np.testing.assert_allclose(float(loss), jax_run["losses"][0], rtol=1e-5)
    want = state_dict_from_jax_params(jax_run["first_grads"], cfg, head)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-30), (name, err)


def test_three_steps_match_jax(jax_run, port):
    """Losses and parameters after three steps of the port's train_step and
    of bench.py's one_step.  Losses to 1e-5.  Parameters: Adam moves an
    element whose gradient sits at rounding level by up to 2 lr per step
    (the sign of m / (sqrt(v) + eps) is rounding noise there), so an
    element may differ by up to 2 lr x steps; all but 1e-3 of the elements
    agree to 1e-3 of lr."""
    model, chunks, cfg, head, loss_fn = port
    opt = optim.make_optimizer(model.parameters(), LR)
    losses = [train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)
              for _ in range(N_STEPS)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    want = state_dict_from_jax_params(jax_run["final"], cfg, head)
    n_off = n_all = 0
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        diff = np.abs(got - w)
        assert diff.max() <= 2 * LR * N_STEPS, (name, diff.max())
        n_off += int(np.sum(diff > 1e-3 * LR + 1e-6 * np.abs(w)))
        n_all += w.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_train_steps_entry_point_on_cpu():
    mols = synthetic_molecules(20, seed=3, min_atoms=6,
                               max_atoms=14).graph_dicts(range(20))
    cfg = GotenNetConfig(**SMALL)
    head = QM9Task("U0", dataset_meta=META).build_head()
    losses = train_steps(cfg, head, mols, 2, chunk=8, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]
