"""The port's unfused dense message against the JAX package's.

``fused=False`` on the dense layout runs the message as plain tensor ops
(``GATADense._unfused_message``, JAX gotennet_dense.py:395-489): ``aggr``
add, mean and max, any activation, ``scale_edge``, flax's attention
dropout.  Each configuration, from one JAX init carried across by
``state_dict_from_jax_params``, is held against JAX's model: float32 at
1e-5 of each output's scale (the same arithmetic, sums in another order)
and bf16 pair and node types at 2e-2 (both round at the same cast points,
but XLA on the CPU keeps some bf16 chains in float32 where the port rounds
each product: a few bf16 ulps a value, carried through the layers, as
tests/test_torch_port_model.py holds the fused model); parameter gradients
at 5e-4 of each gradient's scale, the tolerance the JAX package holds its
own gradients to.  Then three training steps against JAX's ``one_step``,
and the unfused message against the fused one (its plain twin on the CPU)
at the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.graph.dense_batch import collate_dense as j_collate_dense
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.tasks.qm9 import QM9Task as JQM9Task
from gotennet_tpu.train import optim as joptim
from gotennet_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from gotennet_tpu_torch.data.dataset import DenseLoader, synthetic_molecules
from gotennet_tpu_torch.graph.dense_batch import collate_dense
from gotennet_tpu_torch.models import gotennet
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.ops import fused_gata, fused_htr
from gotennet_tpu_torch.tasks.qm9 import QM9Task
from gotennet_tpu_torch.train import optim
from gotennet_tpu_torch.train.trainer import make_loss_fn, train_step
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

from test_torch_port_model import _compare

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
SIZES = dict(min_atoms=5, max_atoms=14)
META = {"mean": 0.0, "std": 1.0}
RATE = 0.1
# name -> options of both configs (fused=False in each)
CONFIGS = {
    "add": dict(),
    "mean": dict(aggr="mean"),
    "max": dict(aggr="max"),
    "ssp_max": dict(activation="ssp", aggr="max"),
    "scale_edge": dict(scale_edge=True, activation="gelu"),
    "joint": dict(sep_dir=False, sep_tensor=False, sep_htr=False),
}
_PARAMS = {}


def jax_params(sep=True):
    if sep not in _PARAMS:
        jbatch = next(iter(JDenseLoader(j_synthetic(3, seed=1, **SIZES), 4)))
        model = JModel(JConfig(**SMALL, sep_dir=sep, sep_tensor=sep,
                               sep_htr=sep), JHead(), layout="dense")
        _PARAMS[sep] = jax.jit(model.init)(jax.random.PRNGKey(0), jbatch)
    return _PARAMS[sep]


def _configs(kw, bf16=False):
    jkw = dict(pair_dtype=jnp.bfloat16, node_dtype=jnp.bfloat16) if bf16 \
        else {}
    pkw = dict(pair_dtype=torch.bfloat16, node_dtype=torch.bfloat16) if bf16 \
        else {}
    return (JConfig(**SMALL, fused=False, **kw, **jkw),
            GotenNetConfig(**SMALL, fused=False, **kw, **pkw))


def _port_model(cfg, params, head=None):
    head = head or HeadConfig()
    model = GotenModel(cfg, head, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg, head))
    return model


def _batches(seed=1, n=3):
    return (next(iter(JDenseLoader(j_synthetic(n, seed=seed, **SIZES), 4))),
            next(iter(DenseLoader(synthetic_molecules(n, seed=seed, **SIZES),
                                  4))))


def _assert_scaled(got, want, tol, what):
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("name,dtype", [(n, "f32") for n in CONFIGS]
                         + [("add", "bf16"), ("max", "bf16")])
def test_unfused_model_matches_jax(name, dtype, monkeypatch):
    bf16 = dtype == "bf16"
    kw = CONFIGS[name]
    jcfg, cfg = _configs(kw, bf16)
    jbatch, batch = _batches()
    params = jax_params(cfg.sep_htr)
    jout = jax.jit(JModel(jcfg, JHead(), layout="dense").apply)(params,
                                                               jbatch)
    model = _port_model(cfg, params)

    def refuse(*args, **kwargs):
        raise AssertionError("a fused kernel ran on the unfused path")

    monkeypatch.setattr(fused_gata, "fused_gata_forward", refuse)
    monkeypatch.setattr(fused_htr, "fused_htr_forward", refuse)
    with torch.no_grad():
        pout = model(batch)
    _compare(jout, pout, 2e-2 if bf16 else 1e-5)


def _tie_batch():
    """A carbon between two hydrogens at equal distance, and a second
    molecule: in the first layer the hydrogens' messages to the carbon are
    equal, so the max over its sources ties."""
    mols = [{"z": [6, 1, 1], "pos": [[0, 0, 0], [1.1, 0, 0], [-1.1, 0, 0]],
             "y": [0.5]},
            {"z": [8, 1, 6, 1], "pos": [[0, 0, 0], [0.9, 0.2, 0],
                                         [0.1, 1.3, 0.4], [-0.7, 0.1, 0.8]],
             "y": [-0.2]}]
    return (j_collate_dense(mols, 2, 8), collate_dense(mols, 2, 8))


def test_max_aggregation_gradients_with_a_tie_match_jax(monkeypatch):
    """aggr='max' where two sources tie: amax shares the gradient between
    them as jnp.max does (max(dim) would hand it all to one).  JAX's
    gradient is taken op by op: under ``jax.jit`` on the CPU its gradient
    of this max disagrees with its own eager gradient and with finite
    differences (ROADMAP.md Queue 3), with or without a tie."""
    jcfg, cfg = _configs(CONFIGS["max"])
    jbatch, batch = _tie_batch()
    params = jax_params()
    jmodel = JModel(jcfg, JHead(), layout="dense")

    def energy(p):
        return jnp.sum(jmodel.apply(p, jbatch)["property"])

    jgrads = jax.grad(energy)(params)
    model = _port_model(cfg, params)
    amax, ties = torch.amax, []

    def counting_amax(x, dim, keepdim=False):
        out = amax(x, dim, keepdim)
        if x.shape[-1] == SMALL["n_atom_basis"]:   # the aggregation's max
            top = out if keepdim else out.unsqueeze(dim)
            hits = torch.sum((x == top) & (x > -1e38), dim=dim)
            ties.append(int(torch.sum(hits >= 2)))
        return out

    monkeypatch.setattr(torch, "amax", counting_amax)
    model(batch)["property"].sum().backward()
    assert ties and ties[0] > 0          # the first layer's d_h ties
    want = state_dict_from_jax_params(jax.device_get(jgrads), cfg,
                                      HeadConfig())
    for name, p in model.named_parameters():
        _assert_scaled(p.grad.numpy(), want[name].numpy(), 5e-4, name)


def test_dropout_matches_jax_with_the_same_mask(monkeypatch):
    """flax's Dropout on the unfused attention, the same keep masks handed
    to both packages (JAX's draw through a patched jax.random.bernoulli,
    the port's through models.gotennet.attention_keep_mask)."""
    jbatch, batch = _batches()
    G, M = batch.z.shape
    rng = np.random.default_rng(0)
    masks = [rng.random((G, M, M, SMALL["num_heads"])) < 1.0 - RATE
             for _ in range(SMALL["n_interactions"])]
    jmodel = JModel(JConfig(**SMALL, fused=False, attn_dropout=RATE,
                            remat=False), JHead(), layout="dense")
    params = jax_params()
    queue = list(masks)

    def bernoulli(key, p=0.5, shape=None):
        mask = queue.pop(0)
        assert tuple(shape) == mask.shape
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    def energy(p):
        out = jmodel.apply(p, jbatch, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out["property"]), out["property"]

    (_, want), jgrads = jax.jit(jax.value_and_grad(energy, has_aux=True))(
        params)
    assert not queue
    cfg = GotenNetConfig(**SMALL, fused=False, attn_dropout=RATE)
    model = _port_model(cfg, params)
    queue = list(masks)
    monkeypatch.setattr(gotennet, "attention_keep_mask",
                        lambda shape, rate, gen, dev: torch.from_numpy(
                            queue.pop(0)))
    model.train()
    got = model(batch)["property"]
    got.sum().backward()
    assert not queue
    _assert_scaled(got.detach().numpy(), np.asarray(want), 1e-5, "property")
    model.eval()
    with torch.no_grad():
        assert not np.allclose(model(batch)["property"].numpy(),
                               np.asarray(want), rtol=1e-4)
    want_g = state_dict_from_jax_params(jax.device_get(jgrads), cfg,
                                        HeadConfig())
    for name, p in model.named_parameters():
        _assert_scaled(p.grad.numpy(), want_g[name].numpy(), 5e-4, name)


def test_three_steps_match_jax():
    """Three steps of the port's train_step and of bench.py's one_step
    (L1 on the property, clip 5, AdamW 1e-4), on two 3-graph chunks:
    losses to 1e-5; parameters as tests/test_torch_port_train.py holds
    them (Adam moves an element whose gradient is rounding noise by up to
    2 lr a step, all but 1e-3 of the elements agree to 1e-3 of lr)."""
    lr, n_steps = 1e-4, 3
    jtask, task = JQM9Task("U0", dataset_meta=META), QM9Task(
        "U0", dataset_meta=META)
    jds, ds = (j_synthetic(6, seed=5, **SIZES),
               synthetic_molecules(6, seed=5, **SIZES))
    jchunks = list(JDenseLoader(jds, 3, bucket=True, bucket_window=2))
    chunks = list(DenseLoader(ds, 3, bucket=True, bucket_window=2))
    jmodel = JModel(JConfig(**SMALL, fused=False), jtask.build_head(),
                    layout="dense")
    params = jax_params()
    grad_fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jmodel, jtask),
                                         has_aux=True), static_argnums=(3,))
    tx = joptim.make_optimizer(lr, weight_decay=0.0)
    state, jp, jlosses = tx.init(params), params, []
    for _ in range(n_steps):
        outs = [grad_fn(jp, c, None, False) for c in jchunks]
        grads = jax.tree.map(lambda *g: sum(g) / len(g),
                             *[g for _, g in outs])
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        jlosses.append(sum(float(l) for (l, _), _ in outs) / len(outs))

    cfg = GotenNetConfig(**SMALL, fused=False)
    head = task.build_head()
    model = _port_model(cfg, params, head)
    opt = optim.make_optimizer(model.parameters(), lr)
    loss_fn = make_loss_fn(model, task)
    losses = [train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)
              for _ in range(n_steps)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = state_dict_from_jax_params(jp, cfg, head)
    n_off = n_all = 0
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 2 * lr * n_steps, (name, diff.max())
        n_off += int(np.sum(diff > 1e-3 * lr + 1e-6 * np.abs(
            want[name].numpy())))
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


@pytest.mark.parametrize("fused_htr", [False, True])
def test_unfused_message_matches_the_fused_one(fused_htr):
    """The same state dict through the fused message (its plain twin here)
    and the unfused one: the same outputs at 1e-5 of their scale (f32),
    with the plain-tensor or the fused HTR update (fused_htr goes with
    fused, as in the JAX package: the unfused model takes the plain
    update).  Energy gradients agree at 5e-4."""
    _, batch = _batches(seed=2, n=4)
    outs, grads = [], []
    for fused in (True, False):
        cfg = GotenNetConfig(**SMALL, fused=fused, fused_htr=fused_htr)
        model = GotenModel(cfg, HeadConfig(), device="cpu", seed=6)
        out = model(batch)
        out["property"].sum().backward()
        outs.append(out)
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for key in ("property", "representation", "vector_representation"):
        _assert_scaled(outs[1][key].detach().numpy(),
                       outs[0][key].detach().numpy(), 1e-5, key)
    for name, g in grads[0].items():
        _assert_scaled(grads[1][name].numpy(), g.numpy(), 5e-4, name)
