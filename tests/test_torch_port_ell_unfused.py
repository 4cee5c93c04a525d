"""The port's unfused ELL paths against the JAX package's.

The ELL model takes the unfused message with ``fused=False`` (any
activation, ``aggr`` add, mean or max) and the unfused HTR update without
``fused_htr`` (the ``large_molecule`` experiment's model: the fused message
with the unfused update), with every update grammar the fused update takes
(rejection on or off, per degree or joint, the three gates), and the
message's ``scale_edge`` and shared direction and tensor blocks.  Each
configuration, from a converted JAX init, is held against JAX's model with
and without gather windows; the training step against JAX's ``one_step``;
forces against JAX's ``apply_with_forces``.  Sizes are small: D = 32, 2
layers, frames of 40-60 atoms.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.models.model import apply_with_forces as j_apply_with_forces
from gotennet_tpu.tasks.qm9 import QM9Task as JQM9Task
from gotennet_tpu.train import optim as joptim
from gotennet_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from gotennet_tpu_torch.data.dataset import ELLLoader, synthetic_molecules
from gotennet_tpu_torch.models.gotennet import GotenNetConfig, kernel_paths
from gotennet_tpu_torch.models.model import (GotenModel, HeadConfig,
                                             apply_with_forces)
from gotennet_tpu_torch.ops import fused_ell, fused_htr
from gotennet_tpu_torch.tasks.qm9 import QM9Task
from gotennet_tpu_torch.train import optim
from gotennet_tpu_torch.train.trainer import (accum_grads, make_loss_fn,
                                              train_step)
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

from test_torch_port_kernel import _assert_close
from test_torch_port_model import _compare

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
FRAMES = dict(min_atoms=40, max_atoms=60, box=6.3)
META = {"mean": 0.0, "std": 1.0}
# name -> (options of both configs); every branch of the unfused update's
# pair sum (per degree or joint, with or without rejection) and each gate;
# the message's post-softmax scale by the source's edge count, and one
# direction and one tensor block shared by every degree
CONFIGS = {
    "unfused": dict(fused=False),
    "unfused_mean": dict(fused=False, aggr="mean"),
    "unfused_max_ssp": dict(fused=False, aggr="max", activation="ssp"),
    "large_molecule": dict(fused=True, fused_htr=False),
    "gated": dict(fused=False, edge_updates="gated"),
    "gatedt_joint": dict(fused=False, edge_updates="gatedt", sep_htr=False),
    "act_norej": dict(fused=True, fused_htr=False, edge_updates="act_norej"),
    "norej_joint": dict(fused=False, edge_updates="norej", sep_htr=False),
    "scale_edge": dict(fused=False, scale_edge=True),
    "shared_blocks": dict(fused=False, sep_dir=False, sep_tensor=False),
}


def _configs(name, bf16=False):
    kw = CONFIGS[name]
    jkw = dict(pair_dtype=jnp.bfloat16, node_dtype=jnp.bfloat16) if bf16 \
        else {}
    pkw = dict(pair_dtype=torch.bfloat16, node_dtype=torch.bfloat16) if bf16 \
        else {}
    # JAX's default is fused=False, the port's True: both are given
    return (JConfig(**SMALL, **kw, **jkw),
            GotenNetConfig(**SMALL, fused=kw["fused"],
                           **{k: v for k, v in kw.items() if k != "fused"},
                           **pkw))


_PARAMS = {}


def jax_params(sep_htr=True, sep_dir=True, sep_tensor=True):
    """One JAX init per parameter tree (``sep_htr`` changes W_vk,
    ``sep_dir`` and ``sep_tensor`` the message's widths); the dense XLA
    model makes it, its tree is the ELL one."""
    key = (sep_htr, sep_dir, sep_tensor)
    if key not in _PARAMS:
        jds = j_synthetic(2, seed=0, min_atoms=5, max_atoms=9)
        jbatch = next(iter(JDenseLoader(jds, batch_size=2)))
        model = JModel(JConfig(**SMALL, sep_htr=sep_htr, sep_dir=sep_dir,
                               sep_tensor=sep_tensor), JHead(),
                       layout="dense")
        _PARAMS[key] = jax.jit(model.init)(jax.random.PRNGKey(0), jbatch)
    return _PARAMS[key]


def _batches(windows, seed=4, batch_size=2):
    lkw = dict(batch_size=batch_size, spatial_sort=windows,
               block_rows=16 if windows else None)
    jbatch = next(iter(JELLLoader(j_synthetic(2, seed=seed, **FRAMES),
                                  neighbor_probe="full", **lkw)))
    batch = next(iter(ELLLoader(synthetic_molecules(2, seed=seed, **FRAMES),
                                **lkw)))
    assert (batch.gather_window is not None) == windows
    return batch, jbatch


def _port_model(cfg, params, head=None):
    head = head or HeadConfig()
    model = GotenModel(cfg, head, layout="ell", device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg, head))
    return model


# f32: the same math in both frameworks, only the order of the sums differs
# -> 1e-5 of the output's scale.  bf16 pair/node types: the gathered tables
# (with windows) and EQFF round at the same points, but XLA on the CPU keeps
# some bf16 chains in float32 where the port rounds each product -> 2e-2 of
# the scale, as tests/test_torch_port_ell.py holds the fused model.
@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("name,dtype", [
    (n, "f32") for n in CONFIGS] + [("unfused", "bf16"),
                                    ("large_molecule", "bf16")])
def test_unfused_model_matches_jax(name, dtype, windows, monkeypatch):
    bf16 = dtype == "bf16"
    jcfg, cfg = _configs(name, bf16)
    batch, jbatch = _batches(windows)
    params = jax_params(cfg.sep_htr, cfg.sep_dir, cfg.sep_tensor)
    jout = jax.jit(JModel(jcfg, JHead(), layout="ell").apply)(params, jbatch)
    model = _port_model(cfg, params)
    calls = {"msg": 0, "htr": 0}
    msg, htr = fused_ell.fused_ell_forward, fused_htr.fused_htr_ell_forward

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fused_ell, "fused_ell_forward", count("msg", msg))
    monkeypatch.setattr(fused_htr, "fused_htr_ell_forward",
                        count("htr", htr))
    with torch.inference_mode():
        pout = model(batch)
    # the layers took the paths the configuration asks for
    assert calls == {"msg": 2 * cfg.fused, "htr": 0}
    _compare(jout, pout, 2e-2 if bf16 else 1e-5)


def test_unfused_paths_are_chosen_as_jax_does():
    """fused=False: neither kernel; fused without fused_htr: the message
    only; both: both.  A table above fused_table_rows with no halo turns
    both off."""
    for kw, want in ((dict(fused=False), (False, False)),
                     (dict(fused_htr=False), (True, False)),
                     (dict(fused_htr=True), (True, True))):
        cfg = GotenNetConfig(**SMALL, **kw)
        assert kernel_paths(cfg, "ell", 128, 128, None) == want
        assert kernel_paths(cfg, "ell", 4096, 4096, None) == (False, False)


def test_update_variants_the_ell_layout_does_not_take_raise():
    """An EK/EQ width other than n_atom_basis and the MLP and linear update
    variants, which item 5 ported: each builds the ELL model, takes the
    unfused update (with the fused message too) and matches JAX's unfused
    model at 1e-5 of scale (float32, sums in another order)."""
    batch, jbatch = _batches(False)
    for variant in (dict(edge_updates="linw", evec_dim=16),
                    dict(edge_updates="mlpa"), dict(edge_updates="linw"),
                    dict(edge_updates="gated_postln")):
        jcfg = JConfig(**SMALL, fused=False, **variant)
        jmodel = JModel(jcfg, JHead(), layout="ell")
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
        cfg = GotenNetConfig(**SMALL, fused=False, **variant)
        assert kernel_paths(dataclasses.replace(cfg, fused=True,
                                                fused_htr=True),
                            "ell", 64, 64, None) == (True, False)
        with torch.inference_mode():
            pout = _port_model(cfg, params)(batch)
        _compare(jax.jit(jmodel.apply)(params, jbatch), pout, 1e-5)


# ---- the training step against JAX's one_step --------------------------------
N_FRAMES, LR, N_STEPS = 2, 1e-4, 3
LOADER = dict(batch_size=1, spatial_sort=True, block_rows=16)


def _jax_steps(name):
    """The JAX side: initial params, the first step's gradients, and the
    losses and params of N_STEPS steps of bench.py's one_step, one frame
    per chunk with gather windows."""
    jcfg, _ = _configs(name)
    jtask = JQM9Task("U0", dataset_meta=META)
    jchunks = list(JELLLoader(j_synthetic(N_FRAMES, seed=7, **FRAMES),
                              neighbor_probe="full", **LOADER))
    jmodel = JModel(jcfg, jtask.build_head(), layout="ell")
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
        losses.append(sum(float(l) for (l, _), _ in outs) / len(outs))
        grads = jax.tree.map(lambda *g: sum(g) / len(g),
                             *[g for _, g in outs])
        first = grads if first is None else first
        jp, state = update(grads, state, jp)
    return dict(params=params, first_grads=first, losses=losses, final=jp)


@pytest.mark.parametrize("name", ["unfused", "large_molecule"])
def test_unfused_training_steps_match_jax(name):
    """The first step's gradients to 1e-5 of each gradient's scale (float32,
    sums in another order), then three steps: losses to 1e-5 and parameters
    with the tolerance and its reason of tests/test_torch_port_train.py
    (Adam moves an element whose gradient sits at rounding level by up to
    2 lr per step)."""
    jax_run = _jax_steps(name)
    _, cfg = _configs(name)
    head = QM9Task("U0", dataset_meta=META).build_head()
    model = _port_model(cfg, jax_run["params"], head)
    chunks = list(ELLLoader(synthetic_molecules(N_FRAMES, seed=7, **FRAMES),
                            **LOADER))
    loss_fn = make_loss_fn(model, QM9Task("U0", META))
    model.train()
    loss = accum_grads(model, loss_fn, chunks)
    np.testing.assert_allclose(float(loss), jax_run["losses"][0], rtol=1e-5)
    want = state_dict_from_jax_params(jax_run["first_grads"], cfg, head)
    for pname, p in model.named_parameters():
        w = want[pname].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-30), (pname, err)

    model.load_state_dict(state_dict_from_jax_params(jax_run["params"], cfg,
                                                     head))
    opt = optim.make_optimizer(model.parameters(), LR)
    losses = [train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)
              for _ in range(N_STEPS)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    want = state_dict_from_jax_params(jax_run["final"], cfg, head)
    n_off = n_all = 0
    for pname, p in model.named_parameters():
        got, w = p.detach().numpy(), want[pname].numpy()
        diff = np.abs(got - w)
        assert diff.max() <= 2 * LR * N_STEPS, (pname, diff.max())
        n_off += int(np.sum(diff > 1e-3 * LR + 1e-6 * np.abs(w)))
        n_all += w.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


# ---- forces -------------------------------------------------------------------
# f32: the backward through the layers adds more float32 roundings than the
# forward -> 1e-4 of each output's scale, as tests/test_torch_port_forces.py
@pytest.mark.parametrize("windows", [False, True])
def test_unfused_forces_match_jax(windows):
    jcfg, cfg = _configs("unfused")
    batch, jbatch = _batches(windows, seed=5)
    params = jax_params()
    jmodel = JModel(jcfg, JHead(derivative=True), layout="ell")
    jout = jax.jit(lambda p, b: j_apply_with_forces(jmodel, p, b))(params,
                                                                 jbatch)
    pout = apply_with_forces(_port_model(cfg, params,
                                         HeadConfig(derivative=True)), batch)
    for key in ("property", "forces"):
        want = np.asarray(jout[key], np.float32)
        got = pout[key].detach().numpy()
        assert got.shape == want.shape, key
        _assert_close(got, want, 1e-4, key)
    mask = batch.node_mask.numpy()
    assert np.all(pout["forces"].numpy()[~mask] == 0)
    assert np.abs(pout["forces"].numpy()[mask]).min(axis=-1).max() > 0
