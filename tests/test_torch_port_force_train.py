"""Training on forces in the port against the JAX package.

The ``MD17Task`` / ``MD22Task`` loss (energy weight 0.05, force weight
0.95, MSE) differentiates the forces ``-dE/dpos``: a gradient of a
gradient.  On the unfused paths (``fused=False``, dense and ELL) the port's
loss and its parameter gradients must match ``jax.value_and_grad`` of the
JAX package's ``make_loss_fn`` from one JAX init: the loss at rtol 1e-5,
each gradient at 5e-4 of its scale (the tolerance the JAX package holds
its own gradients to; float32, sums in another order through two
backward passes).  Then three AdamW steps, ``remat`` against no ``remat``,
the refusal on every fused path (where JAX's gradient fails too), the MD
readers, and ``cli train experiment=md22_atat`` against JAX's ``cli
train``.  D = 32, 2 layers, 8-14-atom molecules.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from gotennet_tpu import cli as jcli
from gotennet_tpu.data import md17 as jmd17
from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.tasks.force_task import MD17Task as JMD17Task
from gotennet_tpu.train import optim as joptim
from gotennet_tpu.train import trainer as jtrainer

from gotennet_tpu_torch import cli
from gotennet_tpu_torch.data import md17
from gotennet_tpu_torch.data.dataset import (DenseLoader, ELLLoader,
                                             synthetic_molecules,
                                             synthetic_trajectory)
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel
from gotennet_tpu_torch.tasks.force_task import MD17Task, MD22Task
from gotennet_tpu_torch.train import optim
from gotennet_tpu_torch.train import trainer as ptrainer
from gotennet_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                              accum_grads, make_loss_fn,
                                              train_step, train_steps)
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
MOLS = dict(min_atoms=8, max_atoms=14, box=4.0, with_forces=True)
META = {"mean": 0.0, "std": 1.0}
TASK = {"task_loss": "MSELoss"}
LR = 1e-4


def _batches(layout, n=3, seed=1):
    jds, ds = (j_synthetic(n, seed=seed, **MOLS),
               synthetic_molecules(n, seed=seed, **MOLS))
    if layout == "dense":
        return list(JDenseLoader(jds, 2)), list(DenseLoader(ds, 2))
    return (list(JELLLoader(jds, 2, neighbor_probe="full")),
            list(ELLLoader(ds, 2)))


def _jax_model(layout, **kw):
    jtask = JMD17Task("x", META, TASK)
    return JModel(JConfig(**{**SMALL, **kw}), jtask.build_head(),
                  layout=layout), jtask


_JAX = {}


def _jax_side(layout):
    """JAX's unfused model, its init and its jitted loss gradient, once
    per layout (the tests that share a layout share the compilation)."""
    if layout not in _JAX:
        jchunks, _ = _batches(layout)
        jmodel, jtask = _jax_model(layout, fused=False)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jchunks[0])
        grad_fn = jax.jit(jax.value_and_grad(
            jtrainer.make_loss_fn(jmodel, jtask), has_aux=True),
            static_argnums=(3,))
        _JAX[layout] = params, grad_fn
    return _JAX[layout]


def _port_model(layout, params, **kw):
    task = MD17Task("x", META, TASK)
    cfg = GotenNetConfig(**{**SMALL, **kw})
    head = task.build_head()
    model = GotenModel(cfg, head, layout, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg, head))
    return model, task


def _assert_scaled(got, want, tol, what):
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_force_loss_and_gradients_match_jax(layout):
    jchunks, chunks = _batches(layout)
    params, grad_fn = _jax_side(layout)
    (jloss, (jlogs, _)), jgrads = grad_fn(params, jchunks[0], None, True)
    model, task = _port_model(layout, params, fused=False)
    model.train()
    logs = {}
    loss = accum_grads(model, make_loss_fn(model, task), chunks[:1],
                       logs=logs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for name in ("energy_MSELoss", "force_MSELoss"):
        np.testing.assert_allclose(float(logs[name]), float(jlogs[name]),
                                   rtol=1e-5)
    want = state_dict_from_jax_params(jax.device_get(jgrads), model.cfg,
                                      model.head)
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        _assert_scaled(p.grad.numpy(), want[name].numpy(), 5e-4, name)


def test_three_adamw_steps_match_jax():
    """Three steps of the port's train_step (one chunk a step) and of the
    same loop in JAX: losses to 1e-5, every parameter within 2 lr x steps
    and all but 1e-3 of them within 1e-3 of lr (Adam moves an element whose
    gradient is rounding noise by about lr a step, whatever its sign)."""
    jchunks, chunks = _batches("dense", n=2)
    assert {c.z.shape for c in jchunks} == {_batches("dense")[0][0].z.shape}
    params, grad_fn = _jax_side("dense")
    tx = joptim.make_optimizer(LR, weight_decay=0.0)
    state, jp, jlosses = tx.init(params), params, []
    for _ in range(3):
        outs = [grad_fn(jp, c, None, True) for c in jchunks]
        grads = jax.tree.map(lambda *g: sum(g) / len(g),
                             *[g for _, g in outs])
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        jlosses.append(sum(float(l) for (l, _), _ in outs) / len(outs))
    model, task = _port_model("dense", params, fused=False)
    opt = optim.make_optimizer(model.parameters(), LR)
    loss_fn = make_loss_fn(model, task)
    losses = [train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)
              for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = state_dict_from_jax_params(jp, model.cfg, model.head)
    n_off = n_all = 0
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 2 * LR * 3, (name, diff.max())
        n_off += int(np.sum(diff > 1e-3 * LR + 1e-6 * np.abs(
            want[name].numpy())))
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_remat_gives_the_same_force_gradients(layout):
    """remat=True recomputes each layer under torch.utils.checkpoint
    (non-reentrant, so the forces' graph survives for the second backward):
    the same gradients to the bit as remat=False, on one CPU thread (the
    ELL gathers' scatter-adds sum in no fixed order over several)."""
    _, chunks = _batches(layout)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        grads = []
        for remat in (True, False):
            model = GotenModel(GotenNetConfig(**SMALL, fused=False,
                                              remat=remat),
                               MD22Task("x", META, TASK).build_head(),
                               layout, device="cpu", seed=3)
            model.train()
            accum_grads(model, make_loss_fn(model, MD22Task("x", META, TASK)),
                        chunks)
            grads.append({n: p.grad for n, p in model.named_parameters()})
    finally:
        torch.set_num_threads(threads)
    for name, g in grads[0].items():
        assert torch.isfinite(g).all() and torch.equal(g, grads[1][name]), \
            name


# every path that launches a fused kernel: the dense fused message (with
# and without the fused HTR update), the ELL ones
FUSED = [("dense", dict(fused=True)),
         ("dense", dict(fused=True, fused_htr=True)),
         ("ell", dict(fused=True)),
         ("ell", dict(fused=True, fused_htr=True))]


@pytest.mark.parametrize("layout,kw", FUSED)
def test_fused_paths_refuse_force_training_as_jax_cannot(layout, kw,
                                                         tmp_path):
    """The port raises ValueError, naming fused=False, before any step
    (train_steps, accum_grads, Trainer.fit); JAX's gradient of the same
    loss fails too: its Pallas VJPs are not differentiable a second
    time."""
    jchunks, chunks = _batches(layout, n=2)
    kw = dict(kw, n_interactions=1)       # one layer shows the failure
    jmodel, jtask = _jax_model(layout, **kw)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jchunks[0])
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.value_and_grad(jtrainer.make_loss_fn(jmodel, jtask),
                           has_aux=True)(params, jchunks[0], None, True)

    model, task = _port_model(layout, params, **kw)

    def no_forward(*args):
        raise AssertionError("a step started")

    model.forward = no_forward
    with pytest.raises(ValueError, match="fused=False"):
        accum_grads(model, make_loss_fn(model, task), chunks)
    mols = synthetic_molecules(2, seed=1, **MOLS).graph_dicts(range(2))
    with pytest.raises(ValueError, match="fused=False"):
        train_steps(model.cfg, model.head, mols, 1, chunk=2, device="cpu",
                    layout=layout, task=task)
    loader = (DenseLoader if layout == "dense" else ELLLoader)(
        synthetic_molecules(2, seed=1, **MOLS), 2)
    tr = Trainer(model, task, TrainerConfig(max_epochs=1,
                                            workdir=str(tmp_path)))
    with pytest.raises(ValueError, match="fused=False"):
        tr.fit(model.state_dict(), loader, loader)
    assert not os.path.exists(tmp_path / "ckpt_last")


def test_an_ell_table_the_fused_kernels_do_not_take_trains():
    """fused=True with a table above fused_table_rows and no halo: both
    packages take the unfused paths there, so the force loss trains."""
    _, chunks = _batches("ell", n=2)
    cfg = GotenNetConfig(**SMALL, fused=True, fused_htr=True,
                         fused_table_rows=8)
    task = MD17Task("x", META, TASK)
    model = GotenModel(cfg, task.build_head(), "ell", device="cpu")
    model.train()
    loss = accum_grads(model, make_loss_fn(model, task), chunks)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)


def test_train_steps_trains_on_forces():
    """The bare entry point with a force task: its molecules' force targets
    reach the chunks, and the loss falls."""
    mols = synthetic_molecules(4, seed=2, **MOLS).graph_dicts(range(4))
    task = MD17Task("x", META, TASK)
    losses = train_steps(GotenNetConfig(**SMALL, fused=False),
                         task.build_head(), mols, 3, chunk=4, lr=1e-3,
                         device="cpu", task=task)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ---- the MD readers ---------------------------------------------------------
def _write_md_files(root):
    """One 12-atom trajectory of 5 frames in the three forms."""
    t = synthetic_trajectory(5, 12, seed=4, box=4.0)
    R, E, F = np.stack(t.pos), t.y, np.stack(t.dy)
    np.savez(root / "rmd17_aspirin.npz", nuclear_charges=t.z[0], coords=R,
             energies=E[:, 0].astype(np.float64), forces=F)
    np.savez(root / "md22_AT-AT.npz", z=t.z[0], R=R, E=E, F=F)
    symbols = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F"}
    with open(root / "ethanol.xyz", "w") as f:
        for i in range(len(R)):
            f.write(f"12\nE={float(E[i, 0])!r} frame {i}\n")
            for a, z in enumerate(t.z[0]):
                sym = symbols[int(z)] if a % 2 else str(int(z))
                f.write(f"{sym} " + " ".join(repr(float(x)) for x in R[i, a])
                        + "\n")
    return t


def _same_dataset(got, want):
    assert len(got) == len(want)
    for a, b in zip(got.z, want.z):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.pos, want.pos):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.y, want.y)
    assert (got.dy is None) == (want.dy is None)
    if got.dy is not None:
        for a, b in zip(got.dy, want.dy):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("molecule,max_frames", [
    ("aspirin", None), ("AT-AT", 3), ("ethanol", None), ("ethanol", 2)])
def test_md_readers_match_jax(tmp_path, molecule, max_frames):
    t = _write_md_files(tmp_path)
    got = md17.load_md_dataset(str(tmp_path), molecule, max_frames)
    _same_dataset(got, jmd17.load_md_dataset(str(tmp_path), molecule,
                                             max_frames))
    n = len(t) if max_frames is None else max_frames
    assert len(got) == n
    np.testing.assert_array_equal(got.pos[0], t.pos[0])
    if molecule != "ethanol":       # XYZ carries no forces
        np.testing.assert_array_equal(got.dy[n - 1], t.dy[n - 1])
    assert md17.MD17_MOLECULES == jmd17.MD17_MOLECULES
    assert md17.MD22_MOLECULES == jmd17.MD22_MOLECULES


def test_md_reader_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="benzene"):
        md17.load_md_dataset(str(tmp_path), "benzene")
    np.savez(tmp_path / "benzene.npz", q=np.zeros(3))
    with pytest.raises(ValueError, match="unrecognised NPZ keys"):
        md17.load_md_dataset(str(tmp_path), "benzene")


# ---- cli train experiment=md22_atat against JAX's ---------------------------
def test_cli_md22_atat_matches_jax(tmp_path, monkeypatch):
    """Both packages' ``cli train experiment=md22_atat`` (2 epochs, then the
    test split) on an sGDML file of one 12-atom topology, from the same
    weights (JAX's init, handed to the port's Trainer.fit): every field of
    every logged record and the test results at rtol 1e-5.  The overrides
    shrink the model (D = 32, 1 layer) and keep float32 pairs and no
    attention dropout: the yaml's bf16 pairs round differently in XLA on
    the CPU (a few bf16 ulps, test_torch_port_dense_unfused.py), and the
    two packages' dropout bits cannot match."""
    root = tmp_path / "md22"
    root.mkdir()
    t = synthetic_trajectory(16, 12, seed=2, box=4.0)
    np.savez(root / "md22_AT-AT-CG-CG.npz", z=t.z[0], R=np.stack(t.pos),
             E=t.y, F=np.stack(t.dy))
    ovs = ["experiment=md22_atat", f"datamodule.dataset_root={root}",
           "model.representation.n_atom_basis=32",
           "model.representation.n_interactions=1",
           "model.representation.n_rbf=8", "model.representation.num_heads=4",
           "model.representation.pair_dtype=float32",
           "model.representation.attn_dropout=0.0", "model.output.n_hidden=16",
           "trainer.max_epochs=2", "trainer.log_every=1"]
    seen = {}
    jfit, pfit = jtrainer.Trainer.fit, ptrainer.Trainer.fit

    def jax_fit(self, params, *args, **kwargs):
        seen["params"] = params
        return jfit(self, params, *args, **kwargs)

    def port_fit(self, state, *args, **kwargs):
        state = state_dict_from_jax_params(seen["params"], self.model.cfg,
                                           self.model.head)
        return pfit(self, state, *args, **kwargs)

    monkeypatch.setattr(jtrainer.Trainer, "fit", jax_fit)
    monkeypatch.setattr(ptrainer.Trainer, "fit", port_fit)
    jcli.main(["train", *ovs, f"workdir={tmp_path / 'jax'}"])
    cli.main(["train", *ovs, "device=cpu", f"workdir={tmp_path / 'port'}"])

    def records(d):
        with open(d / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    want, got = records(tmp_path / "jax"), records(tmp_path / "port")
    # 2 epochs of 2 steps (13 training frames in batches of 8), then a
    # validation record each
    assert len(got) == len(want) == 2 * (2 + 1)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key, value in w.items():
            if key == "epoch_time_s":
                continue
            if isinstance(value, float):
                np.testing.assert_allclose(g[key], value, rtol=1e-5,
                                           err_msg=key)
            else:
                assert g[key] == value, key
    results = [json.loads((tmp_path / d / "test_results.json").read_text())
               for d in ("jax", "port")]
    assert results[1].keys() == results[0].keys()
    for key in results[0]:
        np.testing.assert_allclose(results[1][key], results[0][key],
                                   rtol=1e-5, err_msg=key)
    meta = json.loads((tmp_path / "port" / "ckpt_best" / "meta.json")
                      .read_text())
    assert meta["head"]["derivative"] and not meta["representation"]["fused"]
    # cli test of the port's checkpoint gives the run's test results
    cli.main(["test", f"checkpoint={tmp_path / 'port' / 'ckpt_best'}", *ovs,
              "device=cpu", f"workdir={tmp_path / 'test'}"])
    again = json.loads((tmp_path / "test" / "test_results.json").read_text())
    for key in results[1]:
        np.testing.assert_allclose(again[key], results[1][key], rtol=1e-5,
                                   err_msg=key)
