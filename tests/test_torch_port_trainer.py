"""The port's Trainer against the JAX package's.

One JAX init of a small model (D = 32, 2 layers), carried across by
``state_dict_from_jax_params``; the same synthetic molecules, splits and
seeded loaders (shuffled by epoch) go through ``Trainer.fit`` in both
packages, on the CPU (the port's fused kernels run their plain versions
there, JAX's Pallas kernels run in interpret mode).  Every field of every
epoch's record must agree at rtol 1e-5 (the wall time aside) and the final
weights at 1e-5 of each tensor's scale: the same float32 arithmetic,
summed in another order.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.tasks.qm9 import QM9Task as JQM9Task
from gotennet_tpu.train import metrics as jmetrics
from gotennet_tpu.train import optim as joptim
from gotennet_tpu.train.trainer import Trainer as JTrainer
from gotennet_tpu.train.trainer import TrainerConfig as JTrainerConfig

from gotennet_tpu_torch.data.dataset import (DenseLoader, ELLLoader,
                                             synthetic_molecules)
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel
from gotennet_tpu_torch.tasks.qm9 import QM9Task
from gotennet_tpu_torch.train import metrics, optim
from gotennet_tpu_torch.train.trainer import Trainer, TrainerConfig
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
META = {"mean": 0.0, "std": 1.0}
# warm-up over 2 steps, a plateau that cuts the LR after any epoch that
# does not improve, the loss EMA on
TRAIN_KW = dict(lr=5e-4, weight_decay=0.01, lr_warmup_steps=2,
                lr_patience=0, lr_decay=0.5, ema_rate=0.9, log_every=1,
                grad_accum_steps=2, monitor_checkpoint="MeanAbsoluteError")
# 36 training molecules of 4-20 atoms in batches of 8: 5 batches (the last
# of 4), so with 2-batch accumulation 3 steps an epoch, the last from a
# partial group; bucketed, a group may hold batches of different M
N_TRAIN, N_VAL, BATCH = 36, 12, 8
SIZES = dict(min_atoms=4, max_atoms=20)
FRAMES = dict(min_atoms=40, max_atoms=60, box=6.3)


def test_metric_accumulator_matches_jax():
    rng = np.random.default_rng(0)
    got, want = metrics.MetricAccumulator(), jmetrics.MetricAccumulator()
    for _ in range(3):
        p, t = rng.standard_normal((2, 7, 1)).astype(np.float32)
        m = (rng.random((7, 1)) > 0.3).astype(np.float32)
        got.update(p, t, m)
        want.update(p, t, m)
    assert got.compute() == want.compute()
    got.reset()
    assert got.compute() == {"mae": 0.0, "mse": 0.0}


def test_plateau_and_lr_scale_match_jax(tmp_path):
    state, jstate = optim.PlateauState(0.5, 1, 1e-6), joptim.PlateauState(
        0.5, 1, 1e-6)
    for metric in (3.0, 2.0, 2.0, 1.9999, 2.5, 1.0, 1.0, 1.0, 1.0):
        state = optim.plateau_update(state, metric, 1e-4)
        jstate = joptim.plateau_update(jstate, metric, 1e-4)
        assert dataclasses.asdict(state) == dataclasses.asdict(jstate)
    assert state.scale < 1.0
    task = QM9Task("U0", dataset_meta=META)
    model = GotenModel(GotenNetConfig(**SMALL), task.build_head(),
                       device="cpu")
    for scheduler in ("plateau", "cosine", "none"):
        kw = dict(lr_warmup_steps=5, scheduler=scheduler, cosine_t_max=7,
                  workdir=str(tmp_path / scheduler))
        tr = Trainer(model, task, TrainerConfig(**kw))
        tr.plateau = dataclasses.replace(tr.plateau, scale=0.25)
        jtr = object.__new__(JTrainer)
        jtr.cfg = JTrainerConfig(**kw)
        jtr.plateau = joptim.PlateauState(scale=0.25)
        for step in (0, 2, 4, 6, 9):
            assert tr.lr_scale(step) == pytest.approx(jtr.lr_scale(step),
                                                      rel=1e-12)


def _loaders(layout, pkg):
    """(train, validation) loaders of one package over the same splits."""
    if layout == "dense":
        make_ds, Loader = ((j_synthetic, JDenseLoader) if pkg == "jax"
                           else (synthetic_molecules, DenseLoader))
        ds = make_ds(N_TRAIN + N_VAL, seed=3, **SIZES)
        kw = dict(max_atoms=24, bucket=True)
        bs = BATCH
    else:
        make_ds, Loader = ((j_synthetic, JELLLoader) if pkg == "jax"
                           else (synthetic_molecules, ELLLoader))
        ds = make_ds(8, seed=3, **FRAMES)
        kw = dict(neighbor_probe=4, spatial_sort=True, block_rows=16)
        bs = 2
    n_train = N_TRAIN if layout == "dense" else 6
    train = Loader(ds.subset(range(n_train)), bs, shuffle=True, seed=5, **kw)
    val = Loader(ds.subset(range(n_train, len(ds))), bs, **kw)
    return train, val


def _assert_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key != "epoch_time_s":
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           err_msg=key)


def _assert_weights(state, params, cfg, head):
    """Each tensor at 1e-5 of its layer's scale (the largest entry of the
    module's tensors: a bias starts at zero, and AdamW moves an entry by
    about lr a step whatever its gradient's size, so the sum-order noise of
    a bias gradient that nearly cancels shows at the scale of lr, not of
    the bias)."""
    want = state_dict_from_jax_params(jax.device_get(params), cfg, head)
    layer_scale = {}
    for name, w in want.items():
        layer = name.rsplit(".", 1)[0]
        layer_scale[layer] = max(layer_scale.get(layer, 1e-6),
                                 float(w.abs().max()))
    for name, w in want.items():
        err = float((state[name] - w).abs().max())
        assert err <= 1e-5 * layer_scale[name.rsplit(".", 1)[0]], (name, err)


def _fit_both(tmp_path, layout, use_ema_in_loss, epochs):
    jtask = JQM9Task("U0", dataset_meta=META)
    task = QM9Task("U0", dataset_meta=META)
    jcfg = JConfig(**SMALL, fused=True, remat=False)
    jmodel = JModel(jcfg, jtask.build_head(), layout=layout)
    jtrain, jval = _loaders(layout, "jax")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), next(iter(jval)))
    kw = dict(TRAIN_KW, max_epochs=epochs, use_ema_in_loss=use_ema_in_loss)
    jtr = JTrainer(jmodel, jtask,
                   JTrainerConfig(**kw, workdir=str(tmp_path / "jax")))
    jparams, jhist = jtr.fit(params, jtrain, jval)

    cfg = GotenNetConfig(**SMALL, remat=False)
    head = task.build_head()
    model = GotenModel(cfg, head, layout, device="cpu")
    train, val = _loaders(layout, "port")
    tr = Trainer(model, task, TrainerConfig(**kw,
                                            workdir=str(tmp_path / "port")))
    state, hist = tr.fit(state_dict_from_jax_params(params, cfg, head),
                         train, val)
    _assert_history(hist, jhist)
    _assert_weights(state, jparams, cfg, head)
    return hist


@pytest.mark.parametrize("use_ema_in_loss", [False, True])
def test_dense_fit_matches_jax(tmp_path, use_ema_in_loss):
    hist = _fit_both(tmp_path, "dense", use_ema_in_loss, 2)
    assert [h["step"] for h in hist] == [3, 6]


def test_ell_fit_matches_jax(tmp_path):
    """One epoch on 40-60-atom frames on the ELL layout (spatially sorted,
    16-row gather windows, a probed K): 3 batches of 2 frames, 2 steps."""
    hist = _fit_both(tmp_path, "ell", False, 1)
    assert [h["step"] for h in hist] == [2]


def test_resume_gives_the_same_bits(tmp_path):
    """Two epochs, against one epoch and a resumed second: the same records
    and weights, bit for bit, with attention dropout on (the generator's
    state travels in the checkpoint) and use_ema_in_loss."""
    task = QM9Task("U0", dataset_meta=META)
    cfg = GotenNetConfig(**SMALL, attn_dropout=0.1)

    def run(workdir, epochs, resume=False):
        model = GotenModel(cfg, task.build_head(), device="cpu", seed=2)
        train, val = _loaders("dense", "port")
        tr = Trainer(model, task, TrainerConfig(
            **dict(TRAIN_KW, use_ema_in_loss=True), max_epochs=epochs,
            resume=resume, workdir=str(workdir)))
        return tr.fit(model.state_dict(), train, val)

    state, hist = run(tmp_path / "a", 2)
    run(tmp_path / "b", 1)
    state_r, hist_r = run(tmp_path / "b", 2, resume=True)
    assert len(hist_r) == 1 and hist_r[0]["epoch"] == 1
    for key, value in hist[1].items():
        if key != "epoch_time_s":
            assert value == hist_r[0][key], key
    assert state.keys() == state_r.keys()
    assert all(torch.equal(state[k], state_r[k]) for k in state)


def test_trainer_refuses_what_is_not_ported(tmp_path):
    task = QM9Task("U0", dataset_meta=META)
    model = GotenModel(GotenNetConfig(**SMALL), task.build_head(),
                       device="cpu")
    # more than one device runs one process per device: without a process
    # group each asks for one (tests/test_torch_port_parallel.py runs them)
    for kw in (dict(data_parallel=2), dict(edge_parallel=2),
               dict(distributed=True)):
        with pytest.raises(ValueError, match="one process per device"):
            Trainer(model, task, TrainerConfig(**kw, workdir=str(tmp_path)))
    train, val = _loaders("dense", "port")
    tr = Trainer(model, task, TrainerConfig(max_epochs=1,
                                            monitor="MeanAbsError",
                                            workdir=str(tmp_path)))
    with pytest.raises(KeyError, match="MeanAbsError"):
        tr.fit(model.state_dict(), train, val)
    assert math.isfinite(tr.evaluate(None, val)["MeanAbsoluteError"])
