"""The port's energy-and-force path against the JAX package's.

Forces are ``-dE/dpos``, one backward pass through the model with respect
to the positions.  On the fused message that pass needs the position
cotangents of the GATA backward (``pos_grads=True``): the plain version of
that kernel half is held against ``_pallas_backward(..., interpret=True,
pos_grads=True)``, ``FusedGATA`` against autograd, and the CUDA source,
built for the host, against the plain version.  Then the whole path:
``apply_with_forces`` from a converted JAX init against JAX's on both
layouts, the force targets the loaders carry, the force tasks and their
loss, ``Predictor.predict_with_forces`` in the request's atom order, a
finite-difference check, and what raises.  D = 32, 2 layers.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.graph.dense_batch import collate_dense as j_collate_dense
from gotennet_tpu.graph.ell_batch import collate_ell as j_collate_ell
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.models.model import apply_with_forces as j_apply_with_forces
from gotennet_tpu.ops.pallas.fused_gata import _pallas_backward
from gotennet_tpu.tasks.force_task import MD17Task as JMD17Task
from gotennet_tpu.tasks.force_task import MD22Task as JMD22Task
from gotennet_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from gotennet_tpu_torch.data.dataset import (DenseLoader, ELLLoader,
                                             synthetic_molecules)
from gotennet_tpu_torch.graph.dense_batch import collate_dense
from gotennet_tpu_torch.graph.ell_batch import collate_ell
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import (GotenModel, HeadConfig,
                                             apply_with_forces)
from gotennet_tpu_torch.ops import fused_gata
from gotennet_tpu_torch.ops.fused_gata import (ARG_NAMES, FusedGATA,
                                               fused_gata_backward_reference,
                                               fused_gata_forward_reference)
from gotennet_tpu_torch.serve import Predictor
from gotennet_tpu_torch.tasks.force_task import MD17Task, MD22Task
from gotennet_tpu_torch.train.trainer import (accum_grads, make_loss_fn,
                                              train_steps)
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

from test_torch_port_backward import cotangents
from test_torch_port_kernel import (_assert_close, build_on_host,
                                    kernel_inputs, near_neighbours)

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
META = {"mean": 0.0, "std": 1.0}
SMALL_MOLS = dict(min_atoms=6, max_atoms=14)
MD22_LIKE = dict(min_atoms=20, max_atoms=30, box=6.3)
LARGE = dict(min_atoms=40, max_atoms=60, box=6.3)
_LAUNCH = "kern<<<grid, kThreads, smem, stream>>>(args);"


# ---- the force targets ------------------------------------------------------
def test_synthetic_forces_and_collated_targets_match_jax():
    """The same seed gives the same molecules with and without forces (the
    forces draw nothing from the generator), and the dense and ELL
    collations carry them as JAX's do, permuted with the spatial sort; the
    ELL batch's ``atom`` maps each row back to its atom."""
    ds = synthetic_molecules(5, seed=3, with_forces=True, **SMALL_MOLS)
    jds = j_synthetic(5, seed=3, with_forces=True, **SMALL_MOLS)
    plain = synthetic_molecules(5, seed=3, **SMALL_MOLS)
    assert plain.dy is None
    for i in range(5):
        np.testing.assert_array_equal(ds.dy[i], jds.dy[i])
        np.testing.assert_array_equal(ds.pos[i], plain.pos[i])
        np.testing.assert_array_equal(ds.z[i], jds.z[i])
    np.testing.assert_array_equal(ds.y, plain.y)

    graphs = ds.graph_dicts(range(5))
    got = collate_dense(graphs, 6, 16, with_forces=True)
    want = j_collate_dense(jds.graph_dicts(range(5)), 6, 16,
                           with_forces=True)
    np.testing.assert_array_equal(got.dy.numpy(), np.asarray(want.dy))
    assert collate_dense(graphs, 6, 16).dy is None
    got = next(iter(DenseLoader(ds, batch_size=2)))
    want = next(iter(JDenseLoader(jds, batch_size=2)))
    np.testing.assert_array_equal(got.dy.numpy(), np.asarray(want.dy))

    for spatial in (False, True):
        kw = dict(block_rows=16, spatial_sort=spatial)
        got = collate_ell(graphs, 96, 16, 5, with_forces=True, **kw)
        want = j_collate_ell(jds.graph_dicts(range(5)), 96, 16, 5,
                             with_forces=True, **kw)
        np.testing.assert_array_equal(got.dy.numpy(), np.asarray(want.dy))
        np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
        real = got.node_mask.numpy()
        graph, atom = got.node_graph.numpy(), got.atom.numpy()
        for r in np.flatnonzero(real):
            np.testing.assert_array_equal(got.pos[r].numpy(),
                                          ds.pos[graph[r]][atom[r]])
    got = next(iter(ELLLoader(ds, batch_size=2, block_rows=16,
                              spatial_sort=True)))
    want = next(iter(JELLLoader(jds, batch_size=2, block_rows=16,
                                spatial_sort=True, neighbor_probe="full")))
    np.testing.assert_array_equal(got.dy.numpy(), np.asarray(want.dy))


# ---- the kernel half: plain version, FusedGATA, the CUDA source -------------
# All 13 cotangents against the Pallas backward with pos_grads.  f32: the
# same math, sums in another order -> 1e-5 of each output's scale.  bf16:
# both round at the same cast points, but XLA on the CPU keeps some bf16
# chains in float32, so single pair terms differ by a bf16 ulp -> 2e-2.
# g_rl is held tighter, 5e-4 in bf16: both sides multiply rounded factors
# without rounding the products (the Pallas kernel's float32-accumulating
# matmul), where rounding each product would move g_rl by ~2^-9 of scale.
@pytest.mark.parametrize("sep,M,head_scale,dtype", [
    ((True, True), 8, False, "f32"),
    ((False, False), 8, True, "f32"),
    ((True, False), 72, True, "f32"),
    ((True, True), 8, True, "bf16"),
    ((False, True), 72, False, "bf16"),
])
def test_plain_position_cotangents_match_pallas(sep, M, head_scale, dtype):
    sep_dir, sep_tensor = sep
    G, D, H, lmax = 2, 32, 4, 2
    inputs = kernel_inputs(0, G, M, D, H, lmax, sep_dir, sep_tensor,
                           head_scale)
    g_dh, g_dX = cotangents(5, G, M, D, lmax)
    bf16 = dtype == "bf16"
    args = [torch.from_numpy(a) for a in inputs]
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep_dir, sep_tensor=sep_tensor,
              pair_dtype=torch.bfloat16 if bf16 else torch.float32)
    _, _, sm = fused_gata_forward_reference(*args, **kw, with_attn=True)
    got = fused_gata_backward_reference(*args, sm, torch.from_numpy(g_dh),
                                        torch.from_numpy(g_dX), **kw,
                                        pos_grads=True)
    want = _pallas_backward(
        *[jnp.asarray(a) for a in inputs], jnp.asarray(sm.numpy()),
        jnp.asarray(g_dh), jnp.asarray(g_dX), lmax=lmax, num_heads=H,
        sep_dir=sep_dir, sep_tensor=sep_tensor, interpret=True,
        pair_dtype=jnp.bfloat16 if bf16 else jnp.float32, pos_grads=True)
    for name, g, w in zip(ARG_NAMES, got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        tol = (5e-4 if name == "rl" else 2e-2) if bf16 else 1e-5
        _assert_close(g.numpy(), w, tol, name)
    g_rl, g_env = got[5], got[7]
    assert float(g_rl.abs().max()) > 0 and float(g_env.abs().max()) > 0
    # padded atoms and invalid pairs: exact zeros
    assert torch.all(g_rl[0, M - 3:] == 0)
    assert torch.all(g_rl[0, :, M - 3:] == 0)
    assert torch.all(g_env[args[7] < 0] == 0)


@pytest.mark.parametrize("head_scale", [False, True])
def test_fused_gata_position_gradients_match_autograd(head_scale):
    """FusedGATA with every input asking for a gradient (rl and env_signed
    included) against torch.autograd through the plain forward, float32:
    the same math, sums in another order -> 1e-5 of each gradient's
    scale."""
    G, M, D, H, lmax = 2, 8, 32, 4, 2
    kw = dict(lmax=lmax, num_heads=H, sep_dir=False, sep_tensor=True,
              pair_dtype=torch.float32)
    inputs = kernel_inputs(3, G, M, D, H, lmax, False, True, head_scale)
    g_dh, g_dX = (torch.from_numpy(c) for c in cotangents(4, G, M, D, lmax))
    grads = []
    for use_function in (True, False):
        args = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
        if use_function:
            d_h, dX = FusedGATA.apply(*args, *kw.values())
        else:
            d_h, dX, _ = fused_gata_forward_reference(*args, **kw)
        (torch.sum(d_h * g_dh) + torch.sum(dX * g_dX)).backward()
        grads.append([a.grad for a in args])
    for name, g, w in zip(ARG_NAMES, *grads):
        _assert_close(g.numpy(), w.numpy(), 1e-5, name)


# The CUDA source on the host, position cotangents on: the same rounding
# points as the plain version, every sum with one owner in a fixed order ->
# 1e-5 of each output's scale in float32, 1e-2 with a bf16 pair type (a
# float32 sum in another order can move a rounded value by one ulp); two
# runs give the same bits.
@pytest.fixture(scope="module")
def host_bwd(tmp_path_factory):
    return build_on_host(tmp_path_factory.mktemp("cuda_pos_on_host"),
                         "fused_gata_bwd.cu", _LAUNCH)


@pytest.mark.parametrize("case", [
    dict(G=2, M=8, D=32, H=4, lmax=2, sep=(True, True), hs=False,
         pd=torch.float32, node=torch.float32),
    dict(G=1, M=16, D=32, H=8, lmax=2, sep=(False, False), hs=True,
         pd=torch.bfloat16, node=torch.bfloat16),
    dict(G=1, M=24, D=32, H=4, lmax=3, sep=(True, False), hs=False,
         pd=torch.bfloat16, node=torch.float32),
    # two columns a block, most pairs invalid (near neighbours only)
    dict(G=2, M=12, D=96, H=4, lmax=2, sep=(True, True), hs=True,
         pd=torch.bfloat16, node=torch.bfloat16, reach=2),
])
def test_cuda_position_cotangents_on_host_match_plain(host_bwd, case):
    G, M, D, H, lmax = (case[k] for k in ("G", "M", "D", "H", "lmax"))
    sep_dir, sep_tensor = case["sep"]
    a = [torch.from_numpy(x) for x in kernel_inputs(
        1, G, M, D, H, lmax, sep_dir, sep_tensor, case["hs"])]
    for i in (1, 2, 3, 4):
        a[i] = a[i].to(case["node"])
    if "reach" in case:
        a[7] = near_neighbours(a[7], case["reach"])
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep_dir,
              sep_tensor=sep_tensor, pair_dtype=case["pd"])
    _, _, sm = fused_gata_forward_reference(*a, **kw, with_attn=True)
    g_dh, g_dX = (torch.from_numpy(c) for c in cotangents(2, G, M, D, lmax))
    want = fused_gata_backward_reference(*a, sm, g_dh, g_dX, **kw,
                                         pos_grads=True)
    L = (lmax + 1) ** 2 - 1
    runs = []
    for _ in range(2):
        outs = fused_gata.backward_outputs(a[0], a[8], a[11].shape[1], L,
                                           pos_grads=True)
        for o in outs:
            o.fill_(math.nan)
        fused_gata._call_backward(host_bwd, None, *a, sm, g_dh, g_dX, outs,
                                  **kw)
        runs.append(outs)
    tol = 1e-2 if case["pd"] == torch.bfloat16 else 1e-5
    for name, got, w in zip(ARG_NAMES, runs[0], want):
        _assert_close(got.numpy(), w.numpy(), tol, name)
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    assert torch.all(runs[0][5][0, M - 3:] == 0)
    assert torch.all(runs[0][7][a[7] < 0] == 0)


# ---- the whole model --------------------------------------------------------
@pytest.fixture(scope="module")
def jax_params():
    """One JAX init; every layout and option shares its tree (the cheap
    dense XLA model makes it)."""
    jds = j_synthetic(2, seed=0, min_atoms=5, max_atoms=9)
    jbatch = next(iter(JDenseLoader(jds, batch_size=2)))
    model = JModel(JConfig(**SMALL), JHead(), layout="dense")
    return jax.jit(model.init)(jax.random.PRNGKey(0), jbatch)


def _configs(bf16, fused_htr):
    jkw = dict(pair_dtype=jnp.bfloat16, node_dtype=jnp.bfloat16) if bf16 \
        else {}
    pkw = dict(pair_dtype=torch.bfloat16, node_dtype=torch.bfloat16) if bf16 \
        else {}
    return (JConfig(**SMALL, fused=True, fused_htr=fused_htr, **jkw),
            GotenNetConfig(**SMALL, fused_htr=fused_htr, **pkw))


@functools.lru_cache(maxsize=None)
def _j_forces(jcfg, layout):
    """JAX's ``apply_with_forces`` for a force head, jitted once per
    configuration (tests of one shape share the compile)."""
    model = JModel(jcfg, JHead(derivative=True), layout=layout)
    return jax.jit(lambda p, b: j_apply_with_forces(model, p, b))


def _port_model(jax_params, cfg, layout, head=None):
    head = head or HeadConfig(derivative=True)
    model = GotenModel(cfg, head, layout, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax_params, cfg, head))
    return model


def _batches(case):
    """(port batch, JAX batch) of the same frames, cut the same way."""
    layout, opt = case
    if layout == "dense":
        sizes = SMALL_MOLS if opt == "bucketed" else MD22_LIKE
        kw = dict(batch_size=4, bucket=opt == "bucketed")
        return (next(iter(DenseLoader(synthetic_molecules(4, seed=4, **sizes),
                                      **kw))),
                next(iter(JDenseLoader(j_synthetic(4, seed=4, **sizes),
                                       **kw))))
    kw = dict(batch_size=2, spatial_sort=opt == "windows",
              block_rows=16 if opt == "windows" else None)
    return (next(iter(ELLLoader(synthetic_molecules(2, seed=4, **LARGE),
                                **kw))),
            next(iter(JELLLoader(j_synthetic(2, seed=4, **LARGE),
                                 neighbor_probe="full", **kw))))


# f32: the same math, sums in another order; the backward through four
# layers of kernels adds up more float32 roundings than the forward ->
# 1e-4 of each output's scale.  bf16 pair/node types: XLA on the CPU keeps
# some bf16 chains in float32 where the port rounds every product, and the
# layers carry those few-ulp differences on -> 2e-2 of the scale.
@pytest.mark.parametrize("case,fused_htr,dtype", [
    (("dense", "bucketed"), False, "f32"),
    (("dense", "unbucketed"), True, "f32"),
    (("dense", "unbucketed"), True, "bf16"),
    (("ell", "windows"), True, "f32"),
    (("ell", "windows"), True, "bf16"),
    (("ell", "plain"), True, "f32"),
])
def test_forces_match_jax(jax_params, case, fused_htr, dtype):
    bf16 = dtype == "bf16"
    layout = case[0]
    jcfg, cfg = _configs(bf16, fused_htr)
    batch, jbatch = _batches(case)
    assert (layout == "ell") == hasattr(batch, "nbr")
    jout = _j_forces(jcfg, layout)(jax_params, jbatch)
    pout = apply_with_forces(_port_model(jax_params, cfg, layout), batch)
    tol = 2e-2 if bf16 else 1e-4
    for key in ("property", "forces"):
        want = np.asarray(jout[key], np.float32)
        got = pout[key].detach().numpy()
        assert got.shape == want.shape, key
        _assert_close(got, want, tol, key)
    mask = batch.node_mask.numpy()
    assert np.all(pout["forces"].numpy()[~mask] == 0)
    assert np.abs(pout["forces"].numpy()[mask]).min(axis=-1).max() > 0


# ---- the force tasks --------------------------------------------------------
def _spec_fields(specs):
    return [{k: (v.__name__ if callable(v) else v) for k, v in s.items()}
            for s in specs]


@pytest.mark.parametrize("task_cls,jtask_cls,config", [
    (MD17Task, JMD17Task, {}),
    (MD22Task, JMD22Task, {"task_loss": "L1Loss", "force_weight": 0.8}),
])
def test_force_task_matches_jax(jax_params, task_cls, jtask_cls, config):
    """Losses, metrics, head and targets as JAX's; the loss of
    ``make_loss_fn`` (through ``apply_with_forces``) on one dense batch
    with forces as JAX's ``make_loss_fn``'s, float32 -> 1e-4."""
    task, jtask = task_cls("energy", META, config), jtask_cls(
        "energy", META, config)
    assert task.name == jtask.name
    assert _spec_fields(task.get_losses()) == _spec_fields(jtask.get_losses())
    assert (_spec_fields(task.get_metrics())
            == _spec_fields(jtask.get_metrics()))
    head, jhead = task.build_head(), jtask.build_head()
    assert head.derivative and jhead.derivative
    assert (head.activation, head.mean, head.stddev) == (
        jhead.activation, jhead.mean, jhead.stddev)

    ds = synthetic_molecules(3, seed=6, with_forces=True, **SMALL_MOLS)
    jds = j_synthetic(3, seed=6, with_forces=True, **SMALL_MOLS)
    batch = next(iter(DenseLoader(ds, batch_size=4)))
    jbatch = next(iter(JDenseLoader(jds, batch_size=4)))
    targets, jtargets = task.get_targets(batch), jtask.get_targets(jbatch)
    assert set(targets) == set(jtargets) == {"y", "dy"}
    for k in targets:
        for got, want in zip(targets[k], jtargets[k]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ell = collate_ell(ds.graph_dicts(range(3)), 48, 16, 4, with_forces=True)
    jell = j_collate_ell(jds.graph_dicts(range(3)), 48, 16, 4,
                         with_forces=True)
    for got, want in zip(task.get_targets(ell)["dy"],
                         jtask.get_targets(jell)["dy"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jcfg, cfg = _configs(False, False)
    jmodel = JModel(jcfg, jhead, layout="dense")
    jtotal, (jlogs, _) = jax.jit(j_make_loss_fn(jmodel, jtask),
                                 static_argnums=(3,))(jax_params, jbatch,
                                                      None, True)
    model = _port_model(jax_params, cfg, "dense", head)
    total, logs, out = make_loss_fn(model, task)(batch)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-4)
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=1e-4)
    assert out["forces"].shape == batch.dy.shape


# ---- serving ----------------------------------------------------------------
def test_predict_with_forces_matches_jax_in_request_order(jax_params):
    """Energies and forces of a request, answered bucketed on the dense
    layout and spatially sorted on the ELL one, against JAX's forces on all
    the frames in one unsorted batch (f32 -> 1e-4 of scale); permuting one
    frame's atoms permutes its forces the same way."""
    jds = j_synthetic(4, seed=8, **MD22_LIKE)
    mols = synthetic_molecules(4, seed=8, **MD22_LIKE).graph_dicts(range(4))
    jbatch = next(iter(JDenseLoader(jds, batch_size=4)))
    jcfg, cfg = _configs(False, True)
    jout = _j_forces(jcfg, "dense")(jax_params, jbatch)
    want_e = np.asarray(jout["property"])
    want_f = [np.asarray(jout["forces"])[g, :len(m["z"])]
              for g, m in enumerate(mols)]
    head = HeadConfig(derivative=True)
    sd = state_dict_from_jax_params(jax_params, cfg, head)
    for layout in ("dense", "ell"):
        pred = Predictor(cfg, head, sd, chunk=2, device="cpu", layout=layout,
                         block_rows=16)
        energies, forces = pred.predict_with_forces(mols)
        assert energies.shape == (4, 1) and len(forces) == 4
        _assert_close(energies, want_e, 1e-4, f"{layout} energies")
        scale = max(np.abs(f).max() for f in want_f)
        for got, want in zip(forces, want_f):
            assert got.shape == want.shape and got.dtype == np.float32
            assert np.abs(got - want).max() <= 1e-4 * scale, layout
    perm = np.random.default_rng(0).permutation(len(mols[0]["z"]))
    moved = [dict(z=mols[0]["z"][perm], pos=mols[0]["pos"][perm])] + mols[1:]
    _, forces_p = pred.predict_with_forces(moved)
    np.testing.assert_allclose(forces_p[0], forces[0][perm], rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_forces_match_finite_differences(layout):
    """-F_a.u against the central difference of the energy when one atom a
    moves along a random unit vector u, for three atoms, float32, eps
    1e-2 A: truncation and float32 rounding -> 2e-2 of |F_a|.  Each probed
    atom keeps every distance at least 3 eps away from the cutoff, because
    the dense layout rebuilds its pairs from the positions and a pair that
    crosses the cutoff changes the attention (whose term carries no
    envelope) by a step."""
    cfg = GotenNetConfig(**SMALL, fused_htr=True)
    model = GotenModel(cfg, HeadConfig(derivative=True), layout, seed=3,
                       device="cpu")
    ds = synthetic_molecules(2, seed=9, **MD22_LIKE)
    loader = (DenseLoader(ds, batch_size=2) if layout == "dense"
              else ELLLoader(ds, batch_size=2, block_rows=16,
                             spatial_sort=True))
    batch = next(iter(loader))
    forces = apply_with_forces(model, batch)["forces"].detach()
    eps = 1e-2
    pos = batch.pos.reshape(-1, 3)
    real = torch.nonzero(batch.node_mask.reshape(-1))[:, 0]
    dist = torch.cdist(pos[real].double(), pos[real].double())
    rows = real[((dist - cfg.cutoff).abs() > 3 * eps).all(dim=1)][:3]
    assert len(rows) == 3
    rng = np.random.default_rng(1)

    def energy(row, step):
        moved = pos.clone()
        moved[row] += step
        with torch.inference_mode():
            b = dataclasses.replace(batch, pos=moved.reshape(batch.pos.shape))
            return float(model(b)["property"].double().sum())

    for row in rows.tolist():
        u = rng.standard_normal(3)
        u = torch.from_numpy(u / np.linalg.norm(u)).to(torch.float32)
        num = (energy(row, eps * u) - energy(row, -eps * u)) / (2 * eps)
        f = forces.reshape(-1, 3)[row].double()
        ana = -float(f @ u.double())
        assert abs(num - ana) <= 2e-2 * float(f.norm()), (row, num, ana)


# ---- what raises ------------------------------------------------------------
def test_position_gradient_with_pos_grads_false_raises():
    """pos_grads=False skips the position cotangents; asking for forces then
    raises (the JAX package would give zero-contribution forces)."""
    cfg = GotenNetConfig(**SMALL, pos_grads=False)
    model = GotenModel(cfg, HeadConfig(derivative=True), device="cpu")
    batch = next(iter(DenseLoader(synthetic_molecules(2, seed=0,
                                                      **SMALL_MOLS), 2)))
    with pytest.raises(ValueError, match="pos_grads=False"):
        apply_with_forces(model, batch)


def test_force_training_and_energy_heads_raise():
    """Training on a force loss through the fused kernels raises a
    ValueError naming fused=False (their backward is differentiable once;
    tests/test_torch_port_force_train.py trains with fused=False);
    predict_with_forces needs a derivative head."""
    mols = synthetic_molecules(2, seed=0, with_forces=True,
                               **SMALL_MOLS).graph_dicts(range(2))
    head = MD22Task("energy", META).build_head()
    cfg = GotenNetConfig(**SMALL)
    with pytest.raises(ValueError, match="fused=False"):
        train_steps(cfg, head, mols, 1, device="cpu")
    model = GotenModel(cfg, head, device="cpu")
    batch = next(iter(DenseLoader(synthetic_molecules(
        2, seed=0, with_forces=True, **SMALL_MOLS), 2)))
    with pytest.raises(ValueError, match="fused=False"):
        accum_grads(model, make_loss_fn(model, MD22Task("energy", META)),
                    [batch])
    with pytest.raises(ValueError, match="derivative"):
        Predictor(cfg, HeadConfig(), device="cpu").predict_with_forces(mols)
