"""The port's ELL layout against the JAX package's.

The host-side graph code (``build_edges_np``, ``spatial_order``,
``collate_ell`` and ``ELLLoader``) must give the JAX package's arrays; the
plain versions of the two ELL kernels are held against the Pallas kernels
in interpret mode on the same numpy inputs; the whole ELL model, from a
converted JAX init, against JAX's ``fused=True, fused_htr=True`` ELL model;
``Predictor(layout="ell")`` against per-frame model calls; both forward
CUDA sources, built for the host, against the plain versions (the backward
ones: tests/test_torch_port_ell_train.py).  Sizes are small:
D = 32, 2 layers, frames of 40-60 atoms.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.graph.ell_batch import collate_ell as j_collate_ell
from gotennet_tpu.graph.neighborlist import build_edges_np as j_build_edges
from gotennet_tpu.graph.neighborlist import spatial_order as j_spatial_order
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.models.model import HeadConfig as JHead
from gotennet_tpu.ops.pallas.fused_ell import _pallas_ell_forward
from gotennet_tpu.ops.pallas.fused_htr import make_fused_htr_ell

from gotennet_tpu_torch.data.dataset import ELLLoader, synthetic_molecules
from gotennet_tpu_torch.graph.ell_batch import collate_ell
from gotennet_tpu_torch.graph.neighborlist import build_edges_np, spatial_order
from gotennet_tpu_torch.models.gotennet import GotenNetConfig, kernel_paths
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.ops import fused_ell, fused_htr
from gotennet_tpu_torch.ops.fused_ell import (fused_ell_forward,
                                              fused_ell_forward_reference)
from gotennet_tpu_torch.ops.fused_htr import (fused_htr_ell_forward,
                                              fused_htr_ell_forward_reference)
from gotennet_tpu_torch.serve import Predictor
from gotennet_tpu_torch.train.trainer import make_chunks, train_steps
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

from test_torch_port_kernel import _assert_close, build_on_host
from test_torch_port_model import _compare

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
FRAMES = dict(min_atoms=40, max_atoms=60, box=6.3)
# the frames of the JAX package's chunked-path test (tests/test_ell.py)
XL_TEST_FRAMES = dict(min_atoms=155, max_atoms=160, box=6.3)
# the one launch line of each forward source, which the host build replaces
_LAUNCH = "kern<<<grid, kThreads, smem, stream>>>(args);"
_MSG_LAUNCH = "kern<<<grid, NT, smem, stream>>>(args);"
BATCH_FIELDS = ("z", "pos", "node_graph", "nbr", "nbr_mask", "node_mask",
                "graph_mask", "y")
STATIC_FIELDS = ("gather_window", "block_rows", "gather_halo")


# ---- host-side graph code ----------------------------------------------------
@pytest.mark.parametrize("cap", [32, 6])
def test_edges_and_spatial_order_match_jax(cap):
    ds = synthetic_molecules(3, seed=2, **FRAMES)
    for pos in ds.pos:
        for got, want in zip(build_edges_np(pos, 5.0, True, cap),
                             j_build_edges(pos, 5.0, True, cap)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(spatial_order(pos, 5.0),
                                      j_spatial_order(pos, 5.0))


def _assert_batches_equal(got, want):
    for name in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for name in STATIC_FIELDS:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("block_rows,spatial", [(None, False), (16, True),
                                                (32, False)])
def test_collate_and_loader_match_jax(block_rows, spatial):
    ds = synthetic_molecules(5, seed=1, **FRAMES)
    jds = j_synthetic(5, seed=1, **FRAMES)
    kw = dict(batch_size=2, spatial_sort=spatial, block_rows=block_rows)
    loader = ELLLoader(ds, **kw)
    jloader = JELLLoader(jds, neighbor_probe="full", **kw)
    assert (loader.node_capacity, loader.max_neighbors) == \
        (jloader.node_capacity, jloader.max_neighbors)
    batches = list(loader)
    assert len(batches) == 3
    for got, want in zip(batches, jloader):
        _assert_batches_equal(got, want)
    graphs = ds.graph_dicts([3, 0])
    _assert_batches_equal(
        collate_ell(graphs, 128, 36, 2, block_rows=block_rows,
                    spatial_sort=spatial),
        j_collate_ell(jds.graph_dicts([3, 0]), 128, 36, 2,
                      block_rows=block_rows, spatial_sort=spatial))


def test_loader_rebuckets_like_jax():
    """A neighbour capacity too small for the frames grows by 4 until they
    fit, on both sides, and the batches stay equal."""
    ds = synthetic_molecules(4, seed=3, **FRAMES)
    jds = j_synthetic(4, seed=3, **FRAMES)
    kw = dict(batch_size=2, max_neighbors=8, block_rows=16,
              spatial_sort=True)
    loader, jloader = ELLLoader(ds, **kw), JELLLoader(jds, **kw)
    for got, want in zip(loader, jloader):
        _assert_batches_equal(got, want)
    assert loader.max_neighbors == jloader.max_neighbors > 8


# ---- the message kernel's plain version vs Pallas ----------------------------
def ell_inputs(seed, NR, N, K, D, H, lmax, sep_dir, sep_tensor, head_scale):
    """numpy inputs in argument order: about a third of the slots padded
    (env -1, pointing at their own row), the last row wholly padded."""
    rng = np.random.default_rng(seed)
    L = (lmax + 1) ** 2 - 1
    mult = 1 + (lmax if sep_dir else 1) + (lmax if sep_tensor else 1)

    def rand(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.3

    valid = rng.random((NR, K)) > 0.3
    valid[-1] = False
    nbr = rng.integers(0, N, (NR, K)).astype(np.int32)
    nbr = np.where(valid, nbr, np.arange(NR, dtype=np.int32)[:, None])
    env = np.where(valid, rng.random((NR, K)), -1.0).astype(np.float32)
    scale = (rng.random((NR, K, H)).astype(np.float32) if head_scale
             else np.full((NR, K), 1.0 / math.sqrt(D), np.float32))
    return [rand(NR, K, D), rand(NR, D), rand(N, D), rand(N, mult * D),
            rand(N, mult * D), rand(NR, K, L), rand(N, L, D), env, scale, nbr,
            rand(D, D), rand(D), rand(D, mult * D), rand(mult * D)]


# f32: identical math, only the order of the sums differs -> 1e-5 of each
# output's scale.  bf16: both round at the same cast points, but XLA on the
# CPU fuses bf16 elementwise chains and keeps float32 intermediates where
# the port rounds every product, so single pair terms differ by a bf16 ulp
# (2^-8): 2e-2 of the scale.
@pytest.mark.parametrize("sep,K,NR,N,head_scale,dtype", [
    ((True, True), 12, 16, 16, False, "f32"),
    ((False, False), 36, 16, 24, True, "f32"),
    ((True, False), 12, 8, 16, True, "f32"),
    ((False, True), 36, 16, 16, False, "f32"),
    ((True, True), 36, 16, 24, True, "bf16"),
    ((True, True), 12, 16, 16, False, "bf16"),
])
def test_message_reference_matches_pallas_interpret(sep, K, NR, N,
                                                    head_scale, dtype):
    D, H, lmax = 32, 4, 2
    inputs = ell_inputs(0, NR, N, K, D, H, lmax, *sep, head_scale)
    bf16 = dtype == "bf16"
    tol = 2e-2 if bf16 else 1e-5
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep[0], sep_tensor=sep[1])
    j_dh, j_dx, j_sm = _pallas_ell_forward(
        *[jnp.asarray(a) for a in inputs], **kw, interpret=True,
        pair_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    d_h, dX, sm = fused_ell_forward(
        *[torch.from_numpy(a) for a in inputs], **kw, with_attn=True,
        pair_dtype=torch.bfloat16 if bf16 else torch.float32)
    for name, got, want in (("d_h", d_h, j_dh), ("dX", dX, j_dx),
                            ("sm", sm, j_sm)):
        assert got.shape == want.shape, name
        _assert_close(got.numpy(), np.asarray(want), tol, name)
    # the wholly padded row: no softmax weight, no update
    assert torch.all(sm[-1] == 0) and torch.all(d_h[-1] == 0)
    assert torch.all(dX[-1] == 0)


# ---- the HTR kernel's plain version vs Pallas --------------------------------
def htr_ell_inputs(seed, NR, N, K, D, lmax):
    """numpy (t, EQ, EK, rl, nbr, W_g, b_g); padded slots point at their own
    row and are updated like the others."""
    rng = np.random.default_rng(seed)
    L = (lmax + 1) ** 2 - 1

    def rand(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.4

    nbr = rng.integers(0, N, (NR, K)).astype(np.int32)
    nbr[:, -3:] = np.arange(NR, dtype=np.int32)[:, None]
    return [rand(NR, K, D), rand(NR, L, D), rand(N, L, D), rand(NR, K, L),
            nbr, rand(D, D), rand(D)]


# float32: the JAX package's own tolerances for the HTR kernels
# (tests/test_fused_htr.py); bf16: 2e-2 of the scale, for the reason above.
@pytest.mark.parametrize("sep_htr,rej,gate,dtype", [
    (True, True, "", "f32"), (False, True, "gated", "f32"),
    (True, True, "gatedt", "f32"), (False, True, "act", "f32"),
    (True, False, "", "f32"), (False, False, "gated", "f32"),
    (True, False, "gatedt", "f32"), (True, False, "act", "f32"),
    (True, True, "", "bf16"), (False, False, "gated", "bf16"),
])
def test_htr_reference_matches_pallas_interpret(sep_htr, rej, gate, dtype):
    NR, N, K, D, lmax = 16, 24, 12, 32, 2
    inputs = htr_ell_inputs(1, NR, N, K, D, lmax)
    bf16 = dtype == "bf16"
    fn = make_fused_htr_ell(lmax, sep_htr, rej, gate, interpret=True,
                            pair_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    want = np.asarray(fn(*[jnp.asarray(a) for a in inputs]))
    got = fused_htr_ell_forward(
        *[torch.from_numpy(a) for a in inputs], lmax=lmax, sep_htr=sep_htr,
        rej=rej, gate=gate,
        pair_dtype=torch.bfloat16 if bf16 else torch.float32).numpy()
    assert got.shape == want.shape == (NR, K, D)
    if bf16:
        _assert_close(got, want, 2e-2, "out")
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# ---- the whole model ---------------------------------------------------------
@pytest.fixture(scope="module")
def jax_params():
    """One JAX init.  The ELL tree is the dense tree
    (test_ell_weights_cross_unchanged), so the cheap dense XLA model
    makes it."""
    jds = j_synthetic(2, seed=0, min_atoms=5, max_atoms=9)
    from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
    jbatch = next(iter(JDenseLoader(jds, batch_size=2)))
    model = JModel(JConfig(**SMALL), JHead(), layout="dense")
    return jax.jit(model.init)(jax.random.PRNGKey(0), jbatch)


def _jax_cfg(bf16):
    kw = dict(pair_dtype=jnp.bfloat16, node_dtype=jnp.bfloat16) if bf16 \
        else {}
    return JConfig(**SMALL, fused=True, fused_htr=True, **kw)


def _port_cfg(bf16, **kw):
    if bf16:
        kw.update(pair_dtype=torch.bfloat16, node_dtype=torch.bfloat16)
    return GotenNetConfig(**SMALL, fused_htr=True, **kw)


def test_ell_weights_cross_unchanged():
    """The JAX ELL model keeps the dense parameter tree (W_re, W_rs,
    gamma_t, W_ndp, W_erp and the rest), so the converter needs no change,
    and the port's ELL model has the dense model's state-dict keys."""
    jds = j_synthetic(2, seed=0, **FRAMES)
    jbatch = next(iter(JELLLoader(jds, batch_size=2)))
    key = jax.random.PRNGKey(0)
    ell = jax.eval_shape(JModel(_jax_cfg(False), JHead(), layout="ell").init,
                         key, jbatch)
    from gotennet_tpu.data.dataset import DenseLoader as JDenseLoader
    dense = jax.eval_shape(JModel(JConfig(**SMALL), JHead(),
                                  layout="dense").init, key,
                           next(iter(JDenseLoader(jds, batch_size=2))))
    assert (jax.tree_util.tree_structure(ell)
            == jax.tree_util.tree_structure(dense))
    assert all(a.shape == b.shape for a, b in zip(
        jax.tree_util.tree_leaves(ell), jax.tree_util.tree_leaves(dense)))
    cfg = _port_cfg(False)
    keys = [set(GotenModel(cfg, HeadConfig(), layout=lay,
                           device="cpu").state_dict())
            for lay in ("ell", "dense")]
    assert keys[0] == keys[1]


# f32: the same math in both frameworks, only the order of the sums differs
# -> 1e-5 of the output's scale.  bf16 pair/node types: XLA on the CPU keeps
# some bf16 chains in float32 where the port rounds every product, and the
# layers carry those few-ulp differences on: 2e-2 of the scale, as the dense
# models are held (tests/test_torch_port_model.py).
@pytest.mark.parametrize("dtype,windows", [("f32", False), ("f32", True),
                                           ("bf16", False), ("bf16", True)])
def test_ell_model_matches_jax(jax_params, dtype, windows):
    bf16 = dtype == "bf16"
    lkw = dict(batch_size=2, spatial_sort=windows,
               block_rows=16 if windows else None)
    jbatch = next(iter(JELLLoader(j_synthetic(2, seed=4, **FRAMES),
                                  neighbor_probe="full", **lkw)))
    batch = next(iter(ELLLoader(synthetic_molecules(2, seed=4, **FRAMES),
                                **lkw)))
    assert (batch.gather_window is not None) == windows
    jout = jax.jit(JModel(_jax_cfg(bf16), JHead(), layout="ell").apply)(
        jax_params, jbatch)
    cfg = _port_cfg(bf16)
    model = GotenModel(cfg, HeadConfig(), layout="ell", device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax_params, cfg,
                                                     HeadConfig()))
    with torch.inference_mode():
        pout = model(batch)
    _compare(jout, pout, 2e-2 if bf16 else 1e-5)


def test_ell_predictor_matches_per_frame_model():
    """Answers in request order, each the model's answer on its frame alone
    (f32: chunking and padding only change the order of f32 sums)."""
    cfg = _port_cfg(False)
    head = HeadConfig(mean=0.5, stddev=2.0)
    pred = Predictor(cfg, head, seed=5, chunk=2, device="cpu", layout="ell",
                     block_rows=16)
    mols = synthetic_molecules(3, seed=6, **FRAMES).graph_dicts(range(3))
    got = pred.predict(mols)
    assert got.shape == (3, 1) and np.isfinite(got).all()
    with torch.inference_mode():
        want = [pred.model(collate_ell([m], len(m["z"]), 40, 1))["property"]
                for m in mols]
    np.testing.assert_allclose(got, torch.cat(want).numpy(), rtol=1e-4,
                               atol=1e-4)


def test_ell_training_raises():
    """Training on ELL: attention dropout in training draws its keep masks
    (item 1, ported: the answer moves off the eval one and gradients reach
    the parameters), the dispatchers record the backward, and train_steps
    runs a node table above fused_table_rows that has no halo-windowed
    chunking (64-row blocks, a 64-row limit): the JAX package takes its
    unfused paths there, and so does the port."""
    inputs = [torch.from_numpy(a) for a in ell_inputs(
        0, 8, 8, 12, 32, 4, 2, True, True, False)]
    inputs[0].requires_grad_(True)
    d_h, _ = fused_ell.fused_ell(*inputs, lmax=2, num_heads=4, sep_dir=True,
                                 sep_tensor=True)
    assert d_h.shape == (8, 32) and d_h.grad_fn is not None
    h_in = [torch.from_numpy(a) for a in htr_ell_inputs(0, 8, 8, 12, 32, 2)]
    h_in[5].requires_grad_(True)
    assert fused_htr.fused_htr_ell(*h_in, lmax=2, sep_htr=True, rej=True,
                                   gate="").grad_fn is not None
    mols = synthetic_molecules(2, seed=0, **FRAMES).graph_dicts(range(2))
    model = GotenModel(_port_cfg(False, attn_dropout=0.1), HeadConfig(),
                       layout="ell", device="cpu")
    batch = next(iter(ELLLoader(synthetic_molecules(2, seed=0, **FRAMES),
                                batch_size=2)))
    with torch.no_grad():
        want = model(batch)["property"]
    model.train()
    got = model(batch)["property"]
    assert torch.isfinite(got).all() and not torch.equal(got, want)
    got.sum().backward()
    assert model.representation.gata_list[0].W_q.weight.grad is not None
    cfg = _port_cfg(False, fused_table_rows=64)
    chunk, = make_chunks(mols, 2, "cpu", layout="ell")
    assert chunk.num_nodes > 64
    assert kernel_paths(cfg, "ell", chunk.num_nodes, chunk.num_nodes,
                        chunk.gather_halo) == (False, False)
    losses = train_steps(cfg, HeadConfig(), mols, 2, chunk=2, device="cpu",
                         layout="ell")
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_table_above_fused_table_rows_raises():
    """A node table above fused_table_rows where the JAX package runs its
    chunked paths (a halo-windowed chunking exists): the port runs the
    same kernels on the whole table, so its answer is the one it gives with
    no limit (0), bit for bit; the JAX side is held in
    tests/test_torch_port_xl.py.  (The test once checked that such a table
    raised.)  The large_molecule experiment's model, fused_htr=False, runs
    too."""
    ds = synthetic_molecules(2, seed=0, **XL_TEST_FRAMES)
    batch = next(iter(ELLLoader(ds, batch_size=2, spatial_sort=True,
                                block_rows=8)))
    N, limit = batch.num_nodes, 256
    assert N > limit
    cr, W, C = fused_ell.pick_chunking(N, N, batch.gather_halo, limit)
    assert C > 1 and W < N
    outs = []
    for rows in (limit, 0):
        cfg = _port_cfg(False, fused_table_rows=rows)
        assert kernel_paths(cfg, "ell", N, N,
                            batch.gather_halo) == (True, True)
        model = GotenModel(cfg, HeadConfig(), layout="ell", device="cpu")
        with torch.inference_mode():
            outs.append(model(batch)["property"])
    assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])
    model = GotenModel(GotenNetConfig(**SMALL), HeadConfig(), layout="ell",
                       device="cpu")     # without fused_htr
    with torch.inference_mode():
        assert torch.isfinite(model(batch)["property"]).all()


# ---- both CUDA sources on the host ------------------------------------------
@pytest.fixture(scope="module")
def host_ell(tmp_path_factory):
    return build_on_host(tmp_path_factory.mktemp("ell_fwd_on_host"),
                         "fused_ell_fwd.cu", _MSG_LAUNCH)


@pytest.fixture(scope="module")
def host_htr_ell(tmp_path_factory):
    return build_on_host(tmp_path_factory.mktemp("htr_ell_fwd_on_host"),
                         "fused_htr_ell_fwd.cu", _LAUNCH)


# The host builds round at the same points as the plain versions; only the
# order of the float32 sums differs -> 1e-5 of each output's scale.
HOST_CASES = [
    # NR, N, K, sep / gate, head_scale, pair type, t type
    (64, 96, 36, (True, True), False, torch.float32, torch.float32),
    (40, 40, 28, (False, True), True, torch.bfloat16, torch.float32),
    (100, 128, 36, (True, False), True, torch.bfloat16, torch.bfloat16),
]


@pytest.mark.parametrize("NR,N,K,sep,hs,pd,td", HOST_CASES)
def test_message_source_on_host_matches_plain(host_ell, NR, N, K, sep, hs,
                                              pd, td):
    D, H, lmax = 32, 4, 2
    a = [torch.from_numpy(x) for x in ell_inputs(2, NR, N, K, D, H, lmax,
                                                 *sep, hs)]
    a[0] = a[0].to(td)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep[0], sep_tensor=sep[1],
              pair_dtype=pd)
    want = fused_ell_forward_reference(*a, **kw, with_attn=True)
    L = (lmax + 1) ** 2 - 1
    got = (torch.full((NR, D), math.nan), torch.full((NR, L, D), math.nan),
           torch.full((NR, K, H), math.nan))
    fused_ell._call_kernel(host_ell, None, *a, *got, **kw)
    for name, g, w in zip(("d_h", "dX", "sm"), got, want):
        _assert_close(g.numpy(), w.numpy(), 1e-5, name)


@pytest.mark.parametrize("NR,N,K,gate,pd,td", [
    (64, 96, 36, "", torch.float32, torch.float32),
    (40, 40, 28, "gated", torch.bfloat16, torch.float32),
    (100, 128, 36, "act", torch.bfloat16, torch.bfloat16),
])
def test_htr_source_on_host_matches_plain(host_htr_ell, NR, N, K, gate, pd,
                                          td):
    D, lmax = 32, 2
    a = [torch.from_numpy(x) for x in htr_ell_inputs(3, NR, N, K, D, lmax)]
    a[0] = a[0].to(td)
    kw = dict(lmax=lmax, sep_htr=gate != "act", rej=True, gate=gate,
              pair_dtype=pd)
    want = fused_htr_ell_forward_reference(*a, **kw)
    out = torch.full((NR, K, D), math.nan)
    fused_htr._call_ell_kernel(host_htr_ell, None, *a, out, **kw)
    # every slot, padded ones included: the update masks none
    _assert_close(out.numpy(), want.numpy(), 1e-5, "out")


# The HTR update's block shapes, each held against the plain version and run
# twice (the same bytes: a block owns its slots' outputs): the row path
# (bf16 pair type, lmax <= 2) with K = 36 and K = 12 (a 128-slot block spans
# rows, none aligned to it), fewer rows than table rows, two indices
# outside the table (the kernel clamps them; the plain version is given
# them clamped), float32 and bf16 t and tables, sep_htr on and off, no
# rejection terms, all four gates, lmax 1 and 2; the slice path with a
# float32 pair type and at lmax 3.  1e-5 of the scale, as above.
@pytest.mark.parametrize("NR,N,K,lmax,v,pd,td,nd", [
    (70, 96, 36, 2, (True, True, ""), torch.bfloat16, torch.float32,
     torch.float32),
    (53, 53, 12, 2, (False, True, "gated"), torch.bfloat16, torch.bfloat16,
     torch.bfloat16),
    (40, 60, 36, 1, (True, False, "act"), torch.bfloat16, torch.float32,
     torch.float32),
    (30, 40, 12, 2, (True, False, "gatedt"), torch.bfloat16, torch.bfloat16,
     torch.float32),
    (20, 24, 36, 2, (True, True, "gated"), torch.float32, torch.float32,
     torch.bfloat16),
    (16, 20, 12, 3, (True, True, ""), torch.bfloat16, torch.float32,
     torch.float32),
], ids=["k36-f32-tables", "k12-bf16", "lmax1-norej", "k12-gatedt", "f32",
        "lmax3"])
def test_htr_source_on_host_block_shapes_rerun(host_htr_ell, NR, N, K, lmax,
                                               v, pd, td, nd):
    D = 32
    a = [torch.from_numpy(x) for x in htr_ell_inputs(5, NR, N, K, D, lmax)]
    a[0] = a[0].to(td)
    a[1], a[2] = a[1].to(nd), a[2].to(nd)
    a[4][0, 0], a[4][1, 2] = N + 5, -3
    kw = dict(lmax=lmax, sep_htr=v[0], rej=v[1], gate=v[2], pair_dtype=pd)
    clamped = list(a)
    clamped[4] = a[4].clamp(0, N - 1)
    want = fused_htr_ell_forward_reference(*clamped, **kw)
    runs = []
    for _ in range(2):
        out = torch.full((NR, K, D), math.nan)
        fused_htr._call_ell_kernel(host_htr_ell, None, *a, out, **kw)
        runs.append(out)
    _assert_close(runs[0].numpy(), want.numpy(), 1e-5, "out")
    assert runs[0].numpy().tobytes() == runs[1].numpy().tobytes()


# The message kernel's block shapes, each held against the plain version and
# run twice (the same bytes: every sum has one owner): three rows of K = 36
# slots a block with a ragged last block (NR = 70) and fewer rows than table
# rows; ten rows of K = 12 (NR = 53); the float32 pair type's 32-column path
# with bf16 node tables.  ell_inputs pads about a third of the slots and the
# whole last row, whose outputs must be exact zeros.  Float32: 1e-5 of the
# scale, as above.  bf16: the kernel's sums of the pair terms run in another
# order than the plain version's, and a term next to a rounding boundary can
# round to the neighbouring bf16 value -> 1e-3 of the scale.
@pytest.mark.parametrize("NR,N,K,sep,hs,pd,td,nd", [
    (70, 96, 36, (True, True), True, torch.bfloat16, torch.float32,
     torch.float32),
    (53, 64, 12, (True, False), False, torch.bfloat16, torch.bfloat16,
     torch.bfloat16),
    (20, 24, 36, (False, True), True, torch.float32, torch.float32,
     torch.bfloat16),
], ids=["k36-ragged", "k12-bf16-nodes", "f32"])
def test_message_source_on_host_block_shapes_rerun(host_ell, NR, N, K, sep,
                                                   hs, pd, td, nd):
    D, H, lmax = 32, 4, 2
    L = (lmax + 1) ** 2 - 1
    a = [torch.from_numpy(x) for x in ell_inputs(7, NR, N, K, D, H, lmax,
                                                 *sep, hs)]
    a[0] = a[0].to(td)
    for i in (1, 2, 3, 4):
        a[i] = a[i].to(nd)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep[0], sep_tensor=sep[1],
              pair_dtype=pd)
    want = fused_ell_forward_reference(*a, **kw, with_attn=True)
    runs = []
    for _ in range(2):
        got = (torch.full((NR, D), math.nan), torch.full((NR, L, D), math.nan),
               torch.full((NR, K, H), math.nan))
        fused_ell._call_kernel(host_ell, None, *a, *got, **kw)
        runs.append(got)
    tol = 1e-3 if pd == torch.bfloat16 else 1e-5
    for name, g1, g2, w in zip(("d_h", "dX", "sm"), *runs, want):
        _assert_close(g1.numpy(), w.numpy(), tol, name)
        assert g1.numpy().tobytes() == g2.numpy().tobytes(), name
        assert torch.all(g1[-1] == 0), name   # the wholly padded row
