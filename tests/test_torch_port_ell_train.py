"""ELL training: the port's backward against the JAX package's.

Both ELL backward plain versions are held against the Pallas kernels in
interpret mode (``_pallas_ell_backward`` and the VJP of
``make_fused_htr_ell``) for every output; ``FusedELL`` and ``FusedHTRELL``
against torch autograd through the plain forwards; both CUDA sources, built
for the host, against the plain versions (and against themselves: reruns
give the same bytes); and the port's ELL training step, from a converted
JAX init, against JAX's ``one_step`` on the fused ELL model.  Sizes are
small: D = 32, 2 layers, frames of 40-60 atoms.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gotennet_tpu.data.dataset import ELLLoader as JELLLoader
from gotennet_tpu.data.dataset import synthetic_molecules as j_synthetic
from gotennet_tpu.models.gotennet import GotenNetConfig as JConfig
from gotennet_tpu.models.model import GotenModel as JModel
from gotennet_tpu.ops.pallas.fused_ell import (_pallas_ell_backward,
                                               _pallas_ell_forward)
from gotennet_tpu.ops.pallas.fused_htr import make_fused_htr_ell
from gotennet_tpu.tasks.qm9 import QM9Task as JQM9Task
from gotennet_tpu.train import optim as joptim
from gotennet_tpu.train.trainer import make_loss_fn as j_make_loss_fn

from gotennet_tpu_torch.data.dataset import ELLLoader, synthetic_molecules
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import GotenModel, HeadConfig
from gotennet_tpu_torch.ops import fused_ell, fused_htr
from gotennet_tpu_torch.ops.fused_ell import (FusedELL, fused_ell_backward,
                                              fused_ell_backward_reference,
                                              fused_ell_forward_reference,
                                              source_slots)
from gotennet_tpu_torch.ops.fused_htr import (FusedHTRELL,
                                              fused_htr_ell_backward,
                                              fused_htr_ell_backward_reference,
                                              fused_htr_ell_forward_reference)
from gotennet_tpu_torch.tasks.qm9 import QM9Task
from gotennet_tpu_torch.train import optim
from gotennet_tpu_torch.train.trainer import (accum_grads, make_loss_fn,
                                              train_step, train_steps)
from gotennet_tpu_torch.utils.convert import state_dict_from_jax_params

from test_torch_port_backward import _graph_nodes
from test_torch_port_ell import ell_inputs, htr_ell_inputs
from test_torch_port_kernel import _assert_close, build_on_host

SMALL = dict(n_atom_basis=32, n_interactions=2, lmax=2, num_heads=4,
             n_rbf=8)
FRAMES = dict(min_atoms=40, max_atoms=60, box=6.3)
META = {"mean": 0.0, "std": 1.0}
MSG_NAMES = ("g_t", "g_q", "g_k", "g_xg", "g_v", "g_rl", "g_X", "g_env",
             "g_scale", "g_Wre", "g_bre", "g_Wrs", "g_brs")
HTR_NAMES = ("g_t", "g_EQ", "g_EK", "g_rl", "g_W_g", "g_b_g")
_LAUNCH = "kern<<<grid, kThreads, smem, stream>>>(args);"


def msg_cotangents(seed, NR, D, L):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((NR, D)).astype(np.float32),
            rng.standard_normal((NR, L, D)).astype(np.float32))


# ---- the message backward's plain version vs Pallas --------------------------
# f32: identical math, only the order of the sums differs -> 1e-5 of each
# output's scale.  bf16: both round at the same cast points, but XLA on the
# CPU fuses bf16 elementwise chains and keeps float32 intermediates where the
# port rounds every product, so single slot terms differ by a bf16 ulp
# (2^-8): 2e-2 of the scale.
@pytest.mark.parametrize("sep,K,NR,N,head_scale,dtype", [
    ((True, True), 12, 16, 16, False, "f32"),
    ((False, False), 36, 16, 24, True, "f32"),
    ((True, False), 12, 8, 16, True, "f32"),
    ((False, True), 36, 16, 16, False, "f32"),
    ((True, True), 36, 16, 24, True, "bf16"),
    ((True, True), 12, 16, 16, False, "bf16"),
])
def test_message_backward_matches_pallas_interpret(sep, K, NR, N, head_scale,
                                                   dtype):
    D, H, lmax = 32, 4, 2
    L = (lmax + 1) ** 2 - 1
    inputs = ell_inputs(0, NR, N, K, D, H, lmax, *sep, head_scale)
    g_dh, g_dX = msg_cotangents(1, NR, D, L)
    bf16 = dtype == "bf16"
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep[0], sep_tensor=sep[1])
    jpd = jnp.bfloat16 if bf16 else jnp.float32
    jin = [jnp.asarray(a) for a in inputs]
    _, _, j_sm = _pallas_ell_forward(*jin, **kw, interpret=True,
                                     pair_dtype=jpd)
    want = _pallas_ell_backward(*jin, j_sm, jnp.asarray(g_dh),
                                jnp.asarray(g_dX), **kw, interpret=True,
                                pair_dtype=jpd)
    args = [torch.from_numpy(a) for a in inputs]
    tkw = dict(kw, pair_dtype=torch.bfloat16 if bf16 else torch.float32)
    _, _, sm = fused_ell_forward_reference(*args, **tkw, with_attn=True)
    got = fused_ell_backward(*args, sm, torch.from_numpy(g_dh),
                             torch.from_numpy(g_dX), **tkw)
    for name, g, w in zip(MSG_NAMES, got, want):
        assert g.shape == w.shape, name
        _assert_close(g.numpy(), np.asarray(w), 2e-2 if bf16 else 1e-5, name)
    # padded slots (env -1) and the wholly padded last row: exact zeros
    pad = torch.from_numpy(inputs[7] < 0)
    g_t, g_q, _, _, _, g_rl, _, g_env, g_scale = got[:9]
    for a in (g_t, g_rl, g_env, g_scale):
        assert torch.all(a[pad] == 0)
    assert torch.all(g_q[-1] == 0)


# ---- the HTR backward's plain version vs Pallas ------------------------------
# float32: the JAX package's own tolerances for the HTR kernels
# (tests/test_fused_htr.py); bf16: 2e-2 of the scale, for the reason above.
@pytest.mark.parametrize("sep_htr,rej,gate,dtype,NR", [
    (True, True, "", "f32", 16), (False, True, "gated", "f32", 8),
    (True, True, "gatedt", "f32", 16), (False, True, "act", "f32", 8),
    (True, False, "", "f32", 16), (False, False, "gated", "f32", 16),
    (True, True, "", "bf16", 8), (False, False, "act", "bf16", 16),
])
def test_htr_backward_matches_pallas_vjp(sep_htr, rej, gate, dtype, NR):
    N, K, D, lmax = 24, 12, 32, 2
    inputs = htr_ell_inputs(1, NR, N, K, D, lmax)
    g = np.random.default_rng(2).standard_normal((NR, K, D)).astype(
        np.float32)
    bf16 = dtype == "bf16"
    fn = make_fused_htr_ell(lmax, sep_htr, rej, gate, interpret=True,
                            pair_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    jin = [jnp.asarray(a) for a in inputs]
    _, vjp = jax.vjp(fn, *jin)
    want = vjp(jnp.asarray(g))
    want = [w for i, w in enumerate(want) if i != 4]          # nbr: float0
    got = fused_htr_ell_backward(
        *[torch.from_numpy(a) for a in inputs], torch.from_numpy(g),
        lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
        pair_dtype=torch.bfloat16 if bf16 else torch.float32)
    for name, gr, w in zip(HTR_NAMES, got, want):
        gr, w = gr.numpy(), np.asarray(w, np.float32)
        assert gr.shape == w.shape, name
        if bf16:
            _assert_close(gr, w, 2e-2, name)
        else:
            np.testing.assert_allclose(gr, w, rtol=2e-4, atol=2e-4,
                                       err_msg=name)


# ---- the autograd Functions ----------------------------------------------------
@pytest.mark.parametrize("head_scale", [False, True])
def test_fused_ell_function_matches_autograd(head_scale):
    """FusedELL's analytic backward against torch.autograd through the
    plain forward, float32, every float input (rl, env and scale included):
    the same math, sums in another order -> 1e-5 of each gradient's
    scale."""
    NR, N, K, D, H, lmax = 12, 16, 12, 32, 4, 2
    L = (lmax + 1) ** 2 - 1
    kw = dict(lmax=lmax, num_heads=H, sep_dir=True, sep_tensor=False,
              pair_dtype=torch.float32)
    inputs = ell_inputs(3, NR, N, K, D, H, lmax, True, False, head_scale)
    g_dh, g_dX = (torch.from_numpy(c) for c in msg_cotangents(4, NR, D, L))
    grads = []
    for use_function in (True, False):
        args = [torch.from_numpy(a).requires_grad_(i != 9)
                for i, a in enumerate(inputs)]
        if use_function:
            d_h, dX = FusedELL.apply(*args, *kw.values(), None)
        else:
            d_h, dX, _ = fused_ell_forward_reference(*args, **kw)
        (torch.sum(d_h * g_dh) + torch.sum(dX * g_dX)).backward()
        grads.append([a.grad for i, a in enumerate(args) if i != 9])
    names = [n for i, n in enumerate(fused_ell.ARG_NAMES) if i != 9]
    for name, g, w in zip(names, *grads):
        _assert_close(g.numpy(), w.numpy(), 1e-5, name)


def test_fused_htr_ell_function_matches_autograd():
    NR, N, K, D, lmax = 12, 16, 12, 32, 2
    kw = dict(lmax=lmax, sep_htr=True, rej=True, gate="gated",
              pair_dtype=torch.float32)
    inputs = htr_ell_inputs(5, NR, N, K, D, lmax)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (NR, K, D)).astype(np.float32))
    grads = []
    for use_function in (True, False):
        args = [torch.from_numpy(a).requires_grad_(i != 4)
                for i, a in enumerate(inputs)]
        out = (FusedHTRELL.apply(*args, *kw.values(), None) if use_function
               else fused_htr_ell_forward_reference(*args, **kw))
        torch.sum(out * g).backward()
        grads.append([a.grad for i, a in enumerate(args) if i != 4])
    for name, gr, w in zip(HTR_NAMES, *grads):
        _assert_close(gr.numpy(), w.numpy(), 1e-5, name)


def test_functions_cast_and_skip_unasked_cotangents():
    """Cotangents come back in their inputs' types, only where asked."""
    inputs = [torch.from_numpy(a) for a in ell_inputs(
        0, 8, 8, 12, 32, 4, 2, True, True, False)]
    inputs[0] = inputs[0].to(torch.bfloat16).requires_grad_(True)
    inputs[2].requires_grad_(True)
    d_h, dX = fused_ell.fused_ell(*inputs, lmax=2, num_heads=4, sep_dir=True,
                                  sep_tensor=True, pair_dtype=torch.bfloat16)
    assert type(d_h.grad_fn).__name__ == "FusedELLBackward"
    (d_h.sum() + dX.sum()).backward()
    assert inputs[0].grad.dtype == torch.bfloat16
    assert inputs[2].grad.shape == (8, 32) and inputs[1].grad is None
    h_in = [torch.from_numpy(a) for a in htr_ell_inputs(0, 8, 8, 12, 32, 2)]
    h_in[2].requires_grad_(True)
    out = fused_htr.fused_htr_ell(*h_in, lmax=2, sep_htr=True, rej=True,
                                  gate="", slots=source_slots(h_in[4], 8))
    assert type(out.grad_fn).__name__ == "FusedHTRELLBackward"
    out.sum().backward()
    assert h_in[2].grad.shape == (8, 8, 32) and h_in[0].grad is None
    with torch.no_grad():
        assert fused_htr.fused_htr_ell(*h_in, lmax=2, sep_htr=True, rej=True,
                                       gate="").grad_fn is None


def test_source_slots_transpose_nbr():
    """Every slot once, grouped by the table row it reads, in slot order."""
    nbr = torch.from_numpy(np.random.default_rng(0).integers(
        0, 10, (6, 5)).astype(np.int32))
    starts, order = source_slots(nbr, 12)
    assert starts.dtype == order.dtype == torch.int32
    assert starts.tolist()[0] == 0 and starts.tolist()[-1] == 30
    flat = nbr.reshape(-1).tolist()
    for n in range(12):
        slots = order[starts[n]:starts[n + 1]].tolist()
        assert slots == [i for i, j in enumerate(flat) if j == n]


def test_source_slots_count_no_rows_with_bincount(monkeypatch):
    """The row starts come from the sorted rows: ``bincount`` sizes its
    output from the data, which on a card waits for the device in every
    forward."""
    def refuse(*a, **k):
        raise AssertionError("bincount")

    monkeypatch.setattr(torch, "bincount", refuse)
    nbr = torch.tensor([[3, 0, 3], [1, 1, 3]], dtype=torch.int32)
    starts, order = source_slots(nbr, 5)
    assert starts.tolist() == [0, 1, 3, 3, 6, 6]
    assert order.tolist() == [1, 3, 4, 0, 2, 5]


def test_ell_model_backward_goes_through_both_functions(monkeypatch):
    """The ELL model's loss differentiates through FusedELL and FusedHTRELL,
    whose backwards reach both backward wrappers once per layer with one
    slot list built for the batch."""
    seen = {"msg": [], "htr": []}
    for key, module, name in (("msg", fused_ell, "fused_ell_backward"),
                              ("htr", fused_htr, "fused_htr_ell_backward")):
        real = getattr(module, name)

        def counted(*a, _real=real, _key=key, **k):
            seen[_key].append(k["slots"])
            return _real(*a, **k)

        monkeypatch.setattr(module, name, counted)
    cfg = GotenNetConfig(**SMALL, fused_htr=True)
    model = GotenModel(cfg, HeadConfig(), layout="ell", device="cpu")
    batch = next(iter(ELLLoader(synthetic_molecules(2, seed=0, **FRAMES),
                                batch_size=2)))
    out = model(batch)["property"]
    names = _graph_nodes(out.grad_fn)
    assert "FusedELLBackward" in names and "FusedHTRELLBackward" in names
    out.sum().backward()
    assert len(seen["msg"]) == 2 and len(seen["htr"]) == 1
    assert all(s is seen["msg"][0] for s in seen["msg"] + seen["htr"])
    assert seen["msg"][0] is not None


# ---- both CUDA sources on the host -------------------------------------------
@pytest.fixture(scope="module")
def host_ell_bwd(tmp_path_factory):
    return build_on_host(tmp_path_factory.mktemp("ell_bwd_on_host"),
                         "fused_ell_bwd.cu", _LAUNCH)


@pytest.fixture(scope="module")
def host_htr_ell_bwd(tmp_path_factory):
    return build_on_host(tmp_path_factory.mktemp("htr_ell_bwd_on_host"),
                         "fused_htr_ell_bwd.cu", _LAUNCH)


def _nan_outputs(outs):
    for o in outs:
        o.fill_(math.nan)
    return outs


# The host builds round at the same points as the plain versions and use no
# atomics (every sum has one owner and a fixed order), so only the order of
# the float32 sums differs -> 1e-5 of each output's scale; with a bf16 pair
# type such an order can move a rounded value by one bf16 ulp -> 1e-2.
@pytest.mark.parametrize("NR,N,K,sep,hs,pd,td,nd", [
    (24, 32, 12, (True, True), False, torch.float32, torch.float32,
     torch.float32),
    (16, 16, 36, (False, True), True, torch.float32, torch.float32,
     torch.bfloat16),
    (20, 24, 12, (True, False), True, torch.bfloat16, torch.bfloat16,
     torch.float32),
])
def test_message_backward_source_on_host_matches_plain(
        host_ell_bwd, NR, N, K, sep, hs, pd, td, nd):
    D, H, lmax = 32, 4, 2
    L = (lmax + 1) ** 2 - 1
    a = [torch.from_numpy(x) for x in ell_inputs(2, NR, N, K, D, H, lmax,
                                                 *sep, hs)]
    a[0] = a[0].to(td)
    for i in (1, 2, 3, 4):
        a[i] = a[i].to(nd)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep[0], sep_tensor=sep[1],
              pair_dtype=pd)
    _, _, sm = fused_ell_forward_reference(*a, **kw, with_attn=True)
    g_dh, g_dX = (torch.from_numpy(c) for c in msg_cotangents(3, NR, D, L))
    want = fused_ell_backward_reference(*a, sm, g_dh, g_dX, **kw)
    runs = []
    for _ in range(2):
        outs = _nan_outputs(fused_ell.backward_outputs(
            a[0], a[2], a[8], a[12].shape[1], L))
        fused_ell._call_backward(host_ell_bwd, None, *a, sm, g_dh, g_dX,
                                 source_slots(a[9], N), outs, **kw)
        runs.append(outs)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-5
    for name, got, again, w in zip(MSG_NAMES, *runs, want):
        _assert_close(got.numpy(), w.numpy(), tol, name)
        assert got.numpy().tobytes() == again.numpy().tobytes(), name


@pytest.mark.parametrize("NR,N,K,gate,sep_htr,pd,td", [
    (24, 32, 12, "", True, torch.float32, torch.float32),
    (16, 16, 36, "gated", False, torch.bfloat16, torch.float32),
    (40, 48, 12, "act", True, torch.bfloat16, torch.bfloat16),
])
def test_htr_backward_source_on_host_matches_plain(
        host_htr_ell_bwd, NR, N, K, gate, sep_htr, pd, td):
    D, lmax = 32, 2
    a = [torch.from_numpy(x) for x in htr_ell_inputs(4, NR, N, K, D, lmax)]
    a[0] = a[0].to(td)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (NR, K, D)).astype(np.float32))
    kw = dict(lmax=lmax, sep_htr=sep_htr, rej=True, gate=gate, pair_dtype=pd)
    want = fused_htr_ell_backward_reference(*a, g, **kw)
    runs = []
    for _ in range(2):
        outs = _nan_outputs(fused_htr.ell_backward_outputs(a[0], a[2]))
        fused_htr._call_ell_backward(host_htr_ell_bwd, None, *a, g,
                                     source_slots(a[4], N), outs, **kw)
        runs.append(outs)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-5
    for name, got, again, w in zip(HTR_NAMES, *runs, want):
        _assert_close(got.numpy(), w.numpy(), tol, name)
        assert got.numpy().tobytes() == again.numpy().tobytes(), name


# ---- the training step against JAX's one_step --------------------------------
N_FRAMES, LR, N_STEPS = 2, 1e-4, 3
LOADER = dict(batch_size=1, spatial_sort=True, block_rows=16)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, once: initial params, the first step's gradients, and
    the losses and params of N_STEPS steps of bench.py's one_step on the
    fused ELL model, one frame per chunk with gather windows."""
    jtask = JQM9Task("U0", dataset_meta=META)
    jchunks = list(JELLLoader(j_synthetic(N_FRAMES, seed=7, **FRAMES),
                              neighbor_probe="full", **LOADER))
    jmodel = JModel(JConfig(**SMALL, fused=True, fused_htr=True),
                    jtask.build_head(), layout="ell")
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
    return dict(params=params, windows=[c.gather_window for c in jchunks],
                first_grads=first, losses=losses, final=jp)


@pytest.fixture
def port(jax_run):
    """(ELL model with the JAX init, its chunks, cfg, head, loss_fn)."""
    cfg = GotenNetConfig(**SMALL, fused_htr=True)
    head = QM9Task("U0", dataset_meta=META).build_head()
    model = GotenModel(cfg, head, layout="ell", device="cpu")
    model.load_state_dict(state_dict_from_jax_params(jax_run["params"], cfg,
                                                     head))
    chunks = list(ELLLoader(synthetic_molecules(N_FRAMES, seed=7, **FRAMES),
                            **LOADER))
    assert [c.gather_window for c in chunks] == jax_run["windows"]
    assert all(w is not None for w in jax_run["windows"])
    return model, chunks, cfg, head, make_loss_fn(model, QM9Task("U0", META))


def test_ell_first_step_gradients_match_jax(jax_run, port):
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


def test_ell_three_steps_match_jax(jax_run, port):
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


def test_ell_train_steps_entry_point_on_cpu():
    mols = synthetic_molecules(2, seed=8, **FRAMES).graph_dicts(range(2))
    cfg = GotenNetConfig(**SMALL, fused_htr=True)
    head = QM9Task("U0", dataset_meta=META).build_head()
    losses = train_steps(cfg, head, mols, 3, chunk=1, device="cpu",
                         layout="ell")
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


# ---- attention dropout on ELL --------------------------------------------------
def test_ell_attention_dropout_in_training_raises():
    """The ELL layer does not drop attention silently, and no longer raises
    on it (item 1 is ported): in training with attn_dropout > 0 it draws a
    keep mask from the model's generator, with autograd on or off (the same
    answer from the same generator state); in eval it draws none and
    answers as before."""
    cfg = GotenNetConfig(**SMALL, fused_htr=True, attn_dropout=0.1)
    model = GotenModel(cfg, HeadConfig(), layout="ell", device="cpu")
    batch = next(iter(ELLLoader(synthetic_molecules(2, seed=0, **FRAMES),
                                batch_size=2)))
    with torch.no_grad():
        want = model(batch)["property"]
    model.train()
    state = model.dropout_generator.get_state()
    got = model(batch)["property"]
    model.dropout_generator.set_state(state)
    with torch.no_grad():
        again = model(batch)["property"]
    assert torch.isfinite(got).all() and not torch.equal(got, want)
    assert torch.equal(got, again)
    model.eval()
    state = model.dropout_generator.get_state()
    with torch.no_grad():
        assert torch.equal(model(batch)["property"], want)
    assert torch.equal(model.dropout_generator.get_state(), state)


# The HTR backward's row pass on the ELL layout (bf16 pair type: as many rows
# of K slots a block as fill its 128-row tile), each case held against the
# plain version and run twice (the same bytes): three rows of K = 36 a
# block with a ragged last block, ten rows of K = 12, separate and joined
# degree blocks, with and without the rejection terms, every gate, float32
# and bf16 node tables; and the float32 pair type's four passes.  Table row
# N - 1 is read by no slot, so its g_EK must be exact zeros.  Tolerances as
# above.
@pytest.mark.parametrize("NR,N,K,gate,sep_htr,rej,pd,td,nd", [
    (38, 48, 36, "gatedt", True, True, torch.bfloat16, torch.float32,
     torch.float32),
    (25, 40, 12, "", False, False, torch.bfloat16, torch.bfloat16,
     torch.bfloat16),
    (24, 32, 12, "act", True, True, torch.bfloat16, torch.float32,
     torch.bfloat16),
    (30, 36, 36, "gated", False, True, torch.bfloat16, torch.float32,
     torch.float32),
    (16, 24, 12, "gated", True, True, torch.float32, torch.float32,
     torch.float32),
], ids=["k36-ragged", "k12-norej", "k12-act", "k36-joined", "f32"])
def test_htr_backward_source_on_host_row_pass_rerun(
        host_htr_ell_bwd, NR, N, K, gate, sep_htr, rej, pd, td, nd):
    D, lmax = 32, 2
    a = [torch.from_numpy(x) for x in htr_ell_inputs(6, NR, N, K, D, lmax)]
    a[0] = a[0].to(td)
    a[1], a[2] = a[1].to(nd), a[2].to(nd)
    a[4] = torch.where(a[4] == N - 1, torch.zeros_like(a[4]), a[4])
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (NR, K, D)).astype(np.float32))
    kw = dict(lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate, pair_dtype=pd)
    want = fused_htr_ell_backward_reference(*a, g, **kw)
    runs = []
    for _ in range(2):
        outs = _nan_outputs(fused_htr.ell_backward_outputs(a[0], a[2]))
        fused_htr._call_ell_backward(host_htr_ell_bwd, None, *a, g,
                                     source_slots(a[4], N), outs, **kw)
        runs.append(outs)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-5
    for name, got, again, w in zip(HTR_NAMES, *runs, want):
        _assert_close(got.numpy(), w.numpy(), tol, name)
        assert got.numpy().tobytes() == again.numpy().tobytes(), name
    assert torch.all(runs[0][2][N - 1] == 0)   # g_EK of the unread row
