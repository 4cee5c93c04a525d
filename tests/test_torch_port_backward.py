"""The port's fused-GATA backward against the JAX package's Pallas VJP.

``fused_gata_backward_reference`` (the plain PyTorch version the CUDA
backward is held against on the card) is compared with the VJP of
``make_fused_gata(..., interpret=True, pos_grads=False)`` on the same
numpy inputs and cotangents; ``FusedGATA`` with autograd through the
plain forward; the CUDA source, built for the host, with the plain
version; and the dense model's message is shown to go through
``FusedGATA`` and its backward.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.ops.pallas.fused_gata import make_fused_gata

from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.gotennet_dense import GATADense
from gotennet_tpu_torch.models.model import init_parameters_
from gotennet_tpu_torch.ops import fused_gata
from gotennet_tpu_torch.ops.fused_gata import (FusedGATA,
                                               fused_gata_backward_reference,
                                               fused_gata_forward_reference)

from test_torch_port_kernel import (_assert_close, build_on_host,
                                    kernel_inputs, near_neighbours)

NAMES = fused_gata.ARG_NAMES
# the one kernel-launch line of csrc/fused_gata_bwd.cu
_LAUNCH = "kern<<<grid, kThreads, smem, stream>>>(args);"


def cotangents(seed, G, M, D, lmax):
    rng = np.random.default_rng(seed)
    L = (lmax + 1) ** 2 - 1
    return (rng.standard_normal((G, M, D)).astype(np.float32),
            rng.standard_normal((G, M, L, D)).astype(np.float32))


# f32: the JAX package's own backward tolerance (tests/test_fused_gata.py).
# bf16: both round at the same cast points, but XLA on the CPU fuses bf16
# elementwise chains and rounds once where the port rounds every product,
# so single pair terms differ by a bf16 ulp (2^-8): 2e-2 of each output's
# scale.
@pytest.mark.parametrize("sep,M,head_scale,dtype", [
    ((True, True), 8, False, "f32"),
    ((False, False), 16, True, "f32"),
    ((True, False), 8, True, "bf16"),
    ((False, True), 16, False, "bf16"),
])
def test_plain_backward_matches_pallas_vjp(sep, M, head_scale, dtype):
    sep_dir, sep_tensor = sep
    G, D, H, lmax = 2, 32, 4, 2
    inputs = kernel_inputs(0, G, M, D, H, lmax, sep_dir, sep_tensor,
                           head_scale)
    g_dh, g_dX = cotangents(5, G, M, D, lmax)
    jpd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tpd = torch.bfloat16 if dtype == "bf16" else torch.float32
    fused = make_fused_gata(lmax, H, sep_dir, sep_tensor, interpret=True,
                            pair_dtype=jpd, pos_grads=False)
    _, vjp = jax.vjp(fused, *[jnp.asarray(a) for a in inputs])
    want = vjp((jnp.asarray(g_dh), jnp.asarray(g_dX)))

    args = [torch.from_numpy(a) for a in inputs]
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep_dir,
              sep_tensor=sep_tensor, pair_dtype=tpd)
    _, _, sm = fused_gata_forward_reference(*args, **kw, with_attn=True)
    got = fused_gata_backward_reference(*args, sm, torch.from_numpy(g_dh),
                                        torch.from_numpy(g_dX), **kw)
    for name, g, w in zip(NAMES, got, want):
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=5e-4,
                                       err_msg=name)
        else:
            _assert_close(g, w, 2e-2, name)
    # padded atoms of graph 0: exact zeros on their rows and columns
    g_t, g_q, g_k, g_xg, g_v, _, g_X, _, g_scale = got[:9]
    for a in (g_t, g_q, g_k, g_xg, g_v, g_X, g_scale):
        assert torch.all(a[0, M - 3:] == 0)
    for a in (g_t, g_scale):
        assert torch.all(a[0, :, M - 3:] == 0)


@pytest.mark.parametrize("head_scale", [False, True])
def test_fused_gata_function_matches_autograd(head_scale):
    """FusedGATA's analytic backward against torch.autograd through the
    plain forward, float32: the same math, sums in another order -> 1e-5
    of each gradient's scale."""
    G, M, D, H, lmax = 2, 8, 32, 4, 2
    kw = dict(lmax=lmax, num_heads=H, sep_dir=True, sep_tensor=False,
              pair_dtype=torch.float32)
    inputs = kernel_inputs(3, G, M, D, H, lmax, True, False, head_scale)
    g_dh, g_dX = (torch.from_numpy(c) for c in cotangents(4, G, M, D, lmax))
    grads = []
    for use_function in (True, False):
        args = [torch.from_numpy(a).requires_grad_(i not in (5, 7))
                for i, a in enumerate(inputs)]
        if use_function:
            d_h, dX = FusedGATA.apply(*args, *kw.values())
        else:
            d_h, dX, _ = fused_gata_forward_reference(*args, **kw)
        (torch.sum(d_h * g_dh) + torch.sum(dX * g_dX)).backward()
        grads.append([a.grad for i, a in enumerate(args) if i not in (5, 7)])
    for name, g, w in zip([n for i, n in enumerate(NAMES) if i not in (5, 7)],
                          *grads):
        _assert_close(g.numpy(), w.numpy(), 1e-5, name)


def test_fused_gata_function_casts_and_refuses_position_gradients():
    """Cotangents come back in their inputs' types; built with
    pos_grads=False the step refuses a position gradient (the JAX package
    would return zeros), and pos_grads=True is a valid configuration."""
    G, M, D, H, lmax = 1, 8, 32, 4, 1
    inputs = [torch.from_numpy(a) for a in
              kernel_inputs(0, G, M, D, H, lmax, True, True)]
    for i in (1, 2, 3, 4):
        inputs[i] = inputs[i].to(torch.bfloat16)
    kw = (lmax, H, True, True, torch.bfloat16)
    args = [a.clone().requires_grad_(i not in (5, 7))
            for i, a in enumerate(inputs)]
    d_h, dX = FusedGATA.apply(*args, *kw, False)
    (d_h.sum() + dX.sum()).backward()
    assert args[1].grad.dtype == torch.bfloat16
    assert args[0].grad.dtype == torch.float32
    args = [a.clone().requires_grad_(True) for a in inputs]
    d_h, dX = FusedGATA.apply(*args, *kw, False)
    with pytest.raises(ValueError, match="pos_grads=False"):
        (d_h.sum() + dX.sum()).backward()
    assert GotenNetConfig(n_atom_basis=32, num_heads=4, pos_grads=True)


def _graph_nodes(root):
    """Names of every autograd node reachable from ``root``."""
    seen, stack, names = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return names


def test_gata_message_goes_through_the_backward(monkeypatch):
    """The dense model's message is a FusedGATA node whose backward
    reaches fused_gata_backward (on the card, the backward kernel); with
    grad off it keeps no softmax."""
    cfg = GotenNetConfig(n_atom_basis=32, n_interactions=2, lmax=2,
                         num_heads=4, n_rbf=8)
    layer = GATADense(cfg)
    init_parameters_(layer, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    G, M, D, L = 2, 8, 32, 8

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    pair_mask = torch.from_numpy(rng.random((G, M, M)) > 0.3)
    inputs = (rand(G, M, D), rand(G, M, L, D), rand(G, M, M, D),
              rand(G, M, M, L), torch.from_numpy(
                  rng.random((G, M, M)).astype(np.float32) * 4),
              pair_mask, torch.ones(G, M, M))
    calls = {"bwd": 0, "fwd_attn": []}
    bwd, fwd = fused_gata.fused_gata_backward, fused_gata.fused_gata_forward

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    def count_fwd(*a, **k):
        calls["fwd_attn"].append(k.get("with_attn", False))
        return fwd(*a, **k)

    monkeypatch.setattr(fused_gata, "fused_gata_backward", count_bwd)
    monkeypatch.setattr(fused_gata, "fused_gata_forward", count_fwd)
    h, X, _ = layer(*inputs)
    assert "FusedGATABackward" in _graph_nodes(h.grad_fn)
    (h.sum() + X.sum()).backward()
    assert calls["bwd"] == 1
    assert layer.W_rs.weight.grad is not None
    assert float(layer.W_re.weight.grad.abs().sum()) > 0
    with torch.inference_mode():
        h, _, _ = layer(*inputs)
    assert h.grad_fn is None and calls["fwd_attn"] == [True, False]


# The CUDA source on the host: the same rounding points as the plain
# version and no atomics (every sum has one owner and a fixed order), so
# only the order of the float32 sums differs -> 1e-5 of each output's
# scale.  With a bf16 pair type such an order can move a rounded value by
# one bf16 ulp -> 1e-2.
@pytest.fixture(scope="module")
def host_bwd(tmp_path_factory):
    return build_on_host(tmp_path_factory.mktemp("cuda_bwd_on_host"),
                         "fused_gata_bwd.cu", _LAUNCH)


@pytest.mark.parametrize("case", [
    dict(G=2, M=8, D=32, H=4, lmax=2, sep=(True, True), hs=False,
         pd=torch.float32, t=torch.float32, node=torch.float32),
    dict(G=2, M=8, D=32, H=4, lmax=2, sep=(False, False), hs=True,
         pd=torch.float32, t=torch.float32, node=torch.bfloat16),
    dict(G=1, M=16, D=32, H=8, lmax=2, sep=(True, False), hs=True,
         pd=torch.bfloat16, t=torch.bfloat16, node=torch.bfloat16),
    # two 128-thread columns a block, 32 threads of each without a channel,
    # a last tile of one column, most pairs invalid
    dict(G=2, M=11, D=96, H=4, lmax=1, sep=(True, True), hs=False,
         pd=torch.bfloat16, t=torch.float32, node=torch.bfloat16, reach=1),
    # two channels of D a thread
    dict(G=1, M=5, D=320, H=4, lmax=1, sep=(False, False), hs=True,
         pd=torch.float32, t=torch.float32, node=torch.float32),
])
def test_cuda_backward_on_host_matches_plain(host_bwd, case):
    G, M, D, H, lmax = (case[k] for k in ("G", "M", "D", "H", "lmax"))
    sep_dir, sep_tensor = case["sep"]
    a = [torch.from_numpy(x) for x in kernel_inputs(
        1, G, M, D, H, lmax, sep_dir, sep_tensor, case["hs"])]
    if "reach" in case:
        a[7] = near_neighbours(a[7], case["reach"])
    a[0] = a[0].to(case["t"])
    for i in (1, 2, 3, 4):
        a[i] = a[i].to(case["node"])
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep_dir,
              sep_tensor=sep_tensor, pair_dtype=case["pd"])
    _, _, sm = fused_gata_forward_reference(*a, **kw, with_attn=True)
    g_dh, g_dX = (torch.from_numpy(c) for c in cotangents(2, G, M, D, lmax))
    want = fused_gata_backward_reference(*a, sm, g_dh, g_dX, **kw)
    L = (lmax + 1) ** 2 - 1
    outs = fused_gata.backward_outputs(a[0], a[8], a[11].shape[1], L)
    for o in outs:
        if o is not None:
            o.fill_(math.nan)
    fused_gata._call_backward(host_bwd, None, *a, sm, g_dh, g_dX, outs, **kw)
    tol = 1e-2 if case["pd"] == torch.bfloat16 else 1e-5
    assert outs[5] is None and outs[7] is None
    for name, got, w in zip(NAMES, outs, want):
        if got is not None:
            _assert_close(got.numpy(), w.numpy(), tol, name)
    # graph 0's padded atoms: exact zeros in the j-indexed cotangents
    for o in (outs[3], outs[4], outs[6]):
        assert torch.all(o[0, M - 3:] == 0)
