"""The port's fused HTR edge update against the JAX package's Pallas kernel.

``fused_htr_forward_reference`` and ``fused_htr_backward_reference`` (the
plain PyTorch versions the CUDA kernels are held against on the card) are
compared with ``make_fused_htr(..., interpret=True)`` and its VJP on the same
numpy inputs; ``FusedHTR`` with autograd through the plain forward; and both
CUDA sources, built for the host, with the plain versions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.ops.pallas.fused_htr import make_fused_htr

from gotennet_tpu_torch.ops import fused_htr
from gotennet_tpu_torch.ops.fused_htr import (FusedHTR, fused_htr_backward,
                                              fused_htr_backward_reference,
                                              fused_htr_forward,
                                              fused_htr_forward_reference)

from test_torch_port_kernel import _assert_close, build_on_host

NAMES = ("t", "EQ", "EK", "rl", "W_g", "b_g")
# the one kernel-launch line of each source (both in its run())
_FWD_LAUNCH = "kern<<<grid, kThreads, smem, stream>>>(args);"
_BWD_LAUNCH = "kern<<<grid, kThreads, smem, stream>>>(args);"

FLAGSHIP = dict(sep_htr=True, rej=True, gate="")


def htr_inputs(seed, G, M, D, lmax):
    """numpy inputs (t, EQ, EK, rl, W_g, b_g) and a cotangent of ``out``
    that is zero on the rows and columns of graph 0's last 3 atoms, as the
    message's backward leaves it on padded atoms."""
    rng = np.random.default_rng(seed)
    L = (lmax + 1) ** 2 - 1

    def rand(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.4

    inputs = [rand(G, M, M, D), rand(G, M, L, D), rand(G, M, L, D),
              rand(G, M, M, L), rand(D, D), rand(D)]
    g = rng.standard_normal((G, M, M, D)).astype(np.float32)
    g[0, M - 3:] = 0.0
    g[0, :, M - 3:] = 0.0
    return inputs, g


def assert_padded_zeros(grads, M):
    """Where the cotangent is zero, every cotangent it feeds is an exact
    zero: g_t and g_rl on the padded pairs, g_EQ and g_EK on the padded
    atoms."""
    g_t, g_EQ, g_EK, g_rl = grads[:4]
    for a in (g_t, g_rl):
        assert torch.all(a[0, M - 3:] == 0) and torch.all(a[0, :, M - 3:] == 0)
    for a in (g_EQ, g_EK):
        assert torch.all(a[0, M - 3:] == 0)


def _torch_args(inputs, t_dtype=torch.float32, node_dtype=torch.float32):
    a = [torch.from_numpy(x) for x in inputs]
    a[0] = a[0].to(t_dtype)
    a[1], a[2] = a[1].to(node_dtype), a[2].to(node_dtype)
    return a


# float32: the JAX package's own tolerances for this kernel
# (tests/test_fused_htr.py).  bf16: both round at the same cast points, but
# XLA on the CPU fuses the bf16 S/pq/pk chains and keeps float32
# intermediates where the port rounds every product and partial sum, so a
# pair term can differ by a few bf16 ulps (2^-8 each): 2e-2 of each output's
# scale.
@pytest.mark.parametrize("variant,M,dtype", [
    (FLAGSHIP, 8, "f32"),
    (dict(sep_htr=False, rej=True, gate="gated"), 8, "f32"),
    (dict(sep_htr=True, rej=False, gate="gatedt"), 8, "f32"),
    (dict(sep_htr=False, rej=False, gate="act"), 8, "f32"),
    (FLAGSHIP, 72, "f32"),      # JAX's i-tiled grid: fwd TI=36, bwd TI=24
    (FLAGSHIP, 8, "bf16"),
    (dict(sep_htr=True, rej=True, gate="gated"), 72, "bf16"),
])
def test_plain_versions_match_pallas_interpret(variant, M, dtype):
    G, D, lmax = 2, 32, 2
    inputs, g = htr_inputs(0, G, M, D, lmax)
    bf16 = dtype == "bf16"
    jpd = jnp.bfloat16 if bf16 else jnp.float32
    tpd = torch.bfloat16 if bf16 else torch.float32
    jargs = [jnp.asarray(a) for a in inputs]
    if bf16:    # EQ, EK arrive in the node type
        jargs[1], jargs[2] = jargs[1].astype(jnp.bfloat16), \
            jargs[2].astype(jnp.bfloat16)
    fused = make_fused_htr(lmax, variant["sep_htr"], variant["rej"],
                           variant["gate"], interpret=True, pair_dtype=jpd)
    j_out, vjp = jax.vjp(fused, *jargs)
    j_grads = vjp(jnp.asarray(g))

    args = _torch_args(inputs, node_dtype=tpd)
    kw = dict(lmax=lmax, pair_dtype=tpd, **variant)
    out = fused_htr_forward(*args, **kw)
    grads = fused_htr_backward(*args, torch.from_numpy(g), **kw)
    want = [np.asarray(j_out, np.float32)] + [np.asarray(x, np.float32)
                                              for x in j_grads]
    for name, got, w in zip(("out",) + NAMES, (out,) + grads, want):
        got = got.numpy()
        assert got.shape == w.shape, name
        if bf16:
            _assert_close(got, w, 2e-2, name)
        elif name == "out":
            np.testing.assert_allclose(got, w, rtol=2e-4, atol=2e-4)
        else:
            np.testing.assert_allclose(got, w, rtol=2e-3, atol=5e-4,
                                       err_msg=name)
    assert_padded_zeros(grads, M)


@pytest.mark.parametrize("variant", [
    FLAGSHIP, dict(sep_htr=False, rej=True, gate="gatedt"),
    dict(sep_htr=True, rej=False, gate="act")])
def test_fused_htr_function_matches_autograd(variant):
    """FusedHTR's analytic backward against torch.autograd through the plain
    forward, float32: the same math, sums in another order -> 1e-5 of each
    gradient's scale."""
    G, M, D, lmax = 2, 8, 32, 2
    inputs, g = htr_inputs(3, G, M, D, lmax)
    g = torch.from_numpy(g)
    kw = dict(lmax=lmax, pair_dtype=torch.float32, **variant)
    grads = []
    for use_function in (True, False):
        args = [a.requires_grad_(True) for a in _torch_args(inputs)]
        if use_function:
            out = FusedHTR.apply(*args, lmax, variant["sep_htr"],
                                 variant["rej"], variant["gate"],
                                 torch.float32)
        else:
            out = fused_htr_forward_reference(*args, **kw)
        torch.sum(out * g).backward()
        grads.append([a.grad for a in args])
    for name, got, want in zip(NAMES, *grads):
        if want is None:    # rl does not reach out without rejection
            assert name == "rl" and torch.all(got == 0)
            continue
        _assert_close(got.numpy(), want.numpy(), 1e-5, name)


def test_fused_htr_dispatch_and_casts():
    """Without a gradient the forward runs alone; with one, through
    FusedHTR, whose cotangents come back in the inputs' types; unknown
    devices raise."""
    G, M, D, lmax = 1, 8, 32, 1
    inputs, _ = htr_inputs(1, G, M, D, lmax)
    kw = dict(lmax=lmax, sep_htr=True, rej=True, gate="",
              pair_dtype=torch.bfloat16)
    args = _torch_args(inputs, torch.bfloat16, torch.bfloat16)
    out = fused_htr.fused_htr(*args, **kw)
    assert out.grad_fn is None and out.dtype == torch.float32
    args = [a.requires_grad_(True) for a in args]
    out = fused_htr.fused_htr(*args, **kw)
    assert type(out.grad_fn).__name__ == "FusedHTRBackward"
    out.sum().backward()
    assert [a.grad.dtype for a in args] == [a.dtype for a in args]
    assert args[1].grad.dtype == torch.bfloat16
    meta = [a.detach().to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        fused_htr_forward(*meta, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        fused_htr_backward(*meta, torch.zeros(meta[0].shape, device="meta"),
                           **kw)


# ---------------------------------------------------------------------------
# Both CUDA sources on the host: the same rounding points as the plain
# versions and no atomics, so only the order of the float32 sums differs ->
# 1e-5 of each output's scale.  In the backward with a bf16 pair type such an
# order can move a value that is rounded afterwards (g_z before g_z W_g^T) by
# one bf16 ulp -> 1e-2.
HOST_CASES = [
    dict(G=2, M=8, D=32, lmax=2, v=FLAGSHIP, pd=torch.float32,
         t=torch.float32, node=torch.float32),
    dict(G=1, M=16, D=64, lmax=3, v=dict(sep_htr=False, rej=True,
                                         gate="gated"),
         pd=torch.bfloat16, t=torch.bfloat16, node=torch.bfloat16),
    dict(G=2, M=8, D=32, lmax=1, v=dict(sep_htr=True, rej=False, gate="act"),
         pd=torch.float32, t=torch.float32, node=torch.bfloat16),
    dict(G=1, M=12, D=32, lmax=2, v=dict(sep_htr=True, rej=True,
                                         gate="gatedt"),
         pd=torch.bfloat16, t=torch.float32, node=torch.float32),
    # the MD22 chunk's shape, narrow: M = 120, bf16 pairs and nodes
    dict(G=1, M=120, D=32, lmax=2, v=FLAGSHIP, pd=torch.bfloat16,
         t=torch.float32, node=torch.bfloat16),
]


def _host_case(case):
    inputs, g = htr_inputs(7, case["G"], case["M"], case["D"], case["lmax"])
    args = _torch_args(inputs, case["t"], case["node"])
    kw = dict(lmax=case["lmax"], pair_dtype=case["pd"], **case["v"])
    return args, torch.from_numpy(g), kw


@pytest.fixture(scope="module")
def host_fwd(tmp_path_factory):
    return build_on_host(tmp_path_factory.mktemp("htr_fwd_on_host"),
                         "fused_htr_fwd.cu", _FWD_LAUNCH)


@pytest.fixture(scope="module")
def host_bwd(tmp_path_factory):
    return build_on_host(tmp_path_factory.mktemp("htr_bwd_on_host"),
                         "fused_htr_bwd.cu", _BWD_LAUNCH)


@pytest.mark.parametrize("case", HOST_CASES)
def test_cuda_forward_on_host_matches_plain(host_fwd, case):
    args, _, kw = _host_case(case)
    want = fused_htr_forward_reference(*args, **kw)
    out = torch.full(args[0].shape, math.nan)
    fused_htr._call_kernel(host_fwd, None, *args, out, **kw)
    # every pair, padded ones included: the update masks none
    _assert_close(out.numpy(), want.numpy(), 1e-5, "out")


# The forward's block shapes, each held against the plain version and run
# twice (the same bytes: a block owns its pairs' outputs): the row path
# (bf16 pair type, lmax <= 2) at M = 120 (a 128-pair block spans two EQ
# rows) and M = 13 (a warp's last round finds fewer pairs), rows longer than
# a block (M = 136), float32 and bf16 t and node tables, sep_htr on and off,
# no rejection terms, all four gates, lmax 1 and 2; the slice path with a
# float32 pair type and at lmax 3.  1e-5 of the scale, as above.
@pytest.mark.parametrize("case", [
    dict(G=2, M=120, D=32, lmax=2, v=FLAGSHIP, pd=torch.bfloat16,
         t=torch.float32, node=torch.bfloat16),
    dict(G=2, M=13, D=32, lmax=2, v=dict(sep_htr=False, rej=True,
                                         gate="gated"),
         pd=torch.bfloat16, t=torch.bfloat16, node=torch.float32),
    dict(G=2, M=13, D=64, lmax=1, v=dict(sep_htr=True, rej=False,
                                         gate="gatedt"),
         pd=torch.bfloat16, t=torch.float32, node=torch.bfloat16),
    dict(G=1, M=120, D=32, lmax=2, v=dict(sep_htr=True, rej=False,
                                          gate="act"),
         pd=torch.bfloat16, t=torch.bfloat16, node=torch.float32),
    dict(G=1, M=136, D=32, lmax=1, v=FLAGSHIP, pd=torch.bfloat16,
         t=torch.float32, node=torch.float32),
    dict(G=2, M=10, D=32, lmax=2, v=FLAGSHIP, pd=torch.float32,
         t=torch.float32, node=torch.bfloat16),
    dict(G=1, M=16, D=32, lmax=3, v=dict(sep_htr=True, rej=True,
                                         gate="gated"),
         pd=torch.bfloat16, t=torch.float32, node=torch.bfloat16),
], ids=["md22-row", "ragged-round", "lmax1-norej", "act-f32-nodes",
        "long-row", "f32", "lmax3"])
def test_cuda_forward_on_host_block_shapes_rerun(host_fwd, case):
    args, _, kw = _host_case(case)
    want = fused_htr_forward_reference(*args, **kw)
    runs = []
    for _ in range(2):
        out = torch.full(args[0].shape, math.nan)
        fused_htr._call_kernel(host_fwd, None, *args, out, **kw)
        runs.append(out)
    _assert_close(runs[0].numpy(), want.numpy(), 1e-5, "out")
    assert runs[0].numpy().tobytes() == runs[1].numpy().tobytes()


@pytest.mark.parametrize("case", HOST_CASES)
def test_cuda_backward_on_host_matches_plain(host_bwd, case):
    args, g, kw = _host_case(case)
    want = fused_htr_backward_reference(*args, g, **kw)
    L = args[3].shape[-1]
    outs = fused_htr.backward_outputs(args[0], L)
    for o in outs:
        o.fill_(math.nan)
    fused_htr._call_backward(host_bwd, None, *args, g, outs, **kw)
    tol = 1e-2 if case["pd"] == torch.bfloat16 else 1e-5
    for name, got, w in zip(NAMES, outs, want):
        _assert_close(got.numpy(), w.numpy(), tol, name)
    assert_padded_zeros(outs, case["M"])


# The backward's block shapes, each held against the plain version and run
# twice (the same bytes: every sum has one owner): the row pass with one
# 120-pair row a block, with a last round of warps that finds fewer pairs
# than warps, with a float32 t (it writes t's bf16 copy itself), and at
# lmax 1 without the rejection terms; rows longer than its 128-pair tile
# and the float32 pair type take the passes the ELL backward shares.
@pytest.mark.parametrize("case", [
    dict(G=1, M=120, D=32, lmax=2, v=FLAGSHIP, pd=torch.bfloat16,
         t=torch.bfloat16, node=torch.bfloat16),
    dict(G=2, M=13, D=64, lmax=2, v=dict(sep_htr=True, rej=True,
                                         gate="gated"),
         pd=torch.bfloat16, t=torch.float32, node=torch.float32),
    dict(G=1, M=136, D=32, lmax=1, v=FLAGSHIP, pd=torch.bfloat16,
         t=torch.float32, node=torch.bfloat16),
    dict(G=2, M=10, D=32, lmax=2, v=FLAGSHIP, pd=torch.float32,
         t=torch.float32, node=torch.bfloat16),
    dict(G=1, M=16, D=32, lmax=1, v=dict(sep_htr=True, rej=False,
                                         gate="act"),
         pd=torch.bfloat16, t=torch.float32, node=torch.bfloat16),
], ids=["md22-row", "ragged-round", "long-row", "f32", "lmax1-norej"])
def test_cuda_backward_on_host_block_shapes_rerun(host_bwd, case):
    args, g, kw = _host_case(case)
    want = fused_htr_backward_reference(*args, g, **kw)
    L = args[3].shape[-1]
    runs = []
    for _ in range(2):
        outs = fused_htr.backward_outputs(args[0], L)
        for o in outs:
            o.fill_(math.nan)
        fused_htr._call_backward(host_bwd, None, *args, g, outs, **kw)
        runs.append(outs)
    tol = 1e-2 if case["pd"] == torch.bfloat16 else 1e-5
    for name, g1, g2, w in zip(NAMES, *runs, want):
        _assert_close(g1.numpy(), w.numpy(), tol, name)
        assert g1.numpy().tobytes() == g2.numpy().tobytes(), name
    assert_padded_zeros(runs[0], case["M"])
