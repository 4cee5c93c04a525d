"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and ``nvcc``; without a card each one
skips (the check runs in a fixture, never at import).  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not need.)  This file imports nothing of JAX.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from gotennet_tpu_torch.data.dataset import synthetic_molecules
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import HeadConfig
from gotennet_tpu_torch.ops import fused_gata
from gotennet_tpu_torch.ops.fused_gata import (fused_gata_backward,
                                               fused_gata_backward_reference,
                                               fused_gata_forward,
                                               fused_gata_forward_reference)
from gotennet_tpu_torch.ops.fused_ell import (fused_ell_backward,
                                              fused_ell_backward_reference,
                                              fused_ell_forward,
                                              fused_ell_forward_reference,
                                              source_slots)
from gotennet_tpu_torch.ops.fused_htr import (fused_htr_backward,
                                              fused_htr_backward_reference,
                                              fused_htr_ell_backward,
                                              fused_htr_ell_backward_reference,
                                              fused_htr_ell_forward,
                                              fused_htr_ell_forward_reference,
                                              fused_htr_forward,
                                              fused_htr_forward_reference)
from gotennet_tpu_torch.serve import Predictor
from gotennet_tpu_torch.train.trainer import train_steps

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def inputs(device, G, M, D, H, lmax, sep_dir, sep_tensor, head_scale,
           node_dtype, seed=0):
    """Kernel inputs in argument order; graph 0 has 3 padded atoms."""
    rng = np.random.default_rng(seed)
    L = (lmax + 1) ** 2 - 1
    C = (1 + (lmax if sep_dir else 1) + (lmax if sep_tensor else 1)) * D

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                * 0.3)

    valid = rng.random((G, M, M)) > 0.3
    valid[0, M - 3:, :] = False
    valid[0, :, M - 3:] = False
    env = torch.from_numpy(np.where(valid, rng.random((G, M, M)), -1.0)
                           .astype(np.float32))
    scale = (torch.from_numpy(rng.random((G, M, M, H)).astype(np.float32))
             if head_scale else torch.full((G, M, M), 1.0 / math.sqrt(D)))
    args = [rand(G, M, M, D), rand(G, M, D).to(node_dtype),
            rand(G, M, D).to(node_dtype), rand(G, M, C).to(node_dtype),
            rand(G, M, C).to(node_dtype), rand(G, M, M, L), rand(G, M, L, D),
            env, scale, rand(D, D), rand(D), rand(D, C), rand(C)]
    return [a.to(device) for a in args]


# float32: the same arithmetic, sums in another order -> 1e-4 of each
# output's scale.  bf16 pair type: both versions round at the same
# points, but a float32 sum in another order can move a rounded pair
# term by one bf16 ulp (2^-8) -> 1e-2 of the scale.
@pytest.mark.parametrize("M,D,H,lmax,sep,head_scale,pd", [
    (8, 32, 4, 2, (True, True), False, torch.float32),
    (24, 64, 8, 2, (False, False), True, torch.float32),
    (16, 96, 8, 3, (True, False), True, torch.bfloat16),
    (32, 256, 8, 2, (True, True), False, torch.bfloat16),
    (70, 32, 4, 1, (False, True), False, torch.bfloat16),
    (120, 256, 8, 2, (True, True), False, torch.bfloat16),
])
def test_kernel_matches_plain(card, M, D, H, lmax, sep, head_scale, pd):
    args = inputs(card, 3, M, D, H, lmax, *sep, head_scale, pd)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep[0], sep_tensor=sep[1],
              pair_dtype=pd, with_attn=True)
    got = fused_gata_forward(*args, **kw)
    torch.cuda.synchronize()
    want = fused_gata_forward_reference(*args, **kw)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-4
    for g, w, name in zip(got, want, ("d_h", "dX", "sm")):
        err = (g - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err)
    d_h, dX, sm = got
    assert torch.all(sm[0, M - 3:] == 0) and torch.all(d_h[0, M - 3:] == 0)
    assert torch.all(dX[0, M - 3:] == 0)


def test_kernel_counts_launches_and_checks_arguments(card):
    args = inputs(card, 2, 16, 32, 4, 2, True, True, False, torch.float32)
    kw = dict(lmax=2, num_heads=4, sep_dir=True, sep_tensor=True)
    before = fused_gata_forward.launches
    d_h, dX, sm = fused_gata_forward(*args, **kw)
    assert fused_gata_forward.launches == before + 1 and sm is None
    bad = list(args)
    bad[5] = bad[5].double()
    with pytest.raises(ValueError, match="rl must be float32"):
        fused_gata_forward(*bad, **kw)
    bad = list(args)
    bad[0] = bad[0].transpose(1, 2)
    with pytest.raises(ValueError, match="not contiguous"):
        fused_gata_forward(*bad, **kw)
    assert fused_gata_forward.launches == before + 1


def test_predictor_on_card_matches_cpu(card):
    """The whole serving path in float32, card against CPU, same seed."""
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16)
    head = HeadConfig(mean=0.5, stddev=2.0)
    mols = synthetic_molecules(11, seed=4, min_atoms=5,
                               max_atoms=29).graph_dicts(range(11))
    launches = fused_gata.fused_gata_forward.launches
    got = Predictor(cfg, head, seed=2, chunk=4).predict(mols)
    assert fused_gata.fused_gata_forward.launches == launches + 3 * 2
    want = Predictor(cfg, head, seed=2, chunk=4, device="cpu").predict(mols)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def near_neighbours(env, reach):
    """``env`` ``[G,M,M]`` with only the pairs 0 < |i - j| <= ``reach``
    left valid: most pairs invalid, as in a large molecule's chunk."""
    M = env.shape[-1]
    i = torch.arange(M, device=env.device)
    gap = (i[:, None] - i[None, :]).abs()
    return torch.where((gap <= reach) & (gap > 0), env,
                       torch.full_like(env, -1.0))


# The backward: float32 sums in another order (and without atomics, in a
# fixed one) -> 1e-4 of each cotangent's scale in float32; a bf16 pair
# type may move a rounded pair term by one ulp -> 1e-2.  The benchmark's
# QM9 step shapes (G 64, M 16/24/32, D 256, bf16 pairs) among them; graph
# 0's last 3 atoms are padded (whole rows and columns), and with `reach`
# only near neighbours are valid pairs.
@pytest.mark.parametrize("M,D,H,lmax,sep,head_scale,pd,G,reach", [
    (8, 32, 4, 2, (True, True), False, torch.float32, 3, None),
    (24, 64, 8, 2, (False, False), True, torch.float32, 3, None),
    (16, 96, 8, 3, (True, False), True, torch.bfloat16, 3, None),
    (32, 256, 8, 2, (True, True), False, torch.bfloat16, 3, None),
    (112, 64, 8, 2, (True, True), True, torch.float32, 3, None),
    (16, 256, 8, 2, (True, True), False, torch.bfloat16, 64, None),
    (24, 256, 8, 2, (True, True), True, torch.bfloat16, 64, None),
    (32, 256, 8, 2, (True, True), False, torch.bfloat16, 64, None),
    (32, 256, 8, 2, (True, True), False, torch.bfloat16, 64, 2),
])
def test_backward_kernel_matches_plain(card, M, D, H, lmax, sep, head_scale,
                                       pd, G, reach):
    args = inputs(card, G, M, D, H, lmax, *sep, head_scale, pd, seed=1)
    if reach is not None:
        args[7] = near_neighbours(args[7], reach)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep[0], sep_tensor=sep[1],
              pair_dtype=pd)
    _, _, sm = fused_gata_forward(*args, **kw, with_attn=True)
    L = (lmax + 1) ** 2 - 1
    g_dh = torch.randn(G, M, D, device=card)
    g_dX = torch.randn(G, M, L, D, device=card)
    before = fused_gata_backward.launches
    got = fused_gata_backward(*args, sm, g_dh, g_dX, **kw)
    torch.cuda.synchronize()
    assert fused_gata_backward.launches == before + 1
    want = fused_gata_backward_reference(*args, sm, g_dh, g_dX, **kw)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-4
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max().item()
        assert err <= tol * max(w.abs().max().item(), 1e-30), (i, err)
    for g in got[:5] + (got[6], got[8]):
        assert torch.all(g[0, M - 3:] == 0)
    assert torch.all(got[0][0, :, M - 3:] == 0)


# The backward with position cotangents (forces): tolerances as above; two
# runs give the same bits, padded atoms and invalid pairs exact zeros.  The
# MD22 force request's shape (G 8, M 120) among them, once with only near
# neighbours valid.
@pytest.mark.parametrize("M,D,H,lmax,sep,head_scale,pd,G,reach", [
    (8, 32, 4, 2, (True, True), False, torch.float32, 2, None),
    (24, 64, 8, 3, (False, False), True, torch.bfloat16, 2, None),
    (120, 256, 8, 2, (True, True), False, torch.bfloat16, 2, None),
    (120, 256, 8, 2, (True, True), False, torch.bfloat16, 8, None),
    (120, 256, 8, 2, (True, True), True, torch.bfloat16, 8, 8),
])
def test_backward_kernel_position_cotangents_match_plain(
        card, M, D, H, lmax, sep, head_scale, pd, G, reach):
    args = inputs(card, G, M, D, H, lmax, *sep, head_scale, pd, seed=2)
    if reach is not None:
        args[7] = near_neighbours(args[7], reach)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep[0], sep_tensor=sep[1],
              pair_dtype=pd, pos_grads=True)
    _, _, sm = fused_gata_forward(*args, lmax=lmax, num_heads=H,
                                  sep_dir=sep[0], sep_tensor=sep[1],
                                  pair_dtype=pd, with_attn=True)
    L = (lmax + 1) ** 2 - 1
    g_dh = torch.randn(G, M, D, device=card)
    g_dX = torch.randn(G, M, L, D, device=card)
    got = fused_gata_backward(*args, sm, g_dh, g_dX, **kw)
    again = fused_gata_backward(*args, sm, g_dh, g_dX, **kw)
    torch.cuda.synchronize()
    want = fused_gata_backward_reference(*args, sm, g_dh, g_dX, **kw)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-4
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max().item()
        assert err <= tol * max(w.abs().max().item(), 1e-30), (i, err)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert torch.all(got[5][0, M - 3:] == 0)
    assert torch.all(got[7][args[7] < 0] == 0)


def test_predict_with_forces_on_card_matches_cpu(card):
    """Energies and forces in float32, card against CPU, same seed, on both
    layouts."""
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, fused_htr=True)
    head = HeadConfig(mean=0.5, stddev=2.0, derivative=True)
    mols = synthetic_molecules(5, seed=4, min_atoms=20, max_atoms=40,
                               box=6.3).graph_dicts(range(5))
    for layout in ("dense", "ell"):
        kw = dict(seed=2, chunk=2, layout=layout, block_rows=16)
        e, f = Predictor(cfg, head, **kw).predict_with_forces(mols)
        we, wf = Predictor(cfg, head, **kw,
                           device="cpu").predict_with_forces(mols)
        np.testing.assert_allclose(e, we, rtol=1e-4, atol=1e-4)
        scale = max(np.abs(x).max() for x in wf)
        for got, want in zip(f, wf):
            assert np.abs(got - want).max() <= 1e-4 * scale, layout


def test_train_step_on_card_matches_cpu(card):
    """Two training steps in float32, card against CPU, same seed; each
    step launches both kernels chunks x layers times."""
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, remat=False)
    head = HeadConfig(mean=0.5, stddev=2.0)
    mols = synthetic_molecules(24, seed=5, min_atoms=5,
                               max_atoms=29).graph_dicts(range(24))
    n_fwd, n_bwd = fused_gata_forward.launches, fused_gata_backward.launches
    got = train_steps(cfg, head, mols, 2, chunk=8, seed=1)
    assert fused_gata_forward.launches == n_fwd + 2 * 3 * 2
    assert fused_gata_backward.launches == n_bwd + 2 * 3 * 2
    want = train_steps(cfg, head, mols, 2, chunk=8, seed=1, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---- the fused HTR update ---------------------------------------------------
HTR_CASES = [
    # M, D, lmax, (sep_htr, rej, gate), pair type, t type, node type
    (8, 32, 2, (True, True, ""), torch.float32, torch.float32, torch.float32),
    (16, 64, 3, (False, True, "gated"), torch.bfloat16, torch.bfloat16,
     torch.bfloat16),
    (24, 64, 1, (True, False, "act"), torch.float32, torch.float32,
     torch.bfloat16),
    (120, 256, 2, (True, True, ""), torch.bfloat16, torch.float32,
     torch.bfloat16),
]


def htr_inputs(device, G, M, D, lmax, t_dtype, node_dtype, seed=0):
    """(t, EQ, EK, rl, W_g, b_g) and a cotangent of out that is zero on the
    rows and columns of graph 0's last 3 atoms."""
    rng = np.random.default_rng(seed)
    L = (lmax + 1) ** 2 - 1

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                * 0.4)

    args = [rand(G, M, M, D).to(t_dtype), rand(G, M, L, D).to(node_dtype),
            rand(G, M, L, D).to(node_dtype), rand(G, M, M, L), rand(D, D),
            rand(D)]
    g = torch.randn(G, M, M, D, generator=torch.Generator().manual_seed(seed))
    g[0, M - 3:] = 0.0
    g[0, :, M - 3:] = 0.0
    return [a.to(device) for a in args], g.to(device)


# float32: the same arithmetic, sums in another order -> 1e-4 of each
# output's scale; bf16 pair type: a float32 sum in another order can move a
# value that is rounded afterwards by one bf16 ulp (2^-8) -> 1e-2.
@pytest.mark.parametrize("M,D,lmax,variant,pd,td,nd", HTR_CASES)
def test_htr_kernels_match_plain(card, M, D, lmax, variant, pd, td, nd):
    args, g = htr_inputs(card, 3, M, D, lmax, td, nd)
    kw = dict(lmax=lmax, sep_htr=variant[0], rej=variant[1],
              gate=variant[2], pair_dtype=pd)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-4
    n_fwd, n_bwd = fused_htr_forward.launches, fused_htr_backward.launches
    got = [fused_htr_forward(*args, **kw)]
    got += fused_htr_backward(*args, g, **kw)
    torch.cuda.synchronize()
    assert fused_htr_forward.launches == n_fwd + 1
    assert fused_htr_backward.launches == n_bwd + 1
    want = [fused_htr_forward_reference(*args, **kw)]
    want += fused_htr_backward_reference(*args, g, **kw)
    for i, (a, w) in enumerate(zip(got, want)):
        err = (a - w).abs().max().item()
        assert err <= tol * max(w.abs().max().item(), 1e-30), (i, err)
    g_t, g_EQ, g_EK, g_rl = got[1:5]
    for a in (g_t, g_rl):
        assert torch.all(a[0, M - 3:] == 0) and torch.all(a[0, :, M - 3:] == 0)
    assert torch.all(g_EQ[0, M - 3:] == 0) and torch.all(g_EK[0, M - 3:] == 0)


# The two kernels redesigned for the tensor cores at the MD22 chunk's shape
# (G = 4, M = 120, flagship widths), against their plain versions at the
# tolerances above and run twice: the same bits (every sum has one owner).
@pytest.mark.parametrize("head_scale", [False, True])
def test_gata_forward_at_md22_reruns_bit_identical(card, head_scale):
    M = 120
    args = inputs(card, 4, M, 256, 8, 2, True, True, head_scale,
                  torch.bfloat16, seed=7)
    kw = dict(lmax=2, num_heads=8, sep_dir=True, sep_tensor=True,
              pair_dtype=torch.bfloat16, with_attn=True)
    got = fused_gata_forward(*args, **kw)
    again = fused_gata_forward(*args, **kw)
    torch.cuda.synchronize()
    want = fused_gata_forward_reference(*args, **kw)
    for g, w, name in zip(got, want, ("d_h", "dX", "sm")):
        err = (g - w).abs().max().item()
        assert err <= 1e-2 * w.abs().max().item(), (name, err)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.all(got[2][0, M - 3:] == 0) and torch.all(got[0][0, M - 3:] == 0)


# The GATA backward at the benchmark's shapes (the MD22 force request's G 8,
# M 120 with position cotangents; the QM9 step's G 64, M 32), against its
# plain version and run twice: the same bits (every sum has one owner).
@pytest.mark.parametrize("G,M,pos_grads,head_scale", [
    (8, 120, True, False), (8, 120, True, True), (64, 32, False, False)],
    ids=["md22-forces", "md22-forces-head-scale", "qm9-step"])
def test_gata_backward_at_benchmark_shapes_reruns_bit_identical(
        card, G, M, pos_grads, head_scale):
    args = inputs(card, G, M, 256, 8, 2, True, True, head_scale,
                  torch.bfloat16, seed=11)
    kw = dict(lmax=2, num_heads=8, sep_dir=True, sep_tensor=True,
              pair_dtype=torch.bfloat16)
    _, _, sm = fused_gata_forward(*args, **kw, with_attn=True)
    g_dh = torch.randn(G, M, 256, device=card)
    g_dX = torch.randn(G, M, 8, 256, device=card)
    got = fused_gata_backward(*args, sm, g_dh, g_dX, **kw,
                              pos_grads=pos_grads)
    again = fused_gata_backward(*args, sm, g_dh, g_dX, **kw,
                                pos_grads=pos_grads)
    torch.cuda.synchronize()
    want = fused_gata_backward_reference(*args, sm, g_dh, g_dX, **kw,
                                         pos_grads=pos_grads)
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max().item()
        assert err <= 1e-2 * max(w.abs().max().item(), 1e-30), (i, err)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g in got[:5] + (got[6], got[8]):
        assert torch.all(g[0, M - 3:] == 0)
    if pos_grads:
        assert torch.all(got[5][0, M - 3:] == 0)
        assert torch.all(got[7][args[7] < 0] == 0)


@pytest.mark.parametrize("gate,td", [("", torch.float32),
                                     ("gated", torch.bfloat16)])
def test_htr_backward_at_md22_reruns_bit_identical(card, gate, td):
    M = 120
    args, g = htr_inputs(card, 4, M, 256, 2, td, torch.bfloat16, seed=5)
    kw = dict(lmax=2, sep_htr=True, rej=True, gate=gate,
              pair_dtype=torch.bfloat16)
    got = fused_htr_backward(*args, g, **kw)
    again = fused_htr_backward(*args, g, **kw)
    torch.cuda.synchronize()
    want = fused_htr_backward_reference(*args, g, **kw)
    for i, (a, w) in enumerate(zip(got, want)):
        err = (a - w).abs().max().item()
        assert err <= 1e-2 * max(w.abs().max().item(), 1e-30), (i, err)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    g_t, g_EQ, g_EK, g_rl = got[:4]
    for a in (g_t, g_rl):
        assert torch.all(a[0, M - 3:] == 0) and torch.all(a[0, :, M - 3:] == 0)
    assert torch.all(g_EQ[0, M - 3:] == 0) and torch.all(g_EK[0, M - 3:] == 0)


# The two HTR forwards redesigned on the row pass's shape at the paths'
# shapes (dense: G = 4, M = 120; ELL: N = 704, K = 36, float32 node tables
# as the ELL layer gives them), the gates and degree grammars not taken
# above, bf16 and float32 node tables, bf16 t: against their plain versions
# at the tolerances above, and run twice: the same bits (a block owns its
# pairs' outputs).
@pytest.mark.parametrize("gate,sep_htr,rej,td,nd", [
    ("", True, True, torch.float32, torch.bfloat16),
    ("gatedt", False, True, torch.bfloat16, torch.float32),
    ("act", True, False, torch.float32, torch.bfloat16),
])
def test_htr_forward_at_md22_matches_plain_and_reruns(card, gate, sep_htr,
                                                      rej, td, nd):
    args, _ = htr_inputs(card, 4, 120, 256, 2, td, nd, seed=9)
    kw = dict(lmax=2, sep_htr=sep_htr, rej=rej, gate=gate,
              pair_dtype=torch.bfloat16)
    before = fused_htr_forward.launches
    got = fused_htr_forward(*args, **kw)
    again = fused_htr_forward(*args, **kw)
    torch.cuda.synchronize()
    assert fused_htr_forward.launches == before + 2
    want = fused_htr_forward_reference(*args, **kw)
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize("gate,sep_htr,rej,nd", [
    ("", True, True, torch.float32),
    ("gated", False, True, torch.bfloat16),
    ("act", True, False, torch.float32),
])
def test_htr_ell_forward_matches_plain_and_reruns(card, gate, sep_htr, rej,
                                                  nd):
    D, lmax, K, NR, N = 256, 2, 36, 704, 704
    L = (lmax + 1) ** 2 - 1
    args = ell_inputs(card, NR, N, K, D, 8, lmax, False, seed=13)
    gen = torch.Generator().manual_seed(6)
    h_args = [args[0],
              (torch.randn(NR, L, D, generator=gen) * 0.4).to(card, nd),
              (torch.randn(N, L, D, generator=gen) * 0.4).to(card, nd),
              args[5], args[9], args[10] / 8.0, args[11]]
    hkw = dict(lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
               pair_dtype=torch.bfloat16)
    before = fused_htr_ell_forward.launches
    got = fused_htr_ell_forward(*h_args, **hkw)
    again = fused_htr_ell_forward(*h_args, **hkw)
    torch.cuda.synchronize()
    assert fused_htr_ell_forward.launches == before + 2
    want = fused_htr_ell_forward_reference(*h_args, **hkw)
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert torch.equal(got, again)


def test_htr_kernel_checks_arguments(card):
    args, _ = htr_inputs(card, 1, 8, 32, 2, torch.float32, torch.float32)
    kw = dict(lmax=2, sep_htr=True, rej=True, gate="")
    before = fused_htr_forward.launches
    bad = list(args)
    bad[3] = bad[3].double()
    with pytest.raises(ValueError, match="rl must be float32"):
        fused_htr_forward(*bad, **kw)
    with pytest.raises(ValueError, match="unsupported gate"):
        fused_htr_forward(*args, **dict(kw, gate="mlp"))
    assert fused_htr_forward.launches == before


def _md22_frames(n, seed):
    return synthetic_molecules(n, seed=seed, min_atoms=110, max_atoms=120,
                               box=6.3).graph_dicts(range(n))


def test_md22_predictor_on_card_matches_cpu(card):
    """MD22-sized frames (M = 120, unbucketed) through both fused HTR and
    GATA kernels, float32, card against CPU."""
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, fused_htr=True)
    head = HeadConfig(mean=0.5, stddev=2.0)
    mols = _md22_frames(8, seed=4)
    n_gata, n_htr = (fused_gata.fused_gata_forward.launches,
                     fused_htr_forward.launches)
    got = Predictor(cfg, head, seed=2, chunk=4, bucket=False).predict(mols)
    assert fused_gata.fused_gata_forward.launches == n_gata + 2 * 2
    assert fused_htr_forward.launches == n_htr + 2 * 1
    want = Predictor(cfg, head, seed=2, chunk=4, bucket=False,
                     device="cpu").predict(mols)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_md22_train_step_on_card_matches_cpu(card):
    """Two training steps on MD22-sized frames with fused_htr, float32, card
    against CPU; each step launches the HTR kernels chunks x (layers - 1)
    times."""
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, fused_htr=True, remat=False)
    head = HeadConfig(mean=0.5, stddev=2.0)
    mols = _md22_frames(8, seed=5)
    n_fwd, n_bwd = fused_htr_forward.launches, fused_htr_backward.launches
    got = train_steps(cfg, head, mols, 2, chunk=4, seed=1, bucket=False)
    assert fused_htr_forward.launches == n_fwd + 2 * 2
    assert fused_htr_backward.launches == n_bwd + 2 * 2
    want = train_steps(cfg, head, mols, 2, chunk=4, seed=1, bucket=False,
                       device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_plain_htr_terms_on_card_match_and_take_no_more_memory(card):
    """The plain update's contracted pair terms at the QM9 flagship's
    largest bucket (G 256, M 32, 256 channels, bf16) against the
    per-component form: values and the derivatives of EQ, EK and rl within
    2e-2 of each one's scale (both against that form at float32), and the
    peak memory over one forward and backward no higher."""
    from test_torch_port_htr_plain import per_component_terms

    from gotennet_tpu_torch.models.gotennet_dense import htr_terms
    from gotennet_tpu_torch.ops.spherical import spherical_harmonics
    G, M, E = 256, 32, 256
    gen = torch.Generator(device=card).manual_seed(0)
    EQ, EK = (torch.randn(G, M, 8, E, device=card, generator=gen) * 0.5
              for _ in range(2))
    vec = torch.randn(G, M, M, 3, device=card, generator=gen)
    rl = spherical_harmonics(vec / vec.norm(dim=-1, keepdim=True), 2)
    g_w = torch.randn(G, M, M, E, device=card, generator=gen)
    runs = {}
    for name, terms, pd in (("contracted", htr_terms, torch.bfloat16),
                            ("per_component", per_component_terms,
                             torch.bfloat16),
                            ("float32", per_component_terms, torch.float32)):
        leaves = [x.clone().requires_grad_() for x in (EQ, EK, rl)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        w = terms(*leaves, 2, True, True, pd)
        grads = torch.autograd.grad(w, leaves, g_w.to(pd))
        torch.cuda.synchronize()
        runs[name] = ((w.detach(), *grads),
                      torch.cuda.max_memory_allocated() - base)
        del w, grads, leaves
    assert runs["contracted"][1] <= runs["per_component"][1], runs
    for what, got, old, want in zip(("w", "g_EQ", "g_EK", "g_rl"),
                                    runs["contracted"][0],
                                    runs["per_component"][0],
                                    runs["float32"][0]):
        scale = want.abs().max().item()
        for form, x in (("contracted", got), ("per_component", old)):
            err = (x.float() - want).abs().max().item()
            assert err <= 2e-2 * scale, (what, form, err, scale)


# ---- the ELL layout ----------------------------------------------------------
def ell_inputs(device, NR, N, K, D, H, lmax, head_scale, seed=0):
    """Message-kernel inputs in argument order (ELL layout, float32 node
    tables as the model gives them); a third of the slots padded (env -1,
    pointing at their own row), the last row wholly padded."""
    rng = np.random.default_rng(seed)
    L = (lmax + 1) ** 2 - 1
    C = (1 + 2 * lmax) * D

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                * 0.3)

    valid = rng.random((NR, K)) > 0.3
    valid[-1] = False
    nbr = np.where(valid, rng.integers(0, N, (NR, K)),
                   np.arange(NR)[:, None]).astype(np.int32)
    env = np.where(valid, rng.random((NR, K)), -1.0).astype(np.float32)
    scale = (torch.from_numpy(rng.random((NR, K, H)).astype(np.float32))
             if head_scale else torch.full((NR, K), 1.0 / math.sqrt(D)))
    args = [rand(NR, K, D), rand(NR, D), rand(N, D), rand(N, C), rand(N, C),
            rand(NR, K, L), rand(N, L, D), torch.from_numpy(env), scale,
            torch.from_numpy(nbr), rand(D, D), rand(D), rand(D, C), rand(C)]
    return [a.to(device) for a in args]


# float32: the same arithmetic, sums in another order -> 1e-4 of each
# output's scale; bf16 pair type: a float32 sum in another order can move a
# value that is rounded afterwards by one bf16 ulp (2^-8) -> 1e-2.
@pytest.mark.parametrize("NR,N,K,head_scale,pd", [
    (200, 256, 36, False, torch.float32),
    (200, 256, 36, True, torch.bfloat16),
    (97, 97, 28, True, torch.float32),
    (704, 704, 36, False, torch.bfloat16),
])
def test_ell_kernels_match_plain(card, NR, N, K, head_scale, pd):
    D, H, lmax = 256, 8, 2
    args = ell_inputs(card, NR, N, K, D, H, lmax, head_scale)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=True, sep_tensor=True,
              pair_dtype=pd, with_attn=True)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-4
    before = fused_ell_forward.launches
    got = fused_ell_forward(*args, **kw)
    torch.cuda.synchronize()
    assert fused_ell_forward.launches == before + 1
    want = fused_ell_forward_reference(*args, **kw)
    for g, w, name in zip(got, want, ("d_h", "dX", "sm")):
        err = (g - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (name, err)
    assert torch.all(got[2][-1] == 0) and torch.all(got[0][-1] == 0)

    L = (lmax + 1) ** 2 - 1
    gen = torch.Generator().manual_seed(1)
    h_args = [args[0], (torch.randn(NR, L, D, generator=gen) * 0.4).to(card),
              (torch.randn(N, L, D, generator=gen) * 0.4).to(card), args[5],
              args[9], args[10] / 8.0, args[11]]
    for gate in ("", "gated"):
        hkw = dict(lmax=lmax, sep_htr=True, rej=True, gate=gate,
                   pair_dtype=pd)
        before = fused_htr_ell_forward.launches
        out = fused_htr_ell_forward(*h_args, **hkw)
        torch.cuda.synchronize()
        assert fused_htr_ell_forward.launches == before + 1
        want = fused_htr_ell_forward_reference(*h_args, **hkw)
        err = (out - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (gate, err)


def test_ell_kernels_check_arguments(card):
    args = ell_inputs(card, 16, 16, 12, 32, 4, 2, False)
    kw = dict(lmax=2, num_heads=4, sep_dir=True, sep_tensor=True)
    before = fused_ell_forward.launches
    bad = list(args)
    bad[9] = bad[9].long()
    with pytest.raises(ValueError, match="nbr must be int32"):
        fused_ell_forward(*bad, **kw)
    bad = list(args)
    bad[2] = bad[2][:8].contiguous()     # fewer table rows than rows
    with pytest.raises(ValueError, match="table rows"):
        fused_ell_forward(*bad, **kw)
    assert fused_ell_forward.launches == before


def test_ell_predictor_on_card_matches_cpu(card):
    """Two 600-700-atom frames on the ELL layout through both ELL kernels,
    float32, card against CPU."""
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, fused_htr=True)
    head = HeadConfig(mean=0.5, stddev=2.0)
    mols = synthetic_molecules(2, seed=7, min_atoms=600, max_atoms=700,
                               box=6.3).graph_dicts(range(2))
    n_msg, n_htr = fused_ell_forward.launches, fused_htr_ell_forward.launches
    got = Predictor(cfg, head, seed=2, chunk=1, layout="ell").predict(mols)
    assert fused_ell_forward.launches == n_msg + 2 * 2
    assert fused_htr_ell_forward.launches == n_htr + 2 * 1
    want = Predictor(cfg, head, seed=2, chunk=1, layout="ell",
                     device="cpu").predict(mols)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _close(got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max().item()
        assert err <= tol * max(w.abs().max().item(), 1e-30), (i, err)


# tolerances as test_ell_kernels_match_plain's; reruns give the same bits
# (every sum has one owner, no atomics)
@pytest.mark.parametrize("NR,N,head_scale,pd", [
    (704, 704, False, torch.float32),
    (704, 704, True, torch.bfloat16),
    (640, 704, False, torch.bfloat16),
])
def test_ell_backward_kernels_match_plain(card, NR, N, head_scale, pd):
    D, H, lmax, K = 256, 8, 2, 36
    L = (lmax + 1) ** 2 - 1
    args = ell_inputs(card, NR, N, K, D, H, lmax, head_scale, seed=3)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=True, sep_tensor=True,
              pair_dtype=pd)
    _, _, sm = fused_ell_forward(*args, **kw, with_attn=True)
    gen = torch.Generator().manual_seed(2)
    g_dh = torch.randn(NR, D, generator=gen).to(card)
    g_dX = torch.randn(NR, L, D, generator=gen).to(card)
    slots = source_slots(args[9], N)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-4
    before = fused_ell_backward.launches
    got = fused_ell_backward(*args, sm, g_dh, g_dX, **kw, slots=slots)
    again = fused_ell_backward(*args, sm, g_dh, g_dX, **kw, slots=slots)
    torch.cuda.synchronize()
    assert fused_ell_backward.launches == before + 2
    _close(got, fused_ell_backward_reference(*args, sm, g_dh, g_dX, **kw),
           tol)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    pad = args[7] < 0
    for a in (got[0], got[5], got[7], got[8]):      # g_t, g_rl, g_env, g_scale
        assert torch.all(a[pad] == 0)

    h_args = [args[0], (torch.randn(NR, L, D, generator=gen) * 0.4).to(card),
              (torch.randn(N, L, D, generator=gen) * 0.4).to(card), args[5],
              args[9], args[10] / 8.0, args[11]]
    g = torch.randn(NR, K, D, generator=gen).to(card)
    for gate in ("", "gated"):
        hkw = dict(lmax=lmax, sep_htr=True, rej=True, gate=gate,
                   pair_dtype=pd)
        before = fused_htr_ell_backward.launches
        got = fused_htr_ell_backward(*h_args, g, **hkw, slots=slots)
        again = fused_htr_ell_backward(*h_args, g, **hkw, slots=slots)
        torch.cuda.synchronize()
        assert fused_htr_ell_backward.launches == before + 2
        _close(got, fused_htr_ell_backward_reference(*h_args, g, **hkw), tol)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


# The redesigned ELL message forward at the frame's shapes (N = 704, K = 36:
# three rows of 36 slots a block, valid slots compacted): float32 and bf16
# node tables, scalar and per-head scale, fewer rows than table rows; a rerun
# gives the same bits and the wholly padded row exact zeros.  Tolerances as
# test_ell_kernels_match_plain's.
@pytest.mark.parametrize("NR,head_scale,nd", [
    (704, False, torch.float32),
    (704, True, torch.bfloat16),
    (640, True, torch.float32),
])
def test_ell_forward_redesign_matches_plain_and_reruns(card, NR, head_scale,
                                                       nd):
    D, H, lmax, K, N = 256, 8, 2, 36, 704
    args = ell_inputs(card, NR, N, K, D, H, lmax, head_scale, seed=11)
    for i in (1, 2, 3, 4):
        args[i] = args[i].to(nd)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=True, sep_tensor=True,
              pair_dtype=torch.bfloat16, with_attn=True)
    before = fused_ell_forward.launches
    got = fused_ell_forward(*args, **kw)
    again = fused_ell_forward(*args, **kw)
    torch.cuda.synchronize()
    assert fused_ell_forward.launches == before + 2
    _close(got, fused_ell_forward_reference(*args, **kw), 1e-2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.all(a[-1] == 0) for a in got)


# The ELL HTR backward's row pass at the frame's shapes (three rows of 36
# slots a block): the gates, joined degree blocks and no rejection terms not
# taken above, bf16 node tables, and a table row no slot reads (exact zeros
# in g_EK); a rerun gives the same bits.  Tolerances as above.
@pytest.mark.parametrize("gate,sep_htr,rej,nd", [
    ("act", True, True, torch.float32),
    ("gatedt", False, True, torch.bfloat16),
    ("", True, False, torch.float32),
])
def test_ell_htr_backward_row_pass_matches_plain_and_reruns(card, gate,
                                                            sep_htr, rej, nd):
    D, lmax, K, NR, N = 256, 2, 36, 704, 704
    L = (lmax + 1) ** 2 - 1
    args = ell_inputs(card, NR, N, K, D, 8, lmax, False, seed=12)
    nbr = torch.where(args[9] == N - 1, torch.zeros_like(args[9]), args[9])
    gen = torch.Generator().manual_seed(4)
    h_args = [args[0],
              (torch.randn(NR, L, D, generator=gen) * 0.4).to(card, nd),
              (torch.randn(N, L, D, generator=gen) * 0.4).to(card, nd),
              args[5], nbr, args[10] / 8.0, args[11]]
    g = torch.randn(NR, K, D, generator=gen).to(card)
    slots = source_slots(nbr, N)
    hkw = dict(lmax=lmax, sep_htr=sep_htr, rej=rej, gate=gate,
               pair_dtype=torch.bfloat16)
    before = fused_htr_ell_backward.launches
    got = fused_htr_ell_backward(*h_args, g, **hkw, slots=slots)
    again = fused_htr_ell_backward(*h_args, g, **hkw, slots=slots)
    torch.cuda.synchronize()
    assert fused_htr_ell_backward.launches == before + 2
    _close(got, fused_htr_ell_backward_reference(*h_args, g, **hkw), 1e-2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.all(got[2][N - 1] == 0)


# All four ELL kernels at the xl mode's shapes (N = 4,224 rows, K = 36 slots,
# bench.py's 4,000-4,200-atom frames on the whole table): the slot products
# reach N K L D = 3.1e8 elements and the transposed slot list 152,064 slots.
# Tolerances as test_ell_kernels_match_plain's; reruns give the same bits.
@pytest.mark.parametrize("pd", [torch.float32, torch.bfloat16])
def test_ell_kernels_at_xl_shapes_match_plain_and_rerun(card, pd):
    D, H, lmax, K, N = 256, 8, 2, 36, 4224
    L = (lmax + 1) ** 2 - 1
    args = ell_inputs(card, N, N, K, D, H, lmax, False, seed=21)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=True, sep_tensor=True,
              pair_dtype=pd)
    tol = 1e-2 if pd == torch.bfloat16 else 1e-4
    got = fused_ell_forward(*args, **kw, with_attn=True)
    again = fused_ell_forward(*args, **kw, with_attn=True)
    torch.cuda.synchronize()
    _close(got, fused_ell_forward_reference(*args, **kw, with_attn=True),
           tol)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    sm = got[2]
    gen = torch.Generator().manual_seed(5)
    g_dh = torch.randn(N, D, generator=gen).to(card)
    g_dX = torch.randn(N, L, D, generator=gen).to(card)
    slots = source_slots(args[9], N)
    got = fused_ell_backward(*args, sm, g_dh, g_dX, **kw, slots=slots)
    again = fused_ell_backward(*args, sm, g_dh, g_dX, **kw, slots=slots)
    torch.cuda.synchronize()
    want = fused_ell_backward_reference(*args, sm, g_dh, g_dX, **kw)
    _close(got, want, tol)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again, want

    h_args = [args[0], (torch.randn(N, L, D, generator=gen) * 0.4).to(card),
              (torch.randn(N, L, D, generator=gen) * 0.4).to(card), args[5],
              args[9], args[10] / 8.0, args[11]]
    hkw = dict(lmax=lmax, sep_htr=True, rej=True, gate="", pair_dtype=pd)
    out = fused_htr_ell_forward(*h_args, **hkw)
    torch.cuda.synchronize()
    _close([out], [fused_htr_ell_forward_reference(*h_args, **hkw)], tol)
    assert torch.equal(out, fused_htr_ell_forward(*h_args, **hkw))
    g = torch.randn(N, K, D, generator=gen).to(card)
    got = fused_htr_ell_backward(*h_args, g, **hkw, slots=slots)
    again = fused_htr_ell_backward(*h_args, g, **hkw, slots=slots)
    torch.cuda.synchronize()
    _close(got, fused_htr_ell_backward_reference(*h_args, g, **hkw), tol)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_unfused_ell_paths_on_card_match_cpu(card):
    """The large_molecule experiment's model (fused message, unfused
    update) and fused=False with aggr mean, on two 600-700-atom frames,
    float32, card against CPU; only the first launches a kernel."""
    head = HeadConfig(mean=0.5, stddev=2.0)
    mols = synthetic_molecules(2, seed=7, min_atoms=600, max_atoms=700,
                               box=6.3).graph_dicts(range(2))
    for kw, msg in ((dict(fused=True, fused_htr=False), 4),
                    (dict(fused=False, aggr="mean"), 0)):
        cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                             num_heads=8, n_rbf=16, **kw)
        n_msg = fused_ell_forward.launches
        n_htr = fused_htr_ell_forward.launches
        got = Predictor(cfg, head, seed=2, chunk=1, layout="ell").predict(
            mols)
        assert fused_ell_forward.launches == n_msg + msg
        assert fused_htr_ell_forward.launches == n_htr
        want = Predictor(cfg, head, seed=2, chunk=1, layout="ell",
                         device="cpu").predict(mols)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ell_backward_kernels_check_arguments(card):
    args = ell_inputs(card, 16, 16, 12, 32, 4, 2, False)
    kw = dict(lmax=2, num_heads=4, sep_dir=True, sep_tensor=True)
    _, _, sm = fused_ell_forward(*args, **kw, with_attn=True)
    g_dh = torch.zeros(16, 32, device=card)
    g_dX = torch.zeros(16, 8, 32, device=card)
    before = fused_ell_backward.launches
    with pytest.raises(ValueError, match="g_dX must be"):
        fused_ell_backward(*args, sm, g_dh, g_dX.double(), **kw)
    starts, order = source_slots(args[9], 16)
    with pytest.raises(ValueError, match="slots' order"):
        fused_ell_backward(*args, sm, g_dh, g_dX, **kw,
                           slots=(starts, order.long()))
    assert fused_ell_backward.launches == before
    h_args = [args[0], torch.zeros(16, 8, 32, device=card),
              torch.zeros(16, 8, 32, device=card), args[5], args[9],
              args[10], args[11]]
    before = fused_htr_ell_backward.launches
    with pytest.raises(ValueError, match="g must be"):
        fused_htr_ell_backward(*h_args, torch.zeros(16, 12, 32, 2,
                                                     device=card),
                               lmax=2, sep_htr=True, rej=True, gate="")
    assert fused_htr_ell_backward.launches == before


def test_ell_train_step_on_card_matches_cpu(card):
    """Two ELL training steps on 600-700-atom frames, float32, card against
    CPU; each step launches all four ELL kernels chunks x layers times (the
    HTR ones chunks x (layers - 1))."""
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, fused_htr=True, remat=False)
    head = HeadConfig(mean=0.5, stddev=2.0)
    mols = synthetic_molecules(2, seed=9, min_atoms=600, max_atoms=700,
                               box=6.3).graph_dicts(range(2))
    counters = (fused_ell_forward, fused_ell_backward, fused_htr_ell_forward,
                fused_htr_ell_backward)
    before = [c.launches for c in counters]
    got = train_steps(cfg, head, mols, 2, chunk=1, seed=1, layout="ell")
    assert [c.launches - b for c, b in zip(counters, before)] == [8, 8, 4, 4]
    want = train_steps(cfg, head, mols, 2, chunk=1, seed=1, layout="ell",
                       device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.fixture(scope="module")
def product_lib():
    """chip_smoke.PRODUCT_SOURCE (the backward kernels' product and column
    sums of csrc/bwd_sums.cuh alone) built with nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return chip_smoke.build_products()


@pytest.mark.parametrize("P", [4 * 120 * 120, 704 * 36],
                         ids=["md22_M120", "ell"])
def test_backward_products_match_matmul(product_lib, P):
    """The six products of a message backward (t W_rs, t W_re, g_tf W_rs^T
    + g_zre W_re^T, t^T g_tf and t^T g_zre over the pairs) and the two
    column sums at the MD22 chunk's and the ELL chunk's pair counts, on the
    tensor cores, against torch.matmul of the same bf16-rounded factors (1e-5
    of the scale, one bf16 ulp more where the output is rounded), each run
    twice with the same bits (chip_smoke.hold_products raises otherwise)."""
    rows = chip_smoke.hold_products(product_lib, P, seed=3)
    assert len(rows) == 7 and all(rel <= 1e-5 for _, _, rel in rows[5:])


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_trainer_fit_epoch_with_dropout_on_card(card, tmp_path, layout):
    """One Trainer.fit epoch on the card with attention dropout 0.1 and
    2-batch accumulation: every batch launches the message kernels once a
    layer each way, the record is finite, and ckpt_last evaluates on the CPU as on the card
    (float32, 1e-4 of the scale)."""
    from gotennet_tpu_torch.data.dataset import DenseLoader, ELLLoader
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_ell
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    from gotennet_tpu_torch.train.checkpoint import load_checkpoint
    from gotennet_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, attn_dropout=0.1,
                         remat=False)
    task = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0})
    if layout == "dense":
        ds = synthetic_molecules(40, seed=3, min_atoms=5, max_atoms=29)
        make = lambda d: DenseLoader(d, 8, shuffle=True, seed=1, bucket=True)
        fwd, bwd = fused_gata_forward, fused_gata_backward
        n_train, n_batches = 24, 3
    else:
        ds = synthetic_molecules(5, seed=3, min_atoms=600, max_atoms=700,
                                 box=6.3)
        make = lambda d: ELLLoader(d, 1, shuffle=True, seed=1,
                                   spatial_sort=True, block_rows=64)
        fwd, bwd = fused_ell.fused_ell_forward, fused_ell.fused_ell_backward
        n_train, n_batches = 3, 3
    train, val = make(ds.subset(range(n_train))), make(
        ds.subset(range(n_train, len(ds))))
    model = GotenModel(cfg, task.build_head(), layout, seed=1)
    tr = Trainer(model, task, TrainerConfig(max_epochs=1, grad_accum_steps=2,
                                            workdir=str(tmp_path)))
    n_fwd, n_bwd = fwd.launches, bwd.launches
    _, hist = tr.fit(model.state_dict(), train, val)
    assert fwd.launches - n_fwd == (n_batches + len(val)) * 2
    assert bwd.launches - n_bwd == n_batches * 2
    assert hist[0]["step"] == 2
    assert all(math.isfinite(v) for v in hist[0].values())
    on_card = tr.evaluate(None, val)
    cpu_model, state, _ = load_checkpoint(str(tmp_path / "ckpt_last"), "cpu")
    cpu = Trainer(cpu_model, task, TrainerConfig(
        workdir=str(tmp_path / "cpu"))).evaluate(state, val)
    for key, value in cpu.items():
        assert abs(on_card[key] - value) <= 1e-4 * max(abs(value), 1.0), key


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_force_training_step_on_card_matches_cpu(card, layout):
    """One MD22Task step (energy 0.05, force 0.95, MSE; the gradient of the
    forces) on the unfused paths, fused=False, card against CPU from the
    same weights: no kernel launches, the loss and every parameter's
    gradient within 1e-4 of its scale (float32, sums in another order)."""
    from gotennet_tpu_torch.data.dataset import DenseLoader, ELLLoader
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_ell
    from gotennet_tpu_torch.tasks.force_task import MD22Task
    from gotennet_tpu_torch.train.trainer import accum_grads, make_loss_fn

    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, fused=False)
    task = MD22Task("x", {"mean": 0.0, "std": 1.0},
                    {"task_loss": "MSELoss"})
    ds = synthetic_molecules(4, seed=5, min_atoms=20, max_atoms=40,
                             box=5.0, with_forces=True)
    loader = (DenseLoader(ds, 2) if layout == "dense" else ELLLoader(ds, 2))
    grads, losses = [], []
    counters = (fused_gata_forward, fused_gata_backward,
                fused_ell.fused_ell_forward, fused_ell.fused_ell_backward)
    before = [c.launches for c in counters]
    for device in ("cuda", "cpu"):
        model = GotenModel(cfg, task.build_head(), layout, seed=4,
                           device=device)
        model.train()
        chunks = [b.to(device) for b in loader]
        losses.append(float(accum_grads(model, make_loss_fn(model, task),
                                        chunks)))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    assert [c.launches for c in counters] == before
    assert math.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    for name, want in grads[1].items():
        got = grads[0][name]
        assert torch.isfinite(got).all(), name
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * max(want.abs().max().item(), 1e-30), name


# ---- packed slabs and row-sharded blocks on the kernels ------------------------
def _hold_captured(kernel, plain, captured, tol):
    """Each captured call's kernel result against its plain version within
    ``tol`` of the scale, and a rerun of the first call giving the same
    bits."""
    assert captured
    with torch.inference_mode():
        for args, kwargs in captured:
            got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
            got = (got,) if isinstance(got, torch.Tensor) else got
            want = (want,) if isinstance(want, torch.Tensor) else want
            _close([g for g in got if g is not None],
                   [w for w in want if w is not None], tol)
    chip_smoke.rerun_bits(kernel, captured, kernel.__name__)


def test_packed_slabs_on_the_gata_kernels_match_plain(card):
    """A step of the fused dense model on packed slabs (several molecules a
    slab, the pairs between them masked through env_signed's sign): the
    GATA forward and backward kernels on the inputs the step gave them
    against their plain versions (float32: 1e-4 of the scale), reruns the
    same bits; the step's loss against the CPU's."""
    from gotennet_tpu_torch.graph.dense_batch import collate_dense_packed
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.tasks.qm9 import QM9Task
    from gotennet_tpu_torch.train.trainer import make_loss_fn
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, remat=False)
    mols = synthetic_molecules(24, seed=5, min_atoms=5,
                               max_atoms=14).graph_dicts(range(24))
    batch = collate_dense_packed(mols, 12, 32, 4)
    assert int(batch.graph_mask.sum()) == 24
    losses = []
    for device in ("cuda", "cpu"):
        model = GotenModel(cfg, HeadConfig(mean=0.5, stddev=2.0), "dense",
                           seed=1, device=device)
        model.train()
        loss_fn = make_loss_fn(model, QM9Task("U0", dataset_meta={
            "mean": 0.0, "std": 1.0}))
        b = batch.to(device)

        def step():
            loss = loss_fn(b)[0]
            loss.backward()
            losses.append(float(loss))

        if device == "cuda":
            fwd = chip_smoke.capture(fused_gata, "fused_gata_forward", step)
            bwd = chip_smoke.capture(fused_gata, "fused_gata_backward", step)
        else:
            step()
    assert len(fwd) == len(bwd) == cfg.n_interactions
    _hold_captured(fused_gata_forward, fused_gata_forward_reference, fwd,
                   1e-4)
    _hold_captured(fused_gata_backward, fused_gata_backward_reference, bwd,
                   1e-4)
    np.testing.assert_allclose(losses[0], losses[-1], rtol=1e-4)


def test_row_blocks_on_the_ell_kernels_match_plain(card, monkeypatch):
    """The ELL model's forward and backward on one rank's block of
    destination rows, NR = N / 2 over the whole N-row tables (the row
    sharding of edge_parallel=2, its all-reduce left out: one process
    here): all four ELL kernels on the inputs the model gave them against
    their plain versions (float32: 1e-4 of the scale), reruns the same
    bits."""
    from gotennet_tpu_torch.data.dataset import ELLLoader
    from gotennet_tpu_torch.models import gotennet_ell
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_ell, fused_htr

    class SecondHalf(gotennet_ell.RowShard):
        def __init__(self, axis, n_total):
            super().__init__(None, n_total)
            self.axis, self.n_rows = axis, n_total // 2
            self.start = self.n_rows

        def unshard(self, x):
            return torch.cat([x.new_zeros((self.start,) + x.shape[1:]), x])

    monkeypatch.setattr(gotennet_ell, "RowShard", SecondHalf)
    real_sum = gotennet_ell.segment_sum
    monkeypatch.setattr(gotennet_ell, "segment_sum",
                        lambda *a, psum_axis=None: real_sum(*a))
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16, fused_htr=True, remat=False,
                         edge_axis="edge")
    ds = synthetic_molecules(1, seed=9, min_atoms=600, max_atoms=700,
                             box=6.3)
    batch = next(iter(ELLLoader(ds, 1, spatial_sort=True,
                                block_rows=64))).to("cuda")
    model = GotenModel(cfg, HeadConfig(), "ell", seed=1)
    model.train()

    def step():
        model(batch)["property"].sum().backward()

    names = [(fused_ell, "fused_ell_forward", fused_ell_forward_reference),
             (fused_ell, "fused_ell_backward", fused_ell_backward_reference),
             (fused_htr, "fused_htr_ell_forward",
              fused_htr_ell_forward_reference),
             (fused_htr, "fused_htr_ell_backward",
              fused_htr_ell_backward_reference)]
    for module, name, plain in names:
        captured = chip_smoke.capture(module, name, step)
        N = batch.num_nodes
        assert captured[0][0][0].shape[0] == N // 2 < N
        _hold_captured(getattr(module, name), plain, captured, 1e-4)


# ---- scan_layers and the tools (chip_smoke.py phases 38 and 40) -------------
def test_scanned_dense_model_on_card_is_the_unrolled_one(card):
    """The MD22-sized model with ``scan_layers`` (rows 1-4), its weights
    from the stacked tree of the unrolled model's: a request launches the
    GATA and HTR forwards chunks x layers and chunks x (layers - 1) times,
    h and X are the unrolled model's bits, one step's losses the unrolled
    model's (float32: the same kernels in the same order)."""
    import dataclasses

    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.utils.convert import (jax_params_from_state_dict,
                                                  state_dict_from_jax_params)
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=3, lmax=2,
                         num_heads=8, n_rbf=16, fused_htr=True, remat=False)
    scfg = dataclasses.replace(cfg, scan_layers=True)
    head = HeadConfig(mean=0.5, stddev=2.0)
    mols = _md22_frames(8, seed=6)
    unrolled = Predictor(cfg, head, seed=2, chunk=4, bucket=False)
    tree = jax_params_from_state_dict(unrolled.model.state_dict(), scfg)
    kernel = tree["params"]["representation"]["layers"]["gata"]["W_q"][
        "linear"]["kernel"]
    assert kernel.shape == (2, 64, 64)
    state = state_dict_from_jax_params(tree, scfg, head)
    scanned = Predictor(scfg, head, state, chunk=4, bucket=False)
    n_gata, n_htr = (fused_gata.fused_gata_forward.launches,
                     fused_htr_forward.launches)
    got = scanned.predict(mols)
    assert fused_gata.fused_gata_forward.launches == n_gata + 2 * 3
    assert fused_htr_forward.launches == n_htr + 2 * 2
    np.testing.assert_allclose(got, unrolled.predict(mols), rtol=1e-5)
    with torch.inference_mode():
        for _, b in scanned.loader(scanned._request(mols)).batches():
            b = b.to("cuda")
            u, s = unrolled.model(b), scanned.model(b)
            for key in ("representation", "vector_representation"):
                assert torch.equal(u[key], s[key]), key
    steps = [train_steps(c, head, mols, 2, chunk=4, seed=3, bucket=False,
                         state_dict=state) for c in (cfg, scfg)]
    np.testing.assert_allclose(steps[1], steps[0], rtol=1e-5)
    model = GotenModel(scfg, head, "dense", seed=7)
    model.load_state_dict(state)
    for key, value in unrolled.model.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key


def test_tools_on_card(card):
    """``profile_fn`` sees the request's kernels on the device (its total
    within 10 % of the profiler's device time taken by chip_smoke's
    helper), ``radius_graph`` on the card gives the CPU's arrays, and
    ``multichip_bench`` at world size 1 gives the three modes' records."""
    from gotennet_tpu_torch.graph.neighborlist import radius_graph
    from gotennet_tpu_torch.utils.bench_multichip import MODES, multichip_bench
    from gotennet_tpu_torch.utils.profiling import profile_fn
    cfg = GotenNetConfig(n_atom_basis=64, n_interactions=2, lmax=2,
                         num_heads=8, n_rbf=16)
    pred = Predictor(cfg, HeadConfig(), seed=1, chunk=4, bucket=False)
    mols = _md22_frames(8, seed=7)
    pred.predict(mols)
    summary = profile_fn(lambda: pred.predict(mols), print_summary=False)
    ops = chip_smoke.device_ops(lambda: pred.predict(mols))
    busy_us = sum(e.self_device_time_total for e in ops)
    assert summary["by_category_us"]["CUDA kernels"] > 0
    assert abs(summary["total_us"] - busy_us) <= 0.1 * busy_us
    assert summary["top_ops"] and all(op["us"] > 0
                                      for op in summary["top_ops"])
    ds = synthetic_molecules(6, seed=3, min_atoms=12, max_atoms=29)
    pos = torch.from_numpy(np.concatenate(
        [np.asarray(p, np.float32) for p in ds.pos]))
    graph = torch.cat([torch.full((len(p),), g, dtype=torch.int32)
                       for g, p in enumerate(ds.pos)])
    mask = torch.ones(len(pos), dtype=torch.bool)
    mask[-3:] = False
    for loop in (True, False):
        got = radius_graph(pos.cuda(), graph.cuda(), mask.cuda(), 5.0, 16,
                           loop)
        want = radius_graph(pos, graph, mask, 5.0, 16, loop)
        assert got[0].is_cuda
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    records = multichip_bench(cfg=cfg, steps=1, batch_size=4)
    assert [r["mode"] for r in records] == list(MODES)
    assert all(r["n_devices"] == 1 and r["step_ms"] > 0 for r in records)
