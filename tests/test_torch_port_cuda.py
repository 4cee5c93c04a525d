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


# The backward: float32 sums in another order (and without atomics, in a
# fixed one) -> 1e-4 of each cotangent's scale in float32; a bf16 pair
# type may move a rounded pair term by one ulp -> 1e-2.
@pytest.mark.parametrize("M,D,H,lmax,sep,head_scale,pd", [
    (8, 32, 4, 2, (True, True), False, torch.float32),
    (24, 64, 8, 2, (False, False), True, torch.float32),
    (16, 96, 8, 3, (True, False), True, torch.bfloat16),
    (32, 256, 8, 2, (True, True), False, torch.bfloat16),
    (112, 64, 8, 2, (True, True), True, torch.float32),
])
def test_backward_kernel_matches_plain(card, M, D, H, lmax, sep, head_scale,
                                       pd):
    G = 3
    args = inputs(card, G, M, D, H, lmax, *sep, head_scale, pd, seed=1)
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


# The backward with position cotangents (forces): tolerances as above; two
# runs give the same bits, padded atoms and invalid pairs exact zeros.
@pytest.mark.parametrize("M,D,H,lmax,sep,head_scale,pd", [
    (8, 32, 4, 2, (True, True), False, torch.float32),
    (24, 64, 8, 3, (False, False), True, torch.bfloat16),
    (120, 256, 8, 2, (True, True), False, torch.bfloat16),
])
def test_backward_kernel_position_cotangents_match_plain(
        card, M, D, H, lmax, sep, head_scale, pd):
    G = 2
    args = inputs(card, G, M, D, H, lmax, *sep, head_scale, pd, seed=2)
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
                         num_heads=8, n_rbf=16)
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
                         num_heads=8, n_rbf=16, fused_htr=True)
    head = HeadConfig(mean=0.5, stddev=2.0)
    mols = _md22_frames(8, seed=5)
    n_fwd, n_bwd = fused_htr_forward.launches, fused_htr_backward.launches
    got = train_steps(cfg, head, mols, 2, chunk=4, seed=1, bucket=False)
    assert fused_htr_forward.launches == n_fwd + 2 * 2
    assert fused_htr_backward.launches == n_bwd + 2 * 2
    want = train_steps(cfg, head, mols, 2, chunk=4, seed=1, bucket=False,
                       device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)


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
                         num_heads=8, n_rbf=16, fused_htr=True)
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
