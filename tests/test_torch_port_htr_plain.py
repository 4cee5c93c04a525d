"""The plain HTR update's pair terms (``models.gotennet_dense.htr_terms``)
against the per-component form they replace.

``htr_terms`` forms ``w_ij = sum_l [S_l - pq_l * pk_l * (2 - |r_l|^2)]`` as
batched products over the spherical components; ``per_component_terms``
below keeps the broadcast multiply-add over each component m, the form the
JAX package writes (gotennet_dense.py ``pair_terms``), as the reference
formula.  Both take the same ``EQ``, ``EK`` and ``rl_ij`` (from the pair
geometry of real batches: padded atoms, and packed slabs with ``seg``),
over ``sep_htr`` on and off, ``rej`` and ``norej``, the four gates of
``update_tail`` and M in {8, 16, 24}.  Float32 holds at 1e-6 of each
output's scale (the same sums in another order), bf16 at 2e-2 (the
contraction rounds each output once, the per-component form after each
product and add).  The first derivatives with respect to t, EQ, EK and rl
hold likewise, the bf16 ones against the per-component form at float32:
two bf16 forms differ by both their roundings, and either one's largest
error in rl's derivative reaches 1.4-2.0 % of its scale at 16 channels
(0.9-1.8 % at 64, the width these tests take).  ``gradgradcheck`` at
float64 keeps force training's double backward exact.  This file imports
nothing of JAX.
"""

import pytest
import torch

from gotennet_tpu_torch.data.dataset import synthetic_molecules
from gotennet_tpu_torch.graph.dense_batch import (collate_dense,
                                                  collate_dense_packed)
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.gotennet_dense import (GATADense, htr_terms,
                                                      pair_geometry)
from gotennet_tpu_torch.nn.dense import Dense
from gotennet_tpu_torch.ops.spherical import (degree_slices,
                                              spherical_harmonics)

LMAX = 2
TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
GATES = {"none": "", "gated": "gated", "gatedt": "gatedt", "act": "act"}


def per_component_terms(EQ, EK, rl_ij, lmax, sep_htr, rej, pair_dtype):
    """``w_ij`` as one broadcast multiply-add a component: the reference
    formula."""
    def block(lo, hi):
        eq = EQ[..., lo:hi, :].to(pair_dtype)
        ek = EK[..., lo:hi, :].to(pair_dtype)
        S = pq = pk = 0.0
        for m in range(hi - lo):
            eq_m = eq[:, :, None, m, :]        # [G, i, 1, E]
            ek_m = ek[:, None, :, m, :]        # [G, 1, j, E]
            S = S + eq_m * ek_m
            if rej:
                r_m = rl_ij[..., lo + m:lo + m + 1].to(pair_dtype)
                pq = pq + eq_m * r_m
                pk = pk + ek_m * r_m
        if not rej:
            return S
        r2 = torch.sum(rl_ij[..., lo:hi] ** 2, dim=-1)[..., None]
        return S - pq * pk * (2.0 - r2.to(pair_dtype))

    if sep_htr:
        return sum(block(lo, hi) for lo, hi in degree_slices(lmax))
    return block(0, rl_ij.shape[-1])


def pair_inputs(M, packed=False, seed=0, dtype=torch.float32, E=16):
    """``EQ``, ``EK [G, M, L, E]``, ``rl_ij [G, M, M, L]`` and
    ``t [G, M, M, E]``: the geometry of synthetic molecules of 3 to M - 1
    atoms (padded slots in every graph), or two a slab under ``seg``."""
    top = M // 2 if packed else M - 1
    ds = synthetic_molecules(4, seed=seed, min_atoms=3, max_atoms=top)
    graphs = [{"z": ds.z[i], "pos": ds.pos[i]} for i in range(4)]
    batch = (collate_dense_packed(graphs, 2, M, 2) if packed
             else collate_dense(graphs, 4, M))
    pos = torch.as_tensor(batch.pos)
    seg = None if batch.seg is None else torch.as_tensor(batch.seg)
    geo = pair_geometry(pos, torch.as_tensor(batch.mask), 5.0, None, seg)
    rl = spherical_harmonics(geo.vec_n, LMAX).contiguous().to(dtype)
    G, L = pos.shape[0], rl.shape[-1]
    gen = torch.Generator().manual_seed(seed + 1)

    def rand(*shape):
        return (torch.randn(*shape, generator=gen) * 0.5).to(dtype)

    return rand(G, M, L, E), rand(G, M, L, E), rl, rand(G, M, M, E)


def assert_scaled(got, want, tol, what):
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [8, 16, 24])
@pytest.mark.parametrize("rej", [True, False], ids=["rej", "norej"])
@pytest.mark.parametrize("sep_htr", [True, False], ids=["sep", "joint"])
def test_terms_match_the_per_component_form(sep_htr, rej, M, dtype):
    EQ, EK, rl, _ = pair_inputs(M, seed=M)
    got = htr_terms(EQ, EK, rl, LMAX, sep_htr, rej, dtype)
    want = per_component_terms(EQ, EK, rl, LMAX, sep_htr, rej, dtype)
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    assert_scaled(got, want, TOL[dtype], "w_ij")


def _layer(gate, rej, E):
    parts = [p for p in (gate, "" if rej else "norej") if p]
    cfg = GotenNetConfig(n_atom_basis=E, n_interactions=2, lmax=LMAX,
                         num_heads=2, n_rbf=8, fused=False,
                         edge_updates="_".join(parts) or True)
    layer = GATADense(cfg)
    gen = torch.Generator().manual_seed(0)
    for m in layer.modules():
        if isinstance(m, Dense):
            m.reset_parameters(gen)
    return layer


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout,M,rej", [("padded", 16, True),
                                          ("packed", 16, True),
                                          ("padded", 24, False)])
@pytest.mark.parametrize("gate", list(GATES))
def test_update_and_its_derivatives_match(gate, layout, M, rej, dtype):
    """The whole update, ``update_tail(t, w_ij)``, and its first
    derivatives with respect to t, EQ, EK and rl."""
    layer = _layer(GATES[gate], rej, E=64)
    EQ, EK, rl, t = pair_inputs(M, packed=layout == "packed", seed=3, E=64)
    g_out = torch.randn(t.shape, generator=torch.Generator().manual_seed(9))
    outs = []
    for terms, pd in ((htr_terms, dtype),
                      (per_component_terms, torch.float32)):
        leaves = [x.clone().requires_grad_() for x in (t, EQ, EK, rl)]
        out = layer.update_tail(leaves[0], terms(*leaves[1:], LMAX, True,
                                                 rej, pd))
        # norej: rl takes no part
        grads = torch.autograd.grad(out, leaves, g_out, allow_unused=not rej)
        outs.append((out.detach(), *grads))
    for what, got, want in zip(("out", "g_t", "g_EQ", "g_EK", "g_rl"),
                               *outs):
        if what == "g_rl" and not rej:
            assert got is None and want is None
        else:
            assert_scaled(got, want, TOL[dtype], what)


@pytest.mark.parametrize("rej", [True, False], ids=["rej", "norej"])
@pytest.mark.parametrize("sep_htr", [True, False], ids=["sep", "joint"])
def test_terms_gradgradcheck_float64(sep_htr, rej):
    EQ, EK, rl, _ = pair_inputs(4, seed=5, dtype=torch.float64, E=2)
    leaves = [x[:1].clone().requires_grad_() for x in (EQ, EK, rl)]

    def terms(eq, ek, r):
        return htr_terms(eq, ek, r, LMAX, sep_htr, rej, torch.float64)
    assert torch.autograd.gradcheck(terms, leaves)
    assert torch.autograd.gradgradcheck(terms, leaves)
