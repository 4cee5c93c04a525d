"""The port's CUDA kernel on the card, against its plain PyTorch version.

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

from gotennet_tpu_torch.data.dataset import synthetic_molecules
from gotennet_tpu_torch.models.gotennet import GotenNetConfig
from gotennet_tpu_torch.models.model import HeadConfig
from gotennet_tpu_torch.ops import fused_gata
from gotennet_tpu_torch.ops.fused_gata import (fused_gata_forward,
                                               fused_gata_forward_reference)
from gotennet_tpu_torch.serve import Predictor

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
