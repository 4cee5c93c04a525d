"""The backward kernels' product and column sums alone, built for the host.

``chip_smoke.PRODUCT_SOURCE`` is a plain C wrapper around the product and
the column sums of ``csrc/bwd_sums.cuh`` (the code every backward kernel
of the port shares).  Here it is written into a temporary directory and
built with g++ (one fiber per CUDA thread, as the other host builds of
the CUDA sources), then held against torch products of the same
factors, rounded to bf16 for a bf16 pair type, over ragged shapes, both
layouts of each factor, ``accumulate``, ``bias``, ``round_out`` and the
split over pairs that forms the weight gradients.  The host build of the
tensor-core product forms the same exact products of bf16 factors, so only
the order of the float32 sums differs.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from gotennet_tpu_torch.ops import _build

from test_torch_port_kernel import _CUDA_BF16_H, _CUDA_RUNTIME_H


@pytest.fixture(scope="module")
def host_products(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the CUDA source")
    d = tmp_path_factory.mktemp("products_on_host")
    (d / "cuda_runtime.h").write_text(_CUDA_RUNTIME_H)
    (d / "cuda_bf16.h").write_text(_CUDA_BF16_H)
    src = chip_smoke.PRODUCT_SOURCE
    assert src.count(chip_smoke.PRODUCT_LAUNCH) == 1
    (d / "k.cpp").write_text(src.replace(
        chip_smoke.PRODUCT_LAUNCH,
        "host_launch(kern, grid, kThreads, args); (void)stream; (void)smem;"))
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{d}",
                    f"-I{_build.CSRC}", "-o", str(d / "libp.so"),
                    str(d / "k.cpp")], check=True,
                   capture_output=True)
    return chip_smoke.declare_products(ctypes.CDLL(str(d / "libp.so")))


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _factor(x, rows_contiguous):
    """``x`` [r, c] as a view of that shape whose memory is either
    row-major or column-major (a transposed contiguous tensor)."""
    return x.t().contiguous().t() if rows_contiguous else x.contiguous()


# (pair type, rows, cols, depth, A's storage, A rows contiguous (a_sm == 1),
#  B rows contiguous (b_sn == 1), bias, accumulate, round_out, over pairs)
CASES = [
    ("bf16", 200, 32, 48, torch.float32, False, True, False, False, False,
     False),
    ("bf16", 200, 160, 300, torch.bfloat16, False, False, True, False, True,
     False),
    ("bf16", 200, 160, 300, torch.float32, True, True, False, True, False,
     False),
    ("bf16", 131, 40, 77, torch.float32, True, False, True, True, True,
     False),
    # weight gradients: t^T g over pairs, several splits
    ("bf16", 48, 160, 2000, torch.float32, True, True, False, False, False,
     True),
    ("bf16", 32, 32, 1100, torch.bfloat16, True, True, False, False, False,
     True),
    ("f32", 200, 160, 300, torch.float32, False, False, True, True, False,
     False),
    ("f32", 200, 32, 48, torch.bfloat16, True, True, False, False, True,
     False),
    ("f32", 48, 160, 2000, torch.float32, True, True, False, False, False,
     True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) for x in c[:4]) + ("-pairs" if c[-1] else ""))
def test_product_on_host_matches_torch(host_products, case):
    (pd, rows, cols, depth, a_dtype, a_rc, b_rc, with_bias, accumulate,
     round_out, over_pairs) = case
    rng = np.random.default_rng(rows * 7 + cols + depth)
    A = _factor(_rand(rng, rows, depth).to(a_dtype), a_rc)
    B = _factor(_rand(rng, depth, cols), not b_rc)
    assert (A.stride(0) == 1) == a_rc and (B.stride(1) == 1) == b_rc
    bias = _rand(rng, cols) if with_bias else None
    init = _rand(rng, rows, cols)
    bf16 = pd == "bf16"

    def rounded(x):
        return (x.to(torch.bfloat16) if bf16 else x).double()

    want = rounded(A) @ rounded(B)
    if bias is not None:
        want = want + bias.double()
    if round_out and bf16:
        want = want.float().to(torch.bfloat16).double()
    part = want
    if accumulate:
        want = want + init.double()
    runs = []
    for _ in range(2):
        out = init.clone()
        chip_smoke.run_product(host_products, A, B, out, bias=bias,
                               accumulate=accumulate, round_out=round_out,
                               over_pairs=over_pairs, bf16=bf16)
        runs.append(out)
    # exact products of the rounded factors, float32 sums in another order
    # -> 1e-5 of the scale; a rounded output may land on the neighbouring
    # bf16 value -> one bf16 ulp of the value more (2^(e - 8) for a value
    # in [2^(e-1), 2^e))
    err = (runs[0].double() - want).abs()
    slack = 1e-5 * want.abs().max()
    if round_out and bf16:
        slack = slack + torch.ldexp(torch.ones_like(part),
                                    torch.frexp(part).exponent - 8)
    assert bool((err <= slack).all()), float(err.max())
    assert runs[0].numpy().tobytes() == runs[1].numpy().tobytes()


@pytest.mark.parametrize("rows,cols", [(2000, 160), (300, 32), (5, 300)])
def test_column_sums_on_host_match_torch(host_products, rows, cols):
    x = _rand(np.random.default_rng(rows + cols), rows, cols)
    got = [torch.full((cols,), float("nan")) for _ in range(2)]
    for out in got:
        chip_smoke.run_column_sums(host_products, x, out)
    want = x.double().sum(dim=0)
    assert float((got[0].double() - want).abs().max()) <= (
        1e-5 * float(want.abs().max()))
    assert got[0].numpy().tobytes() == got[1].numpy().tobytes()
