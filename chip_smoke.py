#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it gives.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, in order; any failure exits non-zero before the result line:
  1. device: the card's name and power limit; build the CUDA kernels
     from ``gotennet_tpu_torch/csrc`` (one nvcc per source, all started
     together) and print the ``-Xptxas -v`` summary;
  2. kernel vs plain: the fused-GATA forward kernel against its plain
     PyTorch version at the flagship shapes (G=8, D=256, H=8, lmax 2,
     mult 5), M in {16, 24, 32}, float32 and bf16 pair types, padded
     atoms, scalar and per-head scale, the same bits from a second run;
  3. serving: the flagship QM9 model (256 channels, 4 interactions, lmax
     2, 64 RBFs, 8 heads, bf16 pair/node types, merge_proj, Atomwise U0
     head) from a seeded init answers three requests of 1, 37 and 256
     synthetic QM9-sized molecules through ``Predictor``; the kernel's
     launch counter must equal chunks x 4 layers; each answer is held
     against the same model run through the plain version on the card;
  4. timing: the 256-molecule request (CUDA events, after warm-up), real
     edges per second, the device's busy share of that request (one more
     request under ``torch.profiler``), and the kernel's time per launch on
     the inputs the request gave it, held against the plain version and
     timed beside it and beside its bound;
  5. backward kernel vs plain: the fused-GATA backward kernel against its
     plain PyTorch version at the training shapes (G=16, D=256, H=8, lmax
     2, mult 5), M in {16, 24, 32}, float32 and bf16 pair types, scalar and
     per-head scale, padded atoms (whose cotangents must be exact zeros),
     the same bits from a second run;
  6. training: ``train_steps`` takes one step of the flagship model on 256
     synthetic QM9-sized molecules in 16-graph accumulation chunks; both
     kernels' launch counters must equal chunks x 4 layers.  The first
     step's gradients are held against the same step with the backward's
     plain version; three steps are timed after two warm-up steps (CUDA
     events), with real edges per second, the device's busy share of a step
     (``torch.profiler``) and the backward kernel's time per launch on the
     inputs a step gave it, beside its plain version and its bound;
  7. HTR forward kernel vs plain: the fused-HTR forward against its plain
     PyTorch version at G=4, D=256, lmax 2, sep_htr, M in {16, 32, 112,
     120}, float32 and bf16 pair types, bf16 EQ/EK, the flagship grammar and
     the sigmoid-gated variant (every pair compared, padded ones included);
  8. HTR backward kernel vs plain: the same grid, all six cotangents, with
     exact zeros where the cotangent of out is zero (padded atoms), the
     same bits from a second run;
  9. GATA kernels at M = 112 and 120: forward and backward against their
     plain versions at the MD22 chunk's shapes (G=4), each run twice (the
     same bits);
 10. MD22 serving: the flagship model with ``fused_htr=True`` answers 32
     synthetic MD22-sized frames (110-120 atoms at condensed-phase density)
     through ``Predictor`` in unbucketed 4-frame chunks (M = 120); the launch
     counters must read 8 chunks x 4 layers of GATA and x 3 of HTR; the
     answers are held against the same model run through both forward plain
     versions; the request is timed (CUDA events) and profiled, and the HTR
     forward kernel timed on the inputs the request gave it;
 11. MD22 training: ``train_steps`` takes one step on the same 32 frames
     (4-frame chunks, unbucketed): 32 GATA and 24 HTR launches each way; the
     first step's gradients are held against the same step through both
     backward plain versions; three steps are timed after two warm-up steps,
     profiled, and the HTR backward kernel timed on a step's inputs and
     split per pass (``[passes]``);
 12. ELL message kernel vs plain: the fused ELL forward against its plain
     PyTorch version at N = 704 rows, K = 36 slots, D = 256, H = 8, lmax 2,
     float32 and bf16 pair types, scalar and per-head scale, a third of the
     slots and the last 8 rows padded, and a case with fewer rows than
     table rows; the same bits from a second run;
 13. ELL HTR kernel vs plain: the same shapes, the flagship grammar and the
     sigmoid-gated variant, float32 and bf16 (every slot compared);
 14. ELL serving: the flagship model with ``fused_htr=True`` answers 8
     synthetic frames of 600-700 atoms at condensed-phase density
     (``bench.py``'s ``BENCH_DATASET=large``) through
     ``Predictor(layout="ell")``, one frame per chunk, atoms spatially sorted,
     64-row gather windows; the launch counters must read 8 chunks x 4
     layers of the message and x 3 of the HTR update; the answers are held
     against the same model run through both plain versions; the request is
     timed (CUDA events) and profiled, and both kernels timed on the inputs
     the request gave them, the message split per launch (``[passes]``: the
     bf16 weights and tables, then the message kernel);
 15. ELL message backward kernel vs plain: at phase 12's shapes and cases,
     all 13 cotangents, exact zeros for g_t, g_rl, g_env and g_scale at
     padded slots, and the same bits from a second run;
 16. ELL HTR backward kernel vs plain: phase 13's shapes and variants, all
     six cotangents, the same bits from a second run;
 17. ELL training: ``train_steps(layout="ell")`` takes one step on phase 14's
     8 frames, one per chunk: 32 ELL message and 24 ELL HTR launches each
     way; the first step's gradients are held against the same step through
     both backward plain versions; three steps are timed after two warm-up
     steps (CUDA events), with real edges per second, the device's busy share
     of a step (``torch.profiler``) and both backward kernels timed on the
     inputs a step gave them, beside their plain versions and bounds, and
     both split per pass (``[passes]``);
 18. GATA backward with position cotangents vs plain: ``pos_grads=True``
     (g_rl and g_env, the half forces need) at M 16/24/32 (G=16) and
     112/120 (G=4), float32 and bf16, scalar and per-head scale: all 13
     cotangents, exact zeros at padded atoms and invalid pairs, the same
     bits from a second run;
 19. MD22 forces: the flagship model with ``fused_htr=True`` and MD22Task's
     force head answers phase 10's 32 frames with energies and forces
     through ``Predictor.predict_with_forces`` (unbucketed 4-frame chunks):
     32 GATA forward and backward launches and 24 HTR forward and backward
     launches; energies and forces held against the same model through all
     four plain versions; a finite-difference check of the forces on one
     frame with float32 pair and node types; the request timed (CUDA events)
     and profiled, and the GATA backward timed on the request's own inputs
     beside its bound and plain version; both backwards split per pass;
 20. ELL forces: phase 14's 8 frames of 600-700 atoms, one per chunk,
     through ``predict_with_forces(layout="ell")``: 32 ELL message and 24
     ELL HTR launches each way, energies and forces held against the plain
     path, timed and profiled, the ELL HTR backward split per pass;
 21. the backward kernels' product alone: ``PRODUCT_SOURCE`` (the product
     and column sums of ``csrc/bwd_sums.cuh`` behind a plain C interface)
     at the MD22 chunk's 57,600 pairs and the ELL chunk's 25,344 slots, the
     six products of a message backward held against torch.matmul of the
     same bf16-rounded factors (and the column sums against a float64 sum),
     twice (the same bits), then timed beside torch.matmul of the same six
     bf16 products (a yardstick only: the port never calls it); and the
     yardsticks of every kernel's products: torch.matmul from bf16 factors
     of the message forwards' t W_re and t W_rs (57,600 pairs, each QM9
     request launch's pairs, 25,344 ELL slots), the HTR backwards' t W_g,
     g_z W_g^T and t^T g_z and the HTR forwards' t W_g (57,600 pairs and
     25,344 slots), each logged beside the kernel's own ms a launch.
The last three lines are the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from unittest import mock

import torch

G, D, H, LMAX, N_LAYERS, CHUNK = 8, 256, 8, 2, 4, 8
REQUESTS = (1, 37, 256)
TRAIN_MOLS, TRAIN_CHUNK, LR = 256, 16, 1e-4
# float32: the same arithmetic, sums in another order (and the card's
# expf) -> 1e-4 of each output's scale.  bf16 pair type: both versions
# round at the same points, but the kernel's tensor-core sums are taken in
# another order (and with the tensor cores' own adder), which can round a
# pair term to the neighbouring bf16 value (2^-8 relative) -> 1e-2 of the
# scale.  The served answers carry such flips through four layers -> 2e-2
# of the scale.
TOL_F32, TOL_BF16, TOL_SERVE = 1e-4, 1e-2, 2e-2
# A training step's gradients, backward kernel against its plain version:
# the same rounding points, float32 sums in another order; a bf16 value that
# lands on its neighbour in one layer's cotangents is carried back through
# the layers below it -> 2e-2 of each parameter's gradient scale.
TOL_TRAIN = 2e-2
# MD22-sized frames as bench.py's BENCH_DATASET=md22 makes them, in
# unbucketed 4-frame chunks (every chunk padded to M = 120)
MD22_FRAMES, MD22_CHUNK = 32, 4
MD22_SIZES = dict(min_atoms=110, max_atoms=120, box=6.3)
# 600-700-atom frames as bench.py's BENCH_DATASET=large makes them: one
# frame per chunk on the ELL layout (N = 704 rows, K = 36 slots)
LARGE_FRAMES, ELL_N, ELL_K = 8, 704, 36
LARGE_SIZES = dict(min_atoms=600, max_atoms=700, box=6.3)
# ms a launch of the kernels that phase 21's yardsticks are logged beside,
# by "kernel, path" (filled by the phases that time them)
KERNEL_MS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# The backward kernels' product and column sums (csrc/bwd_sums.cuh) alone,
# behind a plain C interface, so phase 21 and the host tests can hold them
# against torch.matmul; a measuring aid, not part of the port.
PRODUCT_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
constexpr int kThreads = 256;
}  // namespace

#include "bwd_sums.cuh"

namespace {
template <typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream) {
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}
}  // namespace

extern "C" long long gotennet_product_part_floats(long long depth, int rows,
                                                  int cols) {
  const long long w = (long long)pair_splits(depth, rows, cols) * rows * cols;
  const long long b = (long long)col_strips(depth, cols) * cols;
  return w > b ? w : b;
}

// out [rows, cols] (row stride cols) = A B (+ bias), A(m, k) = a[m * a_sm +
// k * a_sk], B(k, n) = b[k * b_sk + n * b_sn] (float or bf16 storage; a bf16
// pair type takes bf16 factors); over_pairs: split over the depth into
// `part`, as the weight gradients are formed
extern "C" int gotennet_product(const void* a, long long a_sm, long long a_sk,
                                int a_bf16, const void* b, long long b_sk,
                                long long b_sn, int b_bf16, float* out,
                                const float* bias, int rows, int cols,
                                int depth, int accumulate, int round_out,
                                int over_pairs, int pair_bf16, float* part,
                                void* stream) {
  Product g{};
  g.a = a; g.a_sm = a_sm; g.a_sk = a_sk; g.a_bf16 = a_bf16;
  g.b = b; g.b_sk = b_sk; g.b_sn = b_sn; g.b_bf16 = b_bf16;
  g.out = out; g.o_sm = cols; g.bias = bias;
  g.rows = rows; g.cols = cols; g.depth = depth;
  g.accumulate = accumulate; g.round_out = round_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (over_pairs) {
    return (int)(pair_bf16 ? product_over_pairs<true>(g, part, s)
                           : product_over_pairs<false>(g, part, s));
  }
  return (int)(pair_bf16 ? product<true>(g, s) : product<false>(g, s));
}

extern "C" int gotennet_column_sums(const float* x, int rows, int cols,
                                    float* part, float* out, void* stream) {
  return (int)column_sums(x, rows, cols, part, out,
                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""
# the one kernel-launch line of PRODUCT_SOURCE (a host build replaces it)
PRODUCT_LAUNCH = "kern<<<grid, kThreads, smem, stream>>>(args);"


def declare_products(lib):
    """Argument and result types of PRODUCT_SOURCE's C interface."""
    import ctypes
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gotennet_product_part_floats.argtypes = [i64, i32, i32]
    lib.gotennet_product_part_floats.restype = i64
    lib.gotennet_product.argtypes = ([ptr, i64, i64, i32, ptr, i64, i64, i32,
                                      ptr, ptr] + [i32] * 7 + [ptr, ptr])
    lib.gotennet_product.restype = i32
    lib.gotennet_column_sums.argtypes = [ptr, i32, i32, ptr, ptr, ptr]
    lib.gotennet_column_sums.restype = i32
    lib.gotennet_cuda_error_string.argtypes = [i32]
    lib.gotennet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_products():
    """PRODUCT_SOURCE built with nvcc beside the kernels (``build/``), as
    the kernels are built; the loaded library."""
    import ctypes
    from gotennet_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "product_check.cu"
    src.write_text(PRODUCT_SOURCE)
    lib = _build.BUILD_DIR / "libproduct_check.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True, timeout=600)
    return declare_products(ctypes.CDLL(str(lib)))


def _raise_on(lib, err, what) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.gotennet_cuda_error_string(err).decode()})")


def run_product(lib, A, B, out, *, bias=None, accumulate=False,
                round_out=False, over_pairs=False, bf16=True, stream=None):
    """out [rows, cols] (=, or += with ``accumulate``) = A B (+ bias) through
    PRODUCT_SOURCE: A a [rows, depth] view, B a [depth, cols] view, each
    row-major or column-major (a transposed view reads its tensor across the
    leading axis); with ``bf16`` both factors are rounded to bf16 first (as
    the backward kernels keep bf16 copies of their factors), with their
    layouts kept."""
    bf = torch.bfloat16
    if bf16:
        A, B = (x if x.dtype == bf else (x.to(bf) if x.is_contiguous()
                                         else x.t().to(bf).t())
                for x in (A, B))
    rows, depth = A.shape
    cols = B.shape[1]
    part = torch.empty(max(1, lib.gotennet_product_part_floats(depth, rows,
                                                               cols)),
                       dtype=torch.float32, device=out.device)
    err = lib.gotennet_product(
        A.data_ptr(), A.stride(0), A.stride(1), int(A.dtype == bf),
        B.data_ptr(), B.stride(0), B.stride(1), int(B.dtype == bf),
        out.data_ptr(),
        bias.data_ptr() if bias is not None else None, rows, cols, depth,
        int(accumulate), int(round_out), int(over_pairs), int(bf16),
        part.data_ptr(), stream)
    _raise_on(lib, err, "product")


def run_column_sums(lib, x, out, stream=None):
    """out [cols] = the sum over the rows of x [rows, cols] through
    PRODUCT_SOURCE's column sums."""
    rows, cols = x.shape
    part = torch.empty(max(1, lib.gotennet_product_part_floats(rows, 1,
                                                               cols)),
                       dtype=torch.float32, device=x.device)
    _raise_on(lib, lib.gotennet_column_sums(x.data_ptr(), rows, cols,
                                            part.data_ptr(), out.data_ptr(),
                                            stream), "column sums")


def backward_products(P, seed, device="cuda"):
    """The six pair products of a message backward at P pairs (flagship D
    and C = 5 D) on seeded factors: a list of (name, steps) where each step
    (A, B, bias, round_out, accumulate, over_pairs) adds into one output,
    as fused_gata_bwd.cu and fused_ell_bwd.cu chain them; and the bias
    gradients' column-sum inputs."""
    gen = torch.Generator().manual_seed(seed)
    C = (1 + 2 * LMAX) * D

    def rand(*s):
        return (torch.randn(s, generator=gen) * 0.3).to(device)

    t, g_tf, g_z = rand(P, D), rand(P, C), rand(P, D)
    W_rs, W_re, b_rs, b_re = rand(D, C), rand(D, D), rand(C), rand(D)
    prods = [("t W_rs + b_rs", [(t, W_rs, b_rs, True, False, False)]),
             ("t W_re + b_re", [(t, W_re, b_re, False, False, False)]),
             ("g_tf W_rs^T + g_zre W_re^T",
              [(g_tf, W_rs.t(), None, False, False, False),
               (g_z, W_re.t(), None, False, True, False)]),
             ("t^T g_tf", [(t.t(), g_tf, None, False, False, True)]),
             ("t^T g_zre", [(t.t(), g_z, None, False, False, True)])]
    return prods, (g_tf, g_z)


def hold_products(lib, P, seed) -> list:
    """The product and the column sums of PRODUCT_SOURCE against
    torch.matmul (float32, no TF32) of the same bf16-rounded factors at P
    pairs, each run twice (the same bits); returns (name, max abs err, rel
    err) of each.  Exact products, float32 sums in another order -> 1e-5 of
    the scale; a rounded output may land on the neighbouring bf16 value ->
    one ulp of it more."""
    stream = torch.cuda.current_stream().cuda_stream
    prods, sums = backward_products(P, seed)
    rows = []
    for name, steps in prods:
        runs, want = [], None
        for _ in range(2):
            out = torch.empty(steps[0][0].shape[0], steps[0][1].shape[1],
                              device="cuda")
            for A, B, bias, round_out, accumulate, over_pairs in steps:
                run_product(lib, A, B, out, bias=bias, round_out=round_out,
                            accumulate=accumulate, over_pairs=over_pairs,
                            stream=stream)
            runs.append(out)
        slack = 0.0
        for A, B, bias, round_out, _, _ in steps:
            w = (A.to(torch.bfloat16).float() @ B.to(torch.bfloat16).float())
            if bias is not None:
                w = w + bias
            if round_out:
                w = w.to(torch.bfloat16).float()
                slack = torch.ldexp(torch.ones_like(w),
                                    torch.frexp(w).exponent - 8)
            want = w if want is None else want + w
        torch.cuda.synchronize()
        err = (runs[0] - want).abs()
        scale = float(want.abs().max())
        if not bool((err <= 1e-5 * scale + slack).all()):
            raise AssertionError(f"product {name} at P={P} disagrees with "
                                 f"torch.matmul (max abs err "
                                 f"{float(err.max()):.3e})")
        if not same_bits(runs[0:1], runs[1:2]):
            raise AssertionError(f"product {name} differs between runs")
        rows.append((name, float(err.max()), float(err.max()) / scale))
    for name, x in zip(("column sums of g_tf", "column sums of g_zre"), sums):
        got = [torch.empty(x.shape[1], device="cuda") for _ in range(2)]
        for out in got:
            run_column_sums(lib, x, out, stream)
        want = x.double().sum(dim=0)
        err = float((got[0].double() - want).abs().max())
        rel = err / float(want.abs().max())
        if rel > 1e-5 or not same_bits(got[0:1], got[1:2]):
            raise AssertionError(f"{name} at P={P}: rel err {rel:.3e} or "
                                 "not the same bits twice")
        rows.append((name, err, rel))
    return rows


def products_phase(card) -> None:
    """Phase 21: the backward kernels' product alone (PRODUCT_SOURCE) at
    the MD22 chunk's pairs (P = 4 x 120 x 120) and the ELL chunk's slots
    (P = 704 x 36), held against torch.matmul; then the time of each of the six
    products through PRODUCT_SOURCE (from bf16 factors, as the backward
    kernels keep them) and of torch.matmul of the same six bf16 products (a
    yardstick for the products only: the port never calls it), each the
    mean of 10 runs between CUDA events after a warm-up."""
    lib = build_products()
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    for what, P in (("M=120", MD22_CHUNK * 120 * 120), ("ELL", ELL_N * ELL_K)):
        for name, err, rel in hold_products(lib, P, seed=900):
            log(f"[products] {what} P={P} {name}: max abs err {err:.3e} "
                f"(rel {rel:.3e}; tol 1e-5 rel + one bf16 ulp where rounded)")
        prods, _ = backward_products(P, seed=901)
        total = total_lib = flops = 0.0
        for name, steps in prods:
            steps = [(A.to(bf) if A.is_contiguous() else A.t().to(bf).t(),
                      B.to(bf) if B.is_contiguous() else B.t().to(bf).t(),
                      *rest) for A, B, *rest in steps]
            out = torch.empty(steps[0][0].shape[0], steps[0][1].shape[1],
                              device="cuda")

            def ours():
                for A, B, bias, ro, acc, op in steps:
                    run_product(lib, A, B, out, bias=bias, round_out=ro,
                                accumulate=acc, over_pairs=op, stream=stream)

            def library():
                for A, B, *_ in steps:
                    torch.matmul(A, B)

            f = sum(2.0 * A.shape[0] * A.shape[1] * B.shape[1]
                    for A, B, *_ in steps)
            ms, lib_ms = (time_calls(lambda _, fn=fn: fn(), [None], 10)
                          for fn in (ours, library))
            total, total_lib, flops = total + ms, total_lib + lib_ms, flops + f
            log(f"[products] {what} {name}: {ms:.4f} ms "
                f"({f / ms / 1e9:.1f} TFLOP/s); torch.matmul {lib_ms:.4f} ms "
                f"({f / lib_ms / 1e9:.1f} TFLOP/s) | {card}")
        log(f"[products] {what} P={P}: the six products {total:.4f} ms "
            f"({flops / total / 1e9:.1f} TFLOP/s, mma.sync bf16, partial sums "
            f"and bias included); torch.matmul of the same six bf16 products "
            f"(yardstick, not on the port's path) {total_lib:.4f} ms "
            f"({flops / total_lib / 1e9:.1f} TFLOP/s) | {card}")


def matmul_ms(shapes) -> float:
    """ms of torch.matmul of seeded bf16 factors, one call per (rows,
    depth, cols) in ``shapes`` (a transposed first factor as (depth, rows)
    with a negative rows), the mean of 10 passes between CUDA events."""
    gen = torch.Generator().manual_seed(902)
    pairs = []
    for rows, depth, cols in shapes:
        if rows < 0:   # the weight gradient's t^T: a [P, D] tensor read across P
            a = torch.randn(depth, -rows, generator=gen).t()
        else:
            a = torch.randn(rows, depth, generator=gen)
        pairs.append((a.to("cuda", torch.bfloat16), torch.randn(
            depth, cols, generator=gen).to("cuda", torch.bfloat16)))
    return time_calls(lambda _: [torch.matmul(a, b) for a, b in pairs],
                      [None], 10)


def yardsticks(card, qm9_shapes) -> None:
    """Phase 21, second half: torch.matmul of each kernel's products from
    bf16 factors, logged beside the kernel's own ms a launch (yardsticks
    only: the port never calls them).  The message forwards' two
    projections t W_re and t W_rs (row 1 at the MD22 chunk's 57,600 pairs
    and at the pairs of each launch of the 256-molecule QM9 request,
    ``qm9_shapes``, the shapes of t; row 5 at the ELL chunk's 25,344
    slots); the HTR backwards' three products t W_g, g_z W_g^T and t^T g_z
    (row 4 at 57,600 pairs, row 8 at 25,344 slots); the HTR forwards' t W_g
    (row 3 at 57,600 pairs, row 7 at 25,344 slots)."""
    C = (1 + 2 * LMAX) * D
    P = MD22_CHUNK * 120 * 120
    S = ELL_N * ELL_K
    rows = [("fused_gata_fwd, MD22 request", f"t W_re + t W_rs at P={P}",
             matmul_ms([(P, D, D), (P, D, C)]))]
    by_pairs = {}
    for shape in qm9_shapes:
        n = shape[0] * shape[1] * shape[2]
        by_pairs[n] = by_pairs.get(n, 0) + 1
    total = sum(matmul_ms([(n, D, D), (n, D, C)]) * k
                for n, k in by_pairs.items())
    rows.append(("fused_gata_fwd, QM9 request",
                 f"t W_re + t W_rs, mean over the {len(qm9_shapes)} launches "
                 f"(P {sorted(by_pairs)})", total / max(len(qm9_shapes), 1)))
    rows.append(("fused_ell_fwd, ELL request", f"t W_re + t W_rs at P={S}",
                 matmul_ms([(S, D, D), (S, D, C)])))
    for kernel, n in (("fused_htr_bwd, MD22 step", P),
                      ("fused_htr_ell_bwd, ELL step", S)):
        rows.append((kernel, f"t W_g + g_z W_g^T + t^T g_z at P={n}",
                     matmul_ms([(n, D, D), (n, D, D), (-D, n, D)])))
    for kernel, n in (("fused_htr_fwd, MD22 request", P),
                      ("fused_htr_ell_fwd, ELL request", S)):
        rows.append((kernel, f"t W_g at P={n}", matmul_ms([(n, D, D)])))
    for kernel, what, ms in rows:
        own = KERNEL_MS.get(kernel)
        log(f"[yardstick] {kernel}: torch.matmul of {what} from bf16 factors "
            f"{ms:.4f} ms (not on the port's path); the kernel "
            + (f"{own:.4f} ms a launch" if own is not None else "not timed")
            + f" | {card}")


def rel_err(got, want) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def kernel_inputs(M, pair_dtype, head_scale, seed, G=G):
    """Flagship-shape inputs on the card; graph 0 has 3 padded atoms."""
    gen = torch.Generator().manual_seed(seed)
    L = (LMAX + 1) ** 2 - 1
    C = (1 + 2 * LMAX) * D

    def rand(*s):
        return torch.randn(s, generator=gen) * 0.3

    valid = torch.rand(G, M, M, generator=gen) > 0.3
    valid[0, M - 3:, :] = False
    valid[0, :, M - 3:] = False
    env = torch.where(valid, torch.rand(G, M, M, generator=gen),
                      torch.tensor(-1.0))
    scale = (torch.rand(G, M, M, H, generator=gen) if head_scale
             else torch.full((G, M, M), 1.0 / math.sqrt(D)))
    nd = torch.bfloat16 if pair_dtype == torch.bfloat16 else torch.float32
    args = [rand(G, M, M, D), rand(G, M, D).to(nd), rand(G, M, D).to(nd),
            rand(G, M, C).to(nd), rand(G, M, C).to(nd), rand(G, M, M, L),
            rand(G, M, L, D), env, scale, rand(D, D), rand(D), rand(D, C),
            rand(C)]
    return [a.cuda() for a in args]


def bound_ms(n_bytes, flops, pair_dtype) -> tuple:
    """Least time an H100 SXM could take for one launch: the larger of
    ``n_bytes`` / 3.35 TB/s and ``flops`` / the pair type's peak (989
    TFLOP/s bf16, 67 TFLOP/s float32)."""
    peak = 989e12 if pair_dtype == torch.bfloat16 else 67e12
    t_bytes, t_ops = n_bytes / 3.35e12 * 1e3, flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def n_bytes(tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors)


def fwd_bound_ms(args, kwargs) -> tuple:
    """The GATA forward: each input read once, d_h and dX written once; the
    two projections t W_re and t W_rs, 2 D (D + mult D) FLOP per valid pair
    (invalid pairs add exact zeros)."""
    t, W_re, W_rs = args[0], args[9], args[11]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    Gg, M = t.shape[:2]
    L = args[5].shape[-1]
    n_out = (Gg * M * Dd + Gg * M * L * Dd) * 4
    valid = int((args[7] >= 0).sum())
    return bound_ms(n_bytes(args) + n_out, 2.0 * Dd * (Dd + C) * valid,
                    kwargs["pair_dtype"])


def bwd_bound_ms(args, kwargs) -> tuple:
    """The GATA backward: each input read once, the 11 cotangents it
    computes written once (float32; 13 with ``pos_grads``: g_rl and g_env
    too); six projections (t W_rs and t W_re recomputed, g_tf W_rs^T, g_zre
    W_re^T, t^T g_tf, t^T g_zre), 6 D (mult D + D) FLOP per valid pair (the
    position sums add ~2 mult D per pair, left out)."""
    t, scale, W_re, W_rs = args[0], args[8], args[9], args[11]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    Gg, M = t.shape[:2]
    L = args[5].shape[-1]
    n_out = 4 * (Gg * M * M * Dd + 2 * Gg * M * Dd + 2 * Gg * M * C
                 + Gg * M * L * Dd + scale.numel() + Dd * Dd + Dd + Dd * C
                 + C)
    if kwargs.get("pos_grads"):
        n_out += 4 * (Gg * M * M * L + Gg * M * M)
    valid = int((args[7] >= 0).sum())
    return bound_ms(n_bytes(args) + n_out, 6.0 * Dd * (C + Dd) * valid,
                    kwargs["pair_dtype"])


def htr_fwd_bound_ms(args, kwargs) -> tuple:
    """The HTR forward: t, EQ, EK, rl, W_g, b_g read once, out (float32)
    written once; the projection t W_g, 2 D^2 FLOP per pair, over every pair
    (the update masks none)."""
    t, W_g = args[0], args[4]
    pairs = t.numel() // t.shape[-1]
    return bound_ms(n_bytes(args) + 4 * t.numel(),
                    2.0 * W_g.numel() * pairs, kwargs["pair_dtype"])


def htr_bwd_bound_ms(args, kwargs) -> tuple:
    """The HTR backward: the six inputs and the cotangent of out read once,
    the six cotangents written once (float32); three projections (t W_g
    recomputed, g_z W_g^T, t^T g_z), 6 D^2 FLOP per pair, over every
    pair."""
    t, W_g = args[0], args[4]
    pairs = t.numel() // t.shape[-1]
    n_out = 4 * sum(a.numel() for a in args[:6])
    return bound_ms(n_bytes(args) + n_out, 6.0 * W_g.numel() * pairs,
                    kwargs["pair_dtype"])


def ell_fwd_bound_ms(args, kwargs) -> tuple:
    """The ELL message: each input read once (the node tables as tables),
    d_h and dX written once; the two projections t W_re and t W_rs,
    2 D (D + mult D) FLOP per valid slot (padded ones add exact zeros)."""
    t, W_re, W_rs = args[0], args[10], args[12]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    NR, L = t.shape[0], args[5].shape[-1]
    n_out = (NR * Dd + NR * L * Dd) * 4
    valid = int((args[7] >= 0).sum())
    return bound_ms(n_bytes(args) + n_out, 2.0 * Dd * (Dd + C) * valid,
                    kwargs["pair_dtype"])


def htr_ell_fwd_bound_ms(args, kwargs) -> tuple:
    """The ELL HTR update: t, EQ, EK (as a table), rl, nbr, W_g, b_g read
    once, out (float32) written once; the projection t W_g, 2 D^2 FLOP per
    slot, over every slot (the update masks none)."""
    t, W_g = args[0], args[5]
    pairs = t.numel() // t.shape[-1]
    return bound_ms(n_bytes(args) + 4 * t.numel(),
                    2.0 * W_g.numel() * pairs, kwargs["pair_dtype"])


def ell_bwd_bound_ms(args, kwargs) -> tuple:
    """The ELL message backward: each input read once (the node tables and
    the transposed slot list as tables), the 13 cotangents written once
    (float32); six projections (t W_rs and t W_re recomputed, g_tf W_rs^T,
    g_zre W_re^T, t^T g_tf, t^T g_zre), 6 D (mult D + D) FLOP per valid
    slot (padded ones add exact zeros)."""
    t, k, scale, W_re, W_rs = args[0], args[2], args[8], args[10], args[12]
    Dd, C = W_re.shape[0], W_rs.shape[1]
    NR, K = t.shape[:2]
    N, L = k.shape[0], args[5].shape[-1]
    n_out = 4 * (NR * K * Dd + NR * Dd + N * Dd + 2 * N * C + NR * K * L
                 + N * L * Dd + NR * K + scale.numel() + Dd * Dd + Dd
                 + Dd * C + C)
    n_in = n_bytes(args) + n_bytes(kwargs.get("slots") or ())
    valid = int((args[7] >= 0).sum())
    return bound_ms(n_in + n_out, 6.0 * Dd * (C + Dd) * valid,
                    kwargs["pair_dtype"])


def htr_ell_bwd_bound_ms(args, kwargs) -> tuple:
    """The ELL HTR backward: t, EQ, EK (as a table), rl, nbr, W_g, b_g, the
    cotangent of out and the transposed slot list read once, the six
    cotangents written once (float32); three projections (t W_g recomputed,
    g_z W_g^T, t^T g_z), 6 D^2 FLOP per slot, over every slot."""
    t, EQ, EK, rl, W_g = args[0], args[1], args[2], args[3], args[5]
    pairs = t.numel() // t.shape[-1]
    n_out = 4 * (t.numel() + EQ.numel() + EK.numel() + rl.numel()
                 + W_g.numel() + W_g.shape[0])
    n_in = n_bytes(args) + n_bytes(kwargs.get("slots") or ())
    return bound_ms(n_in + n_out, 6.0 * W_g.numel() * pairs,
                    kwargs["pair_dtype"])


def time_calls(fn, calls, reps) -> float:
    """Mean ms per call over ``reps`` passes through ``calls``."""
    for c in calls[:2]:
        fn(c)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for c in calls:
            fn(c)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def time_run(run, warmup, reps) -> tuple:
    """``run()`` ``warmup`` times, then ``reps`` times between CUDA events:
    (device ms per run, host ms per run, every run's result)."""
    results = [run() for _ in range(warmup)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    results += [run() for _ in range(reps)]
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    return start.elapsed_time(end) / reps, host_ms, results


def count_pairs(chunks, cfg) -> tuple:
    """(real edges, self-loops included, as the edge list counts them;
    padded pairs) of dense chunks on the card."""
    from gotennet_tpu_torch.models.gotennet_dense import pair_geometry
    real = sum(int(pair_geometry(b.pos, b.mask, cfg.cutoff,
                                 cfg.max_num_neighbors).pair_mask.sum())
               for b in chunks)
    return real, sum(b.num_graphs * b.max_atoms ** 2 for b in chunks)


def device_ops(run) -> list:
    """The device-side events of one ``run()`` under ``torch.profiler``
    (kernels and copies: an aten op's row would repeat its kernels' time),
    the most device time first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler
    torch.cuda.synchronize()
    with profiler(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)


def profile(run, wall_ms, what, card) -> None:
    """``run()`` once under ``torch.profiler``: the device time of its
    kernels and copies, as a share of ``wall_ms`` (its time without the
    profiler), and the device ops that took the most of it."""
    ops = device_ops(run)
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    if busy_ms == 0.0:
        log("[profile] device time not measured: the profiler saw no device "
            "events")
        return
    log(f"[profile] {what}: device busy {busy_ms:.3f} ms in "
        f"{sum(e.count for e in ops)} device ops, "
        f"{100 * busy_ms / wall_ms:.1f} % of the {wall_ms:.3f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %) | {card}")
    for e in ops[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d} x  {e.key[:80]}")


@torch.inference_mode()
def pass_split(kernel, captured, what, card) -> None:
    """The kernel's launches on a path's captured inputs once under
    ``torch.profiler``: device ms per launch of each of its passes (the CUDA
    kernels one launch runs), largest first."""
    for args, kwargs in captured[:2]:
        kernel(*args, **kwargs)
    ops = device_ops(lambda: [kernel(*a, **kw) for a, kw in captured])
    n = len(captured)
    total = sum(e.self_device_time_total for e in ops) / 1e3 / n
    log(f"[passes] {what}: {total:.4f} ms of device time a launch, over {n} "
        f"launches | {card}")
    for e in ops[:14]:
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        log(f"[passes]   {e.self_device_time_total / 1e3 / n:8.4f} ms "
            f"{e.count / n:5.1f} x  {name[:90]}")


def capture(module, name, run) -> list:
    """The arguments of every call of ``module.<name>`` while ``run()``
    runs (the calls still go to the kernel)."""
    kernel = getattr(module, name)
    captured = []

    def record(*args, **kwargs):
        captured.append((args, kwargs))
        return kernel(*args, **kwargs)

    with mock.patch.object(module, name, record):
        run()
    torch.cuda.synchronize()
    return captured


@torch.inference_mode()
def kernel_record(meta, captured, kernel, plain, bound, card) -> dict:
    """Hold the kernel against the plain version on each captured call, and
    time both per launch, grouped by the shape of t, beside
    ``bound(args, kwargs)``.
    (Weights captured while serving are inference tensors, so the replay
    runs in inference mode.)"""
    max_abs = 0.0
    for args, kwargs in captured:
        got = kernel(*args, **kwargs)
        want = plain(*args, **kwargs)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        for g_, w_ in zip(got, want):
            if g_ is None:
                continue
            err, rel = rel_err(g_, w_)
            max_abs = max(max_abs, err)
            if rel > TOL_BF16:
                raise AssertionError(f"{meta['name']} disagrees on the main "
                                     f"path's inputs (rel err {rel:.3e})")
    by_shape = {}
    for c in captured:
        by_shape.setdefault(tuple(c[0][0].shape), []).append(c)
    total_k = total_p = total_b = 0.0
    bound_kind = "operations"
    for shape in sorted(by_shape):
        calls = by_shape[shape]
        k_ms = time_calls(lambda c: kernel(*c[0], **c[1]), calls, 3)
        p_ms = time_calls(lambda c: plain(*c[0], **c[1]), calls, 1)
        bounds = [bound(*c) for c in calls]
        b_ms = sum(b for b, _ in bounds) / len(bounds)
        bound_kind = bounds[0][1]
        total_k += k_ms * len(calls)
        total_p += p_ms * len(calls)
        total_b += b_ms * len(calls)
        log(f"[time] {meta['name']} t{list(shape)}: {len(calls)} launches, "
            f"kernel {k_ms:.4f} ms/launch, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({bound_kind}) | {card}")
    n = len(captured)
    return {**meta, "launches": None, "max_abs_err": max_abs,
            "ms": total_k / n, "plain_ms": total_p / n,
            "bound_ms": total_b / n, "bound_by": bound_kind,
            "library_ms": None}


def check_gata_forward(M, pd, head_scale, G) -> None:
    """The GATA forward kernel against its plain version on one input;
    padded atoms must get exact zeros."""
    from gotennet_tpu_torch.ops import fused_gata
    kw = dict(lmax=LMAX, num_heads=H, sep_dir=True, sep_tensor=True,
              pair_dtype=pd, with_attn=True)
    args = kernel_inputs(M, pd, head_scale, seed=M, G=G)
    got = fused_gata.fused_gata_forward(*args, **kw)
    torch.cuda.synchronize()
    want = fused_gata.fused_gata_forward_reference(*args, **kw)
    tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    log(f"[kernel-vs-plain] G={G} M={M} pair={str(pd)[6:]} "
        f"head_scale={head_scale}: max abs / rel err "
        + ", ".join(f"{n} {a:.3e}/{r:.3e}" for n, (a, r)
                    in zip(("d_h", "dX", "sm"), errs))
        + f" (tol {tol:g} rel)")
    if not all(r <= tol for _, r in errs):
        raise AssertionError(f"kernel disagrees at M={M} {pd}")
    sm = got[2]
    if not (torch.all(sm[0, M - 3:] == 0)
            and torch.all(got[0][0, M - 3:] == 0)):
        raise AssertionError("padded atoms got weight")
    if not same_bits(got, fused_gata.fused_gata_forward(*args, **kw)):
        raise AssertionError("GATA forward differs between runs")


def check_gata_backward(M, pd, head_scale, G, pos_grads=False) -> None:
    """The GATA backward kernel against its plain version on one input;
    padded atoms' cotangents must be exact zeros, and a second run must give
    the same bits.  With ``pos_grads`` the position cotangents g_rl and
    g_env are compared too (exact zeros at padded atoms and invalid
    pairs)."""
    from gotennet_tpu_torch.ops import fused_gata
    kw = dict(lmax=LMAX, num_heads=H, sep_dir=True, sep_tensor=True,
              pair_dtype=pd)
    names = ("g_t", "g_q", "g_k", "g_xg", "g_v", "g_rl", "g_X", "g_env",
             "g_scale", "g_Wre", "g_bre", "g_Wrs", "g_brs")
    L = (LMAX + 1) ** 2 - 1
    args = kernel_inputs(M, pd, head_scale, seed=100 + M, G=G)
    _, _, sm = fused_gata.fused_gata_forward(*args, **kw, with_attn=True)
    gen = torch.Generator().manual_seed(M)
    g_dh = torch.randn(G, M, D, generator=gen).cuda()
    g_dX = torch.randn(G, M, L, D, generator=gen).cuda()
    kw["pos_grads"] = pos_grads
    got = fused_gata.fused_gata_backward(*args, sm, g_dh, g_dX, **kw)
    torch.cuda.synchronize()
    want = fused_gata.fused_gata_backward_reference(*args, sm, g_dh, g_dX,
                                                    **kw)
    tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    worst = max(range(len(errs)), key=lambda i: errs[i][1])
    log(f"[{'pos-' if pos_grads else ''}bwd-vs-plain] G={G} M={M} "
        f"pair={str(pd)[6:]} head_scale={head_scale}: max rel err "
        + ", ".join(f"{n} {r:.1e}" for n, (_, r) in zip(names, errs)
                    if pos_grads or n not in ("g_rl", "g_env"))
        + f" (worst {names[worst]}, abs {errs[worst][0]:.3e}; "
        f"tol {tol:g} rel)")
    if errs[worst][1] > tol:
        raise AssertionError(f"backward kernel disagrees at M={M} {pd} on "
                             f"{names[worst]}")
    # padded atoms (graph 0's last 3): exact zeros
    g_t, g_q, g_k, g_xg, g_v, _, g_X, _, g_scale = got[:9]
    pad = [a[0, M - 3:] for a in (g_t, g_q, g_k, g_xg, g_v, g_X, g_scale)]
    pad += [a[0, :, M - 3:] for a in (g_t, g_scale)]
    if pos_grads:
        pad += [got[5][0, M - 3:], got[5][0, :, M - 3:], got[7][args[7] < 0]]
    if not all(bool(torch.all(a == 0)) for a in pad):
        raise AssertionError("padded atoms got a cotangent")
    if not same_bits(
            got, fused_gata.fused_gata_backward(*args, sm, g_dh, g_dX, **kw)):
        raise AssertionError("GATA backward differs between runs")


HTR_NAMES = ("g_t", "g_EQ", "g_EK", "g_rl", "g_W_g", "g_b_g")


def htr_inputs(M, seed, G=MD22_CHUNK):
    """HTR inputs at the MD22 path's types (t, rl, W_g, b_g float32; EQ, EK
    bf16) and a cotangent of out that is zero on the rows and columns of
    graph 0's last 3 atoms, as the message's backward leaves padded
    atoms."""
    gen = torch.Generator().manual_seed(seed)
    L = (LMAX + 1) ** 2 - 1

    def rand(*s):
        return torch.randn(s, generator=gen) * 0.4

    args = [rand(G, M, M, D), rand(G, M, L, D).to(torch.bfloat16),
            rand(G, M, L, D).to(torch.bfloat16), rand(G, M, M, L),
            rand(D, D) / 8.0, rand(D)]
    g = torch.randn(G, M, M, D, generator=gen)
    g[0, M - 3:] = 0.0
    g[0, :, M - 3:] = 0.0
    return [a.cuda() for a in args], g.cuda()


def htr_cases():
    """(M, pair type, gate) of phases 7 and 8."""
    for M in (16, 32, 112, 120):
        for pd in (torch.float32, torch.bfloat16):
            for gate in ("", "gated"):
                yield M, pd, gate


def check_htr_forward() -> None:
    """Phase 7: the HTR forward kernel against its plain version."""
    from gotennet_tpu_torch.ops import fused_htr
    for M, pd, gate in htr_cases():
        args, _ = htr_inputs(M, seed=300 + M)
        kw = dict(lmax=LMAX, sep_htr=True, rej=True, gate=gate,
                  pair_dtype=pd)
        got = fused_htr.fused_htr_forward(*args, **kw)
        torch.cuda.synchronize()
        want = fused_htr.fused_htr_forward_reference(*args, **kw)
        tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
        err, rel = rel_err(got, want)
        pad = torch.cat([(got - want)[0, M - 3:].flatten(),
                         (got - want)[0, :, M - 3:].flatten()])
        log(f"[htr-fwd-vs-plain] M={M} pair={str(pd)[6:]} gate={gate!r}: "
            f"out max abs {err:.3e} rel {rel:.3e}, on padded pairs max abs "
            f"{pad.abs().max().item():.3e} (tol {tol:g} rel)")
        if rel > tol or not torch.isfinite(got).all():
            raise AssertionError(f"HTR forward disagrees at M={M} {pd}")


def check_htr_backward() -> None:
    """Phase 8: the HTR backward kernel against its plain version; where
    the cotangent of out is zero, every cotangent it feeds is exactly
    zero."""
    from gotennet_tpu_torch.ops import fused_htr
    for M, pd, gate in htr_cases():
        args, g = htr_inputs(M, seed=400 + M)
        kw = dict(lmax=LMAX, sep_htr=True, rej=True, gate=gate,
                  pair_dtype=pd)
        got = fused_htr.fused_htr_backward(*args, g, **kw)
        torch.cuda.synchronize()
        want = fused_htr.fused_htr_backward_reference(*args, g, **kw)
        tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        worst = max(range(len(errs)), key=lambda i: errs[i][1])
        log(f"[htr-bwd-vs-plain] M={M} pair={str(pd)[6:]} gate={gate!r}: "
            "max rel err " + ", ".join(f"{n} {r:.1e}" for n, (_, r)
                                       in zip(HTR_NAMES, errs))
            + f" (worst {HTR_NAMES[worst]}, abs {errs[worst][0]:.3e}; "
            f"tol {tol:g} rel)")
        if errs[worst][1] > tol:
            raise AssertionError(f"HTR backward disagrees at M={M} {pd} on "
                                 f"{HTR_NAMES[worst]}")
        g_t, g_EQ, g_EK, g_rl = got[:4]
        pad = [a[0, M - 3:] for a in (g_t, g_rl, g_EQ, g_EK)]
        pad += [a[0, :, M - 3:] for a in (g_t, g_rl)]
        if not all(bool(torch.all(a == 0)) for a in pad):
            raise AssertionError("a zero cotangent gave a non-zero one")
        if not same_bits(got, fused_htr.fused_htr_backward(*args, g, **kw)):
            raise AssertionError("HTR backward differs between runs")


def train_phase(cfg, head, card) -> dict:
    """Phase 6: the training step at full width; returns the backward
    kernel's record."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_gata
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_chunks,
                                                  make_loss_fn, train_step,
                                                  train_steps)

    fwd, bwd = fused_gata.fused_gata_forward, fused_gata.fused_gata_backward
    ds = synthetic_molecules(TRAIN_MOLS, seed=1, min_atoms=12, max_atoms=29)
    mols = ds.graph_dicts(range(TRAIN_MOLS))
    expected = math.ceil(TRAIN_MOLS / TRAIN_CHUNK) * N_LAYERS

    # the main path: one step through the entry point
    fwd.launches = bwd.launches = 0
    losses = train_steps(cfg, head, mols, 1, chunk=TRAIN_CHUNK, lr=LR,
                         seed=0)
    torch.cuda.synchronize()
    n_fwd, n_bwd = fwd.launches, bwd.launches
    log(f"[train] one step on {TRAIN_MOLS} molecules in {TRAIN_CHUNK}-graph "
        f"chunks: loss {losses[0]:.6f}; launches forward {n_fwd}, backward "
        f"{n_bwd} (chunks x layers = {expected})")
    if n_fwd != expected or n_bwd != expected:
        raise AssertionError(f"launches {n_fwd}/{n_bwd}, expected {expected}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("training loss is not finite")

    # the first step's gradients against the backward's plain version
    model = GotenModel(cfg, head, seed=0)
    chunks = make_chunks(mols, TRAIN_CHUNK, "cuda")
    loss_fn = make_loss_fn(model, Task(None))
    model.train()
    accum_grads(model, loss_fn, chunks)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    with mock.patch.object(fused_gata, "fused_gata_backward",
                           fused_gata.fused_gata_backward_reference):
        accum_grads(model, loss_fn, chunks)
    errs = {n: rel_err(grads[n], p.grad) for n, p in model.named_parameters()}
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[train] first-step gradients, kernel vs plain backward: "
        f"{len(errs)} tensors, worst {worst} abs {errs[worst][0]:.3e} rel "
        f"{errs[worst][1]:.3e} (tol {TOL_TRAIN:g} rel)")
    if errs[worst][1] > TOL_TRAIN or not all(
            torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError("training gradients disagree with the plain "
                             "backward")

    # timing: three steps after two warm-up steps
    opt = make_optimizer(model.parameters(), LR)

    def step():
        return train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)

    step_ms, host_ms, step_losses = time_run(step, 2, 3)
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError("training loss is not finite")
    real_edges, padded = count_pairs(chunks, cfg)
    log(f"[train] step: {step_ms:.3f} ms (CUDA events), {host_ms:.3f} ms "
        f"(host clock); real edges {real_edges} (self-loops included), "
        f"padded pairs {padded}; {real_edges / (step_ms / 1e3):.1f} real "
        f"edges/s; losses {[round(x, 6) for x in step_losses]} | {card}")
    profile(step, step_ms, "training step", card)

    captured = capture(fused_gata, "fused_gata_backward",
                       lambda: accum_grads(model, loss_fn, chunks))
    record = kernel_record(
        {"name": "fused_gata_bwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_gata_bwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_gata.py:350"},
        captured, bwd, fused_gata.fused_gata_backward_reference,
        bwd_bound_ms, card)
    record["launches"] = n_bwd
    return record


def md22_frames() -> list:
    """bench.py's MD22 batch: 32 synthetic frames of 110-120 atoms at
    condensed-phase density, with a synthetic energy."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    return synthetic_molecules(MD22_FRAMES, seed=0,
                               **MD22_SIZES).graph_dicts(range(MD22_FRAMES))


def md22_chunks(mols) -> list:
    """The request's or the step's unbucketed chunks, on the card."""
    from gotennet_tpu_torch.train.trainer import make_chunks
    return make_chunks(mols, MD22_CHUNK, "cuda", bucket=False)


def md22_serve_phase(cfg, head, card) -> dict:
    """Phase 10: MD22-sized serving through both forward kernels; returns
    the HTR forward kernel's record."""
    from gotennet_tpu_torch.ops import fused_gata, fused_htr
    from gotennet_tpu_torch.serve import Predictor

    gata, htr = fused_gata.fused_gata_forward, fused_htr.fused_htr_forward
    mols = md22_frames()
    pred = Predictor(cfg, head, seed=0, chunk=MD22_CHUNK, bucket=False)
    n_chunks = math.ceil(MD22_FRAMES / MD22_CHUNK)
    expected = (n_chunks * N_LAYERS, n_chunks * (N_LAYERS - 1))

    # the main path: one request through the entry point
    gata.launches = htr.launches = 0
    got = pred.predict(mols)
    torch.cuda.synchronize()
    launches = (gata.launches, htr.launches)
    log(f"[md22-serve] answered {MD22_FRAMES} frames in {MD22_CHUNK}-frame "
        f"chunks: launches GATA {launches[0]}, HTR {launches[1]} (chunks x "
        f"layers = {expected[0]}, chunks x (layers - 1) = {expected[1]})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    with mock.patch.object(fused_gata, "fused_gata_forward",
                           fused_gata.fused_gata_forward_reference), \
            mock.patch.object(fused_htr, "fused_htr_forward",
                              fused_htr.fused_htr_forward_reference):
        want = pred.predict(mols)
    got_t = torch.from_numpy(got)
    err, rel = rel_err(got_t, torch.from_numpy(want))
    log(f"[md22-serve] answers: shape {tuple(got.shape)}, max abs err vs the "
        f"plain path {err:.4e} (rel {rel:.3e}, tol {TOL_SERVE:g})")
    if (got.shape != (MD22_FRAMES, 1) or not torch.isfinite(got_t).all()
            or rel > TOL_SERVE):
        raise AssertionError("MD22 answers disagree with the plain path")

    real_edges, padded = count_pairs(md22_chunks(mols), cfg)
    req_ms, host_ms, _ = time_run(lambda: pred.predict(mols), 2, 5)
    log(f"[time] {MD22_FRAMES}-frame MD22 request: {req_ms:.3f} ms (CUDA "
        f"events), {host_ms:.3f} ms (host clock); real edges {real_edges} "
        f"(self-loops included), padded pairs {padded}; "
        f"{real_edges / (req_ms / 1e3):.1f} real edges/s | {card}")
    profile(lambda: pred.predict(mols), req_ms,
            f"{MD22_FRAMES}-frame MD22 request", card)
    # the GATA forward at M = 120, logged only: its JSON record is the QM9
    # request's (phase 4)
    KERNEL_MS["fused_gata_fwd, MD22 request"] = kernel_record(
        {"name": "fused_gata_fwd"},
        capture(fused_gata, "fused_gata_forward", lambda: pred.predict(mols)),
        gata, fused_gata.fused_gata_forward_reference, fwd_bound_ms,
        card)["ms"]
    record = kernel_record(
        {"name": "fused_htr_fwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_htr_fwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_htr.py:79"},
        capture(fused_htr, "fused_htr_forward", lambda: pred.predict(mols)),
        htr, fused_htr.fused_htr_forward_reference, htr_fwd_bound_ms, card)
    record["launches"] = launches[1]
    KERNEL_MS["fused_htr_fwd, MD22 request"] = record["ms"]
    return record


def md22_train_phase(cfg, head, card) -> dict:
    """Phase 11: one MD22-sized training step through all four kernels;
    returns the HTR backward kernel's record."""
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_gata, fused_htr
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_loss_fn,
                                                  train_step, train_steps)

    counters = (fused_gata.fused_gata_forward, fused_gata.fused_gata_backward,
                fused_htr.fused_htr_forward, fused_htr.fused_htr_backward)
    mols = md22_frames()
    n_chunks = math.ceil(MD22_FRAMES / MD22_CHUNK)
    expected = ((n_chunks * N_LAYERS,) * 2
                + (n_chunks * (N_LAYERS - 1),) * 2)

    # the main path: one step through the entry point
    for c in counters:
        c.launches = 0
    losses = train_steps(cfg, head, mols, 1, chunk=MD22_CHUNK, lr=LR,
                         seed=0, bucket=False)
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    log(f"[md22-train] one step on {MD22_FRAMES} frames in {MD22_CHUNK}-frame"
        f" chunks: loss {losses[0]:.6f}; launches GATA forward/backward "
        f"{launches[0]}/{launches[1]}, HTR forward/backward "
        f"{launches[2]}/{launches[3]} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("training loss is not finite")

    # the first step's gradients against both backward plain versions
    model = GotenModel(cfg, head, seed=0)
    chunks = md22_chunks(mols)
    loss_fn = make_loss_fn(model, Task(None))
    model.train()
    accum_grads(model, loss_fn, chunks)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    with mock.patch.object(fused_gata, "fused_gata_backward",
                           fused_gata.fused_gata_backward_reference), \
            mock.patch.object(fused_htr, "fused_htr_backward",
                              fused_htr.fused_htr_backward_reference):
        accum_grads(model, loss_fn, chunks)
    errs = {n: rel_err(grads[n], p.grad) for n, p in model.named_parameters()}
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[md22-train] first-step gradients, kernels vs plain backwards: "
        f"{len(errs)} tensors, worst {worst} abs {errs[worst][0]:.3e} rel "
        f"{errs[worst][1]:.3e} (tol {TOL_TRAIN:g} rel)")
    if errs[worst][1] > TOL_TRAIN or not all(
            torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError("MD22 gradients disagree with the plain "
                             "backwards")

    # timing: three steps after two warm-up steps
    opt = make_optimizer(model.parameters(), LR)

    def step():
        return train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)

    step_ms, host_ms, step_losses = time_run(step, 2, 3)
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError("training loss is not finite")
    real_edges, padded = count_pairs(chunks, cfg)
    log(f"[md22-train] step: {step_ms:.3f} ms (CUDA events), {host_ms:.3f} ms"
        f" (host clock); real edges {real_edges} (self-loops included), "
        f"padded pairs {padded}; {real_edges / (step_ms / 1e3):.1f} real "
        f"edges/s; losses {[round(x, 6) for x in step_losses]} | {card}")
    profile(step, step_ms, "MD22 training step", card)

    # both backward kernels on a step's inputs; the GATA one logged only (its
    # JSON record is the QM9 step's, phase 6)
    captured = capture(fused_gata, "fused_gata_backward",
                       lambda: accum_grads(model, loss_fn, chunks))
    kernel_record({"name": "fused_gata_bwd"}, captured,
                  fused_gata.fused_gata_backward,
                  fused_gata.fused_gata_backward_reference, bwd_bound_ms, card)
    pass_split(fused_gata.fused_gata_backward, captured,
               "fused_gata_bwd at M = 120 (MD22 step)", card)
    captured = capture(fused_htr, "fused_htr_backward",
                       lambda: accum_grads(model, loss_fn, chunks))
    record = kernel_record(
        {"name": "fused_htr_bwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_htr_bwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_htr.py:115"},
        captured, fused_htr.fused_htr_backward,
        fused_htr.fused_htr_backward_reference, htr_bwd_bound_ms, card)
    record["launches"] = launches[3]
    KERNEL_MS["fused_htr_bwd, MD22 step"] = record["ms"]
    pass_split(fused_htr.fused_htr_backward, captured,
               "fused_htr_bwd at M = 120 (MD22 step)", card)
    return record


def ell_message_inputs(NR, N, head_scale, seed) -> list:
    """ELL message inputs on the card at the large request's shapes (float32
    node tables, as the ELL layer gives them): a third of the slots padded
    (env -1, pointing at their own row) and the last 8 rows wholly
    padded."""
    gen = torch.Generator().manual_seed(seed)
    L, C = (LMAX + 1) ** 2 - 1, (1 + 2 * LMAX) * D

    def rand(*s):
        return torch.randn(s, generator=gen) * 0.3

    valid = torch.rand(NR, ELL_K, generator=gen) > 0.3
    valid[-8:] = False
    nbr = torch.where(valid, torch.randint(0, N, (NR, ELL_K), generator=gen),
                      torch.arange(NR)[:, None]).to(torch.int32)
    env = torch.where(valid, torch.rand(NR, ELL_K, generator=gen),
                      torch.tensor(-1.0))
    scale = (torch.rand(NR, ELL_K, H, generator=gen) if head_scale
             else torch.full((NR, ELL_K), 1.0 / math.sqrt(D)))
    args = [rand(NR, ELL_K, D), rand(NR, D), rand(N, D), rand(N, C),
            rand(N, C), rand(NR, ELL_K, L), rand(N, L, D), env, scale, nbr,
            rand(D, D), rand(D), rand(D, C), rand(C)]
    return [a.cuda() for a in args]


def check_ell_message() -> None:
    """Phase 12: the ELL message kernel against its plain version; padded
    rows get exact zeros, and a rerun gives the same bits."""
    from gotennet_tpu_torch.ops import fused_ell
    cases = [(ELL_N, ELL_N, pd, hs) for pd in (torch.float32, torch.bfloat16)
             for hs in (False, True)]
    cases.append((ELL_N - 64, ELL_N, torch.bfloat16, False))
    for NR, N, pd, head_scale in cases:
        args = ell_message_inputs(NR, N, head_scale, seed=500 + NR)
        kw = dict(lmax=LMAX, num_heads=H, sep_dir=True, sep_tensor=True,
                  pair_dtype=pd, with_attn=True)
        got = fused_ell.fused_ell_forward(*args, **kw)
        again = fused_ell.fused_ell_forward(*args, **kw)
        torch.cuda.synchronize()
        if not same_bits(got, again):
            raise AssertionError("ELL message differs between runs")
        want = fused_ell.fused_ell_forward_reference(*args, **kw)
        tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        log(f"[ell-vs-plain] NR={NR} N={N} K={ELL_K} pair={str(pd)[6:]} "
            f"head_scale={head_scale}: max abs / rel err "
            + ", ".join(f"{n} {a:.3e}/{r:.3e}" for n, (a, r)
                        in zip(("d_h", "dX", "sm"), errs))
            + f" (tol {tol:g} rel)")
        if not all(r <= tol for _, r in errs):
            raise AssertionError(f"ELL message disagrees at NR={NR} {pd}")
        if not (torch.all(got[2][-8:] == 0) and torch.all(got[0][-8:] == 0)
                and torch.all(got[1][-8:] == 0)):
            raise AssertionError("padded rows got weight")


def check_htr_ell() -> None:
    """Phase 13: the ELL HTR kernel against its plain version."""
    from gotennet_tpu_torch.ops import fused_htr
    L = (LMAX + 1) ** 2 - 1
    gen = torch.Generator().manual_seed(600)

    def rand(*s):
        return (torch.randn(s, generator=gen) * 0.4).cuda()

    msg = ell_message_inputs(ELL_N, ELL_N, False, seed=601)
    args = [msg[0], rand(ELL_N, L, D), rand(ELL_N, L, D), msg[5], msg[9],
            rand(D, D) / 8.0, rand(D)]
    for pd in (torch.float32, torch.bfloat16):
        for gate in ("", "gated"):
            kw = dict(lmax=LMAX, sep_htr=True, rej=True, gate=gate,
                      pair_dtype=pd)
            got = fused_htr.fused_htr_ell_forward(*args, **kw)
            torch.cuda.synchronize()
            want = fused_htr.fused_htr_ell_forward_reference(*args, **kw)
            tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
            err, rel = rel_err(got, want)
            log(f"[htr-ell-vs-plain] N={ELL_N} K={ELL_K} pair={str(pd)[6:]} "
                f"gate={gate!r}: out max abs {err:.3e} rel {rel:.3e} (tol "
                f"{tol:g} rel)")
            if rel > tol or not torch.isfinite(got).all():
                raise AssertionError(f"ELL HTR disagrees at {pd} {gate!r}")


def large_frames() -> list:
    """bench.py's large batch: 8 synthetic frames of 600-700 atoms at
    condensed-phase density, with a synthetic energy."""
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    return synthetic_molecules(LARGE_FRAMES, seed=0, **LARGE_SIZES
                               ).graph_dicts(range(LARGE_FRAMES))


def ell_serve_phase(cfg, head, card) -> list:
    """Phase 14: the 600-700-atom request on the ELL layout through both ELL
    kernels; returns their records."""
    from gotennet_tpu_torch.data.dataset import MoleculeDataset
    from gotennet_tpu_torch.ops import fused_ell, fused_htr
    from gotennet_tpu_torch.serve import Predictor

    msg, htr = fused_ell.fused_ell_forward, fused_htr.fused_htr_ell_forward
    mols = large_frames()
    pred = Predictor(cfg, head, seed=0, chunk=1, layout="ell",
                     spatial_sort=True, block_rows=64)
    expected = (LARGE_FRAMES * N_LAYERS, LARGE_FRAMES * (N_LAYERS - 1))

    # the main path: one request through the entry point
    msg.launches = htr.launches = 0
    got = pred.predict(mols)
    torch.cuda.synchronize()
    launches = (msg.launches, htr.launches)
    log(f"[ell-serve] answered {LARGE_FRAMES} frames of 600-700 atoms, one "
        f"per chunk: launches ELL message {launches[0]}, ELL HTR "
        f"{launches[1]} (chunks x layers = {expected[0]}, chunks x (layers "
        f"- 1) = {expected[1]})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    with mock.patch.object(fused_ell, "fused_ell_forward",
                           fused_ell.fused_ell_forward_reference), \
            mock.patch.object(fused_htr, "fused_htr_ell_forward",
                              fused_htr.fused_htr_ell_forward_reference):
        want = pred.predict(mols)
    got_t = torch.from_numpy(got)
    err, rel = rel_err(got_t, torch.from_numpy(want))
    log(f"[ell-serve] answers: shape {tuple(got.shape)}, max abs err vs the "
        f"plain path {err:.4e} (rel {rel:.3e}, tol {TOL_SERVE:g})")
    if (got.shape != (LARGE_FRAMES, 1) or not torch.isfinite(got_t).all()
            or rel > TOL_SERVE):
        raise AssertionError("ELL answers disagree with the plain path")

    # the request's chunks as the loader cuts them; its host time is that
    # of the neighbour probe over the request and of every collation
    ds = MoleculeDataset(z=[m["z"] for m in mols],
                         pos=[m["pos"] for m in mols])
    t0 = time.perf_counter()
    chunks = [b for _, b in pred.loader(ds).batches()]
    loader_ms = (time.perf_counter() - t0) * 1e3
    real_edges = sum(int(b.nbr_mask.sum()) for b in chunks)
    padded = sum(b.num_nodes * b.max_neighbors for b in chunks)
    log(f"[ell-serve] chunks: N = {[b.num_nodes for b in chunks]}, K = "
        f"{[b.max_neighbors for b in chunks]}, gather windows "
        f"{[b.gather_window for b in chunks]}, halos "
        f"{[b.gather_halo for b in chunks]}; loader {loader_ms:.3f} ms "
        f"(host)")
    req_ms, host_ms, _ = time_run(lambda: pred.predict(mols), 2, 5)
    log(f"[time] {LARGE_FRAMES}-frame ELL request: {req_ms:.3f} ms (CUDA "
        f"events), {host_ms:.3f} ms (host clock); real edges {real_edges} "
        f"(self-loops included), padded slots {padded}; "
        f"{real_edges / (req_ms / 1e3):.1f} real edges/s | {card}")
    profile(lambda: pred.predict(mols), req_ms,
            f"{LARGE_FRAMES}-frame ELL request", card)
    records = []
    for name, module, fn_name, kernel, plain, bound, replaces in (
            ("fused_ell_fwd", fused_ell, "fused_ell_forward", msg,
             fused_ell.fused_ell_forward_reference, ell_fwd_bound_ms,
             "gotennet_tpu/ops/pallas/fused_ell.py:77"),
            ("fused_htr_ell_fwd", fused_htr, "fused_htr_ell_forward", htr,
             fused_htr.fused_htr_ell_forward_reference, htr_ell_fwd_bound_ms,
             "gotennet_tpu/ops/pallas/fused_htr.py:339")):
        captured = capture(module, fn_name, lambda: pred.predict(mols))
        record = kernel_record(
            {"name": name, "route": "cuda",
             "source": f"gotennet_tpu_torch/csrc/{name}.cu",
             "replaces": replaces}, captured, kernel, plain, bound, card)
        record["launches"] = launches[len(records)]
        KERNEL_MS[f"{name}, ELL request"] = record["ms"]
        records.append(record)
        if kernel is msg:
            pass_split(kernel, captured, f"{name} (ELL request)", card)
    return records


ELL_MSG_NAMES = ("g_t", "g_q", "g_k", "g_xg", "g_v", "g_rl", "g_X", "g_env",
                 "g_scale", "g_Wre", "g_bre", "g_Wrs", "g_brs")


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_ell_message_backward() -> None:
    """Phase 15: the ELL message backward kernel against its plain version;
    padded slots get exact zeros, and a rerun gives the same bits."""
    from gotennet_tpu_torch.ops import fused_ell
    L = (LMAX + 1) ** 2 - 1
    cases = [(ELL_N, ELL_N, pd, hs) for pd in (torch.float32, torch.bfloat16)
             for hs in (False, True)]
    cases.append((ELL_N - 64, ELL_N, torch.bfloat16, False))
    for NR, N, pd, head_scale in cases:
        args = ell_message_inputs(NR, N, head_scale, seed=700 + NR)
        kw = dict(lmax=LMAX, num_heads=H, sep_dir=True, sep_tensor=True,
                  pair_dtype=pd)
        _, _, sm = fused_ell.fused_ell_forward(*args, **kw, with_attn=True)
        gen = torch.Generator().manual_seed(NR)
        g_dh = torch.randn(NR, D, generator=gen).cuda()
        g_dX = torch.randn(NR, L, D, generator=gen).cuda()
        slots = fused_ell.source_slots(args[9], N)
        got = fused_ell.fused_ell_backward(*args, sm, g_dh, g_dX, **kw,
                                           slots=slots)
        again = fused_ell.fused_ell_backward(*args, sm, g_dh, g_dX, **kw,
                                             slots=slots)
        torch.cuda.synchronize()
        want = fused_ell.fused_ell_backward_reference(*args, sm, g_dh, g_dX,
                                                      **kw)
        tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        worst = max(range(len(errs)), key=lambda i: errs[i][1])
        log(f"[ell-bwd-vs-plain] NR={NR} N={N} K={ELL_K} pair={str(pd)[6:]} "
            f"head_scale={head_scale}: max rel err "
            + ", ".join(f"{n} {r:.1e}" for n, (_, r)
                        in zip(ELL_MSG_NAMES, errs))
            + f" (worst {ELL_MSG_NAMES[worst]}, abs {errs[worst][0]:.3e}; "
            f"tol {tol:g} rel)")
        if errs[worst][1] > tol:
            raise AssertionError(f"ELL message backward disagrees at NR={NR} "
                                 f"{pd} on {ELL_MSG_NAMES[worst]}")
        pad = args[7] < 0
        if not all(bool(torch.all(got[i][pad] == 0)) for i in (0, 5, 7, 8)):
            raise AssertionError("a padded slot got a cotangent")
        if not same_bits(got, again):
            raise AssertionError("ELL message backward differs between runs")


def check_htr_ell_backward() -> None:
    """Phase 16: the ELL HTR backward kernel against its plain version; a
    rerun gives the same bits."""
    from gotennet_tpu_torch.ops import fused_ell, fused_htr
    L = (LMAX + 1) ** 2 - 1
    gen = torch.Generator().manual_seed(800)

    def rand(*s):
        return (torch.randn(s, generator=gen) * 0.4).cuda()

    msg = ell_message_inputs(ELL_N, ELL_N, False, seed=801)
    args = [msg[0], rand(ELL_N, L, D), rand(ELL_N, L, D), msg[5], msg[9],
            rand(D, D) / 8.0, rand(D)]
    g = torch.randn(ELL_N, ELL_K, D, generator=gen).cuda()
    slots = fused_ell.source_slots(msg[9], ELL_N)
    for pd in (torch.float32, torch.bfloat16):
        for gate in ("", "gated"):
            kw = dict(lmax=LMAX, sep_htr=True, rej=True, gate=gate,
                      pair_dtype=pd)
            got = fused_htr.fused_htr_ell_backward(*args, g, **kw,
                                                   slots=slots)
            again = fused_htr.fused_htr_ell_backward(*args, g, **kw,
                                                     slots=slots)
            torch.cuda.synchronize()
            want = fused_htr.fused_htr_ell_backward_reference(*args, g, **kw)
            tol = TOL_BF16 if pd == torch.bfloat16 else TOL_F32
            errs = [rel_err(a, w) for a, w in zip(got, want)]
            worst = max(range(len(errs)), key=lambda i: errs[i][1])
            log(f"[htr-ell-bwd-vs-plain] N={ELL_N} K={ELL_K} "
                f"pair={str(pd)[6:]} gate={gate!r}: max rel err "
                + ", ".join(f"{n} {r:.1e}" for n, (_, r)
                            in zip(HTR_NAMES, errs))
                + f" (worst {HTR_NAMES[worst]}, abs {errs[worst][0]:.3e}; "
                f"tol {tol:g} rel)")
            if errs[worst][1] > tol:
                raise AssertionError(f"ELL HTR backward disagrees at {pd} "
                                     f"{gate!r} on {HTR_NAMES[worst]}")
            if not same_bits(got, again):
                raise AssertionError("ELL HTR backward differs between runs")


def ell_train_phase(cfg, head, card) -> list:
    """Phase 17: one ELL training step on the 600-700-atom frames through
    all four ELL kernels; returns both backward kernels' records."""
    from gotennet_tpu_torch.models.model import GotenModel
    from gotennet_tpu_torch.ops import fused_ell, fused_htr
    from gotennet_tpu_torch.tasks.base import Task
    from gotennet_tpu_torch.train.optim import make_optimizer
    from gotennet_tpu_torch.train.trainer import (accum_grads, make_chunks,
                                                  make_loss_fn, train_step,
                                                  train_steps)

    counters = (fused_ell.fused_ell_forward, fused_ell.fused_ell_backward,
                fused_htr.fused_htr_ell_forward,
                fused_htr.fused_htr_ell_backward)
    mols = large_frames()
    expected = ((LARGE_FRAMES * N_LAYERS,) * 2
                + (LARGE_FRAMES * (N_LAYERS - 1),) * 2)

    # the main path: one step through the entry point
    for c in counters:
        c.launches = 0
    losses = train_steps(cfg, head, mols, 1, chunk=1, lr=LR, seed=0,
                         layout="ell")
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    log(f"[ell-train] one step on {LARGE_FRAMES} frames of 600-700 atoms, one"
        f" per chunk: loss {losses[0]:.6f}; launches ELL message forward/"
        f"backward {launches[0]}/{launches[1]}, ELL HTR forward/backward "
        f"{launches[2]}/{launches[3]} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("training loss is not finite")

    # the first step's gradients against both backward plain versions
    model = GotenModel(cfg, head, "ell", seed=0)
    chunks = make_chunks(mols, 1, "cuda", layout="ell", cutoff=cfg.cutoff,
                         max_num_neighbors=cfg.max_num_neighbors)
    loss_fn = make_loss_fn(model, Task(None))
    model.train()
    accum_grads(model, loss_fn, chunks)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    with mock.patch.object(fused_ell, "fused_ell_backward",
                           fused_ell.fused_ell_backward_reference), \
            mock.patch.object(fused_htr, "fused_htr_ell_backward",
                              fused_htr.fused_htr_ell_backward_reference):
        accum_grads(model, loss_fn, chunks)
    errs = {n: rel_err(grads[n], p.grad) for n, p in model.named_parameters()}
    worst = max(errs, key=lambda n: errs[n][1])
    log(f"[ell-train] first-step gradients, kernels vs plain backwards: "
        f"{len(errs)} tensors, worst {worst} abs {errs[worst][0]:.3e} rel "
        f"{errs[worst][1]:.3e} (tol {TOL_TRAIN:g} rel)")
    if errs[worst][1] > TOL_TRAIN or not all(
            torch.isfinite(g).all() for g in grads.values()):
        raise AssertionError("ELL gradients disagree with the plain "
                             "backwards")

    # timing: three steps after two warm-up steps
    opt = make_optimizer(model.parameters(), LR)

    def step():
        return train_step(model, opt, chunks, opt.grad_clip, loss_fn=loss_fn)

    step_ms, host_ms, step_losses = time_run(step, 2, 3)
    if not all(math.isfinite(x) for x in step_losses):
        raise AssertionError("training loss is not finite")
    real_edges = sum(int(b.nbr_mask.sum()) for b in chunks)
    padded = sum(b.num_nodes * b.max_neighbors for b in chunks)
    log(f"[ell-train] step: {step_ms:.3f} ms (CUDA events), {host_ms:.3f} ms "
        f"(host clock); real edges {real_edges} (self-loops included), padded"
        f" slots {padded}; {real_edges / (step_ms / 1e3):.1f} real edges/s; "
        f"losses {[round(x, 6) for x in step_losses]} | {card}")
    profile(step, step_ms, "ELL training step", card)

    # both backward kernels on a step's inputs
    records = []
    for name, module, kernel, n_launches, plain, bound, replaces in (
            ("fused_ell_bwd", fused_ell, counters[1], launches[1],
             fused_ell.fused_ell_backward_reference, ell_bwd_bound_ms,
             "gotennet_tpu/ops/pallas/fused_ell.py:256"),
            ("fused_htr_ell_bwd", fused_htr, counters[3], launches[3],
             fused_htr.fused_htr_ell_backward_reference, htr_ell_bwd_bound_ms,
             "gotennet_tpu/ops/pallas/fused_htr.py:383")):
        captured = capture(module, kernel.__name__,
                           lambda: accum_grads(model, loss_fn, chunks))
        record = kernel_record(
            {"name": name, "route": "cuda",
             "source": f"gotennet_tpu_torch/csrc/{name}.cu",
             "replaces": replaces}, captured, kernel, plain, bound, card)
        record["launches"] = n_launches
        KERNEL_MS[f"{name}, ELL step"] = record["ms"]
        records.append(record)
        pass_split(kernel, captured, f"{name} (ELL step)", card)
    return records


def force_head():
    """MD22Task's head: Atomwise energies with forces (derivative=True)."""
    from gotennet_tpu_torch.tasks.force_task import MD22Task
    return MD22Task("energy", dataset_meta={"mean": 0.0,
                                            "std": 1.0}).build_head()


def hold_forces(what, got, want) -> None:
    """Energies and forces of a request (as ``predict_with_forces`` gives
    them) against the plain path's, each within TOL_SERVE of its scale."""
    (e, f), (we, wf) = got, want
    e_err, e_rel = rel_err(torch.from_numpy(e), torch.from_numpy(we))
    f_err = max(float(abs(a - b).max()) for a, b in zip(f, wf))
    f_rel = f_err / max(float(abs(b).max()) for b in wf)
    log(f"[{what}] energies {tuple(e.shape)}, max abs err vs the plain path "
        f"{e_err:.4e} (rel {e_rel:.3e}); forces of {len(f)} frames "
        f"{[x.shape[0] for x in f][:4]}..., max abs err {f_err:.4e} (rel "
        f"{f_rel:.3e}); tol {TOL_SERVE:g} rel")
    finite = all(bool(torch.isfinite(torch.from_numpy(x)).all()) for x in f)
    if not finite or max(e_rel, f_rel) > TOL_SERVE or not \
            torch.isfinite(torch.from_numpy(e)).all():
        raise AssertionError(f"{what}: energies or forces disagree with the "
                             "plain path")


def force_request_run(what, pred, mols, counters, expected, plains, card
                      ) -> tuple:
    """One force request through the entry point with every counter at 0
    (the launches must read ``expected``), the same request through the
    plain versions (``plains``: (module, name, plain) to patch), then the
    request timed and profiled; returns (launches, the kernels' answer,
    request ms)."""
    for c in counters:
        c.launches = 0
    got = pred.predict_with_forces(mols)
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    log(f"[{what}] answered {len(mols)} frames with forces: launches "
        f"{launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    with contextlib.ExitStack() as stack:
        for module, name, plain in plains:
            stack.enter_context(mock.patch.object(module, name, plain))
        want = pred.predict_with_forces(mols)
    hold_forces(what, got, want)
    req_ms, host_ms, _ = time_run(lambda: pred.predict_with_forces(mols), 2,
                                  3)
    log(f"[time] {len(mols)}-frame {what} request: {req_ms:.3f} ms (CUDA "
        f"events), {host_ms:.3f} ms (host clock) | {card}")
    profile(lambda: pred.predict_with_forces(mols), req_ms,
            f"{len(mols)}-frame {what} request", card)
    return launches, got, req_ms


def finite_difference_check(cfg, frame) -> None:
    """Forces against the central difference of the energy on one frame,
    float32 pair and node types: three atoms whose distances all stay at
    least 3 eps off the cutoff (a pair crossing it changes the energy by a
    step) each move by eps = 1e-2 A along a random unit vector u; -F_a.u
    must match within 2e-2 of |F_a|."""
    from gotennet_tpu_torch.serve import Predictor
    f32 = torch.float32
    pred = Predictor(dataclasses.replace(cfg, pair_dtype=f32, node_dtype=f32),
                     force_head(), seed=0, chunk=1, bucket=False)
    _, (forces,) = pred.predict_with_forces([frame])
    pos = torch.from_numpy(frame["pos"]).double()
    eps = 1e-2
    far = ((torch.cdist(pos, pos) - cfg.cutoff).abs() > 3 * eps).all(dim=1)
    rows = torch.nonzero(far)[:3, 0].tolist()
    gen = torch.Generator().manual_seed(7)

    def energy(row, step):
        moved = frame["pos"].copy()
        moved[row] += step
        return float(pred.predict([{"z": frame["z"], "pos": moved}])[0, 0])

    worst = 0.0
    for row in rows:
        u = torch.randn(3, generator=gen, dtype=torch.float64)
        u = (u / u.norm()).numpy()
        num = (energy(row, eps * u) - energy(row, -eps * u)) / (2 * eps)
        ana = -float(forces[row].astype("float64") @ u)
        rel = abs(num - ana) / float((forces[row] ** 2).sum() ** 0.5)
        worst = max(worst, rel)
        log(f"[fd] atom {row}: -F.u {ana:.6f}, central difference {num:.6f} "
            f"(eps {eps} A), err {rel:.3e} of |F| (tol 2e-2)")
    if len(rows) < 3 or worst > 2e-2:
        raise AssertionError("forces disagree with the energy's finite "
                             "differences")


def md22_force_phase(cfg, card) -> dict:
    """Phase 19: the MD22 force request through both GATA and both HTR
    kernels; returns the record of the GATA backward with position
    cotangents."""
    from gotennet_tpu_torch.ops import fused_gata, fused_htr
    from gotennet_tpu_torch.serve import Predictor

    counters = (fused_gata.fused_gata_forward, fused_gata.fused_gata_backward,
                fused_htr.fused_htr_forward, fused_htr.fused_htr_backward)
    mols = md22_frames()
    n_chunks = math.ceil(MD22_FRAMES / MD22_CHUNK)
    expected = ((n_chunks * N_LAYERS,) * 2
                + (n_chunks * (N_LAYERS - 1),) * 2)
    pred = Predictor(cfg, force_head(), seed=0, chunk=MD22_CHUNK,
                     bucket=False)
    plains = [(fused_gata, n, getattr(fused_gata, f"{n}_reference"))
              for n in ("fused_gata_forward", "fused_gata_backward")]
    plains += [(fused_htr, n, getattr(fused_htr, f"{n}_reference"))
               for n in ("fused_htr_forward", "fused_htr_backward")]
    launches, _, req_ms = force_request_run(
        "md22-forces", pred, mols, counters, expected, plains, card)
    real_edges, padded = count_pairs(md22_chunks(mols), cfg)
    log(f"[md22-forces] real edges {real_edges} (self-loops included), "
        f"padded pairs {padded}; {real_edges / (req_ms / 1e3):.1f} real "
        f"edges/s | {card}")
    finite_difference_check(cfg, mols[0])
    captured = capture(fused_gata, "fused_gata_backward",
                       lambda: pred.predict_with_forces(mols))
    record = kernel_record(
        {"name": "fused_gata_bwd_pos_grads", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_gata_bwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_gata.py:350"},
        captured, counters[1], fused_gata.fused_gata_backward_reference,
        bwd_bound_ms, card)
    record["launches"] = launches[1]
    pass_split(counters[1], captured,
               "fused_gata_bwd with pos_grads (MD22 force request)", card)
    pass_split(counters[3],
               capture(fused_htr, "fused_htr_backward",
                       lambda: pred.predict_with_forces(mols)),
               "fused_htr_bwd at M = 120 (MD22 force request)", card)
    return record


def ell_force_phase(cfg, card) -> None:
    """Phase 20: the ELL force request through all four ELL kernels."""
    from gotennet_tpu_torch.data.dataset import MoleculeDataset
    from gotennet_tpu_torch.ops import fused_ell, fused_htr
    from gotennet_tpu_torch.serve import Predictor

    counters = (fused_ell.fused_ell_forward, fused_ell.fused_ell_backward,
                fused_htr.fused_htr_ell_forward,
                fused_htr.fused_htr_ell_backward)
    expected = ((LARGE_FRAMES * N_LAYERS,) * 2
                + (LARGE_FRAMES * (N_LAYERS - 1),) * 2)
    pred = Predictor(cfg, force_head(), seed=0, chunk=1, layout="ell",
                     spatial_sort=True, block_rows=64)
    plains = [(fused_ell, n, getattr(fused_ell, f"{n}_reference"))
              for n in ("fused_ell_forward", "fused_ell_backward")]
    plains += [(fused_htr, n, getattr(fused_htr, f"{n}_reference"))
               for n in ("fused_htr_ell_forward", "fused_htr_ell_backward")]
    mols = large_frames()
    _, _, req_ms = force_request_run("ell-forces", pred, mols, counters,
                                     expected, plains, card)
    ds = MoleculeDataset(z=[m["z"] for m in mols],
                         pos=[m["pos"] for m in mols])
    real_edges = sum(int(b.nbr_mask.sum())
                     for _, b in pred.loader(ds).batches())
    log(f"[ell-forces] real edges {real_edges} (self-loops included); "
        f"{real_edges / (req_ms / 1e3):.1f} real edges/s | {card}")
    pass_split(counters[3],
               capture(fused_htr, "fused_htr_ell_backward",
                       lambda: pred.predict_with_forces(mols)),
               "fused_htr_ell_bwd (ELL force request)", card)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gotennet_tpu_torch.data.dataset import DenseLoader, MoleculeDataset
    from gotennet_tpu_torch.data.dataset import synthetic_molecules
    from gotennet_tpu_torch.models.gotennet import GotenNetConfig
    from gotennet_tpu_torch.ops import _build, fused_gata
    from gotennet_tpu_torch.serve import Predictor
    from gotennet_tpu_torch.tasks.qm9 import QM9Task

    bf16, f32 = torch.bfloat16, torch.float32
    kernel, plain = (fused_gata.fused_gata_forward,
                     fused_gata.fused_gata_forward_reference)

    start = time.time()

    def phase_done(name) -> None:
        log(f"[phase] {name} done at {time.time() - start:.1f} s")

    # ---- 1. device and build -------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.time()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} source(s) in "
        f"{time.time() - t0:.1f} s")
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[ptxas] {src}: {line.strip()}")
    phase_done("1 (device and build)")
    # ---- 2. kernel vs plain at flagship shapes ---------------------------
    for M in (16, 24, 32):
        for pd in (f32, bf16):
            for head_scale in (False, True):
                check_gata_forward(M, pd, head_scale, G)
    phase_done("2 (GATA forward vs plain)")

    # ---- 3. serving path at full width -----------------------------------
    cfg = GotenNetConfig(n_atom_basis=D, n_interactions=N_LAYERS, lmax=LMAX,
                         n_rbf=64, num_heads=H, pair_dtype=bf16,
                         node_dtype=bf16, merge_proj=True)
    head = QM9Task("U0", dataset_meta={"mean": 0.0, "std": 1.0}).build_head()
    pred = Predictor(cfg, head, seed=0, chunk=CHUNK)
    ds = synthetic_molecules(sum(REQUESTS), seed=0, min_atoms=12,
                             max_atoms=29)
    mols = ds.graph_dicts(range(len(ds)))
    requests, off = [], 0
    for n in REQUESTS:
        requests.append(mols[off:off + n])
        off += n
    kernel.launches = 0
    answers = [pred.predict(r) for r in requests]
    torch.cuda.synchronize()
    launches = kernel.launches
    expected = sum(math.ceil(n / CHUNK) for n in REQUESTS) * N_LAYERS
    log(f"[serve] answered {len(requests)} requests of {REQUESTS} molecules;"
        f" kernel launches {launches} (chunks x layers = {expected})")
    if launches != expected:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{expected}")
    with mock.patch.object(fused_gata, "fused_gata_forward", plain):
        plain_answers = [pred.predict(r) for r in requests]
    for n, got, want in zip(REQUESTS, answers, plain_answers):
        got_t, want_t = torch.from_numpy(got), torch.from_numpy(want)
        err, rel = rel_err(got_t, want_t)
        log(f"[serve] request of {n}: shape {tuple(got.shape)}, max abs err "
            f"vs plain path {err:.4e} (rel {rel:.3e}, tol {TOL_SERVE:g})")
        if (got.shape != (n, 1) or not torch.isfinite(got_t).all()
                or rel > TOL_SERVE):
            raise AssertionError(f"request of {n} disagrees with the plain "
                                 "path")
    phase_done("3 (QM9 serving)")

    # ---- 4. timing ---------------------------------------------------------
    big = requests[-1]
    ds_big = MoleculeDataset(z=[m["z"] for m in big],
                             pos=[m["pos"] for m in big])
    real_edges, padded_pairs = count_pairs(
        [b.to("cuda") for b in DenseLoader(
            ds_big, batch_size=CHUNK, bucket=True,
            bucket_window=math.ceil(len(big) / CHUNK))], cfg)
    req_ms, host_ms, _ = time_run(lambda: pred.predict(big), 2, 5)
    log(f"[time] 256-molecule request: {req_ms:.3f} ms (CUDA events), "
        f"{host_ms:.3f} ms (host clock); real edges {real_edges} "
        f"(self-loops included), padded pairs {padded_pairs}; "
        f"{real_edges / (req_ms / 1e3):.1f} real edges/s | {card}")

    profile(lambda: pred.predict(big), req_ms, f"{len(big)}-molecule request",
            card)
    # the kernel on the inputs the 256-molecule request gave it
    captured = capture(fused_gata, "fused_gata_forward",
                       lambda: pred.predict(big))
    record = kernel_record(
        {"name": "fused_gata_fwd", "route": "cuda",
         "source": "gotennet_tpu_torch/csrc/fused_gata_fwd.cu",
         "replaces": "gotennet_tpu/ops/pallas/fused_gata.py:108"},
        captured, kernel, plain, fwd_bound_ms, card)
    record["launches"] = launches
    KERNEL_MS["fused_gata_fwd, QM9 request"] = record["ms"]
    qm9_shapes = [tuple(c[0][0].shape) for c in captured]
    phase_done("4 (QM9 timing)")

    # ---- 5. backward kernel vs plain at the training shapes --------------
    for M in (16, 24, 32):
        for pd in (f32, bf16):
            for head_scale in (False, True):
                check_gata_backward(M, pd, head_scale, TRAIN_CHUNK)
    phase_done("5 (GATA backward vs plain)")

    # ---- 6. training at full width ----------------------------------------
    bwd_record = train_phase(cfg, head, card)
    phase_done("6 (QM9 training)")

    # ---- 7.-8. HTR kernels vs plain ----------------------------------------
    check_htr_forward()
    phase_done("7 (HTR forward vs plain)")
    check_htr_backward()
    phase_done("8 (HTR backward vs plain)")

    # ---- 9. GATA kernels at the MD22 chunk's M ---------------------------
    for M in (112, 120):
        for pd in (f32, bf16):
            check_gata_forward(M, pd, False, MD22_CHUNK)
            check_gata_backward(M, pd, False, MD22_CHUNK)
    phase_done("9 (GATA kernels at M = 112/120)")

    # ---- 10.-11. MD22 serving and training at full width -----------------
    md22_cfg = dataclasses.replace(cfg, fused_htr=True)
    htr_record = md22_serve_phase(md22_cfg, head, card)
    phase_done("10 (MD22 serving)")
    htr_bwd_record = md22_train_phase(md22_cfg, head, card)
    phase_done("11 (MD22 training)")

    # ---- 12.-14. the ELL layout: both kernels, then 600-700-atom serving --
    check_ell_message()
    phase_done("12 (ELL message vs plain)")
    check_htr_ell()
    phase_done("13 (ELL HTR vs plain)")
    ell_records = ell_serve_phase(md22_cfg, head, card)
    phase_done("14 (ELL serving)")

    # ---- 15.-17. ELL training: both backward kernels, then one step -------
    check_ell_message_backward()
    phase_done("15 (ELL message backward vs plain)")
    check_htr_ell_backward()
    phase_done("16 (ELL HTR backward vs plain)")
    ell_bwd_records = ell_train_phase(md22_cfg, head, card)
    phase_done("17 (ELL training)")

    # ---- 18.-20. forces: the GATA backward's position half, then serving --
    for M, g in ((16, TRAIN_CHUNK), (24, TRAIN_CHUNK), (32, TRAIN_CHUNK),
                 (112, MD22_CHUNK), (120, MD22_CHUNK)):
        for pd in (f32, bf16):
            for head_scale in (False, True):
                check_gata_backward(M, pd, head_scale, g, pos_grads=True)
    phase_done("18 (GATA backward with position cotangents vs plain)")
    pos_record = md22_force_phase(md22_cfg, card)
    phase_done("19 (MD22 forces)")
    ell_force_phase(md22_cfg, card)
    phase_done("20 (ELL forces)")
    products_phase(card)
    yardsticks(card, qm9_shapes)
    phase_done("21 (the backward product alone; the yardsticks)")
    log(json.dumps({"kernels": [record, bwd_record, htr_record,
                                htr_bwd_record, ell_records[0],
                                ell_bwd_records[0], ell_records[1],
                                ell_bwd_records[1], pos_record]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
