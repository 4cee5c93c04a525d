"""The port's fused-GATA forward against the JAX package's Pallas kernel.

``fused_gata_forward_reference`` (the plain PyTorch version the CUDA
kernel is held against on the card) is compared with
``gotennet_tpu.ops.pallas.fused_gata.fused_gata_message`` run in
interpret mode, on the same numpy inputs.  A second test compiles the
CUDA source with the host C++ compiler, one fiber per CUDA thread and a
switch back to the launcher for ``__syncthreads``, and holds its
arithmetic against the plain version on the CPU.
"""

import ctypes
import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gotennet_tpu.ops.pallas.fused_gata import fused_gata_message

from gotennet_tpu_torch.ops import _build, fused_gata
from gotennet_tpu_torch.ops.fused_gata import (fused_gata_forward,
                                               fused_gata_forward_reference)


def kernel_inputs(seed, G, M, D, H, lmax, sep_dir, sep_tensor,
                  head_scale=False, padded=True):
    """numpy inputs in argument order; graph 0 has 3 padded atoms."""
    rng = np.random.default_rng(seed)
    L = (lmax + 1) ** 2 - 1
    mult = 1 + (lmax if sep_dir else 1) + (lmax if sep_tensor else 1)

    def rand(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.3

    t = rand(G, M, M, D)
    q, k = rand(G, M, D), rand(G, M, D)
    xg, v = rand(G, M, mult * D), rand(G, M, mult * D)
    rl, X = rand(G, M, M, L), rand(G, M, L, D)
    valid = rng.random((G, M, M)) > 0.3
    if padded:
        valid[0, M - 3:, :] = False
        valid[0, :, M - 3:] = False
    env = np.where(valid, rng.random((G, M, M)), -1.0).astype(np.float32)
    if head_scale:
        scale = rng.random((G, M, M, H)).astype(np.float32)
    else:
        scale = np.full((G, M, M), 1.0 / math.sqrt(D), np.float32)
    W_re, b_re = rand(D, D), rand(D)
    W_rs, b_rs = rand(D, mult * D), rand(mult * D)
    return [t, q, k, xg, v, rl, X, env, scale, W_re, b_re, W_rs, b_rs]


def near_neighbours(env, reach):
    """``env`` ``[G,M,M]`` with only the pairs 0 < |i - j| <= ``reach``
    left valid: most pairs invalid, as in a large molecule's chunk."""
    i = torch.arange(env.shape[-1])
    gap = (i[:, None] - i[None, :]).abs()
    return torch.where((gap <= reach) & (gap > 0), env,
                       torch.full_like(env, -1.0))


def _assert_close(got, want, tol, name):
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err)


# f32: identical math, only the order of the sums differs -> 1e-5 of
# each output's scale.  bf16: both round at the same cast points, but
# Pallas-interpret (XLA on the CPU) fuses bf16 elementwise chains and
# rounds once at the end where the port rounds every product, so single
# pair terms differ by a bf16 ulp (2^-8): a loose, stated 2e-2.
@pytest.mark.parametrize("sep,M,head_scale,dtype,tol", [
    ((True, True), 8, False, "f32", 1e-5),
    ((False, False), 8, True, "f32", 1e-5),
    ((True, False), 16, True, "f32", 1e-5),
    ((False, True), 16, False, "f32", 1e-5),
    ((True, True), 8, True, "bf16", 2e-2),
])
def test_reference_matches_pallas_interpret(sep, M, head_scale, dtype, tol):
    sep_dir, sep_tensor = sep
    G, D, H, lmax = (3 if M == 8 else 2), 32, 4, 2
    inputs = kernel_inputs(0, G, M, D, H, lmax, sep_dir, sep_tensor,
                           head_scale)
    jpd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tpd = torch.bfloat16 if dtype == "bf16" else torch.float32
    j_dh, j_dx, j_attn = fused_gata_message(
        *inputs, lmax=lmax, num_heads=H, sep_dir=sep_dir,
        sep_tensor=sep_tensor, interpret=True, pair_dtype=jpd)
    targs = [torch.from_numpy(a) for a in inputs]
    d_h, dX, sm = fused_gata_forward(
        *targs, lmax=lmax, num_heads=H, sep_dir=sep_dir,
        sep_tensor=sep_tensor, pair_dtype=tpd, with_attn=True)
    scale = targs[8] if head_scale else targs[8][..., None]
    _assert_close(d_h.numpy(), np.asarray(j_dh), tol, "d_h")
    _assert_close(dX.numpy(), np.asarray(j_dx), tol, "dX")
    _assert_close((sm * scale).numpy(), np.asarray(j_attn), tol, "attn")
    # padded atoms of graph 0: no softmax weight, no update
    assert torch.all(sm[0, M - 3:] == 0) and torch.all(sm[0, :, M - 3:] == 0)
    assert torch.all(d_h[0, M - 3:] == 0) and torch.all(dX[0, M - 3:] == 0)


def test_wrapper_rejects_unported_devices():
    args = [torch.from_numpy(a).to("meta")
            for a in kernel_inputs(0, 1, 8, 32, 4, 2, True, True)]
    with pytest.raises(ValueError, match="no kernel"):
        fused_gata_forward(*args, lmax=2, num_heads=4, sep_dir=True,
                           sep_tensor=True)


# ---------------------------------------------------------------------
# The CUDA source on the CPU: stand-in headers map each CUDA thread of a
# block onto a fiber (ucontext) of the launching thread and __syncthreads
# onto a switch back to the launcher, which runs every fiber of the block
# up to its next barrier before it resumes the first one again.
_CUDA_RUNTIME_H = r"""
#pragma once
#include <math.h>
#include <sys/mman.h>
#include <ucontext.h>
#include <algorithm>
#include <cstddef>
#include <cstdlib>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3_ { unsigned x, y, z; };
inline thread_local uint3_ threadIdx;
inline thread_local uint3_ blockIdx;
struct HostBlock {
  ucontext_t launcher;
  std::vector<ucontext_t> fiber;
  std::vector<char> done;
  unsigned cur = 0;
  void (*body)(const void*, const void*) = nullptr;
  const void* kern = nullptr;
  const void* args = nullptr;
};
inline thread_local HostBlock* g_block;
inline void __syncthreads() {
  swapcontext(&g_block->fiber[g_block->cur], &g_block->launcher); }
// the kernels call it in code every warp of the block runs alike, so the
// block's barrier stands in for the warp's
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
namespace { float4 smem4[16384]; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 132; return 0; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 2; return 0; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
using std::max; using std::min;
template <class K, class P>
void host_body(const void* kern, const void* args) {
  (*static_cast<const K*>(kern))(*static_cast<const P*>(args)); }
inline void host_fiber() {
  g_block->body(g_block->kern, g_block->args);
  g_block->done[g_block->cur] = 1; }
// the blocks in order; within one, rounds that run each fiber still going
// up to its next barrier (or its end), thread 0 first
template <class K, class P>
void host_launch(K kern, dim3 grid, unsigned nt, const P& p) {
  constexpr size_t kStack = size_t(1) << 20;  // touched pages only
  char* stacks = static_cast<char*>(mmap(
      nullptr, kStack * nt, PROT_READ | PROT_WRITE,
      MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0));
  if (stacks == MAP_FAILED) abort();
  HostBlock b;
  b.fiber.resize(nt);
  b.done.resize(nt);
  b.body = host_body<K, P>;
  b.kern = &kern;
  b.args = &p;
  HostBlock* outer = g_block;
  g_block = &b;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = {bx, by, bz};
      for (unsigned t = 0; t < nt; ++t) {
        getcontext(&b.fiber[t]);
        b.fiber[t].uc_stack.ss_sp = stacks + t * kStack;
        b.fiber[t].uc_stack.ss_size = kStack;
        b.fiber[t].uc_link = &b.launcher;
        makecontext(&b.fiber[t], host_fiber, 0);
        b.done[t] = 0;
      }
      for (bool going = true; going;) {
        going = false;
        for (unsigned t = 0; t < nt; ++t) {
          if (b.done[t]) continue;
          b.cur = t;
          threadIdx = {t, 0, 0};
          swapcontext(&b.launcher, &b.fiber[t]);
          going = going || !b.done[t];
        }
      }
    }
  g_block = outer;
  munmap(stacks, kStack * nt);
}
"""
_CUDA_BF16_H = r"""
#pragma once
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
inline float __bfloat162float(__nv_bfloat16 v) {
  unsigned u = (unsigned)v.x << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  unsigned u; std::memcpy(&u, &f, 4); u += 0x7FFFu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)}; }
"""
_LAUNCH = "kern<<<grid, kThreads, smem, stream>>>(args);"


def build_on_host(directory, source, launch):
    """Compile ``csrc/<source>`` with the host C++ compiler into
    ``directory``, its one kernel-launch line ``launch``
    (``kern<<<grid, THREADS, smem, stream>>>(ARGS);``) replaced by a host
    launch of THREADS fibers; returns the loaded library with its C
    interface declared.  Skips without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the CUDA source")
    (directory / "cuda_runtime.h").write_text(_CUDA_RUNTIME_H)
    (directory / "cuda_bf16.h").write_text(_CUDA_BF16_H)
    src = (_build.CSRC / source).read_text()
    assert src.count(launch) == 1, f"{source}: launch line not found once"
    args = launch[launch.index(">>>(") + 4:launch.rindex(")")]
    threads = launch[launch.index("<<<") + 3:].split(",")[1].strip()
    (directory / "k.cpp").write_text(src.replace(
        launch, f"host_launch(kern, grid, {threads}, {args}); (void)stream;"))
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    f"-I{directory}", f"-I{_build.CSRC}",
                    "-o", str(directory / "libk.so"),
                    str(directory / "k.cpp")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(directory / "libk.so"))
    _build._declare(lib, source)
    return lib


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    return build_on_host(tmp_path_factory.mktemp("cuda_on_host"),
                         "fused_gata_fwd.cu", _LAUNCH)


# the host build rounds at the same points as the plain version; only
# the order of the f32 sums differs -> 1e-5 of each output's scale
@pytest.mark.parametrize("case", [
    dict(G=2, M=8, D=32, H=4, lmax=2, sep=(True, True), hs=False,
         pd=torch.float32, t=torch.float32, node=torch.float32),
    dict(G=2, M=8, D=32, H=4, lmax=2, sep=(False, False), hs=True,
         pd=torch.float32, t=torch.float32, node=torch.bfloat16),
    dict(G=1, M=24, D=64, H=8, lmax=2, sep=(True, True), hs=False,
         pd=torch.bfloat16, t=torch.float32, node=torch.bfloat16),
    dict(G=1, M=16, D=96, H=8, lmax=3, sep=(True, False), hs=True,
         pd=torch.bfloat16, t=torch.bfloat16, node=torch.bfloat16),
    dict(G=1, M=70, D=32, H=4, lmax=2, sep=(True, True), hs=False,
         pd=torch.bfloat16, t=torch.float32, node=torch.float32),
    dict(G=2, M=16, D=128, H=8, lmax=2, sep=(False, True), hs=True,
         pd=torch.bfloat16, t=torch.float32, node=torch.bfloat16),
    # the MD22 chunk's M: one destination row of 120 pairs per block, whose
    # mma.sync fragments also read the 8 zero rows past them
    dict(G=1, M=120, D=32, H=4, lmax=2, sep=(True, True), hs=False,
         pd=torch.bfloat16, t=torch.float32, node=torch.bfloat16),
])
def test_cuda_source_on_host_matches_plain(host_build, case):
    G, M, D, H, lmax = (case[k] for k in ("G", "M", "D", "H", "lmax"))
    sep_dir, sep_tensor = case["sep"]
    a = [torch.from_numpy(x) for x in kernel_inputs(
        1, G, M, D, H, lmax, sep_dir, sep_tensor, case["hs"])]
    a[0] = a[0].to(case["t"])
    for i in (1, 2, 3, 4):
        a[i] = a[i].to(case["node"])
    kw = dict(lmax=lmax, num_heads=H, sep_dir=sep_dir,
              sep_tensor=sep_tensor, pair_dtype=case["pd"])
    w_dh, w_dx, w_sm = fused_gata_forward_reference(*a, **kw, with_attn=True)
    L = (lmax + 1) ** 2 - 1
    d_h = torch.full((G, M, D), math.nan)
    dX = torch.full((G, M, L, D), math.nan)
    sm = torch.full((G, M, M, H), math.nan)
    fused_gata._call_kernel(host_build, None, *a, d_h, dX, sm, **kw)
    for got, want, name in ((d_h, w_dh, "d_h"), (dX, w_dx, "dX"),
                            (sm, w_sm, "sm")):
        _assert_close(got.numpy(), want.numpy(), 1e-5, name)


# The block shapes of the tensor-core path, each held against the plain
# version and run twice (the same bytes: every sum has one owner):
# several destination rows a block with the columns split over blocks
# (blockIdx.z), a ragged last slab with slices that do not fill 128
# columns and a head that spans two slices, one 120-pair row a block, and
# the float32 pair type's 32-column path.  Float32: 1e-5 of the scale, as
# above.  bf16: the softmax's sums run in another order than the plain
# version's, and an attention weight or a pair term that lands next to a
# rounding boundary can round to the neighbouring bf16 value (2^-8 of one
# term of a sum over up to 120 pairs) -> 1e-3 of the scale.
@pytest.mark.parametrize("case", [
    dict(G=1, M=16, D=256, H=8, lmax=2, pd=torch.bfloat16, t=torch.float32),
    dict(G=2, M=20, D=160, H=4, lmax=2, pd=torch.bfloat16, t=torch.bfloat16),
    dict(G=1, M=120, D=32, H=4, lmax=2, pd=torch.bfloat16, t=torch.float32),
    dict(G=2, M=12, D=64, H=4, lmax=2, pd=torch.float32, t=torch.float32),
], ids=["qm9-slab-split", "ragged-slab", "md22-row", "f32"])
def test_cuda_source_on_host_block_shapes_rerun(host_build, case):
    G, M, D, H, lmax = (case[k] for k in ("G", "M", "D", "H", "lmax"))
    a = [torch.from_numpy(x) for x in kernel_inputs(
        5, G, M, D, H, lmax, True, True, True)]
    a[0] = a[0].to(case["t"])
    for i in (1, 2, 3, 4):
        a[i] = a[i].to(torch.bfloat16)
    kw = dict(lmax=lmax, num_heads=H, sep_dir=True, sep_tensor=True,
              pair_dtype=case["pd"])
    want = fused_gata_forward_reference(*a, **kw, with_attn=True)
    L = (lmax + 1) ** 2 - 1
    runs = []
    for _ in range(2):
        got = (torch.full((G, M, D), math.nan),
               torch.full((G, M, L, D), math.nan),
               torch.full((G, M, M, H), math.nan))
        fused_gata._call_kernel(host_build, None, *a, *got, **kw)
        runs.append(got)
    tol = 1e-3 if case["pd"] == torch.bfloat16 else 1e-5
    for name, g1, g2, w in zip(("d_h", "dX", "sm"), *runs, want):
        _assert_close(g1.numpy(), w.numpy(), tol, name)
        assert g1.numpy().tobytes() == g2.numpy().tobytes(), name
