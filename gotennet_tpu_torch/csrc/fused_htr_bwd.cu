// Fused dense HTR edge update, backward, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of gotennet_tpu/ops/pallas/fused_htr.py
// (wired by `make_fused_htr`): the cotangents of all six inputs (t, EQ, EK,
// rl, W_g, b_g) from the float32 cotangent g of `out`.  The math and the cast
// points are written out in gotennet_tpu_torch/ops/fused_htr.py
// (`fused_htr_backward_reference`), the plain PyTorch version this kernel is
// held against.
//
// What bounds it on an H100: the bytes.  A 4-graph chunk at M = 120 and
// D = 256 reads t and g and writes g_t, all float32 over every pair
// (~177 MB, ~53 us at 3.35 TB/s); its three projections (t W_g recomputed,
// g_z W_g^T, t^T g_z) are 6 * D^2 * pairs = 22.6 GFLOP, ~23 us at the bf16
// tensor-core peak.  The first version lost most of its time in three
// elementwise passes that talked through device memory, each recomputing the
// update's per-(pair, channel) terms (PERF.md §5 has the split).
//
// Design.  The TPU kernel sums W_g's and b_g's gradients over its whole
// sequential grid and g_EK over each graph's i-tiles, in place.  Hopper's
// blocks run in parallel in no order, so here every sum has one owner and no
// sum uses atomics: every result is the same from run to run.  With a bf16
// pair type and rows of at most 128 pairs, one pass per EQ row does what
// the TPU kernel does per i-tile: z = t W_g on the tensor cores (W_g
// rounded to bf16 once a launch, streamed through a ring of cp.async
// stages), g_w and g_z, and from the terms of each pair once, g_EQ (a sum
// over the row's own pairs) and g_rl (a sum over the pair's channels); only
// the sums that cross rows run apart: g_EK (over i, from the rounded g_w
// and g_pk the row pass writes), g_t's product, g_W_g (partials over pairs,
// added in order) and g_b_g (the rows' sums, added in order); the ELL
// backward shares all of it (fused_htr_bwd.cuh).  A float32 pair type, or
// rows longer than 128 pairs, take the header's four passes, with pair
// (g, i, j) reading EQ row g*M + i and EK row g*M + j.  A pair whose cotangent g is zero (a padded atom's row or
// column, where the message's backward leaves zeros) adds exact zeros to
// every output.

#include "fused_htr_tile.cuh"
#include "bwd_sums.cuh"
#include "fused_htr_bwd.cuh"

namespace {

// every launch of this file goes through here
template <typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream) {
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// Workspace bytes the backward needs for these shapes.
extern "C" long long gotennet_fused_htr_bwd_workspace(int G, int M, int D) {
  return (long long)(layout((long long)G * M * M, D, G * M).total * sizeof(float));
}

// Launches on `stream` and allocates nothing (`work` holds at least
// gotennet_fused_htr_bwd_workspace bytes); returns the first CUDA error.
extern "C" int gotennet_fused_htr_bwd(
    const void* t, const void* eq, const void* ek, const float* rl,
    const float* wg, const float* bg, const float* g, float* gt, float* geq,
    float* gek, float* grl, float* gwg, float* gbg, float* work, int G, int M,
    int D, int lmax, int sep_htr, int rej, int gate, int pair_bf16,
    int t_bf16, int node_bf16, void* stream) {
  Params p{};
  p.t = t; p.eq = eq; p.ek = ek; p.rl = rl; p.wg = wg; p.bg = bg; p.g = g;
  p.gt = gt; p.geq = geq; p.gek = gek; p.grl = grl; p.gwg = gwg; p.gbg = gbg;
  p.P = G > 0 && M > 0 ? (long long)G * M * M : 0;
  p.R = M; p.n_eq = p.n_ek = G * M;
  p.D = D; p.lmax = lmax; p.sep_htr = sep_htr; p.rej = rej; p.gate = gate;
  return launch_backward<false>(p, work, pair_bf16, t_bf16, node_bf16, stream);
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
