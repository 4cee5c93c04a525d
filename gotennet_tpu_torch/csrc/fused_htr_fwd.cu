// Fused dense HTR edge update, forward, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of gotennet_tpu/ops/pallas/fused_htr.py
// (wired by `make_fused_htr`).  The math and the cast points are written out
// in gotennet_tpu_torch/ops/fused_htr.py, beside the plain PyTorch version
// (`fused_htr_forward_reference`) this kernel is held against.
//
// What bounds it on an H100.  A 4-graph chunk at M = 120 and D = 256 reads
// t and writes out, both float32 over every pair (~118 MB, ~35 us at
// 3.35 TB/s); its one projection t W_g is 2 * D^2 * pairs = 7.5 GFLOP, ~8 us
// at the bf16 tensor-core peak.  Neither paces it: its per-(pair, channel)
// epilogue does.  For lmax 2 each of the 14.7 M (pair, channel) elements
// forms S, pq and pk over 8 components, rounding to the pair type after
// every product and every sum, from an EQ and an EK value.  The first
// version rounded one value at a time (about 74 conversions an element) and
// read the 16 EQ and EK values of an element with scalar loads; an
// instrumented copy put most of a block's time in those terms and their
// loads, and only a minority of it in the conversions alone.
//
// Design (fused_htr_fwd.cuh, shared with the ELL forward): W_g rounded to
// bf16 once a launch and streamed through the backward's cp.async ring onto
// mma.sync; 64 consecutive pairs a block, so that two blocks share an SM
// and hide each other's latency (a 128-pair block at one an SM, with or
// without the backward's one EQ row a block, or a persistent block holding
// all of W_g, were slower: PERF.md §6); in the epilogue a lane takes two
// neighbouring channels of four pairs a round, the EQ row's values stay
// packed in registers across the row's pairs, each pair's rl is rounded
// once in the tile load, and every rounding of the terms is one packed
// bf16 product or sum for both channels, with no conversion (0 an element,
// against 74); the EK values arrive 4 bytes a lane, t and out move 8 bytes
// a lane.  A float32 pair type or lmax > 2 takes the slice-by-slice path,
// with pair (g, i, j) reading EQ row g*M + i and EK row g*M + j.

#include "fused_htr_tile.cuh"

namespace {

// every launch of this file goes through here
template <typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream) {
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

#include "fused_htr_fwd.cuh"

// Workspace bytes the forward needs for these shapes: the bf16 W_g and the
// bf16 copies of float32 EQ and EK tables.
extern "C" long long gotennet_fused_htr_fwd_workspace(int G, int M, int D,
                                                      int lmax) {
  return work_layout(G * M, G * M, D, lmax).total * 2;
}

// Launches on `stream` and allocates nothing (`work` holds at least
// gotennet_fused_htr_fwd_workspace bytes, 16-byte aligned); returns the
// first CUDA error.
extern "C" int gotennet_fused_htr_fwd(
    const void* t, const void* eq, const void* ek, const float* rl,
    const float* wg, const float* bg, float* out, void* work, int G, int M,
    int D, int lmax, int sep_htr, int rej, int gate, int pair_bf16,
    int t_bf16, int node_bf16, void* stream) {
  Params p{};
  p.t = t; p.eq = eq; p.ek = ek; p.rl = rl; p.wg = wg; p.bg = bg;
  p.out = out;
  p.P = G > 0 && M > 0 ? (long long)G * M * M : 0;
  p.R = M; p.n_eq = p.n_ek = G * M;
  p.D = D; p.lmax = lmax; p.sep_htr = sep_htr; p.rej = rej; p.gate = gate;
  return launch_forward<false>(p, work, pair_bf16, t_bf16, node_bf16, stream);
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
