// Fused HTR edge update on the ELL layout, backward, for sm_90a.
//
// Replaces the TPU kernel `_ell_htr_bwd_kernel` of
// gotennet_tpu/ops/pallas/fused_htr.py (launched by `_ell_htr_bwd_call`, wired
// by `make_fused_htr_ell`): the cotangents of t, EQ, EK (the source table),
// rl, W_g and b_g from the float32 cotangent g of `out`.  It is
// fused_htr_bwd.cu with i the destination row r of the slot and j = nbr[r, s]
// a row of the EK table; the math and the cast points are written out in
// gotennet_tpu_torch/ops/fused_htr.py, beside the plain PyTorch version
// (`fused_htr_ell_backward_reference`) this kernel is held against.
//
// What bounds it on an H100: one 600-700-atom frame (N = 704 rows, K = 36
// slots, D = 256) reads t and g and writes g_t, all float32 over every slot
// (78 MB, about 0.023 ms at 3.35 TB/s); its three projections (t W_g
// recomputed, g_z W_g^T, t^T g_z) are 6 * D^2 FLOP per slot, 10 GFLOP, about
// 0.01 ms at the bf16 tensor-core peak.  So the bytes bound it.  What costs
// time on the card is the update's terms, evaluated per (slot, channel), and
// any pass that writes them to device memory for another pass to read back
// (PERF.md §5 has the split).
//
// Design, that of fused_htr_bwd.cu (fused_htr_bwd.cuh): with a bf16 pair type
// the row pass takes three destination rows of 36 slots a block (as many as
// fill its 128-row tile) and evaluates each (slot, channel)'s terms once:
// z on the tensor cores, g_w, g_z, g_EQ over each row's slots and g_rl over
// channels, writing the rounded g_w and g_pk; every sum has one owner and no
// atomics, so every result is the same from run to run.  The TPU kernel sums
// g_EK by a transposed one-hot matmul over its sequential grid; here a thread
// per (table row, channel) walks the slots that read its row through the
// transposed slot list (`starts`, `order`, a stable sort of the flat nbr
// built once per batch by the caller), in the list's order, from those
// rounded terms.  A float32 pair type keeps the four passes.  The update
// masks no slot, so padded slots (which read their own row) are updated and
// differentiated like the others.

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
extern "C" long long gotennet_fused_htr_ell_bwd_workspace(int NR, int K,
                                                          int D) {
  return (long long)(layout((long long)NR * K, D, NR).total * sizeof(float));
}

// Launches on `stream` and allocates nothing (`work` holds at least
// gotennet_fused_htr_ell_bwd_workspace bytes); returns the first CUDA error.
extern "C" int gotennet_fused_htr_ell_bwd(
    const void* t, const void* eq, const void* ek, const float* rl,
    const int* nbr, const float* wg, const float* bg, const float* g,
    const int* starts, const int* order, float* gt, float* geq, float* gek,
    float* grl, float* gwg, float* gbg, float* work, int NR, int N, int K,
    int D, int lmax, int sep_htr, int rej, int gate, int pair_bf16,
    int t_bf16, int node_bf16, void* stream) {
  Params p{};
  p.t = t; p.eq = eq; p.ek = ek; p.rl = rl; p.nbr = nbr; p.wg = wg;
  p.bg = bg; p.g = g; p.starts = starts; p.order = order;
  p.gt = gt; p.geq = geq; p.gek = gek; p.grl = grl; p.gwg = gwg; p.gbg = gbg;
  p.P = NR > 0 && K > 0 ? (long long)NR * K : 0;
  p.R = K; p.n_eq = NR; p.n_ek = N;
  p.D = D; p.lmax = lmax; p.sep_htr = sep_htr; p.rej = rej; p.gate = gate;
  if (N < NR) return (int)cudaErrorInvalidValue;
  return launch_backward<true>(p, work, pair_bf16, t_bf16, node_bf16, stream);
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
