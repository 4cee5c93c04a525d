// Fused HTR edge update on the ELL layout, forward, for sm_90a.
//
// Replaces the TPU kernel `_ell_htr_kernel` of
// gotennet_tpu/ops/pallas/fused_htr.py (wired by `make_fused_htr_ell`).  It is
// the dense update of fused_htr_fwd.cu with i the destination row r of the
// pair and j = nbr[r, s] a row of the EK table; the math and the cast points
// are written out in gotennet_tpu_torch/ops/fused_htr.py, beside the plain
// PyTorch version (`fused_htr_ell_forward_reference`) this kernel is held
// against.
//
// What bounds it on an H100.  One 600-700-atom frame (N = 704 rows, K = 36
// slots, D = 256) reads t and writes out, both float32 over every slot
// (52 MB), and reads the EQ and EK tables (12 MB): about 0.019 ms at
// 3.35 TB/s.  Its one projection t W_g is 2 * D^2 FLOP per slot, 3.3 GFLOP,
// about 0.003 ms at the bf16 tensor-core peak.  As in the dense forward, the
// per-(slot, channel) terms pace it; here the tables arrive in float32, so
// the first version also rounded each EQ and EK value it read, per element.
//
// Design, that of fused_htr_fwd.cu (fused_htr_fwd.cuh): W_g and both float32
// tables are rounded to bf16 once a launch (round_bf16_kernel, one launch a
// table), so the EK values of a slot's partner are gathered 4 bytes a lane
// through the clamped nbr (the TPU kernel's one-hot gather matmul) and need
// no conversion; 64 consecutive slots a block at two blocks an SM, whatever
// rows they belong to, with the rows' rounded EQ in shared memory; the
// terms in packed bf16 arithmetic.  An index outside [0, N) is clamped so no read leaves the
// table.  The update masks no slot, so padded slots (which read their own
// row) are updated like the others.

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
extern "C" long long gotennet_fused_htr_ell_fwd_workspace(int NR, int N,
                                                          int D, int lmax) {
  return work_layout(NR, N, D, lmax).total * 2;
}

// Launches on `stream` and allocates nothing (`work` holds at least
// gotennet_fused_htr_ell_fwd_workspace bytes, 16-byte aligned); returns the
// first CUDA error.
extern "C" int gotennet_fused_htr_ell_fwd(
    const void* t, const void* eq, const void* ek, const float* rl,
    const int* nbr, const float* wg, const float* bg, float* out, void* work,
    int NR, int N, int K, int D, int lmax, int sep_htr, int rej, int gate,
    int pair_bf16, int t_bf16, int node_bf16, void* stream) {
  Params p{};
  p.t = t; p.eq = eq; p.ek = ek; p.rl = rl; p.nbr = nbr; p.wg = wg;
  p.bg = bg; p.out = out;
  p.P = NR > 0 && K > 0 ? (long long)NR * K : 0;
  p.R = K; p.n_eq = NR; p.n_ek = N;
  p.D = D; p.lmax = lmax; p.sep_htr = sep_htr; p.rej = rej; p.gate = gate;
  if (N < NR) return (int)cudaErrorInvalidValue;
  return launch_forward<true>(p, work, pair_bf16, t_bf16, node_bf16, stream);
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
