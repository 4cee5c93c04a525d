// Fused dense HTR edge update, forward, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of gotennet_tpu/ops/pallas/fused_htr.py
// (wired by `make_fused_htr`).  The math and the cast points are written out
// in gotennet_tpu_torch/ops/fused_htr.py, beside the plain PyTorch version
// (`fused_htr_forward_reference`) this kernel is held against.
//
// What bounds it on an H100: the bytes.  A 4-graph chunk at M = 120 and
// D = 256 reads t and writes out, both float32 over every pair (~118 MB),
// which takes ~35 us at 3.35 TB/s; its one projection t @ W_g is
// 2 * D^2 * pairs = 7.5 GFLOP, ~8 us at the bf16 tensor-core peak.  The
// design keeps every pair-sized intermediate (z, gt, S, pq, pk, w) on chip,
// as the TPU kernel keeps them in VMEM, so the bytes stay at that minimum.
//
// Design (simple first; wgmma/TMA/overlap are later work):
//  * the HTR update masks no pair and needs no sum over j, so the G*M*M pairs
//    are one flat list of rows; one thread block takes kRows consecutive
//    rows, whatever graph or destination they belong to, and the last block
//    masks its ragged end;
//  * the block's t rows, rounded to the pair type, stay in shared memory; W_g
//    streams through shared memory one 32-column slice at a time.  With a
//    bf16 pair type each slice product runs on the tensor cores (mma.sync
//    m16n8k16, bf16 operands, float32 accumulation: the cast points of the
//    TPU kernel's bf16 matmul); with a float32 pair type as float32 FMAs;
//  * the epilogue takes one (pair, channel) per thread: silu of z, the degree
//    blocks' S, pq and pk from the EQ row of i and the EK row of j (read from
//    device memory, where neighbouring threads read neighbouring channels),
//    the gate, and `out` written straight to device memory.

#include "fused_htr_tile.cuh"

namespace {

struct Params {
  const void* t;       // [G, M, M, D]  float or bf16
  const void* eq;      // [G, M, L, D]  node type
  const void* ek;      // [G, M, L, D]
  const float* rl;     // [G, M, M, L]
  const float* wg;     // [D, D]  (in, out)
  const float* bg;     // [D]
  float* out;          // [G, M, M, D]
  long long P;         // pairs, G * M * M
  int G, M, D, L, lmax, sep_htr, rej, gate;
  // shared-memory carve-up, in bytes from the base (see smem_layout)
  int off_a, off_c, off_rl, smem;
};

template <bool kBF, typename TT, typename NT>
__global__ void __launch_bounds__(kThreads)
fused_htr_fwd_kernel(const Params p) {
  using AT = typename PairT<kBF>::type;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const long long p0 = (long long)blockIdx.x * kRows;
  const int TB = (int)(p.P - p0 < kRows ? p.P - p0 : kRows);
  const int M = p.M, D = p.D, L = p.L;
  const int lda = a_stride(D, kBF);
  const int tid = threadIdx.x;

  void* Wbuf = base;                                      // W slice
  AT* As = reinterpret_cast<AT*>(base + p.off_a);         // [kRows][lda]
  float* Cs = reinterpret_cast<float*>(base + p.off_c);   // [kRows][kNT + 1]
  float* rls = reinterpret_cast<float*>(base + p.off_rl); // [kRows][L]

  const TT* __restrict__ t = static_cast<const TT*>(p.t);
  const NT* __restrict__ eq = static_cast<const NT*>(p.eq);
  const NT* __restrict__ ek = static_cast<const NT*>(p.ek);

  // ---- stage 0: the block's t rows (rounded) and rl rows ----------------
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int row = e / D, c = e % D;
    store(&As[row * lda + c],
          row < TB ? rnd<kBF>(to_f(t[(p0 + row) * D + c])) : 0.f);
  }
  for (int e = tid; e < TB * L; e += kThreads) rls[e] = p.rl[p0 * L + e];
  __syncthreads();

  // ---- per 32-column slice: z = t W_g, then the fused epilogue ----------
  for (int n0 = 0; n0 < D; n0 += kNT) {
    product_tile<kBF>(As, lda, TB, p.wg, D, 1, n0, D, Wbuf, Cs);
    for (int e = tid; e < TB * kNT; e += kThreads) {
      const int row = e / kNT, c = e % kNT, cc = n0 + c;
      const long long pair = p0 + row;
      const long long gi = pair / M;                  // g * M + i
      const long long gj = gi / M * M + pair % M;     // g * M + j
      const float z = Cs[row * (kNT + 1) + c] + p.bg[cc];
      const float gt = z * sigmoid(z);
      const float w = pair_w<kBF>(p, eq + gi * L * D + cc,
                                  ek + gj * L * D + cc, rls + row * L);
      p.out[pair * D + cc] = to_f(t[pair * D + cc]) + gt * gate_fwd(w, p.gate);
    }
    __syncthreads();
  }
}

// byte offsets of the shared arrays; returns the total
size_t smem_layout(Params& p, bool bf) {
  auto up16 = [](size_t x) { return (x + 15) / 16 * 16; };
  const size_t w = bf ? (size_t)kNT * (p.D + kPadBF) * 2
                      : (size_t)kKT * kNT * sizeof(float);
  size_t off = up16(w);
  p.off_a = (int)off;
  off = up16(off + (size_t)kRows * a_stride(p.D, bf) * (bf ? 2 : sizeof(float)));
  p.off_c = (int)off;
  off += (size_t)kRows * (kNT + 1) * sizeof(float);
  p.off_rl = (int)off;
  off += (size_t)kRows * p.L * sizeof(float);
  p.smem = (int)off;
  return off;
}

template <bool kBF, typename TT, typename NT>
cudaError_t launch(Params p, cudaStream_t stream) {
  auto kern = fused_htr_fwd_kernel<kBF, TT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.P + kRows - 1) / kRows));
  kern<<<grid, kThreads, p.smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBF>
cudaError_t dispatch_storage(const Params& p, int t_bf16, int node_bf16,
                             cudaStream_t s) {
  if (t_bf16) {
    return node_bf16 ? launch<kBF, __nv_bfloat16, __nv_bfloat16>(p, s)
                     : launch<kBF, __nv_bfloat16, float>(p, s);
  }
  return node_bf16 ? launch<kBF, float, __nv_bfloat16>(p, s)
                   : launch<kBF, float, float>(p, s);
}

}  // namespace

// Launches on `stream`, allocates nothing; returns cudaGetLastError().
extern "C" int gotennet_fused_htr_fwd(
    const void* t, const void* eq, const void* ek, const float* rl,
    const float* wg, const float* bg, float* out, int G, int M, int D,
    int lmax, int sep_htr, int rej, int gate, int pair_bf16, int t_bf16,
    int node_bf16, void* stream) {
  Params p;
  p.t = t; p.eq = eq; p.ek = ek; p.rl = rl; p.wg = wg; p.bg = bg;
  p.out = out;
  p.G = G; p.M = M; p.D = D; p.lmax = lmax;
  p.L = (lmax + 1) * (lmax + 1) - 1;
  p.P = (long long)G * M * M;
  p.sep_htr = sep_htr; p.rej = rej; p.gate = gate;
  if (G <= 0 || M <= 0) return (int)cudaSuccess;
  if (D % kNT || D % kKT || lmax < 1 || lmax > kMaxLmax || gate < 0 || gate > 3)
    return (int)cudaErrorInvalidValue;
  if (smem_layout(p, pair_bf16 != 0) > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pair_bf16 ? dispatch_storage<true>(p, t_bf16, node_bf16, s)
                                    : dispatch_storage<false>(p, t_bf16, node_bf16, s);
  return (int)err;
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
