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
// tensor-core peak.
//
// Design (right first; fusion of the weight gradient and overlap are later
// work).  The TPU kernel sums W_g's and b_g's gradients over its whole
// sequential grid and g_EK over each graph's i-tiles, in place.  Hopper's
// blocks run in parallel in no order, so here every sum has one owner and no
// sum uses atomics: every result is the same from run to run.
//  A. per block of kRows consecutive pairs (as the forward): z = t W_g on the
//     tensor cores (bf16 pair type) or as float32 FMAs, then per (pair,
//     channel) g_w (the cotangent of w) and g_z (of z), both to workspace;
//     the block keeps its rows of rnd(g_z) in shared memory and forms
//     g_t = g + g_z W_g^T with a second product;
//  B. per (node, degree block, channel): g_EQ sums over j, g_EK over i, each
//     recomputing pq, pk and 2 - r2 of the pairs it visits;
//  C. per pair, a warp per pair: g_rl, sums over channels (each lane sums
//     its channels, then one thread per component adds the 32 lanes in
//     order);
//  D. g_W_g = t^T g_z and g_b_g, sums over all pairs of the chunk: split over
//     blocks into partials, then one pass adds the partials in a fixed order.
// A pair whose cotangent g is zero (a padded atom's row or column, where the
// message's backward leaves zeros) adds exact zeros to every output.

#include "fused_htr_tile.cuh"

namespace {

constexpr int kMaxRlPairs = 64;                  // pairs per block of pass C
constexpr int kBM = 64, kBN = 64, kBK = 16;     // pass D product tile
constexpr int kPad = 4;                          // shared row padding (floats)
constexpr int kMaxSplit = 16;                    // partials of a sum over pairs
constexpr int kRowsPerSplit = 1024;

struct Params {
  const void* t;       // [G, M, M, D]  float or bf16
  const void* eq;      // [G, M, L, D]  node type
  const void* ek;      // [G, M, L, D]
  const float* rl;     // [G, M, M, L]
  const float* wg;     // [D, D]  (in, out)
  const float* bg;     // [D]
  const float* g;      // [G, M, M, D]  cotangent of out
  float *gt, *geq, *gek, *grl, *gwg, *gbg;
  // workspace: gz, gw [P, D] (cotangents of z and w); part (partials)
  float *gz, *gw, *part;
  long long P;         // pairs, G * M * M
  int G, M, D, L, lmax, sep_htr, rej, gate;
  // pass A's shared-memory carve-up, in bytes from the base
  int off_a, off_g, off_c, off_rl, smem;
  int rl_pairs;        // pairs per block of pass C (a multiple of 8)
};

// ---- pass A: g_w, g_z to workspace; g_t = g + g_z W_g^T ------------------
template <bool kBF, typename TT, typename NT>
__global__ void __launch_bounds__(kThreads) pair_bwd_kernel(const Params p) {
  using AT = typename PairT<kBF>::type;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const long long p0 = (long long)blockIdx.x * kRows;
  const int TB = (int)(p.P - p0 < kRows ? p.P - p0 : kRows);
  const int M = p.M, D = p.D, L = p.L;
  const int lda = a_stride(D, kBF);
  const int tid = threadIdx.x;

  void* Wbuf = base;                                      // W slice
  AT* As = reinterpret_cast<AT*>(base + p.off_a);         // [kRows][lda] t
  AT* Gs = reinterpret_cast<AT*>(base + p.off_g);         // [kRows][lda] g_z
  float* Cs = reinterpret_cast<float*>(base + p.off_c);   // [kRows][kNT + 1]
  float* rls = reinterpret_cast<float*>(base + p.off_rl); // [kRows][L]

  const TT* __restrict__ t = static_cast<const TT*>(p.t);
  const NT* __restrict__ eq = static_cast<const NT*>(p.eq);
  const NT* __restrict__ ek = static_cast<const NT*>(p.ek);

  // the block's t rows (rounded) and rl rows; g_z rows past TB are zero
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int row = e / D, c = e % D;
    store(&As[row * lda + c],
          row < TB ? rnd<kBF>(to_f(t[(p0 + row) * D + c])) : 0.f);
    if (row >= TB) store(&Gs[row * lda + c], 0.f);
  }
  for (int e = tid; e < TB * L; e += kThreads) rls[e] = p.rl[p0 * L + e];
  __syncthreads();

  // z = t W_g per 32-column slice; g_w and g_z per (pair, channel)
  for (int n0 = 0; n0 < D; n0 += kNT) {
    product_tile<kBF>(As, lda, TB, p.wg, D, 1, n0, D, Wbuf, Cs);
    for (int e = tid; e < TB * kNT; e += kThreads) {
      const int row = e / kNT, c = e % kNT, cc = n0 + c;
      const long long pair = p0 + row;
      const long long gi = pair / M;                  // g * M + i
      const long long gj = gi / M * M + pair % M;     // g * M + j
      const float z = Cs[row * (kNT + 1) + c] + p.bg[cc];
      const float sg = sigmoid(z);
      const float w = pair_w<kBF>(p, eq + gi * L * D + cc,
                                  ek + gj * L * D + cc, rls + row * L);
      const float gwv = gate_fwd(w, p.gate);
      const float g = p.g[pair * D + cc];
      const float g_w = g * (z * sg) * gate_grad(w, gwv, p.gate);
      const float g_z = g * gwv * (sg + z * sg * (1.f - sg));
      p.gw[pair * D + cc] = g_w;
      p.gz[pair * D + cc] = g_z;
      store(&Gs[row * lda + cc], rnd<kBF>(g_z));
    }
    __syncthreads();
  }

  // g_t = g + rnd(g_z) rnd(W_g)^T per 32-column slice
  for (int n0 = 0; n0 < D; n0 += kNT) {
    product_tile<kBF>(Gs, lda, TB, p.wg, 1, D, n0, D, Wbuf, Cs);
    for (int e = tid; e < TB * kNT; e += kThreads) {
      const int row = e / kNT, c = e % kNT;
      const long long at = (p0 + row) * D + n0 + c;
      p.gt[at] = p.g[at] + Cs[row * (kNT + 1) + c];
    }
    __syncthreads();
  }
}

// ---- pass B: g_EQ (sum over j) and g_EK (sum over i) -----------------------
// one thread per (node n, degree block, channel c); blockIdx.y picks the
// side: 0 is g_EQ[g, n = i], 1 is g_EK[g, n = j]
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) node_grads_kernel(const Params p) {
  const int side = blockIdx.y;
  const int M = p.M, D = p.D, L = p.L, nb = n_blocks(p);
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)p.G * M * nb * D) return;
  const int c = (int)(e % D), b = (int)(e / D % nb);
  const long long gn = e / D / nb, g = gn / M, n = gn % M;
  const int lo = block_lo(p, b), hi = block_hi(p, b);
  const NT* eq = static_cast<const NT*>(p.eq);
  const NT* ek = static_cast<const NT*>(p.ek);
  float acc[kMaxL];
  for (int m = lo; m < hi; ++m) acc[m - lo] = 0.f;
  for (int o = 0; o < M; ++o) {
    const long long i = side ? o : n, j = side ? n : o;
    const long long pair = (g * M + i) * M + j;
    const NT* eqi = eq + (g * M + i) * L * D + c;
    const NT* ekj = ek + (g * M + j) * L * D + c;
    const float* rlp = p.rl + pair * L;
    const float gwv = p.gw[pair * D + c];
    const float gwp = rnd<kBF>(gwv);
    float gp = 0.f;   // rnd(g_pq) for g_EQ, rnd(g_pk) for g_EK
    if (p.rej) {
      const Terms tm = block_terms<kBF>(eqi, ekj, rlp, D, lo, hi, 1);
      gp = rnd<kBF>(-(gwv * (side ? tm.pq : tm.pk)) * tm.a);
    }
    const NT* other = side ? eqi : ekj;
    for (int m = lo; m < hi; ++m) {
      float v = rnd<kBF>(gwp * rnd<kBF>(to_f(other[m * D])));
      if (p.rej) v = rnd<kBF>(v + rnd<kBF>(gp * rnd<kBF>(rlp[m])));
      acc[m - lo] += v;
    }
  }
  float* out = side ? p.gek : p.geq;
  for (int m = lo; m < hi; ++m) out[(gn * L + m) * D + c] = acc[m - lo];
}

// ---- pass C: g_rl, a warp per pair -----------------------------------------
// g_rl[pair, m] = sum_c (g_pq eq_m + g_pk ek_m) + 2 rl_m sum_c g_w rnd(pq pk)
// (the second sum is over the channels of m's degree block).  A block takes
// p.rl_pairs pairs, each warp one pair at a time; lane l sums channels l,
// l + 32, ... into shared memory, then one thread per (pair, component) adds
// the 32 lanes' partials in order.
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_rl_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);   // [rl_pairs][nq][33]
  const int M = p.M, D = p.D, L = p.L, nb = n_blocks(p), nq = L + nb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long pair0 = (long long)blockIdx.x * p.rl_pairs;
  for (int r = warp; r < p.rl_pairs; r += kThreads / 32) {
    const long long pair = pair0 + r;
    float acc[kMaxL + kMaxLmax];
    for (int q = 0; q < nq; ++q) acc[q] = 0.f;
    if (pair < p.P && p.rej) {
      const long long gi = pair / M, gj = gi / M * M + pair % M;
      const NT* eq = static_cast<const NT*>(p.eq) + gi * L * D;
      const NT* ek = static_cast<const NT*>(p.ek) + gj * L * D;
      const float* rlp = p.rl + pair * L;
      for (int c = lane; c < D; c += 32) {
        const float gwv = p.gw[pair * D + c];
        for (int b = 0; b < nb; ++b) {
          const int lo = block_lo(p, b), hi = block_hi(p, b);
          const Terms tm = block_terms<kBF>(eq + c, ek + c, rlp, D, lo, hi, 1);
          const float gpq = -(gwv * tm.pk) * tm.a;
          const float gpk = -(gwv * tm.pq) * tm.a;
          acc[L + b] += gwv * rnd<kBF>(tm.pq * tm.pk);
          for (int m = lo; m < hi; ++m) {
            acc[m] += gpq * rnd<kBF>(to_f(eq[m * D + c])) +
                      gpk * rnd<kBF>(to_f(ek[m * D + c]));
          }
        }
      }
    }
    for (int q = 0; q < nq; ++q) red[(r * nq + q) * 33 + lane] = acc[q];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < p.rl_pairs * L; e += kThreads) {
    const int r = e / L, m = e % L;
    const long long pair = pair0 + r;
    if (pair >= p.P) continue;
    int b = 0;
    while (m >= block_hi(p, b)) ++b;
    float s = 0.f, s2 = 0.f;
    for (int l = 0; l < 32; ++l) {
      s += red[(r * nq + m) * 33 + l];
      s2 += red[(r * nq + L + b) * 33 + l];
    }
    p.grl[pair * L + m] = p.rej ? s + 2.f * p.rl[pair * L + m] * s2 : 0.f;
  }
}

// ---- pass D: weight and bias gradients, sums over all pairs ---------------
// out[z][m][n] = sum_{k in split z} A(m, k) B(k, n), with A(m, k) =
// a[m * a_sm + k * a_sk] (float or bf16 storage) and B(k, n) =
// b[k * b_sk + n * b_sn]; both factors rounded to the pair type.
struct Product {
  const void* a;
  long long a_sm, a_sk;
  int a_bf16;
  const float* b;
  long long b_sk, b_sn;
  float* out;
  long long o_split;
  int rows, cols, depth, k_per_split;
};

template <bool kBF>
__global__ void __launch_bounds__(kThreads) product_kernel(const Product g) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [kBK][kBM + kPad]
  float* Bs = As + kBK * (kBM + kPad);            // [kBK][kBN + kPad]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int k_lo = blockIdx.z * g.k_per_split;
  const int k_hi = min(g.depth, k_lo + g.k_per_split);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    // neighbouring threads take neighbouring addresses of each factor
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int mm = g.a_sm == 1 ? e % kBM : e / kBK;
      const int kk = g.a_sm == 1 ? e / kBM : e % kBK;
      const int m = m0 + mm, k = k0 + kk;
      float a = 0.f;
      if (m < g.rows && k < k_hi) {
        const size_t at = (size_t)m * g.a_sm + (size_t)k * g.a_sk;
        a = g.a_bf16 ? to_f(static_cast<const __nv_bfloat16*>(g.a)[at])
                     : static_cast<const float*>(g.a)[at];
      }
      As[kk * (kBM + kPad) + mm] = rnd<kBF>(a);
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int nn = g.b_sn == 1 ? e % kBN : e / kBK;
      const int kk = g.b_sn == 1 ? e / kBN : e % kBK;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk * (kBN + kPad) + nn] =
          (n < g.cols && k < k_hi)
              ? rnd<kBF>(g.b[(size_t)k * g.b_sk + (size_t)n * g.b_sn])
              : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(&As[kk * (kBM + kPad) + ty * 4]);
      const float4 b4 =
          *reinterpret_cast<const float4*>(&Bs[kk * (kBN + kPad) + tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    __syncthreads();
  }
  float* out = g.out + (size_t)blockIdx.z * g.o_split;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (m < g.rows && n < g.cols) out[(size_t)m * g.cols + n] = acc[r][c];
    }
  }
}

// Column sums of x [rows, cols] in `splits` partials: part[z][col].
struct ColSum {
  const float* x;
  float* part;
  int rows, cols, rows_per_split;
};

__global__ void __launch_bounds__(kThreads) colsum_kernel(const ColSum c) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= c.cols) return;
  const int r_lo = blockIdx.y * c.rows_per_split;
  const int r_hi = min(c.rows, r_lo + c.rows_per_split);
  float s = 0.f;
  for (int r = r_lo; r < r_hi; ++r) s += c.x[(size_t)r * c.cols + col];
  c.part[(size_t)blockIdx.y * c.cols + col] = s;
}

// out[e] = sum_z part[z][e], in order of z.
struct PartSum {
  const float* part;
  float* out;
  int n, splits;
};

__global__ void __launch_bounds__(kThreads) partsum_kernel(const PartSum s) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= s.n) return;
  float acc = 0.f;
  for (int z = 0; z < s.splits; ++z) acc += s.part[(size_t)z * s.n + e];
  s.out[e] = acc;
}

// ---- the C entry point ------------------------------------------------------
// every launch of this file goes through here
template <typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream) {
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

int splits_for(long long rows) {
  const long long s = rows / kRowsPerSplit;
  return (int)(s < 1 ? 1 : (s > kMaxSplit ? kMaxSplit : s));
}

// workspace layout, in floats
struct Layout {
  size_t gz, gw, part, total;
};

Layout layout(int G, int M, int D) {
  const size_t P = (size_t)G * M * M;
  Layout w;
  w.gz = 0;
  w.gw = w.gz + P * D;
  w.part = w.gw + P * D;
  w.total = w.part + (size_t)splits_for((long long)P) * D * D;
  return w;
}

// pass A's shared arrays, byte offsets; returns the total
size_t smem_layout(Params& p, bool bf) {
  auto up16 = [](size_t x) { return (x + 15) / 16 * 16; };
  const size_t w = bf ? (size_t)kNT * (p.D + kPadBF) * 2
                      : (size_t)kKT * kNT * sizeof(float);
  const size_t rows = (size_t)kRows * a_stride(p.D, bf) * (bf ? 2 : sizeof(float));
  size_t off = up16(w);
  p.off_a = (int)off;
  off = up16(off + rows);
  p.off_g = (int)off;
  off = up16(off + rows);
  p.off_c = (int)off;
  off += (size_t)kRows * (kNT + 1) * sizeof(float);
  p.off_rl = (int)off;
  off += (size_t)kRows * p.L * sizeof(float);
  p.smem = (int)off;
  return off;
}

// pass C: as many pairs per block as fit (at most kMaxRlPairs, a multiple
// of the 8 warps), and its shared bytes
int rl_pairs_for(int L, int nb) {
  const size_t per_pair = (size_t)(L + nb) * 33 * sizeof(float);
  const int n = (int)(kMaxSmem / per_pair) / 8 * 8;
  return n < kMaxRlPairs ? n : kMaxRlPairs;
}

size_t rl_smem_bytes(const Params& p) {
  return (size_t)p.rl_pairs * (p.L + (p.sep_htr ? p.lmax : 1)) * 33 *
         sizeof(float);
}

#define CHECK(x)                                 \
  do {                                           \
    const cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

template <bool kBF, typename TT, typename NT>
cudaError_t backward(const Params& p, int t_bf16, cudaStream_t s) {
  const int D = p.D;
  // A. g_w, g_z, g_t
  auto pair_kern = pair_bwd_kernel<kBF, TT, NT>;
  CHECK(cudaFuncSetAttribute(pair_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem));
  CHECK(run(pair_kern, dim3((unsigned)((p.P + kRows - 1) / kRows)), p.smem,
            p, s));
  // B. g_EQ and g_EK
  const long long n_node = (long long)p.G * p.M * (p.sep_htr ? p.lmax : 1) * D;
  CHECK(run(node_grads_kernel<kBF, NT>, dim3(blocks_for(n_node), 2), 0, p, s));
  // C. g_rl
  auto rl_kern = grad_rl_kernel<kBF, NT>;
  const size_t rl_smem = rl_smem_bytes(p);
  CHECK(cudaFuncSetAttribute(rl_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rl_smem));
  CHECK(run(rl_kern, dim3((unsigned)((p.P + p.rl_pairs - 1) / p.rl_pairs)),
            rl_smem, p, s));
  // D. g_W_g = rnd(t)^T rnd(g_z) and g_b_g = sum of g_z, over all pairs:
  // partials over pair ranges, then summed in order
  const int S = splits_for(p.P);
  Product gw{};
  gw.a = p.t; gw.a_sm = 1; gw.a_sk = D; gw.a_bf16 = t_bf16;
  gw.b = p.gz; gw.b_sk = D; gw.b_sn = 1;
  gw.out = p.part; gw.o_split = (long long)D * D;
  gw.rows = D; gw.cols = D; gw.depth = (int)p.P;
  gw.k_per_split = ((int)((p.P + S - 1) / S) + kBK - 1) / kBK * kBK;
  const size_t smem = (size_t)kBK * (kBM + kBN + 2 * kPad) * sizeof(float);
  CHECK(run(product_kernel<kBF>, dim3((D + kBN - 1) / kBN, (D + kBM - 1) / kBM, S),
            smem, gw, s));
  CHECK(run(partsum_kernel, dim3(blocks_for((long long)D * D)), 0,
            PartSum{p.part, p.gwg, D * D, S}, s));
  const ColSum cs{p.gz, p.part, (int)p.P, D, (int)((p.P + S - 1) / S)};
  CHECK(run(colsum_kernel, dim3(blocks_for(D), S), 0, cs, s));
  CHECK(run(partsum_kernel, dim3(blocks_for(D)), 0, PartSum{p.part, p.gbg, D, S},
            s));
  return cudaSuccess;
}

}  // namespace

// Workspace bytes the backward needs for these shapes.
extern "C" long long gotennet_fused_htr_bwd_workspace(int G, int M, int D) {
  return (long long)(layout(G, M, D).total * sizeof(float));
}

// Launches on `stream` and allocates nothing (`work` holds at least
// gotennet_fused_htr_bwd_workspace bytes); returns the first CUDA error.
extern "C" int gotennet_fused_htr_bwd(
    const void* t, const void* eq, const void* ek, const float* rl,
    const float* wg, const float* bg, const float* g, float* gt, float* geq,
    float* gek, float* grl, float* gwg, float* gbg, float* work, int G, int M,
    int D, int lmax, int sep_htr, int rej, int gate, int pair_bf16,
    int t_bf16, int node_bf16, void* stream) {
  Params p;
  p.t = t; p.eq = eq; p.ek = ek; p.rl = rl; p.wg = wg; p.bg = bg; p.g = g;
  p.gt = gt; p.geq = geq; p.gek = gek; p.grl = grl; p.gwg = gwg; p.gbg = gbg;
  p.G = G; p.M = M; p.D = D; p.lmax = lmax;
  p.L = (lmax + 1) * (lmax + 1) - 1;
  p.P = (long long)G * M * M;
  p.sep_htr = sep_htr; p.rej = rej; p.gate = gate;
  if (G <= 0 || M <= 0) return (int)cudaSuccess;
  if (D % kNT || D % kKT || lmax < 1 || lmax > kMaxLmax || gate < 0 || gate > 3)
    return (int)cudaErrorInvalidValue;
  if (smem_layout(p, pair_bf16 != 0) > kMaxSmem) return (int)cudaErrorInvalidValue;
  p.rl_pairs = rl_pairs_for(p.L, sep_htr ? lmax : 1);
  const Layout w = layout(G, M, D);
  p.gz = work + w.gz; p.gw = work + w.gw; p.part = work + w.part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pair_bf16) {
    if (t_bf16) {
      err = node_bf16 ? backward<true, __nv_bfloat16, __nv_bfloat16>(p, 1, s)
                      : backward<true, __nv_bfloat16, float>(p, 1, s);
    } else {
      err = node_bf16 ? backward<true, float, __nv_bfloat16>(p, 0, s)
                      : backward<true, float, float>(p, 0, s);
    }
  } else if (t_bf16) {
    err = node_bf16 ? backward<false, __nv_bfloat16, __nv_bfloat16>(p, 1, s)
                    : backward<false, __nv_bfloat16, float>(p, 1, s);
  } else {
    err = node_bf16 ? backward<false, float, __nv_bfloat16>(p, 0, s)
                    : backward<false, float, float>(p, 0, s);
  }
  return (int)err;
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
