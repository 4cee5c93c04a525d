// The HTR update's backward, shared by the dense layout (fused_htr_bwd.cu)
// and the ELL layout (fused_htr_ell_bwd.cu).  Both see the pairs as one flat
// list of P rows of t, R consecutive pairs per EQ row; they differ only in
// the EK row a pair reads (kEll):
//  * dense: pair (g, i, j) of a [G, M, M] slab (R = M) reads EK row g*M + j,
//    and EK row g*M + j is read by the pairs (g, i, j) for i < M;
//  * ELL: slot (r, s) (R = K) reads EK row nbr[r, s] of the source table,
//    and table row n is read by the slots of the transposed slot list
//    (`starts`, `order`: a stable sort of the flat nbr, built once per batch
//    by the caller), in the list's order.  An index outside the table is
//    clamped so no read leaves it.
// Every sum has one owner and no sum uses atomics, so every result is the
// same from run to run:
//  A. per block of kRows consecutive pairs: z = t W_g on the tensor cores
//     (bf16 pair type) or as float32 FMAs, then per (pair, channel) g_w (the
//     cotangent of w) and g_z (of z), both to workspace; the block keeps its
//     rows of rnd(g_z) in shared memory and forms g_t = g + g_z W_g^T with a
//     second product;
//  B. per (EQ row, degree block, channel): g_EQ sums over the row's R pairs;
//     per (EK row, degree block, channel): g_EK sums over the pairs that read
//     it; each recomputes pq, pk and 2 - r2 of the pairs it visits;
//  C. per pair, a warp per pair: g_rl, sums over channels (each lane sums its
//     channels, then one thread per component adds the 32 lanes in order);
//  D. g_W_g = t^T g_z and g_b_g, sums over all pairs (bwd_sums.cuh: on the
//     tensor cores, through bf16 copies of t and g_z, for a bf16 pair type).
// A pair whose cotangent g is zero adds exact zeros to every output.
//
// Included after fused_htr_tile.cuh and bwd_sums.cuh; the including source
// defines run().

#pragma once

namespace {

constexpr int kMaxRlPairs = 64;                  // pairs per block of pass C

struct Params {
  const void* t;       // [P, D]  float or bf16
  const void* eq;      // [n_eq, L, D]  node type
  const void* ek;      // [n_ek, L, D]
  const float* rl;     // [P, L]
  const int* nbr;      // ELL: [P]  EK rows
  const float* wg;     // [D, D]  (in, out)
  const float* bg;     // [D]
  const float* g;      // [P, D]  cotangent of out
  const int* starts;   // ELL: [n_ek + 1]  row n's slots: order[starts[n]:starts[n+1]]
  const int* order;    // ELL: [P]  flat slot indices, sorted (stably) by nbr
  float *gt, *geq, *gek, *grl, *gwg, *gbg;
  // workspace: gz, gw [P, D] (cotangents of z and w); part (partials);
  // bf16 copies of t and g_z for the weight gradient (bf16 pair type)
  float *gz, *gw, *part;
  __nv_bfloat16 *tb, *gz_b;
  long long P;         // pairs
  int R;               // pairs per EQ row: M (dense) or K (ELL)
  int n_eq, n_ek;      // rows of EQ and of EK
  int D, L, lmax, sep_htr, rej, gate;
  // pass A's shared-memory carve-up, in bytes from the base
  int off_a, off_g, off_c, off_rl, smem;
  int rl_pairs;        // pairs per block of pass C (a multiple of 8)
};

// the EK row pair `pair` reads
template <bool kEll>
__device__ __forceinline__ long long ek_row(const Params& p, long long pair) {
  if constexpr (kEll) {
    return min(max(p.nbr[pair], 0), p.n_ek - 1);
  } else {
    return pair / ((long long)p.R * p.R) * p.R + pair % p.R;
  }
}

// ---- pass A: g_w, g_z to workspace; g_t = g + g_z W_g^T ------------------
template <bool kEll, bool kBF, typename TT, typename NT>
__global__ void __launch_bounds__(kThreads) pair_bwd_kernel(const Params p) {
  using AT = typename PairT<kBF>::type;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const long long p0 = (long long)blockIdx.x * kRows;
  const int TB = (int)(p.P - p0 < kRows ? p.P - p0 : kRows);
  const int D = p.D, L = p.L;
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
      const long long i = pair / p.R, j = ek_row<kEll>(p, pair);
      const float z = Cs[row * (kNT + 1) + c] + p.bg[cc];
      const float sg = sigmoid(z);
      const float w = pair_w<kBF>(p, eq + i * L * D + cc, ek + j * L * D + cc,
                                  rls + row * L);
      const float gwv = gate_fwd(w, p.gate);
      const float g = p.g[pair * D + cc];
      const float g_w = g * (z * sg) * gate_grad(w, gwv, p.gate);
      const float g_z = g * gwv * (sg + z * sg * (1.f - sg));
      p.gw[pair * D + cc] = g_w;
      p.gz[pair * D + cc] = g_z;
      if constexpr (kBF) p.gz_b[pair * D + cc] = __float2bfloat16(g_z);
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

// ---- pass B: g_EQ and g_EK ---------------------------------------------------
// one thread per (row n, degree block, channel c); blockIdx.y picks the
// side: 0 is g_EQ[n], a sum over pairs n*R .. n*R + R - 1; 1 is g_EK[n], a
// sum over the pairs that read EK row n
template <bool kEll, bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) node_grads_kernel(const Params p) {
  const int side = blockIdx.y;
  const int R = p.R, D = p.D, L = p.L, nb = n_blocks(p);
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)(side ? p.n_ek : p.n_eq) * nb * D) return;
  const int c = (int)(e % D), b = (int)(e / D % nb);
  const long long n = e / D / nb;
  const int lo = block_lo(p, b), hi = block_hi(p, b);
  const NT* eq = static_cast<const NT*>(p.eq);
  const NT* ek = static_cast<const NT*>(p.ek);
  const bool listed = kEll && side;
  const int u_lo = listed ? p.starts[n] : 0, u_hi = listed ? p.starts[n + 1] : R;
  // dense: the first row of n's graph and n's place in it (no division in
  // the loop)
  const long long first = n / R * R, at = n % R;
  float acc[kMaxL];
  for (int m = lo; m < hi; ++m) acc[m - lo] = 0.f;
  for (int u = u_lo; u < u_hi; ++u) {
    long long pair, i, j;
    if (side == 0) {
      pair = n * R + u;
      i = n;
      j = kEll ? ek_row<kEll>(p, pair) : first + u;
    } else if (listed) {
      pair = p.order[u];
      i = pair / R;
      j = n;
    } else {
      i = first + u;
      pair = i * R + at;
      j = n;
    }
    const NT* eqi = eq + i * L * D + c;
    const NT* ekj = ek + j * L * D + c;
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
  for (int m = lo; m < hi; ++m) out[(n * L + m) * D + c] = acc[m - lo];
}

// ---- pass C: g_rl, a warp per pair -------------------------------------------
// g_rl[pair, m] = sum_c (g_pq eq_m + g_pk ek_m) + 2 rl_m sum_c g_w rnd(pq pk)
// (the second sum is over the channels of m's degree block).  A block takes
// p.rl_pairs pairs, each warp one pair at a time; lane l sums channels l,
// l + 32, ... into shared memory, then one thread per (pair, component) adds
// the 32 lanes' partials in order.
template <bool kEll, bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_rl_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);   // [rl_pairs][nq][33]
  const int D = p.D, L = p.L, nb = n_blocks(p), nq = L + nb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long pair0 = (long long)blockIdx.x * p.rl_pairs;
  for (int r = warp; r < p.rl_pairs; r += kThreads / 32) {
    const long long pair = pair0 + r;
    float acc[kMaxL + kMaxLmax];
    for (int q = 0; q < nq; ++q) acc[q] = 0.f;
    if (pair < p.P && p.rej) {
      const NT* eq = static_cast<const NT*>(p.eq) + pair / p.R * L * D;
      const NT* ek = static_cast<const NT*>(p.ek) + ek_row<kEll>(p, pair) * L * D;
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

// ---- host side ----------------------------------------------------------------
// workspace layout, in floats
struct Layout {
  size_t gz, gw, part, bf, total;
};

Layout layout(long long P, int D) {
  Layout w;
  w.gz = 0;
  w.gw = w.gz + (size_t)P * D;
  w.part = up4(w.gw + (size_t)P * D);
  w.bf = up4(w.part + part_floats(P, D, D));
  w.total = w.bf + up8((size_t)P * D);   // two bf16 [P, D] copies
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

template <bool kEll, bool kBF, typename TT, typename NT>
cudaError_t backward(const Params& p, int t_bf16, cudaStream_t s) {
  const int D = p.D;
  // A. g_w, g_z, g_t
  auto pair_kern = pair_bwd_kernel<kEll, kBF, TT, NT>;
  CHECK(cudaFuncSetAttribute(pair_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem));
  CHECK(run(pair_kern, dim3((unsigned)((p.P + kRows - 1) / kRows)), p.smem,
            p, s));
  // B. g_EQ and g_EK (the grid covers the larger side)
  const long long rows = p.n_eq > p.n_ek ? p.n_eq : p.n_ek;
  const long long n_node = rows * (p.sep_htr ? p.lmax : 1) * D;
  CHECK(run(node_grads_kernel<kEll, kBF, NT>, dim3(blocks_for(n_node), 2), 0,
            p, s));
  // C. g_rl
  auto rl_kern = grad_rl_kernel<kEll, kBF, NT>;
  const size_t rl_smem = rl_smem_bytes(p);
  CHECK(cudaFuncSetAttribute(rl_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rl_smem));
  CHECK(run(rl_kern, dim3((unsigned)((p.P + p.rl_pairs - 1) / p.rl_pairs)),
            rl_smem, p, s));
  // D. g_W_g = rnd(t)^T rnd(g_z) and g_b_g = sum of g_z, over all pairs
  // (bf16 pair type: through the bf16 copies of t and g_z)
  Product gw{};
  gw.a = p.t; gw.a_sm = 1; gw.a_sk = D; gw.a_bf16 = t_bf16;
  gw.b = p.gz; gw.b_sk = D; gw.b_sn = 1;
  if constexpr (kBF) {
    if (!t_bf16) {
      CHECK(to_bf16_copy(static_cast<const float*>(p.t), p.P * D, p.tb, s));
      gw.a = p.tb;
    }
    gw.a_bf16 = 1;
    gw.b = p.gz_b;
    gw.b_bf16 = 1;
  }
  gw.out = p.gwg; gw.rows = D; gw.cols = D; gw.depth = (int)p.P;
  CHECK(product_over_pairs<kBF>(gw, p.part, s));
  return column_sums(p.gz, (int)p.P, D, p.part, p.gbg, s);
}

// Checks the shapes, lays out the workspace and launches every pass on
// `stream`; returns the first CUDA error.
template <bool kEll>
int launch_backward(Params& p, float* work, int pair_bf16, int t_bf16,
                    int node_bf16, void* stream) {
  p.L = (p.lmax + 1) * (p.lmax + 1) - 1;
  if (p.P <= 0) return (int)cudaSuccess;
  if (p.D % kNT || p.D % kKT || p.lmax < 1 || p.lmax > kMaxLmax ||
      p.gate < 0 || p.gate > 3)
    return (int)cudaErrorInvalidValue;
  if (smem_layout(p, pair_bf16 != 0) > kMaxSmem) return (int)cudaErrorInvalidValue;
  p.rl_pairs = rl_pairs_for(p.L, p.sep_htr ? p.lmax : 1);
  const Layout w = layout(p.P, p.D);
  p.gz = work + w.gz; p.gw = work + w.gw; p.part = work + w.part;
  p.tb = reinterpret_cast<__nv_bfloat16*>(work + w.bf);
  p.gz_b = p.tb + up8((size_t)p.P * p.D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  using BF = __nv_bfloat16;
  if (pair_bf16) {
    if (t_bf16) {
      err = node_bf16 ? backward<kEll, true, BF, BF>(p, 1, s)
                      : backward<kEll, true, BF, float>(p, 1, s);
    } else {
      err = node_bf16 ? backward<kEll, true, float, BF>(p, 0, s)
                      : backward<kEll, true, float, float>(p, 0, s);
    }
  } else if (t_bf16) {
    err = node_bf16 ? backward<kEll, false, BF, BF>(p, 1, s)
                    : backward<kEll, false, BF, float>(p, 1, s);
  } else {
    err = node_bf16 ? backward<kEll, false, float, BF>(p, 0, s)
                    : backward<kEll, false, float, float>(p, 0, s);
  }
  return (int)err;
}

}  // namespace
