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
// same from run to run.
//
// Bf16 pair type, lmax <= 2, EQ rows that fit a 128-pair tile (the MD22 and
// the ELL paths): the row pass (row_bwd_kernel), one block per dense EQ row
// or per three ELL rows of 36 slots, forms z, g_w, g_z, g_EQ and g_rl from
// one evaluation of each pair's terms, and writes the rounded g_w and g_pk,
// the bf16 g_z and each row's sums of g_z; then g_EK (col_bwd_kernel, a sum
// over other blocks' rows from those rounded terms, walking the transposed
// slot list on the ELL layout), g_t = g + g_z W_g^T and g_W_g = t^T g_z
// (bwd_sums.cuh's products) and g_b_g (the rows' sums in order).  On an H100
// the row pass is bounded by its per-(pair, channel) arithmetic and its one
// sweep of t and g (PERF.md §5 has the split).
//
// Every other case (a float32 pair type, lmax > 2, rows longer than the
// tile) takes four passes:
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
  __nv_bfloat16* wg_b;   // the row pass: bf16 copy of W_g
  __nv_bfloat16 *gw_b, *gpk_b;   // the row pass: rnd(g_w) [P, D], rnd(g_pk) [P, nb, D]
  float* bpart;          // the row pass: [n_eq][D] sums of g_z over a row
  long long P;         // pairs
  int R;               // pairs per EQ row: M (dense) or K (ELL)
  int n_eq, n_ek;      // rows of EQ and of EK
  int D, L, lmax, sep_htr, rej, gate;
  int t_f32;           // the row pass: write the bf16 copy of t (t is float)
  // pass A's shared-memory carve-up, in bytes from the base
  int off_a, off_g, off_c, off_rl, smem;
  // the row pass's
  int roff_a, roff_c, roff_eq, roff_rl, roff_red, roff_grl, roff_geq, roff_ek,
      rsmem;
  int TI;              // the row pass: EQ rows a block
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

// ---- the row pass (bf16 pair type, TI R <= kRT, lmax <= 2) ----------------
// One block per TI consecutive EQ rows, their TI R pairs in one tile (the
// dense layout takes one row of R = M pairs; the ELL layout as many rows of
// R = K slots as fill the tile): z = t W_g on the tensor cores, kRN columns
// at a time, W_g's bf16 copy streamed through kRStages kRK-deep stages
// (cp.async, fragments by ldmatrix.trans; a warp whose rows are all past
// the tile's pairs skips its products).  Then, in rounds of kRRows pairs a
// warp with each lane on two neighbouring channels, every load of a round
// issued before its arithmetic (the EK values of the pair's L components in
// registers): g_w and g_z, the terms S, pq, pk of each degree block once, and
// from them g_EQ's terms (summed over each EQ row's pairs: a warp's pairs of
// a row in a round in registers, the rounds in order, then the 8 warps in
// order) and g_rl's (summed over channels: the 32 lanes in order, then the
// slices in order).  Writes the rounded g_w and g_pk (for g_EK), the bf16
// g_z (for the g_t and g_W_g products), g_t = g (the g_t product adds to
// it), the bf16 copy of a float32 t, and each row's sums of g_z (for g_b_g).
constexpr int kRT = 128;         // pair rows of the tile
constexpr int kRN = 64;          // z columns per slice: two a lane
constexpr int kRK = 64;          // depth per stage of W_g
constexpr int kRStages = 3;      // stages in flight
constexpr int kRLd = kRN + 8;    // bf16 row stride of a stage, [kRK][kRLd]
constexpr int kRLdc = kRN + 4;   // float32 row stride of the z tile
constexpr int kRWarps = kThreads / 32;
constexpr int kRRows = 2;        // pairs a warp takes per round
constexpr int kRMaxL = 8;        // SH components kept in registers (lmax 2)

// one degree block's terms (as block_terms) at a lane's two channels, from
// the rounded EQ (e) and EK (k) values of components [lo, hi) in registers
// and the pair's rl (x) and rounded rl (xr); each rounding covers both
// channels (one packed conversion)
__device__ __forceinline__ void reg_terms(const float (&e)[2][kRMaxL],
                                          const float (&k)[2][kRMaxL],
                                          const float* x, const float* xr,
                                          int lo, int hi, int rej,
                                          Terms (&t)[2]) {
  float S[2] = {0.f, 0.f}, pq[2] = {0.f, 0.f}, pk[2] = {0.f, 0.f}, r2 = 0.f;
#pragma unroll
  for (int m = 0; m < kRMaxL; ++m) {
    if (m >= lo && m < hi) {
      float s0 = e[0][m] * k[0][m], s1 = e[1][m] * k[1][m];
      rnd2<true>(s0, s1);
      S[0] += s0;
      S[1] += s1;
      rnd2<true>(S[0], S[1]);
      if (rej) {
        float a0 = e[0][m] * xr[m], a1 = e[1][m] * xr[m];
        float b0 = k[0][m] * xr[m], b1 = k[1][m] * xr[m];
        rnd2<true>(a0, a1);
        rnd2<true>(b0, b1);
        pq[0] += a0;
        pq[1] += a1;
        pk[0] += b0;
        pk[1] += b1;
        rnd2<true>(pq[0], pq[1]);
        rnd2<true>(pk[0], pk[1]);
        r2 += x[m] * x[m];
      }
    }
  }
  for (int c = 0; c < 2; ++c) t[c] = Terms{S[c], pq[c], pk[c], 2.f - r2};
}

template <bool kEll, typename TT, typename NT>
__global__ void __launch_bounds__(kThreads, 1) row_bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const long long i0 = (long long)blockIdx.x * p.TI;   // the first EQ row
  const int TI = (int)(p.n_eq - i0 < p.TI ? p.n_eq - i0 : p.TI);
  const int R = p.R, D = p.D, L = p.L, nb = n_blocks(p), nq = L + nb;
  const int TB = TI * R;                                // the tile's pairs
  const long long p0 = i0 * R, j_first = i0 / R * R;   // dense: EK row of j = 0
  const int lda = D + kPadBF;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  using BF = __nv_bfloat16;
  BF* ring = reinterpret_cast<BF*>(base);                  // [kRStages][kRK][kRLd]
  BF* As = reinterpret_cast<BF*>(base + p.roff_a);         // [kRT][lda] rnd(t)
  float* Cs = reinterpret_cast<float*>(base + p.roff_c);   // [kRT][kRLdc] z, g_z
  BF* eqs = reinterpret_cast<BF*>(base + p.roff_eq);       // [TI][L][D] rnd(EQ)
  float* rls = reinterpret_cast<float*>(base + p.roff_rl); // [kRT][L]
  float* red = reinterpret_cast<float*>(base + p.roff_red);  // [8][kRRows][nq][33]
  float* grl = reinterpret_cast<float*>(base + p.roff_grl);  // [kRT][nq]
  float* geq = reinterpret_cast<float*>(base + p.roff_geq);  // [TI][8][L][kRN]
  int* eks = reinterpret_cast<int*>(base + p.roff_ek);       // ELL: [kRT] EK rows
  const TT* __restrict__ t = static_cast<const TT*>(p.t);
  const NT* __restrict__ ek = static_cast<const NT*>(p.ek);

  // the stream of W_g tiles: tile u is depth stage u % nk of slice u / nk
  const int nsl = (D + kRN - 1) / kRN, nk = (D + kRK - 1) / kRK;
  const int n_tiles = nsl * nk;
  auto load_tile = [&](int u) {
    const int n0 = u / nk * kRN, k0 = u % nk * kRK;
    BF* s = ring + (u % kRStages) * kRK * kRLd;
    for (int c = tid; c < kRK * kRN / 8; c += kThreads) {
      const int r = c / (kRN / 8), n = 8 * (c % (kRN / 8));
      int b = k0 + r < D ? D - (n0 + n) : 0;
      b = b < 0 ? 0 : (b > 8 ? 8 : b);
      cp_async16(s + r * kRLd + n,
                 b > 0 ? p.wg_b + (size_t)(k0 + r) * D + n0 + n : p.wg_b,
                 2 * b);
    }
  };
  for (int u = 0; u < kRStages - 1; ++u) {
    if (u < n_tiles) load_tile(u);
    cp_async_commit();
  }

  // the tile's t (rounded; rows past TB zero), four values a step; the EQ
  // rows, rounded; rl; ELL: the clamped EK row of each slot
#pragma unroll 4
  for (int e = tid; e < kRT * D / 4; e += kThreads) {
    const int row = e / (D / 4), c = 4 * (e % (D / 4));
    float4 val = {0.f, 0.f, 0.f, 0.f};
    if (row < TB) {
      val = load4(t + (p0 + row) * D + c);
      if (p.t_f32) store4_bf16(p.tb + (p0 + row) * D + c, val);
    }
    store4_bf16(As + row * lda + c, val);
  }
  for (int e = tid; e < TI * L * D; e += kThreads) {
    eqs[e] = __float2bfloat16(to_f(static_cast<const NT*>(p.eq)[i0 * L * D + e]));
  }
  for (int e = tid; e < TB * L; e += kThreads) rls[e] = p.rl[p0 * L + e];
  for (int e = tid; e < TB * nq; e += kThreads) grl[e] = 0.f;
  if constexpr (kEll) {
    for (int e = tid; e < TB; e += kThreads) eks[e] = (int)ek_row<true>(p, p0 + e);
  }

  // degree blocks: [0, hi0) and, with separate degrees at lmax 2, [3, L)
  const int hi0 = p.sep_htr ? min(3, L) : L;
  const bool two = nb == 2;
  const int wm = warp / 2, wn = warp % 2, gq = lane / 4, tq = lane % 4;
  const bool active = wm * 32 < TB;   // this warp's rows hold pairs
  int tile = 0;
  for (int sl = 0; sl < nsl; ++sl) {
    // z tile = rnd(t) rnd(W_g)[:, n0 : n0 + kRN]; a warp owns 32 x 32
    float acc[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;
      }
    }
    for (int kt = 0; kt < nk; ++kt, ++tile) {
      cp_async_wait<kRStages - 2>();
      __syncthreads();   // tile is in; every warp is done with tile - 1
      if (tile + kRStages - 1 < n_tiles) load_tile(tile + kRStages - 1);
      cp_async_commit();
      if (!active) continue;
      const BF* Ws = ring + (tile % kRStages) * kRK * kRLd;
      const int k_hi = min(kRK, D - kt * kRK);   // a multiple of 16
      for (int kk = 0; kk < k_hi; kk += 16) {
        mma_16816_tile<2, 4, false, true, true>(
            As + wm * 32 * lda + kt * kRK + kk, lda, Ws + kk * kRLd + wn * 32,
            kRLd, acc);
      }
    }
    if (active) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            Cs[(wm * 32 + 16 * a + gq + (r >= 2 ? 8 : 0)) * kRLdc + wn * 32 +
               8 * b + 2 * tq + (r & 1)] = acc[a][b][r];
          }
        }
      }
    }
    for (int e = tid; e < TI * kRWarps * L * kRN; e += kThreads) geq[e] = 0.f;
    __syncthreads();

    const int n0 = sl * kRN, w = min(kRN, D - n0);
    const int cl = 2 * lane, c = n0 + cl;   // this lane's two channels
    const bool on = cl < w;
    // the EQ row's values at these channels, rounded (e2 holds row il_e of
    // the tile), and b_g
    float e2[2][kRMaxL];
    int il_e = -1;
    auto load_eq = [&](int il) {
#pragma unroll
      for (int m = 0; m < kRMaxL; ++m) {
        const bool in = on && m < L;
        e2[0][m] = in ? __bfloat162float(eqs[(il * L + m) * D + c]) : 0.f;
        e2[1][m] = in ? __bfloat162float(eqs[(il * L + m) * D + c + 1]) : 0.f;
      }
      il_e = il;
    };
    if constexpr (!kEll) load_eq(0);
    const float2 bgc = on ? load2(p.bg + c) : float2{0.f, 0.f};
    // rounds of kRRows pairs a warp, the warps apart from each other; a
    // warp's pairs of a round lie in one EQ row (R even, or one row a
    // block); lane l's g_rl partials meet in the warp's part of `red`, then
    // lanes 0..nq-1 add the 32 lanes of each pair in order
    float* rw = red + warp * kRRows * nq * 33;
    for (int r0 = 0; r0 < TB; r0 += kRWarps * kRRows) {
      const int row0 = r0 + warp * kRRows;
      const int il = kEll ? min(row0, TB - 1) / R : 0;   // its EQ row
      if constexpr (kEll) {
        if (il != il_e) load_eq(il);
      }
      // every load of the round first
      float2 zz[kRRows], gg[kRRows], kk[kRRows][kRMaxL];
#pragma unroll
      for (int u = 0; u < kRRows; ++u) {
        const int row = row0 + u;
        const bool in = on && row < TB;
        const long long pair = p0 + row;
        zz[u] = in ? float2{Cs[row * kRLdc + cl], Cs[row * kRLdc + cl + 1]}
                   : float2{0.f, 0.f};
        gg[u] = in ? load2(p.g + pair * D + c) : float2{0.f, 0.f};
        const long long jr = kEll ? (in ? eks[row] : 0) : j_first + (in ? row : 0);
        const NT* ekj = ek + jr * L * D + c;
#pragma unroll
        for (int m = 0; m < kRMaxL; ++m) {
          kk[u][m] = in && m < L ? load2(ekj + m * D) : float2{0.f, 0.f};
        }
      }
      float geq_acc[kRMaxL][2];
#pragma unroll
      for (int m = 0; m < kRMaxL; ++m) geq_acc[m][0] = geq_acc[m][1] = 0.f;
#pragma unroll
      for (int u = 0; u < kRRows; ++u) {
        const int row = row0 + u;
        const bool in = on && row < TB;
        const long long pair = p0 + row;
        const float* rlp = rls + (in ? row : 0) * L;
        float x[kRMaxL], xr[kRMaxL], k[2][kRMaxL];
#pragma unroll
        for (int m = 0; m < kRMaxL; m += 2) {
          x[m] = m < L ? rlp[m] : 0.f;
          x[m + 1] = m + 1 < L ? rlp[m + 1] : 0.f;
          xr[m] = x[m];
          xr[m + 1] = x[m + 1];
          rnd2<true>(xr[m], xr[m + 1]);
        }
#pragma unroll
        for (int m = 0; m < kRMaxL; ++m) {
          k[0][m] = kk[u][m].x;
          k[1][m] = kk[u][m].y;
          rnd2<true>(k[0][m], k[1][m]);
        }
        // the terms of each degree block, both channels at once
        Terms tm[2][2];   // [block][channel]
        reg_terms(e2, k, x, xr, 0, hi0, p.rej, tm[0]);
        if (two) {
          reg_terms(e2, k, x, xr, 3, L, p.rej, tm[1]);
        } else {
          tm[1][0] = tm[1][1] = Terms{0.f, 0.f, 0.f, 0.f};
        }
        float rq[2][2];   // rnd(pq pk) [block][channel]
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          rq[b][0] = tm[b][0].pq * tm[b][0].pk;
          rq[b][1] = tm[b][1].pq * tm[b][1].pk;
          rnd2<true>(rq[b][0], rq[b][1]);
        }
        float g_w[2], g_z[2], gwp[2];
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          float wv = 0.f;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            if (b == 0 || two) {
              wv = p.rej ? wv + tm[b][ch].S - rq[b][ch] * tm[b][ch].a
                         : wv + tm[b][ch].S;
            }
          }
          const float zv = (ch ? zz[u].y : zz[u].x) + (ch ? bgc.y : bgc.x);
          const float g = ch ? gg[u].y : gg[u].x;
          const float sg = sigmoid(zv);
          const float gwv = gate_fwd(wv, p.gate);
          g_w[ch] = g * (zv * sg) * gate_grad(wv, gwv, p.gate);
          g_z[ch] = g * gwv * (sg + zv * sg * (1.f - sg));
          gwp[ch] = g_w[ch];
        }
        rnd2<true>(gwp[0], gwp[1]);
        float grl_acc[kRMaxL + 2], gpk_out[2][2];
#pragma unroll
        for (int q = 0; q < kRMaxL + 2; ++q) grl_acc[q] = 0.f;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          gpk_out[b][0] = gpk_out[b][1] = 0.f;
          if (b == 1 && !two) continue;
          const int lo = b ? 3 : 0, hi = b ? L : hi0;
          float gpq[2], gpk[2], gp[2];
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            gpq[ch] = -(g_w[ch] * tm[b][ch].pk) * tm[b][ch].a;
            gpk[ch] = -(g_w[ch] * tm[b][ch].pq) * tm[b][ch].a;
            gp[ch] = gpq[ch];
            gpk_out[b][ch] = gpk[ch];
          }
          rnd2<true>(gp[0], gp[1]);
          if (p.rej) {
            grl_acc[kRMaxL + b] += g_w[0] * rq[b][0];
            grl_acc[kRMaxL + b] += g_w[1] * rq[b][1];
          }
#pragma unroll
          for (int m = 0; m < kRMaxL; ++m) {
            if (m < lo || m >= hi) continue;
            float v0 = gwp[0] * k[0][m], v1 = gwp[1] * k[1][m];
            rnd2<true>(v0, v1);
            if (p.rej) {
              float q0 = gp[0] * xr[m], q1 = gp[1] * xr[m];
              rnd2<true>(q0, q1);
              v0 += q0;
              v1 += q1;
              rnd2<true>(v0, v1);
              grl_acc[m] += gpq[0] * e2[0][m] + gpk[0] * k[0][m];
              grl_acc[m] += gpq[1] * e2[1][m] + gpk[1] * k[1][m];
            }
            geq_acc[m][0] += v0;
            geq_acc[m][1] += v1;
          }
        }
        if (in) {
          store2_bf16(p.gw_b + pair * D + c, g_w[0], g_w[1]);
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            if (b == 0 || two) {
              store2_bf16(p.gpk_b + (pair * nb + b) * D + c, gpk_out[b][0],
                          gpk_out[b][1]);
            }
          }
          *reinterpret_cast<float2*>(p.gt + pair * D + c) = gg[u];
          store2_bf16(p.gz_b + pair * D + c, g_z[0], g_z[1]);
          Cs[row * kRLdc + cl] = g_z[0];
          Cs[row * kRLdc + cl + 1] = g_z[1];
        }
        float* ru = rw + u * nq * 33;
#pragma unroll
        for (int m = 0; m < kRMaxL; ++m) {
          if (m < L) ru[m * 33 + lane] = grl_acc[m];
        }
        ru[L * 33 + lane] = grl_acc[kRMaxL];
        if (two) ru[(L + 1) * 33 + lane] = grl_acc[kRMaxL + 1];
      }
      if (on) {
        float* gm = geq + (il * kRWarps + warp) * L * kRN + cl;
#pragma unroll
        for (int m = 0; m < kRMaxL; ++m) {
          if (m < L) {
            gm[m * kRN] += geq_acc[m][0];
            gm[m * kRN + 1] += geq_acc[m][1];
          }
        }
      }
      __syncwarp();
      for (int u = 0; u < kRRows; ++u) {
        const int row = row0 + u;
        if (row < TB && lane < nq) {
          const float* ru = rw + (u * nq + lane) * 33;
          float sum = 0.f;
          for (int l = 0; l < 32; ++l) sum += ru[l];
          grl[row * nq + lane] += sum;
        }
      }
      __syncwarp();   // the warp's part of `red` is written again next round
    }
    __syncthreads();
    // g_EQ[i0 + il, :, n0 + c]: the 8 warps' partials in order; each row's
    // sums of g_z, its pairs in order
    for (int e = tid; e < TI * L * w; e += kThreads) {
      const int ce = e % w, m = e / w % L, il = e / w / L;
      float sum = 0.f;
      for (int wp = 0; wp < kRWarps; ++wp) {
        sum += geq[((il * kRWarps + wp) * L + m) * kRN + ce];
      }
      p.geq[((i0 + il) * L + m) * D + n0 + ce] = sum;
    }
    for (int e = tid; e < TI * w; e += kThreads) {
      const int ce = e % w, il = e / w;
      float sum = 0.f;
      for (int row = il * R; row < il * R + R; ++row) sum += Cs[row * kRLdc + ce];
      p.bpart[(i0 + il) * D + n0 + ce] = sum;
    }
    __syncthreads();   // Cs and geq are reused by the next slice
  }
  for (int e = tid; e < TB * L; e += kThreads) {
    const int row = e / L, m = e % L;
    int b = 0;
    while (m >= block_hi(p, b)) ++b;
    p.grl[(p0 + row) * L + m] =
        p.rej ? grl[row * nq + m] + 2.f * rls[row * L + m] * grl[row * nq + L + b]
              : 0.f;
  }
  cp_async_wait<0>();
}

// ---- g_EK after the row pass: a thread per (EK row n, channel c) -----------
// g_EK[n, m, c] = sum over the pairs (i, n) that read EK row n of
// rnd(rnd(g_w) rnd(EQ[i, m, c])) (+ rnd(g_pk) rnd(rl[m]), rounded, with the
// rejection terms), from the rounded g_w and g_pk the row pass wrote (each
// pair's terms are formed once, there): dense, the pairs of n's graph in
// order of i; ELL, the slots of n's transposed slot list in the list's order
// (a row no slot reads gets exact zeros).  Two pairs' loads in flight, four
// on the ELL layout (its pairs come through the list).
template <bool kEll, typename NT>
__global__ void __launch_bounds__(kThreads) col_bwd_kernel(const Params p) {
  const int R = p.R, D = p.D, L = p.L, nb = n_blocks(p);
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)p.n_ek * D) return;
  const int c = (int)(e % D);
  const long long n = e / D, first = n / R * R, at = n % R;
  const NT* eq = static_cast<const NT*>(p.eq);
  const int hi0 = p.sep_htr ? min(3, L) : L;
  float acc[kRMaxL];
#pragma unroll
  for (int m = 0; m < kRMaxL; ++m) acc[m] = 0.f;
  // the terms of pair `pair`, whose EQ row is i
  auto add = [&](long long pair, long long i) {
    const float gwp = to_f(p.gw_b[pair * D + c]);
    const float gp0 = p.rej ? to_f(p.gpk_b[pair * nb * D + c]) : 0.f;
    const float gp1 = p.rej && nb == 2 ? to_f(p.gpk_b[(pair * nb + 1) * D + c]) : 0.f;
    const NT* eqi = eq + i * L * D + c;
    const float* rlp = p.rl + pair * L;
    float x[kRMaxL];
#pragma unroll
    for (int m = 0; m < kRMaxL; ++m) x[m] = m < L ? to_f(eqi[m * D]) : 0.f;
#pragma unroll
    for (int m = 0; m < kRMaxL; ++m) {
      if (m < L) {
        float v = rnd<true>(gwp * rnd<true>(x[m]));
        if (p.rej) {
          const float gp = m < hi0 ? gp0 : gp1;
          v = rnd<true>(v + rnd<true>(gp * rnd<true>(rlp[m])));
        }
        acc[m] += v;
      }
    }
  };
  if constexpr (kEll) {
    // the list's slots, four in flight
    auto add_slot = [&](int u) {
      const long long pair = p.order[u];
      add(pair, pair / R);
    };
    const int u_hi = p.starts[n + 1];
    int u = p.starts[n];
    for (; u + 3 < u_hi; u += 4) {
      add_slot(u);
      add_slot(u + 1);
      add_slot(u + 2);
      add_slot(u + 3);
    }
    for (; u < u_hi; ++u) add_slot(u);
  } else {
    // the pairs (i, n) of n's graph, two in flight
    auto add_row = [&](int i) { add((first + i) * R + at, first + i); };
    int i = 0;
    for (; i + 1 < R; i += 2) {
      add_row(i);
      add_row(i + 1);
    }
    if (i < R) add_row(i);
  }
#pragma unroll
  for (int m = 0; m < kRMaxL; ++m) {
    if (m < L) p.gek[(n * L + m) * D + c] = acc[m];
  }
}

// ---- host side ----------------------------------------------------------------
// workspace layout, in floats
struct Layout {
  size_t gz, gw, part, bf, wg, bpart, total;
};

Layout layout(long long P, int D, int n_eq) {
  Layout w;
  w.gz = 0;
  w.gw = w.gz + (size_t)P * D;
  w.part = up4(w.gw + (size_t)P * D);
  w.bf = up4(w.part + part_floats(P, D, D));
  w.wg = w.bf + up8((size_t)P * D);      // two bf16 [P, D] copies
  w.bpart = w.wg + up8((size_t)D * D) / 2;   // bf16 W_g
  w.total = w.bpart + (size_t)n_eq * D;
  return w;
}

// the row pass's shared arrays for p.TI EQ rows a block, byte offsets;
// returns the total
size_t row_smem_layout(Params& p) {
  auto up16 = [](size_t x) { return (x + 15) / 16 * 16; };
  const size_t nq = (size_t)p.L + (p.sep_htr ? p.lmax : 1);
  size_t off = up16((size_t)kRStages * kRK * kRLd * 2);
  p.roff_a = (int)off;
  off = up16(off + (size_t)kRT * (p.D + kPadBF) * 2);
  p.roff_c = (int)off;
  off += (size_t)kRT * kRLdc * sizeof(float);
  p.roff_eq = (int)off;
  off = up16(off + (size_t)p.TI * p.L * p.D * 2);
  p.roff_rl = (int)off;
  off += (size_t)kRT * p.L * sizeof(float);
  p.roff_red = (int)off;
  off += (size_t)kRWarps * kRRows * nq * 33 * sizeof(float);
  p.roff_grl = (int)off;
  off += (size_t)kRT * nq * sizeof(float);
  p.roff_geq = (int)off;
  off += (size_t)p.TI * kRWarps * p.L * kRN * sizeof(float);
  p.roff_ek = (int)off;
  off += (size_t)kRT * sizeof(int);
  p.rsmem = (int)off;
  return off;
}

// EQ rows a block of the row pass takes: one dense row (R = M), or as many
// ELL rows as fill the tile and the shared memory; 0 when not even one fits
// (or lmax > 2), and the four passes run instead
template <bool kEll>
int row_pass_rows(Params& p) {
  if (p.lmax > 2 || p.R > kRT) return 0;
  // a warp's kRRows pairs of a round stay in one EQ row when R is even
  for (p.TI = kEll && p.R % kRRows == 0 ? kRT / p.R : 1; p.TI > 0; --p.TI) {
    if (row_smem_layout(p) <= kMaxSmem) break;
  }
  return p.TI;
}

// Bf16 pair type, whole EQ rows in one tile: the row pass, then g_EK, g_t,
// g_W_g and g_b_g; returns the first CUDA error.
template <bool kEll, typename TT, typename NT>
cudaError_t row_backward(Params p, int t_bf16, cudaStream_t s) {
  const int D = p.D;
  // the row path needs no float32 g_z or g_w: their room holds the bf16
  // rnd(g_w) [P, D] and rnd(g_pk) [P, nb <= 2, D]
  p.gw_b = reinterpret_cast<__nv_bfloat16*>(p.gz);
  p.gpk_b = reinterpret_cast<__nv_bfloat16*>(p.gw);
  CHECK(to_bf16_copy(p.wg, (long long)D * D, p.wg_b, s));
  p.t_f32 = !t_bf16;
  auto kern = row_bwd_kernel<kEll, TT, NT>;
  CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.rsmem));
  CHECK(run(kern, dim3((unsigned)((p.n_eq + p.TI - 1) / p.TI)), p.rsmem, p,
            s));
  // g_EK from the rounded g_w and g_pk
  CHECK(run(col_bwd_kernel<kEll, NT>, dim3(blocks_for((long long)p.n_ek * D)),
            0, p, s));
  // g_t = g + rnd(g_z) rnd(W_g)^T (the row pass wrote g into g_t)
  Product gt{};
  gt.a = p.gz_b; gt.a_sm = D; gt.a_sk = 1; gt.a_bf16 = 1;
  gt.b = p.wg_b; gt.b_sk = 1; gt.b_sn = D; gt.b_bf16 = 1;
  gt.out = p.gt; gt.o_sm = D;
  gt.rows = (int)p.P; gt.cols = D; gt.depth = D; gt.accumulate = 1;
  CHECK(product<true>(gt, s));
  // g_W_g = rnd(t)^T rnd(g_z), through the bf16 copies
  Product gw{};
  gw.a = t_bf16 ? p.t : p.tb; gw.a_sm = 1; gw.a_sk = D; gw.a_bf16 = 1;
  gw.b = p.gz_b; gw.b_sk = D; gw.b_sn = 1; gw.b_bf16 = 1;
  gw.out = p.gwg; gw.rows = D; gw.cols = D; gw.depth = (int)p.P;
  CHECK(product_over_pairs<true>(gw, p.part, s));
  // g_b_g: the rows' sums of g_z, in order
  constexpr int kWarps = kThreads / 32;
  return run(strip_sum_kernel, dim3((unsigned)((D + kWarps - 1) / kWarps)),
             (size_t)kWarps * kLanePad * sizeof(float),
             PartSum{p.bpart, p.gbg, D, p.n_eq}, s);
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
cudaError_t backward(Params p, int t_bf16, cudaStream_t s) {
  const int D = p.D;
  if constexpr (kBF) {
    if (row_pass_rows<kEll>(p) > 0) return row_backward<kEll, TT, NT>(p, t_bf16, s);
  }
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
  const Layout w = layout(p.P, p.D, p.n_eq);
  p.gz = work + w.gz; p.gw = work + w.gw; p.part = work + w.part;
  p.tb = reinterpret_cast<__nv_bfloat16*>(work + w.bf);
  p.gz_b = p.tb + up8((size_t)p.P * p.D);
  p.wg_b = reinterpret_cast<__nv_bfloat16*>(work + w.wg);
  p.bpart = work + w.bpart;
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
