// The HTR update's forward, shared by the dense layout (fused_htr_fwd.cu)
// and the ELL layout (fused_htr_ell_fwd.cu).  Both see the pairs as one flat
// list of P rows of t, R consecutive pairs per EQ row; they differ only in
// the EK row a pair reads (ek_row: dense, g*M + j; ELL, nbr[r, s] clamped
// into the table).  The update masks no pair and sums nothing across pairs,
// so a block owns its pairs' outputs and every result is the same from run
// to run.
//
// Bf16 pair type, lmax <= 2 (the MD22 and the ELL paths): the row path.
// W_g, and a float32 node table, are rounded to bf16 once a launch
// (round_bf16_kernel) into the workspace.  A block, two an SM, then takes
// kFT consecutive pairs, whatever EQ rows they belong to: their rounded t
// rows, the EQ rows they read (rounded), their rl rounded once per pair and
// 2 - r2 once per degree block stay in shared memory; z = t W_g runs on
// mma.sync, 64 columns at a time, from the ring of bf16 W_g stages of the
// backward's row pass (fused_htr_tile.cuh).  The epilogue takes a warp per
// pair (kFRows a round) and a lane per two neighbouring channels: z and t
// in 8-byte accesses, the EQ row's values held packed in registers while
// the warp's pairs stay in it, the EK values gathered 4 bytes a lane, every
// rounding of S, pq, pk and pq pk one packed bf16 instruction for both
// channels (pair_terms), no runtime division, `out` written 8 bytes a lane.
//
// Every other case (a float32 pair type, lmax > 2, EQ rows so short that
// the ones a block touches overflow its shared memory) takes the
// slice-by-slice path: kRows pairs a block, W_g rounded per 32-column
// slice, one (pair, channel) a thread.
//
// Included after fused_htr_tile.cuh; the including source defines run().

#pragma once

namespace {

struct Params {
  const void* t;       // [P, D]  float or bf16
  const void* eq;      // [n_eq, L, D]  node type
  const void* ek;      // [n_ek, L, D]
  const float* rl;     // [P, L]
  const int* nbr;      // ELL: [P]  EK rows
  const float* wg;     // [D, D]  (in, out)
  const float* bg;     // [D]
  float* out;          // [P, D]
  // the row path: bf16 W_g, EQ and EK (copies, or the tables themselves)
  const __nv_bfloat16 *wg_b, *eq_b, *ek_b;
  long long P;         // pairs
  int R;               // pairs per EQ row: M (dense) or K (ELL)
  int n_eq, n_ek;      // rows of EQ and of EK
  int D, L, lmax, sep_htr, rej, gate;
  // the slice path's shared-memory carve-up, in bytes from the base
  int off_a, off_c, off_rl, smem;
  // the row path's
  int roff_a, roff_c, roff_eq, roff_xr, roff_r2, roff_idx, rsmem;
};

// ---- the slice path -----------------------------------------------------------
template <bool kEll, bool kBF, typename TT, typename NT>
__global__ void __launch_bounds__(kThreads) slice_fwd_kernel(const Params p) {
  using AT = typename PairT<kBF>::type;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const long long p0 = (long long)blockIdx.x * kRows;
  const int TB = (int)(p.P - p0 < kRows ? p.P - p0 : kRows);
  const int D = p.D, L = p.L;
  const int lda = a_stride(D, kBF);
  const int tid = threadIdx.x;

  void* Wbuf = base;                                      // W slice
  AT* As = reinterpret_cast<AT*>(base + p.off_a);         // [kRows][lda]
  float* Cs = reinterpret_cast<float*>(base + p.off_c);   // [kRows][kNT + 1]
  float* rls = reinterpret_cast<float*>(base + p.off_rl); // [kRows][L]

  const TT* __restrict__ t = static_cast<const TT*>(p.t);
  const NT* __restrict__ eq = static_cast<const NT*>(p.eq);
  const NT* __restrict__ ek = static_cast<const NT*>(p.ek);

  // the block's t rows (rounded) and rl rows
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int row = e / D, c = e % D;
    store(&As[row * lda + c],
          row < TB ? rnd<kBF>(to_f(t[(p0 + row) * D + c])) : 0.f);
  }
  for (int e = tid; e < TB * L; e += kThreads) rls[e] = p.rl[p0 * L + e];
  __syncthreads();

  // per 32-column slice: z = t W_g, then one (pair, channel) a thread
  for (int n0 = 0; n0 < D; n0 += kNT) {
    product_tile<kBF>(As, lda, TB, p.wg, D, 1, n0, D, Wbuf, Cs);
    for (int e = tid; e < TB * kNT; e += kThreads) {
      const int row = e / kNT, c = e % kNT, cc = n0 + c;
      const long long pair = p0 + row;
      const long long i = pair / p.R, j = ek_row<kEll>(p, pair);
      const float z = Cs[row * (kNT + 1) + c] + p.bg[cc];
      const float gt = z * sigmoid(z);
      const float w = pair_w<kBF>(p, eq + i * L * D + cc,
                                  ek + j * L * D + cc, rls + row * L);
      p.out[pair * D + cc] = to_f(t[pair * D + cc]) + gt * gate_fwd(w, p.gate);
    }
    __syncthreads();
  }
}

// ---- the row path -------------------------------------------------------------
constexpr int kFT = 64;          // pairs a block: two blocks an SM
constexpr int kFRows = 4;        // pairs a warp takes per round
constexpr int kFMaxB = 2;        // degree blocks (lmax <= 2)

template <bool kEll, typename TT>
__global__ void __launch_bounds__(kThreads, 2) row_fwd_kernel(const Params p) {
  using BF = __nv_bfloat16;
  // warps over the z slice: kWM along the pairs, 32 rows each
  constexpr int kWM = kFT / 32, kWN = kRWarps / kWM, kNI = kRN / kWN / 8;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const long long p0 = (long long)blockIdx.x * kFT;
  const int TB = (int)(p.P - p0 < kFT ? p.P - p0 : kFT);
  const int R = p.R, D = p.D, L = p.L;
  const int lda = D + kPadBF;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  BF* ring = reinterpret_cast<BF*>(base);                   // [kRStages][kRK][kRLd]
  BF* As = reinterpret_cast<BF*>(base + p.roff_a);          // [kFT][lda] rnd(t)
  float* Cs = reinterpret_cast<float*>(base + p.roff_c);    // [kFT][kRLdc] z
  BF* eqs = reinterpret_cast<BF*>(base + p.roff_eq);        // [EQ rows a tile touches][L][D]
  BF2* xrs = reinterpret_cast<BF2*>(base + p.roff_xr);      // [kFT][kRMaxL] rnd(rl)
  float* as = reinterpret_cast<float*>(base + p.roff_r2);   // [kFT][kFMaxB] 2 - r2
  int* ers = reinterpret_cast<int*>(base + p.roff_idx);     // [kFT] EQ row, of eqs
  int* eks = ers + kFT;                                     // [kFT] EK row
  const TT* __restrict__ t = static_cast<const TT*>(p.t);

  // the stream of W_g tiles: tile u is depth stage u % nk of slice u / nk
  const int nsl = (D + kRN - 1) / kRN, nk = (D + kRK - 1) / kRK;
  const int n_tiles = nsl * nk;
  auto load_tile = [&](int u) {
    load_w_tile(ring + (u % kRStages) * kRK * kRLd, p.wg_b, D, u / nk * kRN,
                u % nk * kRK);
  };
  for (int u = 0; u < kRStages - 1; ++u) {
    if (u < n_tiles) load_tile(u);
    cp_async_commit();
  }

  // the tile's t, rounded (rows past TB zero), four values a step; the EQ
  // rows its pairs read, 16 bytes a step; per pair its EQ and EK rows, its
  // rl rounded (both halves alike) and 2 - r2 of each degree block
#pragma unroll 4
  for (int e = tid; e < kFT * D / 4; e += kThreads) {
    const int row = e / (D / 4), c = 4 * (e % (D / 4));
    float4 val = {0.f, 0.f, 0.f, 0.f};
    if (row < TB) val = load4(t + (p0 + row) * D + c);
    store4_bf16(As + row * lda + c, val);
  }
  const long long i_first = p0 / R;
  const int n_rows = (int)((p0 + TB - 1) / R - i_first + 1);
  const float4* eq_src = reinterpret_cast<const float4*>(p.eq_b + i_first * L * D);
  for (int e = tid; e < n_rows * L * D / 8; e += kThreads) {
    reinterpret_cast<float4*>(eqs)[e] = eq_src[e];   // 8 bf16 values, as bits
  }
  const int hi0 = p.sep_htr ? min(3, L) : L;
  const bool two = p.sep_htr && L > 3;
  for (int row = tid; row < TB; row += kThreads) {
    const long long pair = p0 + row;
    ers[row] = (int)(pair / R - i_first);
    eks[row] = (int)ek_row<kEll>(p, pair);
    float r2a = 0.f, r2b = 0.f;   // over [0, hi0) and [hi0, L)
#pragma unroll
    for (int m = 0; m < kRMaxL; ++m) {
      const float x = m < L ? p.rl[pair * L + m] : 0.f;
      xrs[row * kRMaxL + m] = bf2_round(x, x);
      if (m < hi0) {
        r2a += x * x;
      } else {
        r2b += x * x;
      }
    }
    as[row * kFMaxB] = 2.f - (p.rej ? r2a : 0.f);
    as[row * kFMaxB + 1] = 2.f - (p.rej ? r2b : 0.f);
  }

  const int wm = warp / kWN, wn = warp % kWN, gq = lane / 4, tq = lane % 4;
  const bool active = wm * 32 < TB;   // this warp's rows hold pairs
  int tile = 0;
  for (int sl = 0; sl < nsl; ++sl) {
    // z tile = rnd(t) rnd(W_g)[:, n0 : n0 + kRN]; a warp owns 32 x kRN / kWN
    float acc[2][kNI][4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < kNI; ++b) {
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
        mma_16816_tile<2, kNI, false, true, true>(
            As + wm * 32 * lda + kt * kRK + kk, lda,
            Ws + kk * kRLd + wn * (kRN / kWN), kRLd, acc);
      }
    }
    if (active) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < kNI; ++b) {
          const int col = wn * (kRN / kWN) + 8 * b + 2 * tq;
          const int row = wm * 32 + 16 * a + gq;
          *reinterpret_cast<float2*>(Cs + row * kRLdc + col) =
              float2{acc[a][b][0], acc[a][b][1]};
          *reinterpret_cast<float2*>(Cs + (row + 8) * kRLdc + col) =
              float2{acc[a][b][2], acc[a][b][3]};
        }
      }
    }
    __syncthreads();   // (the next slice's first stage waits again before
                       // its z tile overwrites this one)

    const int n0 = sl * kRN, w = min(kRN, D - n0);
    const int cl = 2 * lane, c = n0 + cl;   // this lane's two channels
    const bool on = cl < w;
    const float2 bgc = on ? load2(p.bg + c) : float2{0.f, 0.f};
    // the EQ row's values at these channels, rounded, packed (row il_e of
    // eqs)
    BF2 e2[kRMaxL];
    int il_e = -1;
    // rounds of kFRows consecutive pairs a warp, the warps apart
    for (int r0 = 0; r0 < TB; r0 += kRWarps * kFRows) {
      const int row0 = r0 + warp * kFRows;
      // every global load of the round first
      float2 zz[kFRows], tt[kFRows];
      BF2 kk[kFRows][kRMaxL];
#pragma unroll
      for (int u = 0; u < kFRows; ++u) {
        const int row = row0 + u;
        const bool in = on && row < TB;
        zz[u] = in ? *reinterpret_cast<const float2*>(Cs + row * kRLdc + cl)
                   : float2{0.f, 0.f};
        tt[u] = in ? load2(t + (p0 + row) * D + c) : float2{0.f, 0.f};
        const BF* ekj = p.ek_b + (size_t)(in ? eks[row] : 0) * L * D + c;
#pragma unroll
        for (int m = 0; m < kRMaxL; ++m) {
          kk[u][m] = in && m < L ? bf2_load(ekj + m * D) : bf2_zero();
        }
      }
#pragma unroll
      for (int u = 0; u < kFRows; ++u) {
        const int row = row0 + u;
        if (row >= TB) break;   // the warp's pairs end together
        const int il = ers[row];
        if (il != il_e) {
#pragma unroll
          for (int m = 0; m < kRMaxL; ++m) {
            e2[m] = on && m < L ? bf2_load(eqs + (il * L + m) * D + c)
                                : bf2_zero();
          }
          il_e = il;
        }
        BF2 xr[kRMaxL];
#pragma unroll
        for (int m = 0; m < kRMaxL; ++m) xr[m] = xrs[row * kRMaxL + m];
        // w = sum over the degree blocks of S - rnd(pq pk) (2 - r2)
        float wv[2] = {0.f, 0.f};
#pragma unroll
        for (int b = 0; b < kFMaxB; ++b) {
          if (b == 1 && !two) continue;
          const Terms2 tm = pair_terms(e2, kk[u], xr, b ? 3 : 0, b ? L : hi0,
                                       p.rej);
          if (p.rej) {
            const BF2 q = bf2_mul(tm.pq, tm.pk);
            const float a = as[row * kFMaxB + b];
            wv[0] = wv[0] + bf2_lo(tm.S) - bf2_lo(q) * a;
            wv[1] = wv[1] + bf2_hi(tm.S) - bf2_hi(q) * a;
          } else {
            wv[0] = wv[0] + bf2_lo(tm.S);
            wv[1] = wv[1] + bf2_hi(tm.S);
          }
        }
        float o[2];
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          const float z = (ch ? zz[u].y : zz[u].x) + (ch ? bgc.y : bgc.x);
          const float gt = z * sigmoid(z);
          o[ch] = (ch ? tt[u].y : tt[u].x) + gt * gate_fwd(wv[ch], p.gate);
        }
        if (on) {
          *reinterpret_cast<float2*>(p.out + (p0 + row) * D + c) =
              float2{o[0], o[1]};
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- host side ----------------------------------------------------------------
// the slice path's shared arrays, byte offsets; returns the total
size_t slice_smem_layout(Params& p, bool bf) {
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

// the row path's shared arrays, byte offsets; returns the total
size_t row_smem_layout(Params& p) {
  auto up16 = [](size_t x) { return (x + 15) / 16 * 16; };
  // EQ rows a tile of kFT consecutive pairs can touch
  int eq_rows = (kFT - 1) / p.R + 2;
  eq_rows = eq_rows < p.n_eq ? eq_rows : p.n_eq;
  size_t off = up16((size_t)kRStages * kRK * kRLd * 2);
  p.roff_a = (int)off;
  off = up16(off + (size_t)kFT * (p.D + kPadBF) * 2);
  p.roff_c = (int)off;
  off += (size_t)kFT * kRLdc * sizeof(float);
  p.roff_eq = (int)off;
  off = up16(off + (size_t)eq_rows * p.L * p.D * 2);
  p.roff_xr = (int)off;
  off += (size_t)kFT * kRMaxL * sizeof(BF2);
  p.roff_r2 = (int)off;
  off += (size_t)kFT * kFMaxB * sizeof(float);
  p.roff_idx = (int)off;
  off += (size_t)2 * kFT * sizeof(int);
  p.rsmem = (int)off;
  return off;
}

// the workspace's parts, in bf16 values: W_g, then the rounded EQ and EK
// tables (used when the tables are float32)
struct Work {
  long long wg, eq, ek, total;
};

Work work_layout(int n_eq, int n_ek, int D, int lmax) {
  const long long L = (lmax + 1) * (lmax + 1) - 1;
  Work w;
  w.wg = 0;
  w.eq = w.wg + (long long)D * D;
  w.ek = w.eq + (long long)n_eq * L * D;
  w.total = w.ek + (long long)n_ek * L * D;
  return w;
}

template <bool kEll, bool kBF, typename TT, typename NT>
cudaError_t slice_forward(Params p, cudaStream_t s) {
  auto kern = slice_fwd_kernel<kEll, kBF, TT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  return run(kern, dim3((unsigned)((p.P + kRows - 1) / kRows)), p.smem, p, s);
}

// The row path: W_g (and float32 tables) rounded into `work`, then one
// launch of the row kernel.
template <bool kEll, typename TT>
cudaError_t row_forward(Params p, __nv_bfloat16* work, int node_bf16,
                        cudaStream_t s) {
  const Work w = work_layout(p.n_eq, p.n_ek, p.D, p.lmax);
  cudaError_t err = cudaSuccess;
  auto round_into = [&](const void* x, long long at, long long n) {
    if (err == cudaSuccess) {   // the first error is the one returned
      err = run(round_bf16_kernel, round_bf16_grid(n), 0,
                RoundBF16{static_cast<const float*>(x), work + at, n}, s);
    }
    return static_cast<const __nv_bfloat16*>(work + at);
  };
  p.wg_b = round_into(p.wg, w.wg, (long long)p.D * p.D);
  if (node_bf16) {
    p.eq_b = static_cast<const __nv_bfloat16*>(p.eq);
    p.ek_b = static_cast<const __nv_bfloat16*>(p.ek);
  } else {
    p.eq_b = round_into(p.eq, w.eq, (long long)p.n_eq * p.L * p.D);
    p.ek_b = round_into(p.ek, w.ek, (long long)p.n_ek * p.L * p.D);
  }
  if (err != cudaSuccess) return err;
  auto kern = row_fwd_kernel<kEll, TT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.rsmem);
  if (err != cudaSuccess) return err;
  return run(kern, dim3((unsigned)((p.P + kFT - 1) / kFT)), p.rsmem, p, s);
}

// Checks the shapes and launches the forward on `stream`; returns the first
// CUDA error.  `work` holds at least work_layout(...).total bf16 values,
// 16-byte aligned.
template <bool kEll>
int launch_forward(Params& p, void* work, int pair_bf16, int t_bf16,
                   int node_bf16, void* stream) {
  p.L = (p.lmax + 1) * (p.lmax + 1) - 1;
  if (p.P <= 0) return (int)cudaSuccess;
  if (p.D % kNT || p.D % kKT || p.lmax < 1 || p.lmax > kMaxLmax ||
      p.gate < 0 || p.gate > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (pair_bf16 && p.lmax <= 2 && row_smem_layout(p) <= kMaxSmem) {
    BF* wb = static_cast<BF*>(work);
    return (int)(t_bf16 ? row_forward<kEll, BF>(p, wb, node_bf16, s)
                        : row_forward<kEll, float>(p, wb, node_bf16, s));
  }
  if (slice_smem_layout(p, pair_bf16 != 0) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (pair_bf16) {
    if (t_bf16) {
      err = node_bf16 ? slice_forward<kEll, true, BF, BF>(p, s)
                      : slice_forward<kEll, true, BF, float>(p, s);
    } else {
      err = node_bf16 ? slice_forward<kEll, true, float, BF>(p, s)
                      : slice_forward<kEll, true, float, float>(p, s);
    }
  } else if (t_bf16) {
    err = node_bf16 ? slice_forward<kEll, false, BF, BF>(p, s)
                    : slice_forward<kEll, false, BF, float>(p, s);
  } else {
    err = node_bf16 ? slice_forward<kEll, false, float, BF>(p, s)
                    : slice_forward<kEll, false, float, float>(p, s);
  }
  return (int)err;
}

}  // namespace
