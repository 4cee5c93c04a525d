// Device code shared by the backward kernels (fused_gata_bwd.cu,
// fused_ell_bwd.cu, fused_htr_bwd.cu, fused_htr_ell_bwd.cu): the tiled
// product that recomputes projections and forms g_t, and the sums over every
// pair of a launch (weight gradients as a product whose depth runs over
// pairs, bias gradients as column sums), each split over blocks into
// partials that a second pass adds in a fixed order, so no sum uses atomics
// and reruns give the same bits.  For the two message backwards also the
// forward's o at one (pair, channel), and the sums over a pair's channels
// (a warp per pair, then the 32 lanes added in order).
//
// The product, with a bf16 pair type, runs on the tensor cores:
// mma.sync.m16n8k16 (bf16 factors, float32 sums) through pair_type.cuh's
// helper, on bf16 copies of both factors (the caller makes them: each factor
// rounded to bf16, round to nearest even, as the plain versions round it, so
// every product is the exact product of the rounded factors and only the
// order of the float32 sums differs).  A block of 8 warps owns a 128 x 128
// output tile, each warp a 64 x 32 piece (4 x 4 mma tiles), and walks the
// depth 64 at a time through kStages shared-memory stages filled by cp.async
// (16 bytes a copy, straight from global memory), so two depth tiles are in
// flight while the warps multiply the third.  Each factor is staged in the
// orientation it has in memory, depth or rows contiguous (a weight gradient
// reads t^T and g across their leading pair axis), and the fragments come
// from ldmatrix, with .trans for a factor whose rows are contiguous.  A
// float32 pair type keeps float32 FMAs (a 64 x 64 tile, 4 x 4 outputs a
// thread): TF32 would not hold float32's tolerance.  On an H100 the six
// products of a message backward run at a third of cuBLAS's rate on the
// same bf16 factors or less (PERF.md §6 has the rates): mma.sync rather
// than wgmma, register spills at two blocks an SM, and float32 outputs.
// A sum over pairs is cut into enough splits that output tiles x splits
// fill the card four times over; column sums into strips of at least 32
// rows, enough to fill it eight times, whose partials a warp per column then
// adds (each lane its strided share, then the 32 lanes in order).
//
// The including source defines kThreads (256) before it, and run(), its one
// launch site, anywhere.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "pair_type.cuh"

#define CHECK(x)                                 \
  do {                                           \
    const cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;   // float32 product tile
constexpr int kPad = 4;                        // its shared row padding (floats)
constexpr size_t kProductSmem = (size_t)kBK * (kBM + kBN + 2 * kPad) * sizeof(float);
constexpr int kTM = 128, kTN = 128, kTK = 64;  // tensor-core product tile
constexpr int kStages = 3;                     // its depth tiles in flight
constexpr int kLdK = kTK + 8;                  // bf16 row stride, depth contiguous
constexpr int kLdR = kTM + 8;                  // bf16 row stride, rows contiguous
constexpr int kTileElems = kTM * kLdK > kTK * kLdR ? kTM * kLdK : kTK * kLdR;
constexpr size_t kMmaSmem = (size_t)kStages * 2 * kTileElems * sizeof(__nv_bfloat16);
constexpr int kSMs = 132;                      // H100 SXM: the fill the splits aim at
constexpr int kMaxSplit = 256;                 // partials of a sum over pairs
constexpr int kMinPairsPerSplit = 256;
constexpr int kMinStrip = 32;                  // rows per column-sum strip
constexpr int kLanePad = 33;

// every launch of an including source goes through its run()
template <typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream);

// ---- sums over a warp's lanes ----------------------------------------------
// Lane l leaves its partial sums acc[0..nq) in `red` ([rows][nq][kLanePad]
// floats of shared memory), and after a __syncthreads lane_total(red, row,
// nq, u) adds the 32 lanes of sum u in order (no warp shuffles, so the host
// build runs the same code).
__device__ __forceinline__ void store_lanes(float* red, int row, int nq,
                                            int lane, const float* acc) {
  for (int u = 0; u < nq; ++u) red[(row * nq + u) * kLanePad + lane] = acc[u];
}

__device__ __forceinline__ float lane_total(const float* red, int row, int nq,
                                            int u) {
  float s = 0.f;
  for (int l = 0; l < 32; ++l) s += red[(row * nq + u) * kLanePad + l];
  return s;
}

// ---- the tiled product ----------------------------------------------------
// out[z][m][n] (= or +=) sum_{k in split z} A(m, k) B(k, n) (+ bias[n]),
// with A(m, k) = a[m * a_sm + k * a_sk] (float or bf16 storage) and
// B(k, n) = b[k * b_sk + n * b_sn]; both factors rounded to the pair type.
struct Product {
  const void* a;
  long long a_sm, a_sk;
  int a_bf16;
  const void* b;       // float for a float32 pair type, bf16 for bf16
  long long b_sk, b_sn;
  int b_bf16;
  float* out;
  long long o_sm, o_split;
  const float* bias;
  int rows, cols, depth, k_per_split, accumulate, round_out;
  int vec_a, vec_b;    // bf16 product: each factor staged 16 bytes at a time
};

// float32 pair type: float32 FMAs, a 64 x 64 tile, 4 x 4 outputs a thread
__global__ void __launch_bounds__(kThreads) fma_product_kernel(const Product g) {
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
      As[kk * (kBM + kPad) + mm] = a;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int nn = g.b_sn == 1 ? e % kBN : e / kBK;
      const int kk = g.b_sn == 1 ? e / kBN : e % kBK;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk * (kBN + kPad) + nn] =
          (n < g.cols && k < k_hi)
              ? static_cast<const float*>(g.b)[(size_t)k * g.b_sk +
                                               (size_t)n * g.b_sn]
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
      if (m < g.rows && n < g.cols) {
        float val = acc[r][c];
        if (g.bias != nullptr) val += g.bias[n];
        float* o = out + (size_t)m * g.o_sm + n;
        *o = g.accumulate ? *o + val : val;
      }
    }
  }
}

// Stage the kTM-row x kTK-deep tile X(r, k) = x[r * s_r + k * s_k] (bf16),
// rows [r0, r0 + kTM) and depths [k0, k0 + kTK), into shared memory in the
// orientation it has in memory: depth contiguous, [kTM][kLdK], or rows
// contiguous (kRows, s_r == 1), [kTK][kLdR]; zero at r >= n_rows or k >=
// k_hi.  With vec (16-byte aligned runs) as 1,024 cp.async of 8 values, four
// a thread, neighbouring threads on neighbouring runs; else value by value.
template <bool kRows>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* s,
                                           const __nv_bfloat16* x,
                                           long long s_r, long long s_k,
                                           int r0, int n_rows, int k0,
                                           int k_hi, bool vec) {
  if (vec) {
    for (int c = threadIdx.x; c < kTM * kTK / 8; c += kThreads) {
      int r, k, n;
      if constexpr (kRows) {
        k = c / (kTM / 8);
        r = 8 * (c % (kTM / 8));
        n = k0 + k < k_hi ? n_rows - (r0 + r) : 0;
      } else {
        r = c / (kTK / 8);
        k = 8 * (c % (kTK / 8));
        n = r0 + r < n_rows ? k_hi - (k0 + k) : 0;
      }
      n = n < 0 ? 0 : (n > 8 ? 8 : n);
      const __nv_bfloat16* src = x + (long long)(r0 + r) * s_r +
                                 (long long)(k0 + k) * s_k;
      cp_async16(kRows ? s + k * kLdR + r : s + r * kLdK + k,
                 n > 0 ? src : x, 2 * n);
    }
  } else {
    for (int e = threadIdx.x; e < kTM * kTK; e += kThreads) {
      const int r = kRows ? e % kTM : e / kTK, k = kRows ? e / kTM : e % kTK;
      const bool in = r0 + r < n_rows && k0 + k < k_hi;
      s[kRows ? k * kLdR + r : r * kLdK + k] =
          in ? x[(long long)(r0 + r) * s_r + (long long)(k0 + k) * s_k]
             : __float2bfloat16(0.f);
    }
  }
}

// bf16 pair type: the product on the tensor cores, both factors in bf16.
// kAT: A's rows contiguous (a_sm == 1); kBT: B's columns contiguous
// (b_sn == 1).  8 warps, each a 64 x 32 piece of the 128 x 128 tile;
// kStages depth tiles in flight; two blocks an SM (at most 128 registers a
// thread: a few spill, and it still runs faster than one block an SM).
template <bool kAT, bool kBT>
__global__ void __launch_bounds__(kThreads, 2) mma_product_kernel(const Product g) {
  static_assert(kThreads == 256 && kTM == kTN, "8 warps, square tiles");
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  auto a_tile = [&](int st) { return sm + (2 * st) * kTileElems; };
  auto b_tile = [&](int st) { return sm + (2 * st + 1) * kTileElems; };
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * kTM;
  const int k_lo = blockIdx.z * g.k_per_split;
  const int k_hi = min(g.depth, k_lo + g.k_per_split);
  const int nk = k_hi > k_lo ? (k_hi - k_lo + kTK - 1) / kTK : 0;
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(g.a);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(g.b);
  auto load = [&](int kt) {
    const int st = kt % kStages, k0 = k_lo + kt * kTK;
    stage_tile<kAT>(a_tile(st), a, g.a_sm, g.a_sk, m0, g.rows, k0, k_hi,
                    g.vec_a);
    stage_tile<kBT>(b_tile(st), b, g.b_sn, g.b_sk, n0, g.cols, k0, k_hi,
                    g.vec_b);
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    }
  }
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();
  }
  constexpr int lda = kAT ? kLdR : kLdK, ldb = kBT ? kLdR : kLdK;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile kt is in; every warp is done with tile kt - 1
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* As = a_tile(kt % kStages);
    const __nv_bfloat16* Bs = b_tile(kt % kStages);
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      mma_16816_tile<4, 4, kAT, kBT, true>(
          kAT ? As + kk * kLdR + wm * 64 : As + wm * 64 * kLdK + kk, lda,
          kBT ? Bs + kk * kLdR + wn * 32 : Bs + wn * 32 * kLdK + kk, ldb, acc);
    }
  }
  cp_async_wait<0>();
  float* out = g.out + (size_t)blockIdx.z * g.o_split;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int m = m0 + wm * 64 + 16 * i + gq + (s >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + 8 * j + 2 * tq + (s & 1);
        if (m < g.rows && n < g.cols) {
          float val = acc[i][j][s];
          if (g.bias != nullptr) val += g.bias[n];
          if (g.round_out) val = rnd<true>(val);
          float* o = out + (size_t)m * g.o_sm + n;
          *o = g.accumulate ? *o + val : val;
        }
      }
    }
  }
}

// y[i] = bf16(x[i]) (round to nearest even): the bf16 copy of a factor
struct ToBF16 {
  const float* x;
  __nv_bfloat16* y;
  long long n;
};

__global__ void __launch_bounds__(kThreads) to_bf16_kernel(const ToBF16 c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < c.n) c.y[i] = __float2bfloat16(c.x[i]);
}

// out[e] = sum_z part[z][e], in order of z, a thread per e
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

// ---- column sums ------------------------------------------------------------
// part[z][col] = sum of x[r][col] over strip z's rows, in order
struct ColSum {
  const float* x;
  float* part;
  int rows, cols, rows_per_strip;
};

__global__ void __launch_bounds__(kThreads) colsum_kernel(const ColSum c) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= c.cols) return;
  const int r_lo = blockIdx.y * c.rows_per_strip;
  const int r_hi = min(c.rows, r_lo + c.rows_per_strip);
  float s = 0.f;
  for (int r = r_lo; r < r_hi; ++r) s += c.x[(size_t)r * c.cols + col];
  c.part[(size_t)blockIdx.y * c.cols + col] = s;
}

// out[e] = sum_z part[z][e], a warp per e: lane l adds z = l, l + 32, ... in
// order, then the 32 lanes are added in order
__global__ void __launch_bounds__(kThreads) strip_sum_kernel(const PartSum s) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);   // [8][1][kLanePad]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * (kThreads / 32) + warp;
  float acc = 0.f;
  if (e < s.n) {
    for (int z = lane; z < s.splits; z += 32) acc += s.part[(size_t)z * s.n + e];
  }
  store_lanes(red, warp, 1, lane, &acc);
  __syncthreads();
  if (lane == 0 && e < s.n) s.out[e] = lane_total(red, warp, 1, 0);
}

// ---- the message backwards' per-pair sums -----------------------------------
// the forward's o at (pair, channel c) from t_filter, the rounded node values
// x_g[j] and v[j], the envelope and the rounded attention of c's head
template <bool kBF>
__device__ __forceinline__ float o_at(float tf, float xv, float vv,
                                      float envp, float ac) {
  return rnd<kBF>(rnd<kBF>(rnd<kBF>(tf * xv) * envp) + rnd<kBF>(ac * vv));
}

// ---- host side ------------------------------------------------------------
unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// partials of a sum over `depth` pairs into a rows x cols output: enough
// that output tiles x splits fill the card four times over, each split at
// least kMinPairsPerSplit pairs
int pair_splits(long long depth, int rows, int cols) {
  const long long tiles =
      (long long)((rows + kTM - 1) / kTM) * ((cols + kTN - 1) / kTN);
  long long s = (4LL * kSMs + tiles - 1) / tiles;
  if (s > depth / kMinPairsPerSplit) s = depth / kMinPairsPerSplit;
  if (s > kMaxSplit) s = kMaxSplit;
  return (int)(s < 1 ? 1 : s);
}

// strips of a column sum over `rows` rows: enough that blocks x strips fill
// the card eight times over, each strip at least kMinStrip rows
int col_strips(long long rows, int cols) {
  const long long blocks = (cols + kThreads - 1) / kThreads;
  long long s = (8LL * kSMs + blocks - 1) / blocks;
  if (s > (rows + kMinStrip - 1) / kMinStrip) s = (rows + kMinStrip - 1) / kMinStrip;
  return (int)(s < 1 ? 1 : s);
}

// floats of `part` that product_over_pairs and column_sums need for P pairs
// and outputs of at most D x C (weights) and C (biases), C >= D
size_t part_floats(long long P, int D, int C) {
  const size_t n[4] = {(size_t)pair_splits(P, D, C) * D * C,
                       (size_t)pair_splits(P, D, D) * D * D,
                       (size_t)col_strips(P, C) * C,
                       (size_t)col_strips(P, D) * D};
  size_t most = 0;
  for (size_t x : n) most = x > most ? x : most;
  return most;
}

// the bf16 copy of n floats
cudaError_t to_bf16_copy(const float* x, long long n, __nv_bfloat16* y,
                         cudaStream_t s) {
  return run(to_bf16_kernel, dim3(blocks_for(n)), 0, ToBF16{x, y, n}, s);
}

// a factor's runs of 8 bf16 along its contiguous axis are 16-byte aligned
bool runs_aligned(const void* p, long long other_stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && other_stride % 8 == 0;
}

template <bool kAT, bool kBT>
cudaError_t launch_mma(const Product& g, dim3 grid, cudaStream_t s) {
  auto kern = mma_product_kernel<kAT, kBT>;
  CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMmaSmem));
  return run(kern, grid, kMmaSmem, g, s);
}

// the product in the pair type's arithmetic over `splits` depth splits of
// g.k_per_split (a multiple of kTK); a bf16 product takes bf16 factors
template <bool kBF>
cudaError_t launch_product(Product g, int splits, cudaStream_t s) {
  if constexpr (kBF) {
    if (!g.a_bf16 || !g.b_bf16) return cudaErrorInvalidValue;
    const bool at = g.a_sm == 1, bt = g.b_sn == 1;
    g.vec_a = runs_aligned(g.a, at ? g.a_sk : g.a_sm);
    g.vec_b = runs_aligned(g.b, bt ? g.b_sk : g.b_sn);
    const dim3 grid((g.cols + kTN - 1) / kTN, (g.rows + kTM - 1) / kTM, splits);
    if (at) return bt ? launch_mma<true, true>(g, grid, s)
                      : launch_mma<true, false>(g, grid, s);
    return bt ? launch_mma<false, true>(g, grid, s)
              : launch_mma<false, false>(g, grid, s);
  } else {
    if (g.b_bf16) return cudaErrorInvalidValue;
    const dim3 grid((g.cols + kBN - 1) / kBN, (g.rows + kBM - 1) / kBM, splits);
    return run(fma_product_kernel, grid, kProductSmem, g, s);
  }
}

// out[rows, cols] (=, or += when accumulate) = A B (+ bias), one pass
template <bool kBF>
cudaError_t product(Product g, cudaStream_t s) {
  g.k_per_split = g.depth;
  g.o_split = 0;
  return launch_product<kBF>(g, 1, s);
}

// out[rows, cols] = A B where the depth runs over pairs: split into
// partials in `part` (part_floats), then summed in order
template <bool kBF>
cudaError_t product_over_pairs(Product g, float* part, cudaStream_t s) {
  const int S = pair_splits(g.depth, g.rows, g.cols);
  float* out = g.out;
  const int per = (g.depth + S - 1) / S;
  g.k_per_split = per < kTK ? kTK : (per + kTK - 1) / kTK * kTK;
  const int splits = g.depth > 0 ? (g.depth + g.k_per_split - 1) / g.k_per_split : 1;
  g.out = part;
  g.o_sm = g.cols;
  g.o_split = (long long)g.rows * g.cols;
  g.accumulate = 0;
  g.round_out = 0;
  g.bias = nullptr;
  cudaError_t err = launch_product<kBF>(g, splits, s);
  if (err != cudaSuccess) return err;
  const PartSum ps{part, out, g.rows * g.cols, splits};
  return run(partsum_kernel, dim3(blocks_for(ps.n)), 0, ps, s);
}

// out[cols] = sum over rows of x[rows, cols], through `part` (part_floats)
cudaError_t column_sums(const float* x, int rows, int cols, float* part,
                        float* out, cudaStream_t s) {
  const int S = col_strips(rows, cols);
  const int per = rows > 0 ? (rows + S - 1) / S : 1;
  const int strips = rows > 0 ? (rows + per - 1) / per : 1;
  const ColSum c{x, part, rows, cols, per};
  cudaError_t err = run(colsum_kernel, dim3(blocks_for(cols), strips), 0, c, s);
  if (err != cudaSuccess) return err;
  constexpr int kWarps = kThreads / 32;
  return run(strip_sum_kernel, dim3((unsigned)((cols + kWarps - 1) / kWarps)),
             (size_t)kWarps * kLanePad * sizeof(float),
             PartSum{part, out, cols, strips}, s);
}


// ---- the six pair products of the message backwards -------------------------
// fused_gata_bwd.cu and fused_ell_bwd.cu over P pairs (or slots): t_filter =
// t W_rs + b_rs (rounded) and z_re = t W_re + b_re recomputed; then g_t =
// g_tf W_rs^T + g_zre W_re^T, the weight gradients t^T g_tf and t^T g_zre
// and the bias gradients (column sums of the unrounded g_tf and g_zre).
// With a bf16 pair type every product takes bf16 copies of its factors: t
// and the weights made here, g_tf and g_zre written by the passes that form
// them (they are rounded to bf16 by the product anyway, so nothing is lost).
struct MsgProducts {
  const void* t;                     // [P, D], float or bf16 (t_bf16)
  int t_bf16;
  const float *wrs, *brs, *wre, *bre;    // [D, C], [C], [D, D], [D]
  float *tf, *zre, *gtf, *gz;            // [P, C], [P, D], [P, C], [P, D]
  float *gt, *gwrs, *gbrs, *gwre, *gbre, *part;
  __nv_bfloat16 *tb, *wrs_b, *wre_b, *gtf_b, *gz_b;   // the bf16 copies
  long long P;
  int D, C;
};

// n rounded up to whole 16-byte runs, of floats (up4) or of bf16 (up8)
size_t up4(size_t n) { return (n + 3) / 4 * 4; }
size_t up8(size_t n) { return (n + 7) / 8 * 8; }

// floats that hold the bf16 copies (each 16-byte aligned)
size_t msg_bf16_floats(long long P, int D, int C) {
  return (up8((size_t)P * D) * 2 + up8((size_t)D * C) + up8((size_t)D * D) +
          up8((size_t)P * C)) / 2;
}

// the copies' places from `base` (16-byte aligned)
void carve_bf16(MsgProducts& m, float* base) {
  m.tb = reinterpret_cast<__nv_bfloat16*>(base);
  m.wrs_b = m.tb + up8((size_t)m.P * m.D);
  m.wre_b = m.wrs_b + up8((size_t)m.D * m.C);
  m.gtf_b = m.wre_b + up8((size_t)m.D * m.D);
  m.gz_b = m.gtf_b + up8((size_t)m.P * m.C);
}

// t as the products read it: its bf16 copy for a bf16 pair type
template <bool kBF>
const void* t_factor(const MsgProducts& m, int* bf16) {
  *bf16 = kBF ? 1 : m.t_bf16;
  return kBF && !m.t_bf16 ? m.tb : m.t;
}

template <bool kBF>
cudaError_t recompute(const MsgProducts& m, cudaStream_t s) {
  const int P = (int)m.P, D = m.D, C = m.C;
  if constexpr (kBF) {
    if (!m.t_bf16) {
      CHECK(to_bf16_copy(static_cast<const float*>(m.t), m.P * D, m.tb, s));
    }
    CHECK(to_bf16_copy(m.wrs, (long long)D * C, m.wrs_b, s));
    CHECK(to_bf16_copy(m.wre, (long long)D * D, m.wre_b, s));
  }
  Product g{};
  g.a = t_factor<kBF>(m, &g.a_bf16); g.a_sm = D; g.a_sk = 1;
  g.b = kBF ? (const void*)m.wrs_b : m.wrs; g.b_sk = C; g.b_sn = 1;
  g.b_bf16 = kBF;
  g.out = m.tf; g.o_sm = C; g.bias = m.brs;
  g.rows = P; g.cols = C; g.depth = D; g.round_out = 1;
  CHECK(product<kBF>(g, s));
  g.b = kBF ? (const void*)m.wre_b : m.wre; g.b_sk = D;
  g.out = m.zre; g.o_sm = D; g.bias = m.bre; g.cols = D; g.round_out = 0;
  return product<kBF>(g, s);
}

template <bool kBF>
cudaError_t grad_products(const MsgProducts& m, cudaStream_t s) {
  const int P = (int)m.P, D = m.D, C = m.C;
  const void* gtf = kBF ? (const void*)m.gtf_b : m.gtf;
  const void* gz = kBF ? (const void*)m.gz_b : m.gz;
  // g_t = g_tf W_rs^T + g_zre W_re^T
  Product gt{};
  gt.a = gtf; gt.a_sm = C; gt.a_sk = 1; gt.a_bf16 = kBF;
  gt.b = kBF ? (const void*)m.wrs_b : m.wrs; gt.b_sk = 1; gt.b_sn = C;
  gt.b_bf16 = kBF;
  gt.out = m.gt; gt.o_sm = D;
  gt.rows = P; gt.cols = D; gt.depth = C;
  CHECK(product<kBF>(gt, s));
  gt.a = gz; gt.a_sm = D;
  gt.b = kBF ? (const void*)m.wre_b : m.wre; gt.b_sn = D;
  gt.depth = D; gt.accumulate = 1;
  CHECK(product<kBF>(gt, s));
  // weight and bias gradients, sums over all pairs
  Product gw{};
  gw.a = t_factor<kBF>(m, &gw.a_bf16); gw.a_sm = 1; gw.a_sk = D;
  gw.b = gtf; gw.b_sk = C; gw.b_sn = 1; gw.b_bf16 = kBF;
  gw.out = m.gwrs; gw.rows = D; gw.cols = C; gw.depth = P;
  CHECK(product_over_pairs<kBF>(gw, m.part, s));
  gw.b = gz; gw.b_sk = D; gw.out = m.gwre; gw.cols = D;
  CHECK(product_over_pairs<kBF>(gw, m.part, s));
  CHECK(column_sums(m.gtf, P, C, m.part, m.gbrs, s));
  return column_sums(m.gz, P, D, m.part, m.gbre, s);
}

}  // namespace
