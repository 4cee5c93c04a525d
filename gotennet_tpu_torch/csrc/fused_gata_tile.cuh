// Device code shared by the fused GATA message kernels on the dense
// (fused_gata_fwd.cu) and the ELL layout (fused_ell_fwd.cu).
//
// The weight path of both (bf16 pair type): W_re and W_rs are rounded to
// bf16 once a launch, by weights_bf16_kernel, into one [D + C, D] matrix
// whose rows are the output columns (depth contiguous), the orientation
// mma.sync's B fragments want (and the node tables every pair reads rounded,
// by round_bf16_kernel).  A block then stages kFN-column x kFK-deep tiles of
// it with 16-byte cp.async (stage_w_tile) into a ring of kFStages
// shared-memory stages, so the next tiles load while the current one
// multiplies and the slice's epilogue runs.
// A float32 pair type takes 32-column slices as float32 FMAs
// (product_tile_f32), each slice read from the float32 weights.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "pair_type.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNT = 32;             // product columns per tile
constexpr int kKT = 32;             // rows of W per shared-memory stage
constexpr int kMaxPairs = 128;      // pair rows per block (TI * M)
constexpr int kPadBF = 8;           // bf16 row padding: conflict-free fragments

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// the bf16 weight tiles of the ring
constexpr int kFN = 128;            // output columns per slice (tile rows)
constexpr int kFK = 64;             // depth per stage
constexpr int kFStages = 3;         // stages of the ring
constexpr int kFLd = kFK + 8;       // bf16 row stride of a stage

// the pair type's shared-memory element for the t rows
template <bool kBF> struct PairT { using type = float; };
template <> struct PairT<true> { using type = __nv_bfloat16; };

// row stride (elements) of the shared t rows
__host__ __device__ inline int a_stride(int D, bool bf) {
  return bf ? D + kPadBF : D + 1;
}

// Cs[TB][kNT+1] = As[TB][0:K] @ W[0:K, col0:col0+kNT], float32 FMAs, by
// the NT threads of a block (TB <= kMaxPairs).
template <int NT = kThreads>
__device__ void product_tile_f32(const float* __restrict__ As, int lda,
                                 int TB, const float* __restrict__ W, int ldw,
                                 int col0, int K, float* __restrict__ Ws,
                                 float* __restrict__ Cs) {
  constexpr int kRowsPerThread = kMaxPairs / (NT / 8);
  const int tid = threadIdx.x;
  const int tc = tid % 8;   // columns tc*4 .. tc*4+3
  const int tr = tid / 8;   // rows tr, tr + NT/8, ...
  float acc[kRowsPerThread][4];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += kKT) {
    for (int e = tid; e < kKT * kNT; e += NT) {
      const int kk = e / kNT, c = e % kNT;
      Ws[e] = W[(size_t)(k0 + kk) * ldw + col0 + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKT; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&Ws[kk * kNT + tc * 4]);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int row = tr + NT / 8 * r;
        if (row < TB) {
          const float a = As[row * lda + k0 + kk];
          acc[r][0] = fmaf(a, b.x, acc[r][0]);
          acc[r][1] = fmaf(a, b.y, acc[r][1]);
          acc[r][2] = fmaf(a, b.z, acc[r][2]);
          acc[r][3] = fmaf(a, b.w, acc[r][3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = tr + NT / 8 * r;
    if (row < TB) {
#pragma unroll
      for (int c = 0; c < 4; ++c) Cs[row * (kNT + 1) + tc * 4 + c] = acc[r][c];
    }
  }
  __syncthreads();
}

// ---- the bf16 weights -----------------------------------
// wt[n][k] = bf16(W[k][n]) of the [D, D + C] matrix W_re | W_rs (round to
// nearest even), a 32 x 32 tile a block, transposed through shared memory
struct WPrep {
  const float* wre;    // [D, D]
  const float* wrs;    // [D, C]
  __nv_bfloat16* wt;   // [D + C, D]
  int D, C;
};

__global__ void __launch_bounds__(kThreads) weights_bf16_kernel(const WPrep w) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);   // [32][33]
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int N = w.D + w.C;
  for (int r = ty; r < 32; r += kThreads / 32) {
    const int k = k0 + r, n = n0 + tx;
    float v = 0.f;
    if (k < w.D && n < N) {
      v = n < w.D ? w.wre[(size_t)k * w.D + n]
                  : w.wrs[(size_t)k * w.C + n - w.D];
    }
    tile[r * 33 + tx] = v;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += kThreads / 32) {
    const int n = n0 + r, k = k0 + tx;
    if (n < N && k < w.D) {
      w.wt[(size_t)n * w.D + k] = __float2bfloat16(tile[tx * 33 + r]);
    }
  }
}

// y[e] = bf16(x[e]) (round to nearest even), four values a thread (n a
// multiple of 4, both 16-byte aligned): the forwards' copies of X and of
// the ELL node tables
struct RoundBF16 {
  const float* x;
  __nv_bfloat16* y;
  long long n;
};

__global__ void __launch_bounds__(kThreads) round_bf16_kernel(const RoundBF16 r) {
  const long long e = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (e < r.n) store4_bf16(r.y + e, load4(r.x + e));
}

// One stage of the ring: rows [n0, n0 + kFN) and depths [k0, k0 + kFK) of
// wt ([*, K], depth contiguous) into s ([kFN][kFLd]), as 1,024 cp.async of
// 8 values spread over the NT threads of the block; zero at rows >= n_hi
// and depths >= K.
template <int NT = kThreads>
__device__ __forceinline__ void stage_w_tile(__nv_bfloat16* s,
                                             const __nv_bfloat16* wt, int K,
                                             int n0, int n_hi, int k0) {
  for (int c = threadIdx.x; c < kFN * kFK / 8; c += NT) {
    const int r = c / (kFK / 8), k = 8 * (c % (kFK / 8));
    int n = n0 + r < n_hi ? K - (k0 + k) : 0;
    n = n < 0 ? 0 : (n > 8 ? 8 : n);
    cp_async16(s + r * kFLd + k,
               n > 0 ? wt + (size_t)(n0 + r) * K + k0 + k : wt, 2 * n);
  }
}

}  // namespace
