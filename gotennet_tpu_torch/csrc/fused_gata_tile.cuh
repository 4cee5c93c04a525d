// Device code shared by the fused GATA message kernels on the dense
// (fused_gata_fwd.cu) and the ELL layout (fused_ell_fwd.cu): the pair
// type's rounding and the product of a block's pair rows (at most kMaxPairs)
// with a 32-column slice of W_re or W_rs, on the tensor cores for a bf16
// pair type and as float32 FMAs otherwise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNT = 32;             // product columns per tile
constexpr int kKT = 32;             // rows of W per shared-memory stage
constexpr int kMaxPairs = 128;      // pair rows per block (TI * M)
constexpr int kRowsPerThread = kMaxPairs / 32;
constexpr int kPadBF = 8;           // bf16 row padding: conflict-free fragments

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round to the pair type (round to nearest even), keep computing in float32
template <bool kBF>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBF) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

// the pair type's shared-memory element for the t rows
template <bool kBF> struct PairT { using type = float; };
template <> struct PairT<true> { using type = __nv_bfloat16; };

// row stride (elements) of the shared t rows
__host__ __device__ inline int a_stride(int D, bool bf) {
  return bf ? D + kPadBF : D + 1;
}

// Cs[TB][kNT+1] = As[TB][0:K] @ W[0:K, col0:col0+kNT], float32 FMAs.
__device__ void product_tile_f32(const float* __restrict__ As, int lda,
                                 int TB, const float* __restrict__ W, int ldw,
                                 int col0, int K, float* __restrict__ Ws,
                                 float* __restrict__ Cs) {
  const int tid = threadIdx.x;
  const int tc = tid % 8;   // columns tc*4 .. tc*4+3
  const int tr = tid / 8;   // rows tr, tr+32, tr+64, tr+96
  float acc[kRowsPerThread][4];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += kKT) {
    for (int e = tid; e < kKT * kNT; e += kThreads) {
      const int kk = e / kNT, c = e % kNT;
      Ws[e] = W[(size_t)(k0 + kk) * ldw + col0 + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKT; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&Ws[kk * kNT + tc * 4]);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int row = tr + 32 * r;
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
    const int row = tr + 32 * r;
    if (row < TB) {
#pragma unroll
      for (int c = 0; c < 4; ++c) Cs[row * (kNT + 1) + tc * 4 + c] = acc[r][c];
    }
  }
  __syncthreads();
}

// acc += A[16 x 16] @ B[16 x 8] for this lane's four accumulator slots
// (mma.sync m16n8k16 layout: lane = 4 g + t holds rows g and g + 8, columns
// 2t and 2t + 1).  A is row-major (k contiguous, row stride lda); B is kept
// transposed, B[n * ldb + k], so each fragment register is one 32-bit load.
__device__ __forceinline__ void mma_16816(const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* B, int ldb,
                                          float* acc) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#if defined(__CUDA_ARCH__)
  auto ld = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
  const uint32_t a0 = ld(A + g * lda + 2 * t);
  const uint32_t a1 = ld(A + (g + 8) * lda + 2 * t);
  const uint32_t a2 = ld(A + g * lda + 2 * t + 8);
  const uint32_t a3 = ld(A + (g + 8) * lda + 2 * t + 8);
  const uint32_t b0 = ld(B + g * ldb + 2 * t);
  const uint32_t b1 = ld(B + g * ldb + 2 * t + 8);
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
#else
  // the same four sums, one slot at a time (a build for the host)
  for (int s = 0; s < 4; ++s) {
    const int row = g + (s >= 2 ? 8 : 0), col = 2 * t + (s & 1);
    for (int k = 0; k < 16; ++k) {
      acc[s] += __bfloat162float(A[row * lda + k]) *
                __bfloat162float(B[col * ldb + k]);
    }
  }
#endif
}

// Cs[TB][kNT+1] = As[TB][0:K] @ bf16(W[0:K, col0:col0+kNT]) on the tensor
// cores.  As holds round16(TB) rows; the rows past TB are zero.
__device__ void product_tile_bf16(const __nv_bfloat16* __restrict__ As,
                                  int lda, int TB,
                                  const float* __restrict__ W, int ldw,
                                  int col0, int K,
                                  __nv_bfloat16* __restrict__ Wt,
                                  float* __restrict__ Cs) {
  const int tid = threadIdx.x;
  const int ldt = K + kPadBF;
  // the W slice, transposed (k contiguous) and rounded to bf16; each
  // thread keeps kBatch loads in flight
  constexpr int kBatch = 8;
  const int n = K * kNT;
  for (int e0 = tid; e0 < n; e0 += kThreads * kBatch) {
    float w[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      w[u] = e < n ? W[(size_t)(e / kNT) * ldw + col0 + e % kNT] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) Wt[(e % kNT) * ldt + e / kNT] = __float2bfloat16(w[u]);
    }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_jobs = round16(TB) / 16 * (kNT / 16);
  for (int job = warp; job < n_jobs; job += kThreads / 32) {
    const int r0 = job / (kNT / 16) * 16, n0 = job % (kNT / 16) * 16;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < K; k0 += 16) {
      mma_16816(As + r0 * lda + k0, lda, Wt + n0 * ldt + k0, ldt, acc[0]);
      mma_16816(As + r0 * lda + k0, lda, Wt + (n0 + 8) * ldt + k0, ldt,
                acc[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 8 * h + 2 * t;
      Cs[(r0 + g) * (kNT + 1) + col] = acc[h][0];
      Cs[(r0 + g) * (kNT + 1) + col + 1] = acc[h][1];
      Cs[(r0 + g + 8) * (kNT + 1) + col] = acc[h][2];
      Cs[(r0 + g + 8) * (kNT + 1) + col + 1] = acc[h][3];
    }
  }
  __syncthreads();
}

// Cs = As @ W slice in the pair type's arithmetic
template <bool kBF>
__device__ __forceinline__ void product_tile(const void* As, int lda, int TB,
                                             const float* W, int ldw,
                                             int col0, int K, void* Wbuf,
                                             float* Cs) {
  if constexpr (kBF) {
    product_tile_bf16(static_cast<const __nv_bfloat16*>(As), lda, TB, W, ldw,
                      col0, K, static_cast<__nv_bfloat16*>(Wbuf), Cs);
  } else {
    product_tile_f32(static_cast<const float*>(As), lda, TB, W, ldw, col0, K,
                     static_cast<float*>(Wbuf), Cs);
  }
}

}  // namespace
