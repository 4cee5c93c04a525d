// Device code shared by every kernel of the port: the pair type's rounding,
// the one tensor-core product helper, `mma.sync.m16n8k16` with bf16
// factors and float32 sums, and the 16-byte cp.async that stages its
// factors.  A build for the host (no __CUDA_ARCH__) forms
// the same sums of exact bf16 products one accumulator slot at a time, in k
// order, so the host tests run the same code.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 2 or 4 consecutive values as float32, from float32 or bf16 storage
// aligned to their size (8 or 16 bytes as float32, 4 or 8 as bf16): one
// vector load on the card; and 2 or 4 float32 values rounded to bf16 (round
// to nearest even) in one store
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float2*>(p);
  } else {
#if defined(__CUDA_ARCH__)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
#else
    return float2{to_f(p[0]), to_f(p[1])};
#endif
  }
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
#if defined(__CUDA_ARCH__)
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
#else
    const float2 a = load2(p), b = load2(p + 2);
#endif
    return float4{a.x, a.y, b.x, b.y};
  }
}

__device__ __forceinline__ void store2_bf16(__nv_bfloat16* p, float a,
                                            float b) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
#else
  p[0] = __float2bfloat16(a);
  p[1] = __float2bfloat16(b);
#endif
}

__device__ __forceinline__ void store4_bf16(__nv_bfloat16* p, float4 v) {
#if defined(__CUDA_ARCH__)
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
#else
  store2_bf16(p, v.x, v.y);
  store2_bf16(p + 2, v.z, v.w);
#endif
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


// rnd of two values at once: one packed conversion on the card
template <bool kBF>
__device__ __forceinline__ void rnd2(float& a, float& b) {
  if constexpr (kBF) {
#if defined(__CUDA_ARCH__)
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    a = __low2float(h);
    b = __high2float(h);
#else
    a = rnd<true>(a);
    b = rnd<true>(b);
#endif
  }
}

// acc[i][j] += A[16 i .. 16 i + 16, 0:16] @ B[0:16, 8 j .. 8 j + 8] for
// i < MI, j < NI: one warp, MI x NI mma.sync.m16n8k16 (lane = 4 g + t holds
// rows g and g + 8, columns 2t and 2t + 1 of each 16 x 8 piece).  A(m, k)
// is A[m * lda + k] (k contiguous), or A[k * lda + m] with kAT; B(k, n) is
// B[n * ldb + k] (k contiguous), or B[k * ldb + n] with kBT.  The fragments
// come from ldmatrix (.trans for kAT / kBT; NI even) with kLdsm, else from
// 32-bit loads (k contiguous only); each is loaded once and reused.
template <int MI, int NI, bool kAT = false, bool kBT = false,
          bool kLdsm = false>
__device__ __forceinline__ void mma_16816_tile(const __nv_bfloat16* A,
                                               int lda,
                                               const __nv_bfloat16* B,
                                               int ldb, float (*acc)[NI][4]) {
  static_assert(kLdsm || (!kAT && !kBT), "transposed tiles need ldmatrix");
  static_assert(!kLdsm || NI % 2 == 0, "ldmatrix takes n8 tiles in pairs");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#if defined(__CUDA_ARCH__)
  auto ld = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
  auto smem = [](const __nv_bfloat16* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
  };
  // lane l addresses row l % 8 of 8 x 8 matrix l / 8
  const int mat = lane / 8, row = lane % 8;
  uint32_t b[NI][2];
  if constexpr (kLdsm) {
#pragma unroll
    for (int j = 0; j < NI; j += 2) {
      const __nv_bfloat16* p =
          kBT ? B + (row + 8 * (mat % 2)) * ldb + 8 * j + 8 * (mat / 2)
              : B + (8 * j + row + 8 * (mat / 2)) * ldb + 8 * (mat % 2);
      if constexpr (kBT) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]), "=r"(b[j + 1][1])
            : "r"(smem(p)));
      } else {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]), "=r"(b[j + 1][1])
            : "r"(smem(p)));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      b[j][0] = ld(B + (8 * j + g) * ldb + 2 * t);
      b[j][1] = ld(B + (8 * j + g) * ldb + 2 * t + 8);
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    uint32_t a0, a1, a2, a3;
    if constexpr (kLdsm) {
      const __nv_bfloat16* p =
          kAT ? A + (row + 8 * (mat / 2)) * lda + 16 * i + 8 * (mat % 2)
              : A + (16 * i + row + 8 * (mat % 2)) * lda + 8 * (mat / 2);
      if constexpr (kAT) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
            : "r"(smem(p)));
      } else {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
            : "r"(smem(p)));
      }
    } else {
      const __nv_bfloat16* a = A + 16 * i * lda;
      a0 = ld(a + g * lda + 2 * t);
      a1 = ld(a + (g + 8) * lda + 2 * t);
      a2 = ld(a + g * lda + 2 * t + 8);
      a3 = ld(a + (g + 8) * lda + 2 * t + 8);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]),
            "+f"(acc[i][j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[j][0]), "r"(b[j][1]));
    }
  }
#else
  // the same sums, one slot at a time (a build for the host)
  for (int i = 0; i < MI; ++i) {
    for (int j = 0; j < NI; ++j) {
      for (int s = 0; s < 4; ++s) {
        const int m = 16 * i + g + (s >= 2 ? 8 : 0);
        const int n = 8 * j + 2 * t + (s & 1);
        for (int k = 0; k < 16; ++k) {
          const __nv_bfloat16 a = kAT ? A[k * lda + m] : A[m * lda + k];
          const __nv_bfloat16 b = kBT ? B[k * ldb + n] : B[n * ldb + k];
          acc[i][j][s] += __bfloat162float(a) * __bfloat162float(b);
        }
      }
    }
  }
#endif
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async), zero-filled past `bytes`; the host build copies at once
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(bytes));
#else
  unsigned char* d = static_cast<unsigned char*>(dst);
  for (int i = 0; i < 16; ++i) {
    d[i] = i < bytes ? static_cast<const unsigned char*>(src)[i] : 0;
  }
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
#endif
}

// acc += A[16 x 16] @ B[16 x 8] for this lane's four accumulator slots
__device__ __forceinline__ void mma_16816(const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* B, int ldb,
                                          float* acc) {
  mma_16816_tile<1, 1>(A, lda, B, ldb,
                       reinterpret_cast<float(*)[1][4]>(acc));
}

}  // namespace
