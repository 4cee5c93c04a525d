// Device code shared by the fused HTR kernels, forward (fused_htr_fwd.cu,
// fused_htr_ell_fwd.cu) and backward (fused_htr_bwd.cuh, which both
// fused_htr_bwd.cu and fused_htr_ell_bwd.cu include): the update's
// per-(pair, channel) terms as the TPU kernel forms them, and the product of
// a block's pair rows with a 32-column slice of W_g or of its transpose (on
// the tensor cores through pair_type.cuh's mma helper for a bf16 pair type).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "pair_type.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;           // pair rows per block of the pair passes
constexpr int kNT = 32;             // product columns per slice
constexpr int kKT = 32;             // rows of W per float32 stage
constexpr int kRowsPerThread = kRows / 32;
constexpr int kPadBF = 8;           // bf16 row padding: conflict-free fragments
constexpr int kMaxLmax = 4;
constexpr int kMaxL = (kMaxLmax + 1) * (kMaxLmax + 1) - 1;
constexpr size_t kMaxSmem = 232448;  // shared memory a block can use

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// gate codes: 0 none, 1 sigmoid ("gated"), 2 tanh ("gatedt"), 3 silu ("act")
__device__ __forceinline__ float gate_fwd(float w, int gate) {
  if (gate == 1) return sigmoid(w);
  if (gate == 2) return tanhf(w);
  if (gate == 3) return w * sigmoid(w);
  return w;
}

// d gate(w) / d w, given w and gw = gate(w)
__device__ __forceinline__ float gate_grad(float w, float gw, int gate) {
  if (gate == 1) return gw * (1.f - gw);
  if (gate == 2) return 1.f - gw * gw;
  if (gate == 3) {
    const float s = sigmoid(w);
    return s + w * s * (1.f - s);
  }
  return 1.f;
}

// degree blocks of the SH axis (P is a kernel's parameter struct: lmax, L,
// sep_htr, rej, D)
template <typename P>
__device__ __forceinline__ int n_blocks(const P& p) {
  return p.sep_htr ? p.lmax : 1;
}
// [lo, hi) of degree block b on the SH axis
template <typename P>
__device__ __forceinline__ int block_lo(const P& p, int b) {
  return p.sep_htr ? (b + 1) * (b + 1) - 1 : 0;
}
template <typename P>
__device__ __forceinline__ int block_hi(const P& p, int b) {
  return p.sep_htr ? (b + 2) * (b + 2) - 1 : p.L;
}

// one degree block's terms at one (pair, channel): S, pq, pk in the pair
// type (one rounding per product and per sum, in m order) and a = 2 - r2 in
// float32.  eqi and ekj point at channel c of rows i and j (component
// stride D); rlp at the pair's L components.
struct Terms {
  float S, pq, pk, a;
};

template <bool kBF, typename NT>
__device__ Terms block_terms(const NT* eqi, const NT* ekj, const float* rlp,
                             int D, int lo, int hi, int rej) {
  Terms r{0.f, 0.f, 0.f, 0.f};
  float r2 = 0.f;
  for (int m = lo; m < hi; ++m) {
    const float e = rnd<kBF>(to_f(eqi[m * D])), k = rnd<kBF>(to_f(ekj[m * D]));
    r.S = rnd<kBF>(r.S + rnd<kBF>(e * k));
    if (rej) {
      const float x = rlp[m], xp = rnd<kBF>(x);
      r.pq = rnd<kBF>(r.pq + rnd<kBF>(e * xp));
      r.pk = rnd<kBF>(r.pk + rnd<kBF>(k * xp));
      r2 += x * x;
    }
  }
  r.a = 2.f - r2;
  return r;
}

// w at one (pair, channel), as the forward forms it
template <bool kBF, typename NT, typename P>
__device__ float pair_w(const P& p, const NT* eqi, const NT* ekj,
                        const float* rlp) {
  float w = 0.f;
  for (int b = 0; b < n_blocks(p); ++b) {
    const Terms tm = block_terms<kBF>(eqi, ekj, rlp, p.D, block_lo(p, b),
                                      block_hi(p, b), p.rej);
    w = p.rej ? w + tm.S - rnd<kBF>(tm.pq * tm.pk) * tm.a : w + tm.S;
  }
  return w;
}

// the pair type's shared-memory element for the t and g_z rows
template <bool kBF> struct PairT { using type = float; };
template <> struct PairT<true> { using type = __nv_bfloat16; };

// row stride (elements) of the shared rows
__host__ __device__ inline int a_stride(int D, bool bf) {
  return bf ? D + kPadBF : D + 1;
}

// ---- pass A's products ------------------------------------------------------
// B(k, n) = W[k * w_sk + n * w_sn]: W_g itself (w_sk = D, w_sn = 1) or its
// transpose (w_sk = 1, w_sn = D); neighbouring threads load neighbouring
// addresses either way.

// Cs[kRows][kNT+1] = As[0:TB][0:K] @ B[0:K, col0:col0+kNT], float32 FMAs.
__device__ void product_tile_f32(const float* __restrict__ As, int lda,
                                 int TB, const float* __restrict__ W,
                                 int w_sk, int w_sn, int col0, int K,
                                 float* __restrict__ Ws,
                                 float* __restrict__ Cs) {
  const int tid = threadIdx.x;
  const int tc = tid % 8;   // columns tc*4 .. tc*4+3
  const int tr = tid / 8;   // rows tr, tr+32
  float acc[kRowsPerThread][4];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += kKT) {
    for (int e = tid; e < kKT * kNT; e += kThreads) {
      const int kk = w_sk == 1 ? e % kKT : e / kNT;
      const int c = w_sk == 1 ? e / kKT : e % kNT;
      Ws[kk * kNT + c] = W[(size_t)(k0 + kk) * w_sk + (size_t)(col0 + c) * w_sn];
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

// Cs[kRows][kNT+1] = As[0:kRows][0:K] @ bf16(B[0:K, col0:col0+kNT]) on the
// tensor cores.  As holds kRows rows; the rows past the block's pairs are
// zero.
__device__ void product_tile_bf16(const __nv_bfloat16* __restrict__ As,
                                  int lda, const float* __restrict__ W,
                                  int w_sk, int w_sn, int col0, int K,
                                  __nv_bfloat16* __restrict__ Wt,
                                  float* __restrict__ Cs) {
  const int tid = threadIdx.x;
  const int ldt = K + kPadBF;
  // the B slice, transposed (k contiguous) and rounded to bf16; each
  // thread keeps kBatch loads in flight
  constexpr int kBatch = 8;
  const int n = K * kNT;
  for (int e0 = tid; e0 < n; e0 += kThreads * kBatch) {
    float w[kBatch];
    int kk[kBatch], c[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      kk[u] = w_sk == 1 ? e % K : e / kNT;
      c[u] = w_sk == 1 ? e / K : e % kNT;
      w[u] = e < n ? W[(size_t)kk[u] * w_sk + (size_t)(col0 + c[u]) * w_sn]
                   : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (e0 + u * kThreads < n) Wt[c[u] * ldt + kk[u]] = __float2bfloat16(w[u]);
    }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  constexpr int n_jobs = kRows / 16 * (kNT / 16);
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

// Cs = As @ B slice in the pair type's arithmetic
template <bool kBF>
__device__ __forceinline__ void product_tile(const void* As, int lda, int TB,
                                             const float* W, int w_sk,
                                             int w_sn, int col0, int K,
                                             void* Wbuf, float* Cs) {
  if constexpr (kBF) {
    product_tile_bf16(static_cast<const __nv_bfloat16*>(As), lda, W, w_sk,
                      w_sn, col0, K, static_cast<__nv_bfloat16*>(Wbuf), Cs);
  } else {
    product_tile_f32(static_cast<const float*>(As), lda, TB, W, w_sk, w_sn,
                     col0, K, static_cast<float*>(Wbuf), Cs);
  }
}

template <typename AT>
__device__ __forceinline__ void store(AT* a, float v) {
  if constexpr (sizeof(AT) == 2) {
    *a = __float2bfloat16(v);
  } else {
    *a = v;
  }
}

}  // namespace
