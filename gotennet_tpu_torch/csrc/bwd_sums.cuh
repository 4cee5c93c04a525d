// Device code shared by the backward kernels (fused_gata_bwd.cu,
// fused_ell_bwd.cu, fused_htr_bwd.cu, fused_htr_ell_bwd.cu): the tiled
// FP32-FMA product that recomputes projections and forms g_t, and the sums
// over every pair of a launch (weight gradients as a product whose depth runs
// over pairs, bias gradients as column sums), each split over blocks into
// partials that one pass then adds in a fixed order, so no sum uses atomics
// and reruns give the same bits.  For the two message backwards also the
// forward's o at one (pair, channel), and the sums over a pair's channels
// (a warp per pair, then one thread adds the 32 lanes in order).
//
// The including source defines kThreads, to_f and rnd<kBF> before it, and
// run(), its one launch site, anywhere.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;   // product tile (rows, cols, depth)
constexpr int kPad = 4;                        // shared row padding (floats)
constexpr int kMaxSplit = 16;                  // partials of a sum over pairs
constexpr int kRowsPerSplit = 1024;
constexpr size_t kProductSmem = (size_t)kBK * (kBM + kBN + 2 * kPad) * sizeof(float);

// every launch of an including source goes through its run()
template <typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream);

// ---- the tiled product ----------------------------------------------------
// out[z][m][n] (= or +=) sum_{k in split z} A(m, k) B(k, n) (+ bias[n]),
// with A(m, k) = a[m * a_sm + k * a_sk] (float or bf16 storage) and
// B(k, n) = b[k * b_sk + n * b_sn]; both factors rounded to the pair type.
struct Product {
  const void* a;
  long long a_sm, a_sk;
  int a_bf16;
  const float* b;
  long long b_sk, b_sn;
  float* out;
  long long o_sm, o_split;
  const float* bias;
  int rows, cols, depth, k_per_split, accumulate, round_out;
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
      if (m < g.rows && n < g.cols) {
        float val = acc[r][c];
        if (g.bias != nullptr) val += g.bias[n];
        if (g.round_out) val = rnd<kBF>(val);
        float* o = out + (size_t)m * g.o_sm + n;
        *o = g.accumulate ? *o + val : val;
      }
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

// ---- the message backwards' per-pair sums -----------------------------------
// the forward's o at (pair, channel c) from t_filter, the rounded node values
// x_g[j] and v[j], the envelope and the rounded attention of c's head
template <bool kBF>
__device__ __forceinline__ float o_at(float tf, float xv, float vv,
                                      float envp, float ac) {
  return rnd<kBF>(rnd<kBF>(rnd<kBF>(tf * xv) * envp) + rnd<kBF>(ac * vv));
}

// A warp per pair (or slot), `row` its place in the block, sums nq values
// over the pair's channels: lane l leaves its partial sums acc[0..nq) in
// `red` ([rows][nq][kLanePad] floats of shared memory), and after a
// __syncthreads lane_total(red, row, nq, u) adds the 32 lanes of sum u in
// order (no warp shuffles, so the host build runs the same code).
constexpr int kLanePad = 33;

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

// ---- host side ------------------------------------------------------------
unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// partials of a sum over `rows` pairs
int splits_for(long long rows) {
  const long long s = rows / kRowsPerSplit;
  return (int)(s < 1 ? 1 : (s > kMaxSplit ? kMaxSplit : s));
}

// out[rows, cols] (=, or += when accumulate) = A B (+ bias), one pass
template <bool kBF>
cudaError_t product(Product g, cudaStream_t s) {
  g.k_per_split = g.depth;
  g.o_split = 0;
  const dim3 grid((g.cols + kBN - 1) / kBN, (g.rows + kBM - 1) / kBM, 1);
  return run(product_kernel<kBF>, grid, kProductSmem, g, s);
}

// out[rows, cols] = A B where the depth runs over pairs: split into
// partials in `part` (splits_for(depth) * rows * cols floats), then summed in
// order
template <bool kBF>
cudaError_t product_over_pairs(Product g, float* part, cudaStream_t s) {
  const int S = splits_for(g.depth);
  float* out = g.out;
  g.k_per_split = (g.depth + S - 1) / S;
  g.k_per_split = (g.k_per_split + kBK - 1) / kBK * kBK;
  g.out = part;
  g.o_sm = g.cols;
  g.o_split = (long long)g.rows * g.cols;
  g.accumulate = 0;
  g.round_out = 0;
  g.bias = nullptr;
  const dim3 grid((g.cols + kBN - 1) / kBN, (g.rows + kBM - 1) / kBM, S);
  cudaError_t err = run(product_kernel<kBF>, grid, kProductSmem, g, s);
  if (err != cudaSuccess) return err;
  const PartSum ps{part, out, g.rows * g.cols, S};
  return run(partsum_kernel, dim3(blocks_for(ps.n)), 0, ps, s);
}

// out[cols] = sum over rows of x[rows, cols], through `part`
// (splits_for(rows) * cols floats)
cudaError_t column_sums(const float* x, int rows, int cols, float* part,
                        float* out, cudaStream_t s) {
  const int S = splits_for(rows);
  const ColSum c{x, part, rows, cols, (rows + S - 1) / S};
  cudaError_t err = run(colsum_kernel, dim3(blocks_for(cols), S), 0, c, s);
  if (err != cudaSuccess) return err;
  return run(partsum_kernel, dim3(blocks_for(cols)), 0,
             PartSum{part, out, cols, S}, s);
}

#define CHECK(x)                                 \
  do {                                           \
    const cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) return e_;            \
  } while (0)

}  // namespace
