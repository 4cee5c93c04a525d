// Fused GATA message + aggregation on the ELL layout, backward, for sm_90a.
//
// Replaces the TPU kernel `_ell_bwd_kernel` of gotennet_tpu/ops/pallas/fused_ell.py
// (launched by `_pallas_ell_backward`, wired by `make_fused_ell`): the
// cotangents of the 13 float inputs of the forward (every input but nbr,
// g_rl and g_env included), from the forward's pre-scale softmax and the
// float32 cotangents of d_h and dX.  The math and the cast points are written
// out in gotennet_tpu_torch/ops/fused_ell.py (`fused_ell_backward_reference`),
// the plain PyTorch version this kernel is held against.
//
// What bounds it on an H100: six slot projections (t W_rs and t W_re
// recomputed, g_tf W_rs^T, g_zre W_re^T, t^T g_tf, t^T g_zre),
// 6 * D * (mult*D + D) FLOP per valid slot: ~32 GFLOP for one 600-700-atom
// frame (N = 704 rows, K = 36 slots, ~13,400 valid, D = 256, mult = 5), about
// 0.03 ms at the bf16 tensor-core peak, against ~95 MB of inputs and outputs
// (about 0.03 ms at 3.35 TB/s).  The two bounds are close.
//
// Design (right first; tensor cores, fusion and overlap are later work).  The
// TPU kernel sums the weight gradients and the table gradients (g_k, g_xg,
// g_v, g_X: sums over every slot that reads a table row) in place over its
// sequential grid, the latter by a transposed one-hot matmul.  Hopper's blocks
// run in parallel in no order, so here the work is cut into passes, each of
// whose outputs is owned by one thread or one block, and no sum uses atomics:
// every result is the same from run to run.  A table row's owner walks the
// slots that read it through the transposed slot list (`starts`, `order`: a
// stable sort of the flat nbr, built once per batch by the caller) and
// recomputes each slot's terms, as fused_htr_bwd.cu's pass B does; no
// per-slot table terms go to device memory (they would take ~0.5 GB).
//  1. two products recompute t_filter = t W_rs + b_rs and z_re = t W_re +
//     b_re over all slots into workspace (a tiled FP32-FMA product);
//  2. per slot, a warp per slot: g_tf per channel, and the sums over channels
//     g_attn (per head), g_env and g_rl (each lane sums its channels, then one
//     thread adds the 32 lanes in order);
//  3. per destination row: the softmax backward over its K slots, and g_scale;
//  4. per (slot, channel of D): g_zre through the silu;
//  5. per (row, channel of D): g_q (sum over the row's slots); per (table row,
//     channel of D): g_k (sum over the slots that read it);
//  6. per (table row, channel): g_xg and g_v, and g_X from the tensor blocks,
//     sums over the slots that read the row;
//  7. g_t = g_tf W_rs^T + g_zre W_re^T, one product each;
//  8. the weight gradients t^T g_tf and t^T g_zre, and the bias gradients
//     (column sums), as sums over all slots: split over blocks into partials,
//     then one pass adds the partials in a fixed order.
// Padded slots (env < 0) have softmax 0 and envelope 0, so every term they
// add is an exact zero.  An index outside [0, N) is clamped so no read leaves
// the table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerBlock = 16;             // slots per block of pass 2
constexpr int kMaxH = 16;                      // heads pass 2 sums in registers
constexpr int kMaxL = 24;                      // SH components (lmax <= 4)

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

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

}  // namespace

#include "bwd_sums.cuh"

namespace {

// ---- the slot and table passes ---------------------------------------------
struct Params {
  const void* t;       // [NR, K, D]   float or bf16
  const void* q;       // [NR, D]      node type
  const void* k;       // [N, D]
  const void* xg;      // [N, C]
  const void* v;       // [N, C]
  const float* rl;     // [NR, K, L]
  const float* X;      // [N, L, D]
  const float* env;    // [NR, K]
  const float* scale;  // [NR, K] or [NR, K, H]
  const int* nbr;      // [NR, K]  rows of the tables
  const float* wre;    // [D, D]   (in, out)
  const float* bre;    // [D]
  const float* wrs;    // [D, C]   (in, out)
  const float* brs;    // [C]
  const float* sm;     // [NR, K, H]  the forward's pre-scale softmax
  const float* gdh;    // [NR, D]
  const float* gdx;    // [NR, L, D]
  const int* starts;   // [N + 1]  table row n's slots: order[starts[n]:starts[n+1]]
  const int* order;    // [NR * K] flat slot indices, sorted (stably) by nbr
  float *gt, *gq, *gk, *gxg, *gv, *grl, *gX, *genv, *gscale, *gwre, *gbre,
      *gwrs, *gbrs;
  // workspace: tf, gtf [P, C]; zre, gz [P, D]; ga [P, H]; part (partials)
  float *tf, *gtf, *zre, *gz, *ga, *part;
  long long P;         // slots, NR * K
  int NR, N, K, D, H, L, C, lmax, sep_dir, sep_tensor, scale_heads;
};

// channel block b of o: 0 scalar, 1 direction, 2 tensor; and its m range
struct Block {
  int kind, mlo, mhi;
};

__device__ __forceinline__ Block block_of(const Params& p, int b) {
  if (b == 0) return {0, 0, 0};
  const int n_dir = p.sep_dir ? p.lmax : 1;
  const int kind = b <= n_dir ? 1 : 2;
  const bool sep = kind == 1 ? p.sep_dir : p.sep_tensor;
  const int l = kind == 1 ? b : b - n_dir;   // degree, when separate
  return {kind, sep ? l * l - 1 : 0, sep ? (l + 1) * (l + 1) - 1 : p.L};
}

__device__ __forceinline__ float scale_at(const Params& p, long long slot,
                                          int h) {
  return p.scale_heads ? p.scale[slot * p.H + h] : p.scale[slot];
}

// the table row slot `slot` reads
__device__ __forceinline__ long long src_of(const Params& p, long long slot) {
  return min(max(p.nbr[slot], 0), p.N - 1);
}

// the cotangent of o at (slot of row i reading table row j, channel c), in
// the pair type: scalar block g_dh[i]; direction blocks sum_m rl[slot,m]
// g_dX[i,m]; tensor blocks sum_m X[j,m] g_dX[i,m]; each product and each
// partial sum rounded, in m order, as the TPU kernel adds them in the pair
// type
template <bool kBF>
__device__ float grad_o(const Params& p, long long i, long long j,
                        long long slot, int c) {
  const int D = p.D, L = p.L;
  const Block blk = block_of(p, c / D);
  const int d = c % D;
  if (blk.kind == 0) return rnd<kBF>(p.gdh[i * D + d]);
  const float* gx = p.gdx + i * L * D + d;
  const float* x = p.X + j * L * D + d;
  float s = 0.f;
  for (int m = blk.mlo; m < blk.mhi; ++m) {
    const float f = blk.kind == 1 ? p.rl[slot * L + m] : x[m * D];
    s = rnd<kBF>(s + rnd<kBF>(rnd<kBF>(f) * rnd<kBF>(gx[m * D])));
  }
  return s;
}

// pass 2: one warp per slot at a time, kSlotsPerBlock slots per block.  Lane
// l takes channels l, l + 32, ...: it writes g_tf = g_o x_g[j] max(env, 0)
// and sums g_env's terms g_o tf x_g[j], g_attn's terms g_o v[j] (per head)
// and g_rl's terms g_dX[i,m] o (direction blocks); then one thread per
// (slot, sum) adds the 32 lanes in order (store_lanes, lane_total).
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) slot_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);   // [slots][nq][kLanePad]
  const int C = p.C, D = p.D, H = p.H, L = p.L, nq = 1 + H + L;
  const int e_per = C / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long slot0 = (long long)blockIdx.x * kSlotsPerBlock;
  const NT* xg = static_cast<const NT*>(p.xg);
  const NT* v = static_cast<const NT*>(p.v);
  for (int r = warp; r < kSlotsPerBlock; r += kThreads / 32) {
    const long long slot = slot0 + r;
    float acc[1 + kMaxH + kMaxL];
    for (int u = 0; u < nq; ++u) acc[u] = 0.f;
    if (slot < p.P) {
      const long long i = slot / p.K, j = src_of(p, slot);
      const float envp = rnd<kBF>(fmaxf(p.env[slot], 0.f));
      for (int c = lane; c < C; c += 32) {
        const Block blk = block_of(p, c / D);
        const int h = c / e_per, d = c % D;
        const float go = grad_o<kBF>(p, i, j, slot, c);
        const float tf = p.tf[slot * C + c];
        const float xv = rnd<kBF>(to_f(xg[j * C + c]));
        const float vv = rnd<kBF>(to_f(v[j * C + c]));
        p.gtf[slot * C + c] = rnd<kBF>(rnd<kBF>(go * xv) * envp);
        acc[0] += rnd<kBF>(rnd<kBF>(go * tf) * xv);
        acc[1 + h] += rnd<kBF>(go * vv);
        if (blk.kind == 1) {
          const float ac = rnd<kBF>(p.sm[slot * H + h] * scale_at(p, slot, h));
          const float o = o_at<kBF>(tf, xv, vv, envp, ac);
          for (int m = blk.mlo; m < blk.mhi; ++m) {
            acc[1 + H + m] += rnd<kBF>(rnd<kBF>(p.gdx[(i * L + m) * D + d]) * o);
          }
        }
      }
    }
    store_lanes(red, r, nq, lane, acc);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kSlotsPerBlock * nq; e += kThreads) {
    const int r = e / nq, u = e % nq;
    const long long slot = slot0 + r;
    if (slot >= p.P) continue;
    const float s = lane_total(red, r, nq, u);
    if (u == 0) {
      p.genv[slot] = p.env[slot] >= 0.f ? s : 0.f;
    } else if (u <= H) {
      p.ga[slot * H + u - 1] = s;
    } else {
      p.grl[slot * L + u - 1 - H] = s;
    }
  }
}

// pass 3, one thread per destination row r: g_scale, then the softmax
// backward g_logits = sm * (g_sm - sum_s sm * g_sm), g_sm = g_attn * scale,
// written over g_attn
__global__ void __launch_bounds__(kThreads) softmax_bwd_kernel(const Params p) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= p.NR) return;
  const int K = p.K, H = p.H;
  if (!p.scale_heads) {
    for (int s = 0; s < K; ++s) {
      const long long slot = r * K + s;
      float acc = 0.f;
      for (int h = 0; h < H; ++h) acc += p.sm[slot * H + h] * p.ga[slot * H + h];
      p.gscale[slot] = acc;
    }
  }
  for (int h = 0; h < H; ++h) {
    float acc = 0.f;
    for (int s = 0; s < K; ++s) {
      const long long slot = r * K + s;
      acc += p.sm[slot * H + h] * (p.ga[slot * H + h] * scale_at(p, slot, h));
    }
    for (int s = 0; s < K; ++s) {
      const long long slot = r * K + s;
      const float sm = p.sm[slot * H + h], ga = p.ga[slot * H + h];
      if (p.scale_heads) p.gscale[slot * H + h] = sm * ga;
      p.ga[slot * H + h] = sm * (ga * scale_at(p, slot, h) - acc);
    }
  }
}

// pass 4: g_zre[slot, d] = g_logits[head(d)] q_i k_j silu'(z_re)
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_zre_kernel(const Params p) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= p.P * p.D) return;
  const long long slot = e / p.D;
  const int d = (int)(e % p.D);
  const long long i = slot / p.K, j = src_of(p, slot);
  const float z = p.zre[e], sg = sigmoid(z);
  const float gp = rnd<kBF>(p.ga[slot * p.H + d / (p.D / p.H)]);
  const float qv = rnd<kBF>(to_f(static_cast<const NT*>(p.q)[i * p.D + d]));
  const float kv = rnd<kBF>(to_f(static_cast<const NT*>(p.k)[j * p.D + d]));
  const float g_ta = rnd<kBF>(rnd<kBF>(gp * qv) * kv);
  p.gz[e] = g_ta * (sg + z * sg * (1.f - sg));
}

// pass 5: blockIdx.y picks the side.  0: one thread per (row r, d), g_q
// sums over the row's K slots; 1: one thread per (table row n, d), g_k sums
// over the slots that read n, in the transposed list's order
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_qk_kernel(const Params p) {
  const int side = blockIdx.y;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int D = p.D, Dh = p.D / p.H, K = p.K;
  if (e >= (long long)(side ? p.N : p.NR) * D) return;
  const long long n = e / D;
  const int d = (int)(e % D);
  const NT* q = static_cast<const NT*>(p.q);
  const NT* k = static_cast<const NT*>(p.k);
  const int lo = side ? p.starts[n] : 0, hi = side ? p.starts[n + 1] : K;
  float s = 0.f;
  for (int u = lo; u < hi; ++u) {
    const long long slot = side ? (long long)p.order[u] : n * K + u;
    const float z = p.zre[slot * D + d];
    const float ta = rnd<kBF>(z * sigmoid(z));
    const float gp = rnd<kBF>(p.ga[slot * p.H + d / Dh]);
    const float other = side ? rnd<kBF>(to_f(q[(slot / K) * D + d]))
                             : rnd<kBF>(to_f(k[src_of(p, slot) * D + d]));
    s += rnd<kBF>(rnd<kBF>(gp * ta) * other);
  }
  (side ? p.gk : p.gq)[e] = s;
}

// pass 6, one thread per (table row n, channel c): g_xg and g_v sum over the
// slots that read n, in the transposed list's order; a tensor-block channel
// also owns g_X[n, m, c % D] for each m of its block
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_tables_kernel(const Params p) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)p.N * p.C) return;
  const int C = p.C, D = p.D, H = p.H, L = p.L, K = p.K;
  const long long n = e / C;
  const int c = (int)(e % C), h = c / (C / H), d = c % D;
  const Block blk = block_of(p, c / D);
  const float xv = rnd<kBF>(to_f(static_cast<const NT*>(p.xg)[e]));
  const float vv = rnd<kBF>(to_f(static_cast<const NT*>(p.v)[e]));
  float sxg = 0.f, sv = 0.f, sx[kMaxL];
  for (int m = 0; m < L; ++m) sx[m] = 0.f;
  for (int u = p.starts[n]; u < p.starts[n + 1]; ++u) {
    const long long slot = p.order[u], i = slot / K;
    const float envp = rnd<kBF>(fmaxf(p.env[slot], 0.f));
    const float go = grad_o<kBF>(p, i, n, slot, c);
    const float tf = p.tf[slot * C + c];
    const float ac = rnd<kBF>(p.sm[slot * H + h] * scale_at(p, slot, h));
    sxg += rnd<kBF>(rnd<kBF>(go * tf) * envp);
    sv += rnd<kBF>(ac * go);
    if (blk.kind == 2) {
      const float o = o_at<kBF>(tf, xv, vv, envp, ac);
      for (int m = blk.mlo; m < blk.mhi; ++m) {
        sx[m] += rnd<kBF>(o * rnd<kBF>(p.gdx[(i * L + m) * D + d]));
      }
    }
  }
  p.gxg[e] = sxg;
  p.gv[e] = sv;
  if (blk.kind != 2) return;
  for (int m = blk.mlo; m < blk.mhi; ++m) p.gX[(n * L + m) * D + d] = sx[m];
}

// ---- the C entry point ----------------------------------------------------
// every launch of this file goes through here
template <typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream) {
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// workspace layout, in floats
struct Layout {
  size_t tf, gtf, zre, gz, ga, part, total;
};

Layout layout(long long P, int D, int H, int C) {
  const int S = splits_for(P);
  Layout w;
  w.tf = 0;
  w.gtf = w.tf + (size_t)P * C;
  w.zre = w.gtf + (size_t)P * C;
  w.gz = w.zre + (size_t)P * D;
  w.ga = w.gz + (size_t)P * D;
  w.part = w.ga + (size_t)P * H;
  w.total = w.part + (size_t)S * D * C;   // D*C >= D*D and >= C partials
  return w;
}

template <bool kBF, typename NT>
cudaError_t backward(const Params& p, int t_bf16, cudaStream_t s) {
  const int P = (int)p.P, D = p.D, C = p.C;
  // 1. t_filter (rounded, as the forward uses it) and z_re
  Product g{};
  g.a = p.t; g.a_sm = D; g.a_sk = 1; g.a_bf16 = t_bf16;
  g.b = p.wrs; g.b_sk = C; g.b_sn = 1;
  g.out = p.tf; g.o_sm = C; g.bias = p.brs;
  g.rows = P; g.cols = C; g.depth = D; g.round_out = 1;
  CHECK(product<kBF>(g, s));
  g.b = p.wre; g.b_sk = D;
  g.out = p.zre; g.o_sm = D; g.bias = p.bre; g.cols = D; g.round_out = 0;
  CHECK(product<kBF>(g, s));
  // 2. g_tf, g_attn, g_env, g_rl per slot
  auto slot_kern = slot_kernel<kBF, NT>;
  const size_t slot_smem =
      (size_t)kSlotsPerBlock * (1 + p.H + p.L) * kLanePad * sizeof(float);
  CHECK(cudaFuncSetAttribute(slot_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)slot_smem));
  CHECK(run(slot_kern, dim3((unsigned)((p.P + kSlotsPerBlock - 1) / kSlotsPerBlock)),
            slot_smem, p, s));
  // 3.-6. softmax backward, g_zre, g_q and g_k, the table gradients
  CHECK(run(softmax_bwd_kernel, dim3(blocks_for(p.NR)), 0, p, s));
  CHECK(run(grad_zre_kernel<kBF, NT>, dim3(blocks_for(p.P * D)), 0, p, s));
  CHECK(run(grad_qk_kernel<kBF, NT>, dim3(blocks_for((long long)p.N * D), 2),
            0, p, s));
  CHECK(run(grad_tables_kernel<kBF, NT>, dim3(blocks_for((long long)p.N * C)),
            0, p, s));
  // 7. g_t = g_tf W_rs^T + g_zre W_re^T
  Product gt{};
  gt.a = p.gtf; gt.a_sm = C; gt.a_sk = 1;
  gt.b = p.wrs; gt.b_sk = 1; gt.b_sn = C;
  gt.out = p.gt; gt.o_sm = D;
  gt.rows = P; gt.cols = D; gt.depth = C;
  CHECK(product<kBF>(gt, s));
  gt.a = p.gz; gt.a_sm = D; gt.b = p.wre; gt.b_sn = D; gt.depth = D;
  gt.accumulate = 1;
  CHECK(product<kBF>(gt, s));
  // 8. weight and bias gradients, sums over all slots
  Product gw{};
  gw.a = p.t; gw.a_sm = 1; gw.a_sk = D; gw.a_bf16 = t_bf16;
  gw.b = p.gtf; gw.b_sk = C; gw.b_sn = 1;
  gw.out = p.gwrs; gw.rows = D; gw.cols = C; gw.depth = P;
  CHECK(product_over_pairs<kBF>(gw, p.part, s));
  gw.b = p.gz; gw.b_sk = D; gw.out = p.gwre; gw.cols = D;
  CHECK(product_over_pairs<kBF>(gw, p.part, s));
  CHECK(column_sums(p.gtf, P, C, p.part, p.gbrs, s));
  CHECK(column_sums(p.gz, P, D, p.part, p.gbre, s));
  return cudaSuccess;
}

int channels(int D, int lmax, int sep_dir, int sep_tensor) {
  return D * (1 + (sep_dir ? lmax : 1) + (sep_tensor ? lmax : 1));
}

}  // namespace

// Workspace bytes the backward needs for these shapes.
extern "C" long long gotennet_fused_ell_bwd_workspace(int NR, int K, int D,
                                                      int H, int lmax,
                                                      int sep_dir,
                                                      int sep_tensor) {
  const int C = channels(D, lmax, sep_dir, sep_tensor);
  return (long long)(layout((long long)NR * K, D, H, C).total * sizeof(float));
}

// Launches on `stream` and allocates nothing (`work` holds at least
// gotennet_fused_ell_bwd_workspace bytes); returns the first CUDA error.
extern "C" int gotennet_fused_ell_bwd(
    const void* t, const void* q, const void* k, const void* xg,
    const void* v, const float* rl, const float* X, const float* env,
    const float* scale, const int* nbr, const float* wre, const float* bre,
    const float* wrs, const float* brs, const float* sm, const float* gdh,
    const float* gdx, const int* starts, const int* order, float* gt,
    float* gq, float* gk, float* gxg, float* gv, float* grl, float* gX,
    float* genv, float* gscale, float* gwre, float* gbre, float* gwrs,
    float* gbrs, float* work, int NR, int N, int K, int D, int H, int lmax,
    int sep_dir, int sep_tensor, int scale_heads, int pair_bf16, int t_bf16,
    int node_bf16, void* stream) {
  Params p;
  p.t = t; p.q = q; p.k = k; p.xg = xg; p.v = v;
  p.rl = rl; p.X = X; p.env = env; p.scale = scale; p.nbr = nbr;
  p.wre = wre; p.bre = bre; p.wrs = wrs; p.brs = brs;
  p.sm = sm; p.gdh = gdh; p.gdx = gdx; p.starts = starts; p.order = order;
  p.gt = gt; p.gq = gq; p.gk = gk; p.gxg = gxg; p.gv = gv; p.grl = grl;
  p.gX = gX; p.genv = genv; p.gscale = gscale; p.gwre = gwre; p.gbre = gbre;
  p.gwrs = gwrs; p.gbrs = gbrs;
  p.NR = NR; p.N = N; p.K = K; p.D = D; p.H = H; p.lmax = lmax;
  p.L = (lmax + 1) * (lmax + 1) - 1;
  p.C = channels(D, lmax, sep_dir, sep_tensor);
  p.P = (long long)NR * K;
  p.sep_dir = sep_dir; p.sep_tensor = sep_tensor; p.scale_heads = scale_heads;
  if (NR <= 0 || K <= 0) return (int)cudaSuccess;
  if (N < NR || D % H || p.C % H || H > kMaxH || p.L > kMaxL || lmax < 1)
    return (int)cudaErrorInvalidValue;
  const Layout w = layout(p.P, D, H, p.C);
  p.tf = work + w.tf; p.gtf = work + w.gtf; p.zre = work + w.zre;
  p.gz = work + w.gz; p.ga = work + w.ga; p.part = work + w.part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pair_bf16) {
    err = node_bf16 ? backward<true, __nv_bfloat16>(p, t_bf16, s)
                    : backward<true, float>(p, t_bf16, s);
  } else {
    err = node_bf16 ? backward<false, __nv_bfloat16>(p, t_bf16, s)
                    : backward<false, float>(p, t_bf16, s);
  }
  return (int)err;
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
