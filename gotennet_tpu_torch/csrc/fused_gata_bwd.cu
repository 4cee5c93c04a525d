// Fused dense-GATA message + aggregation, backward, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of gotennet_tpu/ops/pallas/fused_gata.py
// (launched by `_pallas_backward`, wired by `make_fused_gata`) with
// pos_grads=False: the cotangents of every input of the forward except rl and
// env_signed.  The math and the cast points are written out in
// gotennet_tpu_torch/ops/fused_gata.py (`fused_gata_backward_reference`), the
// plain PyTorch version this kernel is held against.
//
// What bounds it on an H100: six pair projections (t W_rs and t W_re
// recomputed, g_tf W_rs^T, g_zre W_re^T, t^T g_tf, t^T g_zre),
// 6 * D * (mult*D + D) FLOP per valid pair: ~25 GFLOP for a 16-graph chunk
// at M = 32 and QM9 density (D = 256, mult = 5), a few tens of microseconds
// on the tensor cores, against ~20 MB of inputs and outputs (~6 us).  So the
// operations bound it.
//
// Design (right first; tensor cores, fusion and overlap are later work).  The
// TPU kernel sums weight gradients and j-indexed gradients in place over its
// sequential grid.  Hopper's blocks run in parallel in no order, so here the
// work is cut into passes, each of whose outputs is owned by one thread or one
// block, and no sum uses atomics: every result is the same from run to run.
//  1. two projections recompute t_filter = t W_rs + b_rs and z_re = t W_re +
//     b_re over all pairs into workspace (a tiled FP32-FMA product);
//  2. per (pair, channel): the cotangent of the spatial filter, g_tf;
//  3. per (pair, head): the attention cotangent, a sum over the head's
//     channels (each channel's g_o recomputed);
//  4. per destination row: the softmax backward over j, and g_scale;
//  5. per (pair, channel of D): g_zre through the silu;
//  6. per (node, channel of D): g_q (sum over j) and g_k (sum over i);
//  7. per (node, channel): g_xg and g_v (sums over i), and g_X from the
//     tensor blocks (sums over i);
//  8. g_t = g_tf W_rs^T + g_zre W_re^T, one product each;
//  9. the weight gradients t^T g_tf and t^T g_zre, and the bias gradients
//     (column sums), as sums over all pairs of the chunk: split over blocks
//     into partials, then one pass adds the partials in a fixed order.
// Padded atoms and invalid pairs (env < 0) have softmax 0 and envelope 0, so
// every term they touch is an exact zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// ---- the elementwise passes -----------------------------------------------
struct Params {
  const void* t;       // [G, M, M, D]    float or bf16
  const void* q;       // [G, M, D]       node type
  const void* k;       // [G, M, D]
  const void* xg;      // [G, M, C]
  const void* v;       // [G, M, C]
  const float* rl;     // [G, M, M, L]
  const float* X;      // [G, M, L, D]
  const float* env;    // [G, M, M]
  const float* scale;  // [G, M, M] or [G, M, M, H]
  const float* wre;    // [D, D]   (in, out)
  const float* bre;    // [D]
  const float* wrs;    // [D, C]   (in, out)
  const float* brs;    // [C]
  const float* sm;     // [G, M, M, H]  the forward's pre-scale softmax
  const float* gdh;    // [G, M, D]
  const float* gdx;    // [G, M, L, D]
  float *gt, *gq, *gk, *gxg, *gv, *gX, *gscale, *gwre, *gbre, *gwrs, *gbrs;
  // workspace: tf, gtf [P, C]; zre, gz [P, D]; ga [P, H]; part (partials)
  float *tf, *gtf, *zre, *gz, *ga, *part;
  int G, M, D, H, L, C, lmax, sep_dir, sep_tensor, scale_heads;
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

__device__ __forceinline__ float scale_at(const Params& p, size_t pair,
                                          int h) {
  return p.scale_heads ? p.scale[pair * p.H + h] : p.scale[pair];
}

// the cotangent of o at (pair (gi, j), channel c), in the pair type:
// scalar block g_dh[i]; direction blocks sum_m rl[ij,m] g_dX[i,m] (float32
// sum, rounded once); tensor blocks sum_m X[j,m] g_dX[i,m] (each product and
// each partial sum rounded, as the TPU kernel adds them in the pair type)
template <bool kBF>
__device__ float grad_o(const Params& p, size_t gi, size_t gj, size_t pair,
                        int c) {
  const int D = p.D, L = p.L;
  const Block blk = block_of(p, c / D);
  const int d = c % D;
  if (blk.kind == 0) return rnd<kBF>(p.gdh[gi * D + d]);
  const float* gx = p.gdx + gi * L * D + d;
  float s = 0.f;
  if (blk.kind == 1) {
    for (int m = blk.mlo; m < blk.mhi; ++m) {
      s += rnd<kBF>(p.rl[pair * L + m]) * rnd<kBF>(gx[m * D]);
    }
    return rnd<kBF>(s);
  }
  const float* x = p.X + gj * L * D + d;
  for (int m = blk.mlo; m < blk.mhi; ++m) {
    s = rnd<kBF>(s + rnd<kBF>(rnd<kBF>(x[m * D]) * rnd<kBF>(gx[m * D])));
  }
  return s;
}

// pass 2: g_tf[pair, c] = g_o * x_g[j] * max(env, 0)
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_tf_kernel(const Params p) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t n = (size_t)p.G * p.M * p.M * p.C;
  if (e >= n) return;
  const size_t pair = e / p.C;
  const int c = (int)(e % p.C);
  const size_t gi = pair / p.M, g = gi / p.M, gj = g * p.M + pair % p.M;
  const float envp = rnd<kBF>(fmaxf(p.env[pair], 0.f));
  const float go = grad_o<kBF>(p, gi, gj, pair, c);
  const float xv = rnd<kBF>(to_f(static_cast<const NT*>(p.xg)[gj * p.C + c]));
  p.gtf[e] = rnd<kBF>(rnd<kBF>(go * xv) * envp);
}

// pass 3: g_attn[pair, h] = sum over the head's channels of g_o * v[j]
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_attn_kernel(const Params p) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t n = (size_t)p.G * p.M * p.M * p.H;
  if (e >= n) return;
  const size_t pair = e / p.H;
  const int h = (int)(e % p.H);
  const size_t gi = pair / p.M, g = gi / p.M, gj = g * p.M + pair % p.M;
  const int e_per = p.C / p.H;
  const NT* v = static_cast<const NT*>(p.v) + gj * p.C;
  float s = 0.f;
  for (int c = h * e_per; c < (h + 1) * e_per; ++c) {
    s += rnd<kBF>(grad_o<kBF>(p, gi, gj, pair, c) * rnd<kBF>(to_f(v[c])));
  }
  p.ga[e] = s;
}

// pass 4, one thread per destination row (g, i): g_scale, then the softmax
// backward g_logits = sm * (g_sm - sum_j sm * g_sm), g_sm = g_attn * scale,
// written over g_attn
__global__ void __launch_bounds__(kThreads) softmax_bwd_kernel(const Params p) {
  const size_t gi = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (gi >= (size_t)p.G * p.M) return;
  const int M = p.M, H = p.H;
  if (!p.scale_heads) {
    for (int j = 0; j < M; ++j) {
      const size_t pair = gi * M + j;
      float s = 0.f;
      for (int h = 0; h < H; ++h) s += p.sm[pair * H + h] * p.ga[pair * H + h];
      p.gscale[pair] = s;
    }
  }
  for (int h = 0; h < H; ++h) {
    float s = 0.f;
    for (int j = 0; j < M; ++j) {
      const size_t pair = gi * M + j;
      s += p.sm[pair * H + h] * (p.ga[pair * H + h] * scale_at(p, pair, h));
    }
    for (int j = 0; j < M; ++j) {
      const size_t pair = gi * M + j;
      const float sm = p.sm[pair * H + h], ga = p.ga[pair * H + h];
      if (p.scale_heads) p.gscale[pair * H + h] = sm * ga;
      p.ga[pair * H + h] = sm * (ga * scale_at(p, pair, h) - s);
    }
  }
}

// pass 5: g_zre[pair, d] = g_logits[head(d)] q_i k_j silu'(z_re)
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_zre_kernel(const Params p) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t n = (size_t)p.G * p.M * p.M * p.D;
  if (e >= n) return;
  const size_t pair = e / p.D;
  const int d = (int)(e % p.D);
  const size_t gi = pair / p.M, g = gi / p.M, gj = g * p.M + pair % p.M;
  const float z = p.zre[e], sg = sigmoid(z);
  const float gp = rnd<kBF>(p.ga[pair * p.H + d / (p.D / p.H)]);
  const float qv = rnd<kBF>(to_f(static_cast<const NT*>(p.q)[gi * p.D + d]));
  const float kv = rnd<kBF>(to_f(static_cast<const NT*>(p.k)[gj * p.D + d]));
  const float g_ta = rnd<kBF>(rnd<kBF>(gp * qv) * kv);
  p.gz[e] = g_ta * (sg + z * sg * (1.f - sg));
}

// pass 6, one thread per (g, n, d): g_q[g,n,d] sums over j, g_k[g,n,d] over i
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_qk_kernel(const Params p) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)p.G * p.M * p.D) return;
  const int M = p.M, D = p.D, Dh = p.D / p.H;
  const size_t gn = e / D, g = gn / M, node = gn % M;
  const int d = (int)(e % D);
  const NT* q = static_cast<const NT*>(p.q);
  const NT* k = static_cast<const NT*>(p.k);
  float sq = 0.f, sk = 0.f;
  for (int o = 0; o < M; ++o) {
    const size_t pq = gn * M + o;                 // (i = node, j = o)
    const size_t pk = (g * M + o) * M + node;     // (i = o, j = node)
    const float zq = p.zre[pq * D + d], zk = p.zre[pk * D + d];
    const float taq = rnd<kBF>(zq * sigmoid(zq)), tak = rnd<kBF>(zk * sigmoid(zk));
    const float gpq = rnd<kBF>(p.ga[pq * p.H + d / Dh]);
    const float gpk = rnd<kBF>(p.ga[pk * p.H + d / Dh]);
    const float kj = rnd<kBF>(to_f(k[(g * M + o) * D + d]));
    const float qi = rnd<kBF>(to_f(q[(g * M + o) * D + d]));
    sq += rnd<kBF>(rnd<kBF>(gpq * taq) * kj);
    sk += rnd<kBF>(rnd<kBF>(gpk * tak) * qi);
  }
  p.gq[e] = sq;
  p.gk[e] = sk;
}

// pass 7, one thread per (g, j, c): g_xg and g_v sum over i; a tensor-block
// channel also owns g_X[g, j, m, c % D] for each m of its block
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) grad_nodes_kernel(const Params p) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)p.G * p.M * p.C) return;
  const int M = p.M, C = p.C, D = p.D, H = p.H, L = p.L;
  const size_t gj = e / C, g = gj / M, j = gj % M;
  const int c = (int)(e % C), head = c / (C / H), d = c % D;
  const Block blk = block_of(p, c / D);
  const float xv = rnd<kBF>(to_f(static_cast<const NT*>(p.xg)[e]));
  const float vv = rnd<kBF>(to_f(static_cast<const NT*>(p.v)[e]));
  float sxg = 0.f, sv = 0.f;
  for (int i = 0; i < M; ++i) {
    const size_t gi = g * M + i, pair = gi * M + j;
    const float envp = rnd<kBF>(fmaxf(p.env[pair], 0.f));
    const float go = grad_o<kBF>(p, gi, gj, pair, c);
    const float tf = p.tf[pair * C + c];
    const float ac = rnd<kBF>(p.sm[pair * H + head] * scale_at(p, pair, head));
    sxg += rnd<kBF>(rnd<kBF>(go * tf) * envp);
    sv += rnd<kBF>(ac * go);
  }
  p.gxg[e] = sxg;
  p.gv[e] = sv;
  if (blk.kind != 2) return;
  for (int m = blk.mlo; m < blk.mhi; ++m) {
    float s = 0.f;
    for (int i = 0; i < M; ++i) {
      const size_t gi = g * M + i, pair = gi * M + j;
      const float envp = rnd<kBF>(fmaxf(p.env[pair], 0.f));
      const float tf = p.tf[pair * C + c];
      const float ac = rnd<kBF>(p.sm[pair * H + head] * scale_at(p, pair, head));
      const float o = rnd<kBF>(rnd<kBF>(rnd<kBF>(tf * xv) * envp) + rnd<kBF>(ac * vv));
      s += rnd<kBF>(o * rnd<kBF>(p.gdx[(gi * L + m) * D + d]));
    }
    p.gX[(gj * L + m) * D + d] = s;
  }
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

Layout layout(int G, int M, int D, int H, int C) {
  const size_t P = (size_t)G * M * M;
  const int S = splits_for((int)P);
  Layout w;
  w.tf = 0;
  w.gtf = w.tf + P * C;
  w.zre = w.gtf + P * C;
  w.gz = w.zre + P * D;
  w.ga = w.gz + P * D;
  w.part = w.ga + P * H;
  w.total = w.part + (size_t)S * D * C;   // D*C >= D*D and >= C partials
  return w;
}

template <bool kBF, typename NT>
cudaError_t backward(const Params& p, int t_bf16, cudaStream_t s) {
  const int P = p.G * p.M * p.M, D = p.D, C = p.C;
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
  // 2-7. the elementwise passes
  const size_t PC = (size_t)P * C, PH = (size_t)P * p.H, PD = (size_t)P * D;
  CHECK(run(grad_tf_kernel<kBF, NT>, dim3(blocks_for(PC)), 0, p, s));
  CHECK(run(grad_attn_kernel<kBF, NT>, dim3(blocks_for(PH)), 0, p, s));
  CHECK(run(softmax_bwd_kernel, dim3(blocks_for((size_t)p.G * p.M)), 0, p, s));
  CHECK(run(grad_zre_kernel<kBF, NT>, dim3(blocks_for(PD)), 0, p, s));
  CHECK(run(grad_qk_kernel<kBF, NT>, dim3(blocks_for((size_t)p.G * p.M * D)),
            0, p, s));
  CHECK(run(grad_nodes_kernel<kBF, NT>, dim3(blocks_for((size_t)p.G * p.M * C)),
            0, p, s));
  // 8. g_t = g_tf W_rs^T + g_zre W_re^T
  Product gt{};
  gt.a = p.gtf; gt.a_sm = C; gt.a_sk = 1;
  gt.b = p.wrs; gt.b_sk = 1; gt.b_sn = C;
  gt.out = p.gt; gt.o_sm = D;
  gt.rows = P; gt.cols = D; gt.depth = C;
  CHECK(product<kBF>(gt, s));
  gt.a = p.gz; gt.a_sm = D; gt.b = p.wre; gt.b_sn = D; gt.depth = D;
  gt.accumulate = 1;
  CHECK(product<kBF>(gt, s));
  // 9. weight and bias gradients, sums over all pairs
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

}  // namespace

// Workspace bytes the backward needs for these shapes.
extern "C" long long gotennet_fused_gata_bwd_workspace(int G, int M, int D,
                                                       int H, int lmax,
                                                       int sep_dir,
                                                       int sep_tensor) {
  const int C = D * (1 + (sep_dir ? lmax : 1) + (sep_tensor ? lmax : 1));
  return (long long)(layout(G, M, D, H, C).total * sizeof(float));
}

// Launches on `stream` and allocates nothing (`work` holds at least
// gotennet_fused_gata_bwd_workspace bytes); returns the first CUDA error.
extern "C" int gotennet_fused_gata_bwd(
    const void* t, const void* q, const void* k, const void* xg,
    const void* v, const float* rl, const float* X, const float* env,
    const float* scale, const float* wre, const float* bre, const float* wrs,
    const float* brs, const float* sm, const float* gdh, const float* gdx,
    float* gt, float* gq, float* gk, float* gxg, float* gv, float* gX,
    float* gscale, float* gwre, float* gbre, float* gwrs, float* gbrs,
    float* work, int G, int M, int D, int H, int lmax, int sep_dir,
    int sep_tensor, int scale_heads, int pair_bf16, int t_bf16,
    int node_bf16, void* stream) {
  Params p;
  p.t = t; p.q = q; p.k = k; p.xg = xg; p.v = v;
  p.rl = rl; p.X = X; p.env = env; p.scale = scale;
  p.wre = wre; p.bre = bre; p.wrs = wrs; p.brs = brs;
  p.sm = sm; p.gdh = gdh; p.gdx = gdx;
  p.gt = gt; p.gq = gq; p.gk = gk; p.gxg = gxg; p.gv = gv; p.gX = gX;
  p.gscale = gscale; p.gwre = gwre; p.gbre = gbre; p.gwrs = gwrs;
  p.gbrs = gbrs;
  p.G = G; p.M = M; p.D = D; p.H = H; p.lmax = lmax;
  p.L = (lmax + 1) * (lmax + 1) - 1;
  p.C = D * (1 + (sep_dir ? lmax : 1) + (sep_tensor ? lmax : 1));
  p.sep_dir = sep_dir; p.sep_tensor = sep_tensor; p.scale_heads = scale_heads;
  if (G <= 0 || M <= 0) return (int)cudaSuccess;
  if (D % H || p.C % H) return (int)cudaErrorInvalidValue;
  const Layout w = layout(G, M, D, H, p.C);
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
