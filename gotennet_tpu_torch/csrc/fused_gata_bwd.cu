// Fused dense-GATA message + aggregation, backward, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of gotennet_tpu/ops/pallas/fused_gata.py
// (launched by `_pallas_backward`, wired by `make_fused_gata`): the
// cotangents of every input of the forward, those of rl and env_signed (the
// position gradients, pos_grads=True) only when the caller passes outputs for
// them.  The math and the cast points are written out in
// gotennet_tpu_torch/ops/fused_gata.py (`fused_gata_backward_reference`), the
// plain PyTorch version this kernel is held against.
//
// What bounds it on an H100: six pair projections (t W_rs and t W_re
// recomputed, g_tf W_rs^T, g_zre W_re^T, t^T g_tf, t^T g_zre),
// 6 * D * (mult*D + D) FLOP per pair: 136 GFLOP for a 4-frame MD22 chunk
// (M = 120, D = 256, mult = 5) over every pair, ~25 GFLOP for a 16-graph
// QM9 chunk at M = 32; over the valid pairs alone (invalid ones add exact
// zeros) the operations still bound it, at a few tens of microseconds on the
// tensor cores, against ~20-60 MB of inputs and outputs.  The kernel runs
// ~100x above that bound.  On an H100 at M = 120 passes 7, 3 and 2, each of
// which recomputes g_o per (pair, channel), take about 70 % of its time, and
// the six products about 20 %; the products run over every pair, padded
// ones included (PERF.md §5-6 have the split and the times).
//
// Design.  The TPU kernel sums weight gradients and j-indexed gradients in
// place over its sequential grid.  Hopper's blocks run in parallel in no
// order, so here the work is cut into passes, each of whose outputs is owned
// by one thread, one warp or one block, and no sum uses atomics: every
// result is the same from run to run.
//  1. two products recompute t_filter = t W_rs + b_rs and z_re = t W_re +
//     b_re over all pairs into workspace (bwd_sums.cuh's `recompute`);
//  2. per (pair, channel): the cotangent of the spatial filter, g_tf (and,
//     for a bf16 pair type, its bf16 copy for the products);
//  3. per (pair, head): the attention cotangent, a sum over the head's
//     channels (each channel's g_o recomputed);
//  4. a block per destination row: g_scale, and the softmax backward over j
//     with a warp per head, the lanes splitting the row's pairs;
//  5. per (pair, channel of D): g_zre through the silu (and its bf16 copy);
//  6. per (node, channel of D): g_q (sum over j) and g_k (sum over i);
//  7. per (node, channel): g_xg and g_v (sums over i), and g_X from the
//     tensor blocks (sums over i);
//  8. g_t = g_tf W_rs^T + g_zre W_re^T;
//  9. the weight gradients t^T g_tf and t^T g_zre, split over the pairs into
//     partials added in a fixed order, and the bias gradients as column sums
//     in strips, then a warp per column (8 and 9: bwd_sums.cuh's
//     `grad_products`);
// 10. with position gradients only, a warp per pair: g_env and g_rl, sums
//     over the pair's channels (each lane sums its channels, then the 32
//     lanes are added in order), as the ELL backward's slot pass sums them.
// The six products run on the tensor cores for a bf16 pair type
// (mma.sync.m16n8k16, bf16 factors, float32 sums: bwd_sums.cuh), on bf16
// copies of their factors, and as float32 FMAs for a float32 pair type.
// Padded atoms and invalid pairs (env < 0) have softmax 0 and envelope 0, so
// every term they touch is an exact zero (o too, so g_rl is zero there; g_env
// is set to zero on invalid pairs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairsPerBlock = 16;             // pairs per block of pass 10
constexpr int kMaxL = 24;                      // SH components (lmax <= 4)

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
  float *gt, *gq, *gk, *gxg, *gv, *grl, *gX, *genv, *gscale, *gwre, *gbre,
      *gwrs, *gbrs;                     // grl, genv: null without pos_grads
  // workspace: tf, gtf [P, C]; zre, gz [P, D]; ga [P, H]; gtf_b, gz_b the
  // bf16 copies of gtf, gz (bf16 pair type)
  float *tf, *gtf, *zre, *gz, *ga;
  __nv_bfloat16 *gtf_b, *gz_b;
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
  const float val = rnd<kBF>(rnd<kBF>(go * xv) * envp);
  p.gtf[e] = val;
  if constexpr (kBF) p.gtf_b[e] = __float2bfloat16(val);
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

// pass 4, a block per destination row (g, i): g_scale, then the softmax
// backward g_logits = sm * (g_sm - sum_j sm * g_sm), g_sm = g_attn * scale,
// written over g_attn.  A scalar scale's g_scale is a thread per pair (its
// heads in order); the softmax a warp per head, the lanes splitting the row's
// pairs and their 32 sums added in order (store_lanes, lane_total).
__global__ void __launch_bounds__(kThreads) softmax_bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);   // [warps][1][kLanePad]
  const size_t gi = blockIdx.x;
  const int M = p.M, H = p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (!p.scale_heads) {
    for (int j = threadIdx.x; j < M; j += kThreads) {
      const size_t pair = gi * M + j;
      float s = 0.f;
      for (int h = 0; h < H; ++h) s += p.sm[pair * H + h] * p.ga[pair * H + h];
      p.gscale[pair] = s;
    }
  }
  for (int h0 = 0; h0 < H; h0 += kThreads / 32) {
    const int h = h0 + warp;
    float s = 0.f;
    for (int j = lane; h < H && j < M; j += 32) {
      const size_t pair = gi * M + j;
      s += p.sm[pair * H + h] * (p.ga[pair * H + h] * scale_at(p, pair, h));
    }
    store_lanes(red, warp, 1, lane, &s);
    __syncthreads();
    const float total = lane_total(red, warp, 1, 0);
    for (int j = lane; h < H && j < M; j += 32) {
      const size_t pair = gi * M + j;
      const float sm = p.sm[pair * H + h], ga = p.ga[pair * H + h];
      if (p.scale_heads) p.gscale[pair * H + h] = sm * ga;
      p.ga[pair * H + h] = sm * (ga * scale_at(p, pair, h) - total);
    }
    __syncthreads();   // red again for the next heads
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
  const float val = g_ta * (sg + z * sg * (1.f - sg));
  p.gz[e] = val;
  if constexpr (kBF) p.gz_b[e] = __float2bfloat16(val);
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
      const float o = o_at<kBF>(tf, xv, vv, envp, ac);
      s += rnd<kBF>(o * rnd<kBF>(p.gdx[(gi * L + m) * D + d]));
    }
    p.gX[(gj * L + m) * D + d] = s;
  }
}

// pass 10 (position gradients): one warp per pair at a time, kPairsPerBlock
// pairs per block.  Lane l takes channels l, l + 32, ...: it sums g_env's
// terms g_o tf x_g[j] over every channel and g_rl's terms g_dX[i,m] o over
// the direction blocks, each product of rounded factors left unrounded (the
// TPU kernel forms g_rl as a float32-accumulating matmul); then one thread
// per (pair, sum) adds the 32 lanes in order.
template <bool kBF, typename NT>
__global__ void __launch_bounds__(kThreads) pos_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);   // [pairs][nq][kLanePad]
  const int M = p.M, C = p.C, D = p.D, H = p.H, L = p.L, nq = 1 + L;
  const int e_per = C / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t n = (size_t)p.G * M * M;
  const size_t pair0 = (size_t)blockIdx.x * kPairsPerBlock;
  const NT* xg = static_cast<const NT*>(p.xg);
  const NT* v = static_cast<const NT*>(p.v);
  for (int r = warp; r < kPairsPerBlock; r += kThreads / 32) {
    const size_t pair = pair0 + r;
    float acc[1 + kMaxL];
    for (int u = 0; u < nq; ++u) acc[u] = 0.f;
    if (pair < n) {
      const size_t gi = pair / M, gj = gi / M * M + pair % M;
      const float envp = rnd<kBF>(fmaxf(p.env[pair], 0.f));
      for (int c = lane; c < C; c += 32) {
        const Block blk = block_of(p, c / D);
        const float go = grad_o<kBF>(p, gi, gj, pair, c);
        const float tf = p.tf[pair * C + c];
        const float xv = rnd<kBF>(to_f(xg[gj * C + c]));
        acc[0] += rnd<kBF>(rnd<kBF>(go * tf) * xv);
        if (blk.kind != 1) continue;
        const int h = c / e_per;
        const float ac = rnd<kBF>(p.sm[pair * H + h] * scale_at(p, pair, h));
        const float vv = rnd<kBF>(to_f(v[gj * C + c]));
        const float o = o_at<kBF>(tf, xv, vv, envp, ac);
        const float* gx = p.gdx + gi * L * D + c % D;
        for (int m = blk.mlo; m < blk.mhi; ++m) {
          acc[1 + m] += rnd<kBF>(gx[m * D]) * o;
        }
      }
    }
    store_lanes(red, r, nq, lane, acc);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kPairsPerBlock * nq; e += kThreads) {
    const int r = e / nq, u = e % nq;
    const size_t pair = pair0 + r;
    if (pair >= n) continue;
    const float s = lane_total(red, r, nq, u);
    if (u == 0) {
      p.genv[pair] = p.env[pair] >= 0.f ? s : 0.f;
    } else {
      p.grl[pair * L + u - 1] = s;
    }
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

// workspace layout, in floats (each part 16-byte aligned)
struct Layout {
  size_t tf, gtf, zre, gz, ga, part, bf, total;
};

Layout layout(int G, int M, int D, int H, int C) {
  const size_t P = (size_t)G * M * M;
  Layout w;
  w.tf = 0;
  w.gtf = w.tf + P * C;
  w.zre = w.gtf + P * C;
  w.gz = w.zre + P * D;
  w.ga = w.gz + P * D;
  w.part = up4(w.ga + P * H);
  w.bf = up4(w.part + part_floats((long long)P, D, C));
  w.total = w.bf + msg_bf16_floats((long long)P, D, C);
  return w;
}

template <bool kBF, typename NT>
cudaError_t backward(const Params& p, const MsgProducts& m, cudaStream_t s) {
  const int P = p.G * p.M * p.M, D = p.D, C = p.C;
  // 1. t_filter (rounded, as the forward uses it) and z_re
  CHECK(recompute<kBF>(m, s));
  // 2-7. the elementwise passes
  const size_t PC = (size_t)P * C, PH = (size_t)P * p.H, PD = (size_t)P * D;
  CHECK(run(grad_tf_kernel<kBF, NT>, dim3(blocks_for(PC)), 0, p, s));
  CHECK(run(grad_attn_kernel<kBF, NT>, dim3(blocks_for(PH)), 0, p, s));
  CHECK(run(softmax_bwd_kernel, dim3((unsigned)(p.G * p.M)),
            (size_t)(kThreads / 32) * kLanePad * sizeof(float), p, s));
  CHECK(run(grad_zre_kernel<kBF, NT>, dim3(blocks_for(PD)), 0, p, s));
  CHECK(run(grad_qk_kernel<kBF, NT>, dim3(blocks_for((size_t)p.G * p.M * D)),
            0, p, s));
  CHECK(run(grad_nodes_kernel<kBF, NT>, dim3(blocks_for((size_t)p.G * p.M * C)),
            0, p, s));
  // 8.-9. g_t, the weight and bias gradients
  CHECK(grad_products<kBF>(m, s));
  if (p.grl == nullptr) return cudaSuccess;
  // 10. g_env and g_rl, position gradients only
  auto pos_kern = pos_kernel<kBF, NT>;
  const size_t pos_smem = (size_t)kPairsPerBlock * (1 + p.L) * kLanePad *
                          sizeof(float);
  CHECK(cudaFuncSetAttribute(pos_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pos_smem));
  CHECK(run(pos_kern, dim3((unsigned)((P + kPairsPerBlock - 1) / kPairsPerBlock)),
            pos_smem, p, s));
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
// grl and genv are both null (no position gradients) or both given.
extern "C" int gotennet_fused_gata_bwd(
    const void* t, const void* q, const void* k, const void* xg,
    const void* v, const float* rl, const float* X, const float* env,
    const float* scale, const float* wre, const float* bre, const float* wrs,
    const float* brs, const float* sm, const float* gdh, const float* gdx,
    float* gt, float* gq, float* gk, float* gxg, float* gv, float* grl,
    float* gX, float* genv, float* gscale, float* gwre, float* gbre,
    float* gwrs, float* gbrs,
    float* work, int G, int M, int D, int H, int lmax, int sep_dir,
    int sep_tensor, int scale_heads, int pair_bf16, int t_bf16,
    int node_bf16, void* stream) {
  Params p;
  p.t = t; p.q = q; p.k = k; p.xg = xg; p.v = v;
  p.rl = rl; p.X = X; p.env = env; p.scale = scale;
  p.wre = wre; p.bre = bre; p.wrs = wrs; p.brs = brs;
  p.sm = sm; p.gdh = gdh; p.gdx = gdx;
  p.gt = gt; p.gq = gq; p.gk = gk; p.gxg = gxg; p.gv = gv; p.grl = grl;
  p.gX = gX; p.genv = genv; p.gscale = gscale; p.gwre = gwre; p.gbre = gbre; p.gwrs = gwrs;
  p.gbrs = gbrs;
  p.G = G; p.M = M; p.D = D; p.H = H; p.lmax = lmax;
  p.L = (lmax + 1) * (lmax + 1) - 1;
  p.C = D * (1 + (sep_dir ? lmax : 1) + (sep_tensor ? lmax : 1));
  p.sep_dir = sep_dir; p.sep_tensor = sep_tensor; p.scale_heads = scale_heads;
  if (G <= 0 || M <= 0) return (int)cudaSuccess;
  if (D % H || p.C % H || (grl == nullptr) != (genv == nullptr) ||
      (grl != nullptr && p.L > kMaxL))
    return (int)cudaErrorInvalidValue;
  const Layout w = layout(G, M, D, H, p.C);
  p.tf = work + w.tf; p.gtf = work + w.gtf; p.zre = work + w.zre;
  p.gz = work + w.gz; p.ga = work + w.ga;
  MsgProducts m{};
  m.t = t; m.t_bf16 = t_bf16;
  m.wrs = wrs; m.brs = brs; m.wre = wre; m.bre = bre;
  m.tf = p.tf; m.zre = p.zre; m.gtf = p.gtf; m.gz = p.gz;
  m.gt = gt; m.gwrs = gwrs; m.gbrs = gbrs; m.gwre = gwre; m.gbre = gbre;
  m.part = work + w.part;
  m.P = (long long)G * M * M; m.D = D; m.C = p.C;
  carve_bf16(m, work + w.bf);
  p.gtf_b = m.gtf_b; p.gz_b = m.gz_b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pair_bf16) {
    err = node_bf16 ? backward<true, __nv_bfloat16>(p, m, s)
                    : backward<true, float>(p, m, s);
  } else {
    err = node_bf16 ? backward<false, __nv_bfloat16>(p, m, s)
                    : backward<false, float>(p, m, s);
  }
  return (int)err;
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
