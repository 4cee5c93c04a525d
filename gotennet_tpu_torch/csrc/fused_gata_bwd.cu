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
// 6 * D * (mult*D + D) FLOP per pair, on the tensor cores for a bf16 pair
// type (bwd_sums.cuh), and the bytes of the pair arrays around them.  Of
// the elementwise work the pair pass (2 below) moves most of the bytes: it
// writes g_tf [P, C] in float32 and, for a bf16 pair type, its bf16 copy on
// every pair (6 bytes a (pair, channel)) and reads t_filter [P, C] on valid
// pairs alone.  At an MD22 force request's G 8, M 120 (D 256, mult 5, 14 %
// of pairs valid) that is ~0.97 GB, 0.29 ms at 3.35 TB/s; at a QM9 step's
// G 256, M 32 (62 % valid) ~2.8 GB, 0.85 ms.  So it writes an invalid
// pair's zeros 16 bytes at a time, reads nothing else there and forms
// nothing, forms g_o once per valid (pair, channel), and reads each node
// row once per tile.  On an H100 at 700 W it runs at 2.3x and 3.1x those
// bytes: a thread spends ~800 instructions on a valid pair's five
// channels, at 64 registers and three or four blocks an SM.  The products
// run over every pair, padded ones included, and now hold most of a launch
// at M = 120 (PERF.md §5-6 have the split and the times).
//
// Design.  The TPU kernel sums weight gradients and j-indexed gradients in
// place over its sequential grid.  Hopper's blocks run in parallel in no
// order, so here the work is cut into passes, each of whose outputs is owned
// by one thread, one warp or one block, and no sum uses atomics: every
// result is the same from run to run.
//  1. two products recompute t_filter = t W_rs + b_rs and z_re = t W_re +
//     b_re over all pairs into workspace (bwd_sums.cuh's `recompute`);
//  2. the pair pass: a block owns a tile of destination columns j of one
//     graph (a column's threads, the least power of two from 32 that holds
//     D, split its D channels, each thread a channel d of every channel
//     block; as many columns a block as fill its 256 threads) and walks
//     i = 0..M-1 in order.  On a valid pair it forms the cotangent of
//     o, g_o, once per channel and takes from it at once g_tf (and its bf16
//     copy), the column sums g_xg, g_v and, on the tensor channels, g_X
//     (each thread its own channels, in shared memory, in the order of i),
//     and the sums over the pair's channels: g_attn per head and, with
//     position gradients, g_env and g_rl (each thread's channels, then the
//     32 lanes of a warp in order, then the column's warps in order).  An
//     invalid pair gets exact zeros (g_tf, g_attn, g_env, g_rl) and adds
//     nothing: its softmax and envelope are 0, so every term there is an
//     exact zero and pass 3 multiplies its g_attn by a softmax of 0.
//     x_g[j], v[j] and X[j] are read once a tile, g_dh[i] and g_dX[i] once
//     for each i and column;
//  3. a block per destination row: g_scale, and the softmax backward over j
//     with a warp per head, the lanes splitting the row's pairs;
//  4. per (pair, channel of D): g_zre through the silu (and its bf16 copy);
//  5. per (node, channel of D): g_q (sum over j) and g_k (sum over i);
//  6. g_t = g_tf W_rs^T + g_zre W_re^T;
//  7. the weight gradients t^T g_tf and t^T g_zre, split over the pairs into
//     partials added in a fixed order, and the bias gradients as column sums
//     in strips, then a warp per column (6 and 7: bwd_sums.cuh's
//     `grad_products`).
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
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;   // shared memory a block can use

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
  // the pair pass's tile (pair_tile): threads a column (a power of two,
  // 32..kThreads), columns a block, channels of D a thread, channel blocks
  // of o, sums over a pair's channels (g_attn's H, then g_env and g_rl's L
  // with position gradients)
  int tc, tj, nd, nb, nq;
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

// ---- pass 2, the pair pass ------------------------------------------------
// Its shared memory.  Each thread's slots, slot-major ([slot][kThreads], so
// a warp's lanes take 32 banks): for each of its nd channels of D, the
// rounded x_g[j] and v[j] (nb each) and X[j] (L), and the sums over i of
// g_xg, g_v (nb each) and g_X (L); and g_dX[i] of the channel in hand,
// rounded (L).  Then env of every pair (i, j) of the tile ([M][tj]).  Then
// the lanes' partial sums over a pair's channels, [kWarps][nq][kLanePad]
// (store_lanes' layout), and the warps', [kWarps][nq].  Offsets of the
// slots in slots, of the rest in floats.
struct PairSmem {
  int xv, vv, xr, sxg, sv, sX, gx, env, red, red2, floats;
};

__host__ __device__ __forceinline__ PairSmem pair_smem(const Params& p) {
  PairSmem s;
  const int nbd = p.nb * p.nd, nld = p.L * p.nd;
  s.xv = 0;
  s.vv = s.xv + nbd;
  s.xr = s.vv + nbd;
  s.sxg = s.xr + nld;
  s.sv = s.sxg + nbd;
  s.sX = s.sv + nbd;
  s.gx = s.sX + nld;
  s.env = (s.gx + p.L) * kThreads;
  s.red = s.env + p.M * p.tj;
  s.red2 = s.red + kWarps * p.nq * kLanePad;
  s.floats = s.red2 + kWarps * p.nq;
  return s;
}

// an invalid pair's g_tf row (and its bf16 copy): exact zeros, written by
// the nt threads t0, t0 + 1, ... 16 bytes at a time where rows are 16-byte
// runs (the workspace's parts start on 16 bytes)
template <bool kBF>
__device__ __forceinline__ void zero_gtf_row(const Params& p, size_t pair,
                                             int t0, int nt) {
  const int C = p.C;
  if (C % 8 == 0) {
    const float4 z = {0.f, 0.f, 0.f, 0.f};
    float4* row = reinterpret_cast<float4*>(p.gtf + pair * C);
    for (int q = t0; q < C / 4; q += nt) row[q] = z;
    if constexpr (kBF) {
      float4* rb = reinterpret_cast<float4*>(p.gtf_b + pair * C);
      for (int q = t0; q < C / 8; q += nt) rb[q] = z;
    }
  } else {
    for (int c = t0; c < C; c += nt) {
      p.gtf[pair * C + c] = 0.f;
      if constexpr (kBF) p.gtf_b[pair * C + c] = __float2bfloat16(0.f);
    }
  }
}

// sum u of pair `pair` over its channels: g_attn (u < H), g_env, g_rl
__device__ __forceinline__ void store_pair_sum(const Params& p, size_t pair,
                                               int u, float s) {
  if (u < p.H) {
    p.ga[pair * p.H + u] = s;
  } else if (u == p.H) {
    p.genv[pair] = s;
  } else {
    p.grl[pair * p.L + u - p.H - 1] = s;
  }
}

// A block per tile of p.tj destination columns j of graph g; the p.tc
// threads of a column take its channels d = dt, dt + tc, ... of D, each of
// every channel block, and walk i = 0..M-1 in order.  On a valid pair
// (i, j) a thread forms g_o for each of its channels once, from g_dh[i],
// g_dX[i], rl[ij] and X[j]: the scalar block g_dh[i]; a direction block
// sum_m rl[ij,m] g_dX[i,m] (float32 sum, rounded once); a tensor block
// sum_m X[j,m] g_dX[i,m] (each product and partial sum rounded, as the TPU
// kernel adds them in the pair type).  From it, at once:
//   g_tf[ij, c] = g_o x_g[j] env+ (and its bf16 copy);
//   g_xg[j, c] += g_o tf env+, g_v[j, c] += attn g_o, and on a tensor
//     channel g_X[j, m, d] += o g_dX[i, m] (the thread's own sums, in the
//     order of i);
//   g_attn[ij, h] = sum over the head's channels of g_o v[j]; with position
//     gradients g_env[ij] = sum over every channel of g_o tf x_g[j], and
//     g_rl[ij, m] = sum over m's direction block of g_dX[i, m] o (products
//     of rounded factors left unrounded: the TPU kernel forms g_rl as a
//     float32-accumulating matmul).  Each thread sums its channels, then
//     the 32 lanes of a warp are added in order, then the column's warps.
// An invalid pair writes exact zeros and adds nothing.  The tile's env is
// read once, up front, so a row waits on no load to know which of its pairs
// are valid; every thread reads it alike, so the barriers are the block's,
// and a row with no valid pair in the tile takes none.
template <bool kBF, typename NT, bool kPos>
__global__ void __launch_bounds__(kThreads) pair_pass_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const PairSmem o = pair_smem(p);
  const int M = p.M, D = p.D, C = p.C, H = p.H, L = p.L;
  const int nd = p.nd, nb = p.nb, nq = p.nq, tc = p.tc, tj = p.tj;
  const int e_per = C / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = (M + tj - 1) / tj;
  const size_t g = blockIdx.x / tiles;
  const int j0 = (int)(blockIdx.x % tiles) * tj;
  const int jl = tid / tc, dt = tid % tc, j = j0 + jl;
  const bool col = j < M;
  const size_t gj = g * M + j;
  auto at = [&](int slot) -> float& { return sh[slot * kThreads + tid]; };
  float* senv = sh + o.env;   // [M][tj]
  float* red = sh + o.red;
  float* red2 = sh + o.red2;
  float* part = red + warp * nq * kLanePad + lane;   // sum u: part[u * kLanePad]
  const NT* xg = static_cast<const NT*>(p.xg);
  const NT* v = static_cast<const NT*>(p.v);
  // the tile's env, once (past the graph's columns: invalid)
  for (int e = tid; e < M * tj; e += kThreads) {
    const int q = e % tj;
    senv[e] = j0 + q < M ? p.env[(g * M + e / tj) * M + j0 + q] : -1.f;
  }
  // x_g[j], v[j] and X[j], rounded, once a tile; the sums start at zero
  for (int e = 0; col && e < nd && dt + e * tc < D; ++e) {
    const int d = dt + e * tc;
    for (int b = 0; b < nb; ++b) {
      at(o.xv + b * nd + e) = rnd<kBF>(to_f(xg[gj * C + b * D + d]));
      at(o.vv + b * nd + e) = rnd<kBF>(to_f(v[gj * C + b * D + d]));
      at(o.sxg + b * nd + e) = 0.f;
      at(o.sv + b * nd + e) = 0.f;
    }
    for (int m = 0; m < L; ++m) {
      at(o.xr + m * nd + e) = rnd<kBF>(p.X[(gj * L + m) * D + d]);
      at(o.sX + m * nd + e) = 0.f;
    }
  }
  __syncthreads();
  for (int i = 0; i < M; ++i) {
    const size_t gi = g * M + i, pair = gi * M + j;
    const float* env_i = senv + i * tj;
    bool any = false;
    for (int q = 0; q < tj; ++q) any = any || env_i[q] >= 0.f;
    const float env = col ? env_i[jl] : -1.f;
    if (col && env < 0.f) zero_gtf_row<kBF>(p, pair, dt, tc);
    if (any) {
      if (col && env >= 0.f) {
        for (int u = 0; u < nq; ++u) part[u * kLanePad] = 0.f;
        const float envp = rnd<kBF>(fmaxf(env, 0.f));
        const float* rl = p.rl + pair * L;
        for (int e = 0; e < nd && dt + e * tc < D; ++e) {
          const int d = dt + e * tc;
          const float gh = rnd<kBF>(p.gdh[gi * D + d]);
          for (int m = 0; m < L; ++m) {
            at(o.gx + m) = rnd<kBF>(p.gdx[(gi * L + m) * D + d]);
          }
          for (int b = 0; b < nb; ++b) {
            const Block blk = block_of(p, b);
            const int c = b * D + d, h = c / e_per;
            const float tf = p.tf[pair * C + c];
            const float xv = at(o.xv + b * nd + e), vv = at(o.vv + b * nd + e);
            float go = gh;
            if (blk.kind == 1) {
              float s = 0.f;
              for (int m = blk.mlo; m < blk.mhi; ++m) {
                s += rnd<kBF>(rl[m]) * at(o.gx + m);
              }
              go = rnd<kBF>(s);
            } else if (blk.kind == 2) {
              float s = 0.f;
              for (int m = blk.mlo; m < blk.mhi; ++m) {
                s = rnd<kBF>(s + rnd<kBF>(at(o.xr + m * nd + e) * at(o.gx + m)));
              }
              go = s;
            }
            const float val = rnd<kBF>(rnd<kBF>(go * xv) * envp);
            p.gtf[pair * C + c] = val;
            if constexpr (kBF) p.gtf_b[pair * C + c] = __float2bfloat16(val);
            const float ac = rnd<kBF>(p.sm[pair * H + h] * scale_at(p, pair, h));
            const float gotf = rnd<kBF>(go * tf);
            at(o.sxg + b * nd + e) += rnd<kBF>(gotf * envp);
            at(o.sv + b * nd + e) += rnd<kBF>(ac * go);
            part[h * kLanePad] += rnd<kBF>(go * vv);
            if constexpr (kPos) part[H * kLanePad] += rnd<kBF>(gotf * xv);
            if (blk.kind == 2) {
              const float ov = o_at<kBF>(tf, xv, vv, envp, ac);
              for (int m = blk.mlo; m < blk.mhi; ++m) {
                at(o.sX + m * nd + e) += rnd<kBF>(ov * at(o.gx + m));
              }
            } else if (kPos && blk.kind == 1) {
              const float ov = o_at<kBF>(tf, xv, vv, envp, ac);
              for (int m = blk.mlo; m < blk.mhi; ++m) {
                part[(H + 1 + m) * kLanePad] += at(o.gx + m) * ov;
              }
            }
          }
        }
      }
      __syncthreads();
      for (int e = tid; e < kWarps * nq; e += kThreads) {
        red2[e] = lane_total(red, e / nq, nq, e % nq);
      }
      __syncthreads();
    }
    // the column's warps in order; zeros on invalid pairs
    const int W = tc / 32;
    for (int e = tid; e < tj * nq; e += kThreads) {
      const int q = e / nq, u = e % nq;
      if (j0 + q >= M) continue;
      float s = 0.f;
      if (env_i[q] >= 0.f) {
        for (int w = q * W; w < (q + 1) * W; ++w) s += red2[w * nq + u];
      }
      store_pair_sum(p, gi * M + j0 + q, u, s);
    }
  }
  for (int e = 0; col && e < nd && dt + e * tc < D; ++e) {
    const int d = dt + e * tc;
    for (int b = 0; b < nb; ++b) {
      p.gxg[gj * C + b * D + d] = at(o.sxg + b * nd + e);
      p.gv[gj * C + b * D + d] = at(o.sv + b * nd + e);
    }
    for (int m = 0; m < L; ++m) {
      p.gX[(gj * L + m) * D + d] = at(o.sX + m * nd + e);
    }
  }
}

// pass 3, a block per destination row (g, i): g_scale, then the softmax
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

// pass 4: g_zre[pair, d] = g_logits[head(d)] q_i k_j silu'(z_re)
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

// pass 5, one thread per (g, n, d): g_q[g,n,d] sums over j, g_k[g,n,d] over i
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

// the pair pass's tile: a column's threads the least power of two from 32
// that holds D (a warp at least, so its lanes' sums stay within a column),
// at most kThreads (more channels a thread beyond that), and as many
// columns a block as fill its kThreads
void pair_tile(Params& p) {
  p.tc = 32;
  while (p.tc < p.D && p.tc < kThreads) p.tc *= 2;
  p.tj = kThreads / p.tc;
  p.nd = (p.D + p.tc - 1) / p.tc;
  p.nb = p.C / p.D;
  p.nq = p.H + (p.grl != nullptr ? 1 + p.L : 0);
}

template <bool kBF, typename NT, bool kPos>
cudaError_t pair_pass(const Params& p, cudaStream_t s) {
  auto kern = pair_pass_kernel<kBF, NT, kPos>;
  const size_t smem = (size_t)pair_smem(p).floats * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem));
  const unsigned tiles = (unsigned)((p.M + p.tj - 1) / p.tj);
  return run(kern, dim3((unsigned)p.G * tiles), smem, p, s);
}

template <bool kBF, typename NT>
cudaError_t backward(const Params& p, const MsgProducts& m, cudaStream_t s) {
  const int P = p.G * p.M * p.M, D = p.D;
  // 1. t_filter (rounded, as the forward uses it) and z_re
  CHECK(recompute<kBF>(m, s));
  // 2. the pair pass: g_tf, g_attn, g_xg, g_v, g_X (and g_env, g_rl)
  const cudaError_t err = p.grl != nullptr ? pair_pass<kBF, NT, true>(p, s)
                                            : pair_pass<kBF, NT, false>(p, s);
  CHECK(err);
  // 3.-5. the softmax backward, g_zre, g_q and g_k
  CHECK(run(softmax_bwd_kernel, dim3((unsigned)(p.G * p.M)),
            (size_t)kWarps * kLanePad * sizeof(float), p, s));
  CHECK(run(grad_zre_kernel<kBF, NT>, dim3(blocks_for((size_t)P * D)), 0, p,
            s));
  CHECK(run(grad_qk_kernel<kBF, NT>, dim3(blocks_for((size_t)p.G * p.M * D)),
            0, p, s));
  // 6.-7. g_t, the weight and bias gradients
  return grad_products<kBF>(m, s);
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
  if (D % H || p.C % H || (grl == nullptr) != (genv == nullptr))
    return (int)cudaErrorInvalidValue;
  pair_tile(p);
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
