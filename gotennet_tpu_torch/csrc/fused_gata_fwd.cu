// Fused dense-GATA message + aggregation, forward, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of gotennet_tpu/ops/pallas/fused_gata.py
// (launched by `_pallas_forward`).  The math and the cast points are written
// out in gotennet_tpu_torch/ops/fused_gata.py, beside the plain PyTorch
// version this kernel is held against.
//
// What bounds it on an H100: the bytes.  An MD22 chunk (4 graphs, M = 120,
// D = 256, mult = 5) reads t (59 MB in float32) and writes d_h and dX; its
// two pair projections t W_re and t W_rs are 2 * pairs * D * (D + mult*D)
// FLOP, 45 GFLOP over all 57,600 pairs, 46 us at the bf16 tensor-core peak.
// Every [pairs, mult*D] tensor stays on chip, so the bytes stay at that
// minimum.  What costs time instead is on chip: each block holds one slab
// (at M = 120 one destination row of 120 pairs) and, with its t rows and
// weight stages, takes most of an SM's shared memory, so 8 warps hide the
// latency of every load and every bf16 rounding (a conversion issues at a
// fraction of the FMA rate) of its epilogues (PERF.md §5 splits a block).
//
// Design:
//  * one thread block per (graph, slab of TI destination rows) holds every
//    neighbour j of its rows, so the masked softmax over j is exact and no
//    block depends on another; about 64 pair rows a block (a 64-row tile),
//    one destination row when M > 64 (a 128-row tile);
//  * bf16 pair type: a first launch rounds W_re | W_rs to bf16 once, into a
//    workspace, in the orientation the mma.sync B fragments want, and a
//    second X, which the tensor blocks read rounded (fused_gata_tile.cuh);
//    the block keeps its slab's rounded t rows in shared memory and streams
//    the weights through a ring of three 64-deep stages of a 128-column
//    slice (16-byte cp.async), one stream over every slice it multiplies,
//    so the next slice's first stages load while this slice's epilogue
//    runs.  Each warp owns a 32 x 32 (64-row tile) or 64 x 32 (128-row
//    tile) piece of the slice, fragments by ldmatrix, float32 sums: the
//    cast points of the TPU kernel's bf16 matmul.  Float32 pair type:
//    32-column slices as float32 FMAs (product_tile_f32);
//  * each slice's product lands in a float32 shared tile, where the
//    epilogue forms the logit terms (W_re slices) or o (W_rs slices) in
//    place, four channels of a pair row a step (no division in the loop)
//    and two values a bf16 rounding; the per-head sums, the softmax (a warp
//    per (row, head), lanes over j) and the j-sums (a thread per (row, four
//    channels) and up to five SH components, the j range split into parts
//    when that leaves threads idle, the parts added in order) use the whole
//    block; a slice's dX stays in shared memory until its direction and
//    tensor blocks are added; every sum has one owner, no atomics, and a
//    rerun gives the same bits;
//  * the output columns split over NZ blocks per slab (blockIdx.z) while the
//    grid fits one wave of resident blocks, so small-M chunks fill more of
//    the card; each such block recomputes the attention (the W_re slices, a
//    sixth of the products at mult = 5).
// Padded atoms and ragged slabs are masked here: a destination row i >= M is
// skipped, an invalid pair (env < 0) gets softmax weight exactly 0 (the
// exponential is multiplied by the valid flag) and envelope 0, so it adds
// exact zeros.

#include "fused_gata_tile.cuh"

namespace {

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
  const __nv_bfloat16* wt;  // [D + C, D]: bf16 W_re | W_rs, transposed
  const __nv_bfloat16* xb;  // [G, M, L, D]: bf16 X (bf16 pair type)
  float* dh;           // [G, M, D]
  float* dx;           // [G, M, L, D]
  float* attn;         // [G, M, M, H] pre-scale softmax, or null
  int G, M, D, H, L, C, lmax, sep_dir, sep_tensor, scale_heads, TI;
  int NZ;  // column groups: block z takes the slices z, z+NZ, ... of D
  int jp_max;  // parts of j a j-sum may take (what `part` holds)
  // shared-memory carve-up, in bytes from the base (see smem_layout)
  int off_a, off_c, off_lg, off_ap, off_ev, off_vd, off_rl, off_red,
      off_part, off_dx, smem;
};

// product columns per slice and the row stride of the float32 tile
template <bool kBF> constexpr int kSlice = kBF ? kFN : kNT;
template <bool kBF> constexpr int kLdc = kBF ? kFN + 4 : kNT + 1;
// epilogue steps a thread (four channels each): a 128-row slice of 128
// columns
constexpr int kSteps = kFN / 4 * kMaxPairs / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;   // shared memory a block can use
constexpr int kMaxComp = 5;   // SH components a j-sum thread keeps at once

// rows of the shared t tile: 32 * MI for the tensor cores, else the slab's
// rows rounded up to 16
template <bool kBF, int MI>
__host__ __device__ int a_rows(int TB) {
  return kBF ? 32 * MI : round16(TB);
}

template <bool kBF, int MI, typename TT, typename NT>
__global__ void __launch_bounds__(kThreads, 1)
fused_gata_fwd_kernel(const Params p) {
  using AT = typename PairT<kBF>::type;
  constexpr int NS = kSlice<kBF>, LDC = kLdc<kBF>;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int g = blockIdx.y;
  const int i0 = blockIdx.x * p.TI;
  const int z = blockIdx.z;
  const int M = p.M, D = p.D, H = p.H, L = p.L, C = p.C;
  const int TB = p.TI * M;
  const int rows_a = a_rows<kBF, MI>(TB);
  const int lda = a_stride(D, kBF);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  void* Wbuf = base;                      // bf16: the ring; f32: one W stage
  AT* As = reinterpret_cast<AT*>(base + p.off_a);      // [rows_a][lda] t rows
  float* Cs = reinterpret_cast<float*>(base + p.off_c);   // [rows_a][LDC]
  float* lg = reinterpret_cast<float*>(base + p.off_lg);  // [TB][H] logits
  float* ap = reinterpret_cast<float*>(base + p.off_ap);  // [TB][H] rnd(attn)
  float* ev = reinterpret_cast<float*>(base + p.off_ev);  // [TB] rnd(env+)
  float* vd = reinterpret_cast<float*>(base + p.off_vd);  // [TB] valid flag
  float* rls = reinterpret_cast<float*>(base + p.off_rl); // [TB][L] rnd(rl)
  float* red = reinterpret_cast<float*>(base + p.off_red);    // [8][33]
  float* dxs = reinterpret_cast<float*>(base + p.off_dx);     // [TI][L][NS]
  float* part = reinterpret_cast<float*>(base + p.off_part);  // [jp][units][5][4]

  const TT* __restrict__ t = static_cast<const TT*>(p.t);
  const NT* __restrict__ q = static_cast<const NT*>(p.q);
  const NT* __restrict__ k = static_cast<const NT*>(p.k);
  const NT* __restrict__ xg = static_cast<const NT*>(p.xg);
  const NT* __restrict__ v = static_cast<const NT*>(p.v);
  // X as the tensor blocks read it: rnd(X), the bf16 copy for bf16 pairs
  const AT* __restrict__ X;
  if constexpr (kBF) {
    X = p.xb;
  } else {
    X = p.X;
  }
  const float* __restrict__ scale = p.scale;
  const size_t gM = (size_t)g * M;

  // The slices this block multiplies, in order: the W_re slices 0 .. nsl-1,
  // then for each owned D-slice ds = z, z + NZ, ... the W_rs columns of
  // ds in channel block b = 0 .. nb-1.  Column n of W_re | W_rs is row n
  // of wt; `width` is the slice's columns (D need not be a multiple of NS).
  const int nsl = (D + NS - 1) / NS, nb = C / D;
  const int nown = z < nsl ? (nsl - 1 - z) / p.NZ + 1 : 0;
  auto slice_col = [&](int s, int* width) {
    if (s < nsl) {
      *width = min(NS, D - s * NS);
      return s * NS;
    }
    const int ds = z + (s - nsl) / nb * p.NZ, b = (s - nsl) % nb;
    *width = min(NS, D - ds * NS);
    return D + b * D + ds * NS;
  };

  // bf16: the ring of weight tiles, one stream over every slice's kFK-deep
  // stages; tile u is stage u % nk of slice u / nk
  __nv_bfloat16* ring = static_cast<__nv_bfloat16*>(Wbuf);
  const int nk = (D + kFK - 1) / kFK;
  const int n_tiles = (nsl + nown * nb) * nk;
  auto load_tile = [&](int u) {
    int width;
    const int col = slice_col(u / nk, &width);
    stage_w_tile(ring + (u % kFStages) * kFN * kFLd, p.wt, D, col,
                 col + width, (u % nk) * kFK);
  };
  if constexpr (kBF) {
    for (int u = 0; u < kFStages - 1; ++u) {
      if (u < n_tiles) load_tile(u);
      cp_async_commit();
    }
  }

  // ---- stage 0: the slab's pair rows into shared memory ----------------
  // pair row `row` = (i0 + row / M, row % M), t's row (gM + i0) M + row:
  // the slab is consecutive in t; four values a step.  Rows past the slab
  // or of destinations i >= M (a ragged last slab) are zero.
  const TT* tslab = t + (gM + i0) * M * D;
  const int rows_in = min(TB, (M - i0) * M);
#pragma unroll 4
  for (int e = tid; e < rows_a * D / 4; e += kThreads) {
    const int row = e / (D / 4), c = 4 * (e % (D / 4));
    float4 val = {0.f, 0.f, 0.f, 0.f};
    if (row < rows_in) val = load4(tslab + (size_t)row * D + c);
    if constexpr (kBF) {
      store4_bf16(As + row * lda + c, val);
    } else {
      As[row * lda + c] = val.x;
      As[row * lda + c + 1] = val.y;
      As[row * lda + c + 2] = val.z;
      As[row * lda + c + 3] = val.w;
    }
  }
  for (int row = tid; row < TB; row += kThreads) {
    const int i = i0 + row / M, j = row % M;
    const float e = i < M ? p.env[(gM + i) * M + j] : -1.f;
    vd[row] = e >= 0.f ? 1.f : 0.f;
    ev[row] = rnd<kBF>(fmaxf(e, 0.f));
    for (int m = 0; m < L; ++m) {
      rls[row * L + m] = i < M ? rnd<kBF>(p.rl[((gM + i) * M + j) * L + m])
                               : 0.f;
    }
  }
  for (int e = tid; e < TB * H; e += kThreads) lg[e] = 0.f;
  __syncthreads();

  // Cs[0:rows_a][0:NS] = As @ (slice s of W_re | W_rs); ends synchronised
  int tile = 0;   // bf16: the next tile of the stream
  auto product = [&](int s) {
    if constexpr (kBF) {
      const int wm = warp / 4, wn = warp % 4;
      const int gq = lane / 4, tq = lane % 4;
      float acc[MI][4][4];
#pragma unroll
      for (int a = 0; a < MI; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;
        }
      }
      for (int kt = 0; kt < nk; ++kt, ++tile) {
        cp_async_wait<kFStages - 2>();
        __syncthreads();   // tile is in; every warp is done with tile - 1
        if (tile + kFStages - 1 < n_tiles) load_tile(tile + kFStages - 1);
        cp_async_commit();
        const __nv_bfloat16* Ws = ring + (tile % kFStages) * kFN * kFLd;
        const int k_hi = min(kFK, D - kt * kFK);   // a multiple of 16
        for (int kk = 0; kk < k_hi; kk += 16) {
          mma_16816_tile<MI, 4, false, false, true>(
              As + wm * 16 * MI * lda + kt * kFK + kk, lda,
              Ws + wn * 32 * kFLd + kk, kFLd, acc);
        }
      }
#pragma unroll
      for (int a = 0; a < MI; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            Cs[(wm * 16 * MI + 16 * a + gq + (r >= 2 ? 8 : 0)) * LDC + wn * 32 +
               8 * b + 2 * tq + (r & 1)] = acc[a][b][r];
          }
        }
      }
      __syncthreads();
    } else {
      int width;
      const int col = slice_col(s, &width);
      const bool rs = col >= D;
      product_tile_f32(As, lda, TB, rs ? p.wrs : p.wre, rs ? C : D,
                       rs ? col - D : col, D, static_cast<float*>(Wbuf), Cs);
    }
  };
  // The epilogues take four neighbouring channels of a pair row a step: a
  // thread keeps the channels 4 (tid % w4) .. + 3 and takes the rows
  // tid / w4 + u rstep, u < kSteps (no division in the loop: (i, j) moves on
  // by rstep rows a step).
  struct Walk {
    int c, row, il, j, rstep;
  };
  auto walk = [&](int w4) {
    Walk k{4 * (tid % w4), tid / w4, 0, 0, kThreads / w4};
    if (k.row >= k.rstep) k.row = TB;   // threads past rstep rows x w4 rest
    k.il = k.row / M;
    k.j = k.row - k.il * M;
    return k;
  };
  auto step = [&](Walk& k) {
    k.row += k.rstep;
    k.j += k.rstep;
    while (k.j >= M) {
      k.j -= M;
      ++k.il;
    }
  };

  // ---- stage 1: ta = silu(t W_re + b_re); per-head logits --------------
  const int Dh = D / H;
  for (int s = 0; s < nsl; ++s) {
    const int n0 = s * NS, w = min(NS, D - n0), w4 = w / 4;
    product(s);
    // each pair's logit terms q_i k_j ta, one per channel, in place of ta
    Walk wk = walk(w4);
#pragma unroll
    for (int u = 0; u < kSteps; ++u, step(wk)) {
      if (wk.row >= TB) break;
      const int c = wk.c;
      float* cs = Cs + wk.row * LDC + c;
      if (i0 + wk.il < M) {
        const float4 b4 = load4(p.bre + n0 + c);
        const float4 q4 = load4(q + (gM + i0 + wk.il) * D + n0 + c);
        const float4 k4 = load4(k + (gM + wk.j) * D + n0 + c);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        float qv[4] = {q4.x, q4.y, q4.z, q4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w};
        float ta[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float zz = cs[h] + bv[h];
          ta[h] = zz * (1.f / (1.f + expf(-zz)));
        }
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
          rnd2<kBF>(ta[h], ta[h + 1]);
          rnd2<kBF>(qv[h], qv[h + 1]);
          rnd2<kBF>(kv[h], kv[h + 1]);
          float t0 = ta[h] * qv[h], t1 = ta[h + 1] * qv[h + 1];
          rnd2<kBF>(t0, t1);
          t0 *= kv[h];
          t1 *= kv[h + 1];
          rnd2<kBF>(t0, t1);
          cs[h] = t0;
          cs[h + 1] = t1;
        }
      } else {
        cs[0] = cs[1] = cs[2] = cs[3] = 0.f;
      }
    }
    __syncthreads();
    // per-head sums over the slice's channels (a head may span slices)
    const int h_lo = n0 / Dh, nh = (n0 + w - 1) / Dh - h_lo + 1;
    for (int e = tid; e < TB * nh; e += kThreads) {
      const int row = e / nh, h = h_lo + e % nh;
      const int c_lo = max(h * Dh, n0), c_hi = min((h + 1) * Dh, n0 + w);
      float sum = 0.f;
      for (int c = c_lo; c < c_hi; ++c) sum += Cs[row * LDC + c - n0];
      lg[row * H + h] += sum;
    }
    __syncthreads();
  }

  // ---- stage 2: masked softmax over j, a warp per (i, head) -------------
  // lanes over j; the 32 lanes' maxima and sums meet in `red` and are read
  // back in lane order
  for (int it0 = 0; it0 < p.TI * H; it0 += kWarps) {
    const int it = it0 + warp, il = it / H, h = it % H, i = i0 + il;
    const bool on = it < p.TI * H && i < M;
    float mx = -INFINITY;
    if (on) {
      for (int j = lane; j < M; j += 32) {
        const int row = il * M + j;
        mx = fmaxf(mx, vd[row] > 0.f ? lg[row * H + h] : -1e30f);
      }
    }
    red[warp * 33 + lane] = mx;
    __syncthreads();
    mx = -INFINITY;
    for (int l = 0; l < 32; ++l) mx = fmaxf(mx, red[warp * 33 + l]);
    __syncthreads();
    float den = 0.f;
    if (on) {
      for (int j = lane; j < M; j += 32) {
        const int row = il * M + j;
        const float l = vd[row] > 0.f ? lg[row * H + h] : -1e30f;
        const float ex = expf(l - mx) * vd[row];
        lg[row * H + h] = ex;
        den += ex;
      }
    }
    red[warp * 33 + lane] = den;
    __syncthreads();
    den = 0.f;
    for (int l = 0; l < 32; ++l) den += red[warp * 33 + l];
    den += 1e-16f;
    if (on) {
      for (int j = lane; j < M; j += 32) {
        const int row = il * M + j;
        const size_t pair = (gM + i) * M + j;
        const float sm = lg[row * H + h] / den;
        if (p.attn != nullptr && z == 0) p.attn[pair * H + h] = sm;
        const float sc = p.scale_heads ? scale[pair * H + h] : scale[pair];
        ap[row * H + h] = rnd<kBF>(sm * sc);
      }
    }
    __syncthreads();   // `red` is reused by the next round
  }

  // ---- stage 3: channel blocks of o -> d_h, dX --------------------------
  const int e_per = C / H;
  const int n_dir = p.sep_dir ? p.lmax : 1;
  int s = nsl;
  for (int ds = z; ds < nsl; ds += p.NZ) {
    const int d0 = ds * NS, w = min(NS, D - d0), w4 = w / 4;
    for (int b = 0; b < nb; ++b, ++s) {
      int kind = 0, mlo = 0, mhi = 0;   // 0 scalar, 1 direction, 2 tensor
      if (b >= 1) {
        kind = b <= n_dir ? 1 : 2;
        const bool sep = kind == 1 ? p.sep_dir : p.sep_tensor;
        const int l = kind == 1 ? b : b - n_dir;   // degree, when separate
        mlo = sep ? l * l - 1 : 0;
        mhi = sep ? (l + 1) * (l + 1) - 1 : L;
      }
      const int col0 = b * D + d0;
      product(s);
      // o = rnd(rnd(rnd(tf x_g) env+) + rnd(attn v)), tf = rnd(t W_rs + b_rs),
      // in place of t W_rs
      // the head of channel col0 + c (a head may end inside a step)
      const int hd0 = (col0 + 4 * (tid % w4)) / e_per;
      const int hr0 = col0 + 4 * (tid % w4) - hd0 * e_per;
      Walk wk = walk(w4);
#pragma unroll
      for (int u = 0; u < kSteps; ++u, step(wk)) {
        if (wk.row >= TB) break;
        const int row = wk.row, c = wk.c;
        float* cs = Cs + row * LDC + c;
        if (i0 + wk.il < M) {
          const int cc = col0 + c;
          const float4 b4 = load4(p.brs + cc);
          const float4 x4 = load4(xg + (gM + wk.j) * C + cc);
          const float4 v4 = load4(v + (gM + wk.j) * C + cc);
          int hd[4];
#pragma unroll
          for (int h = 0, hh = hd0, hr = hr0; h < 4; ++h, ++hr) {
            if (hr >= e_per) {
              hr -= e_per;
              ++hh;
            }
            hd[h] = hh;
          }
          float tf[4] = {cs[0] + b4.x, cs[1] + b4.y, cs[2] + b4.z, cs[3] + b4.w};
          float xv[4] = {x4.x, x4.y, x4.z, x4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int h = 0; h < 4; h += 2) {
            rnd2<kBF>(tf[h], tf[h + 1]);
            rnd2<kBF>(xv[h], xv[h + 1]);
            rnd2<kBF>(vv[h], vv[h + 1]);
            float sp0 = tf[h] * xv[h], sp1 = tf[h + 1] * xv[h + 1];
            rnd2<kBF>(sp0, sp1);
            sp0 *= ev[row];
            sp1 *= ev[row];
            rnd2<kBF>(sp0, sp1);
            float se0 = ap[row * H + hd[h]] * vv[h];
            float se1 = ap[row * H + hd[h + 1]] * vv[h + 1];
            rnd2<kBF>(se0, se1);
            float o0 = sp0 + se0, o1 = sp1 + se1;
            rnd2<kBF>(o0, o1);
            cs[h] = o0;
            cs[h + 1] = o1;
          }
        } else {
          cs[0] = cs[1] = cs[2] = cs[3] = 0.f;
        }
      }
      __syncthreads();
      // j-sums: a thread per (i, four channels) and up to kMaxComp
      // components, over one of JP parts of j; with JP > 1 the parts meet
      // in `part` and are added in order.
      const int units = p.TI * w4;
      const int JP = units < kThreads ? min(kThreads / units, p.jp_max) : 1;
      const int nm = kind == 0 ? 1 : mhi - mlo;
      // d_h straight to device memory; dX into the slice's shared tile
      // (the direction blocks write it, the tensor blocks add to it)
      auto put = [&](int il, int c, int mm, int ma, const float* sum) {
        for (int u = 0; u < 4; ++u) {
          if (kind == 0) {
            p.dh[(gM + i0 + il) * D + d0 + c + u] = sum[u];
          } else {
            float* o = dxs + (il * L + ma + mm) * NS + c + u;
            *o = kind == 1 ? sum[u] : *o + sum[u];
          }
        }
      };
      for (int m0 = 0; m0 < nm; m0 += kMaxComp) {
        const int mn = min(kMaxComp, nm - m0);
        const int ma = mlo + m0;   // first component of this chunk
        for (int e = tid; e < units * JP; e += kThreads) {
          const int pt = e / units, unit = e % units;
          const int il = unit / w4, c = 4 * (unit % w4);
          const int i = i0 + il, d = d0 + c;
          float sums[kMaxComp][4];
#pragma unroll
          for (int mm = 0; mm < kMaxComp; ++mm) {
            sums[mm][0] = sums[mm][1] = sums[mm][2] = sums[mm][3] = 0.f;
          }
          if (i < M) {
            const float* oc = Cs + il * M * LDC + c;
#pragma unroll 4
            for (int j = pt * M / JP; j < (pt + 1) * M / JP; ++j) {
              const float o[4] = {oc[j * LDC], oc[j * LDC + 1],
                                  oc[j * LDC + 2], oc[j * LDC + 3]};
              if (kind == 0) {
#pragma unroll
                for (int u = 0; u < 4; ++u) sums[0][u] += o[u];
              } else if (kind == 1) {
                const float* r = rls + (il * M + j) * L + ma;
#pragma unroll
                for (int mm = 0; mm < kMaxComp; ++mm) {
                  if (mm < mn) {
#pragma unroll
                    for (int u = 0; u < 4; ++u) sums[mm][u] += r[mm] * o[u];
                  }
                }
              } else {
                float4 x4[kMaxComp];
#pragma unroll
                for (int mm = 0; mm < kMaxComp; ++mm) {
                  x4[mm] = mm < mn ? load4(X + ((gM + j) * L + ma + mm) * D + d)
                                   : float4{0.f, 0.f, 0.f, 0.f};
                }
#pragma unroll
                for (int mm = 0; mm < kMaxComp; ++mm) {
                  // rnd(o rnd(X)), X already rounded, two products a rounding
                  float p0 = o[0] * x4[mm].x, p1 = o[1] * x4[mm].y;
                  float p2 = o[2] * x4[mm].z, p3 = o[3] * x4[mm].w;
                  rnd2<kBF>(p0, p1);
                  rnd2<kBF>(p2, p3);
                  if (mm < mn) {
                    sums[mm][0] += p0;
                    sums[mm][1] += p1;
                    sums[mm][2] += p2;
                    sums[mm][3] += p3;
                  }
                }
              }
            }
          }
          if (JP == 1) {
            if (i >= M) continue;
            for (int mm = 0; mm < mn; ++mm) put(il, c, mm, ma, sums[mm]);
          } else {
            float* pp = part + (pt * units + unit) * kMaxComp * 4;
#pragma unroll
            for (int mm = 0; mm < kMaxComp; ++mm) {
#pragma unroll
              for (int u = 0; u < 4; ++u) pp[mm * 4 + u] = sums[mm][u];
            }
          }
        }
        if (JP > 1) {
          __syncthreads();
          for (int e = tid; e < units * mn; e += kThreads) {
            const int unit = e / mn, mm = e % mn;
            const int il = unit / w4, c = 4 * (unit % w4);
            if (i0 + il >= M) continue;
            float sum[4] = {0.f, 0.f, 0.f, 0.f};
            for (int pt = 0; pt < JP; ++pt) {
              const float* pp = part + ((pt * units + unit) * kMaxComp + mm) * 4;
              for (int u = 0; u < 4; ++u) sum[u] += pp[u];
            }
            put(il, c, mm, ma, sum);
          }
        }
        __syncthreads();   // `part` and Cs are reused next
      }
    }
    // the slice's dX, every direction and tensor block added
    for (int e = tid; e < p.TI * L * w; e += kThreads) {
      const int c = e % w, m = e / w % L, il = e / w / L;
      if (i0 + il < M) {
        p.dx[((gM + i0 + il) * L + m) * D + d0 + c] = dxs[(il * L + m) * NS + c];
      }
    }
    __syncthreads();   // dxs is written again by the next slice
  }
  if constexpr (kBF) cp_async_wait<0>();
}

// byte offsets of the shared arrays; returns the total
template <bool kBF, int MI>
size_t smem_layout(Params& p) {
  const size_t TB = (size_t)p.TI * p.M, rows = a_rows<kBF, MI>((int)TB);
  auto up16 = [](size_t x) { return (x + 15) / 16 * 16; };
  const size_t w = kBF ? (size_t)kFStages * kFN * kFLd * 2
                       : (size_t)kKT * kNT * sizeof(float);
  size_t off = up16(w);
  p.off_a = (int)off;
  off = up16(off + rows * a_stride(p.D, kBF) * (kBF ? 2 : sizeof(float)));
  p.off_c = (int)off;
  off += rows * kLdc<kBF> * sizeof(float);
  p.off_lg = (int)off;
  off += TB * p.H * sizeof(float);
  p.off_ap = (int)off;
  off += TB * p.H * sizeof(float);
  p.off_ev = (int)off;
  off += TB * sizeof(float);
  p.off_vd = (int)off;
  off += TB * sizeof(float);
  p.off_rl = (int)off;
  off += TB * p.L * sizeof(float);
  p.off_red = (int)off;
  off += (size_t)kWarps * 33 * sizeof(float);
  // dX's tile, then the j-sums' partials: as many parts of j as fit
  p.off_dx = (int)off;
  off += (size_t)p.TI * p.L * kSlice<kBF> * sizeof(float);
  p.off_part = (int)off;
  const size_t units = (size_t)p.TI * kSlice<kBF> / 4;
  const size_t per_part = units * kMaxComp * 4 * sizeof(float);
  const size_t room = off < kMaxSmem ? (kMaxSmem - off) / per_part : 0;
  p.jp_max = (int)min((size_t)max(kThreads / (int)units, 1), room);
  off += (size_t)max(p.jp_max, 1) * per_part;
  p.smem = (int)off;
  return off;
}

// Column groups per slab: the output columns split over NZ blocks while the
// grid still fits one wave of resident blocks.  Each block recomputes the
// attention (the W_re product, a sixth of the work at mult = 5) and owns its
// columns of d_h and dX, so the blocks share nothing.
template <typename K>
int column_groups(const Params& p, K kern, int n_slices) {
  int dev = 0, n_sm = 1, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                p.smem);
  const int slots = n_sm * max(per_sm, 1);
  const int slabs = p.G * ((p.M + p.TI - 1) / p.TI);
  int nz = 1;
  while (n_slices % (2 * nz) == 0 && slabs * 2 * nz <= slots) nz *= 2;
  return nz;
}

// every launch of this file goes through here
template <typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream) {
  kern<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <bool kBF, int MI, typename TT, typename NT>
cudaError_t launch(Params p, cudaStream_t stream) {
  if (smem_layout<kBF, MI>(p) > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = fused_gata_fwd_kernel<kBF, MI, TT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  p.NZ = column_groups(p, kern, (p.D + kSlice<kBF> - 1) / kSlice<kBF>);
  const dim3 grid((p.M + p.TI - 1) / p.TI, p.G, p.NZ);
  return run(kern, grid, p.smem, p, stream);
}

template <bool kBF, int MI>
cudaError_t dispatch_storage(const Params& p, int t_bf16, int node_bf16,
                             cudaStream_t s) {
  using BF = __nv_bfloat16;
  if (t_bf16) {
    return node_bf16 ? launch<kBF, MI, BF, BF>(p, s)
                     : launch<kBF, MI, BF, float>(p, s);
  }
  return node_bf16 ? launch<kBF, MI, float, BF>(p, s)
                   : launch<kBF, MI, float, float>(p, s);
}

int channels(int D, int lmax, int sep_dir, int sep_tensor) {
  return D * (1 + (sep_dir ? lmax : 1) + (sep_tensor ? lmax : 1));
}

}  // namespace

// Workspace bytes the forward needs for these shapes: the bf16 weights and
// the bf16 X.
extern "C" long long gotennet_fused_gata_fwd_workspace(int G, int M, int D,
                                                       int H, int lmax,
                                                       int sep_dir,
                                                       int sep_tensor) {
  (void)H;
  const long long L = (lmax + 1) * (lmax + 1) - 1;
  return ((long long)(D + channels(D, lmax, sep_dir, sep_tensor)) * D +
          (long long)G * M * L * D) * 2;
}

// Launches on `stream` and allocates nothing (`work` holds at least
// gotennet_fused_gata_fwd_workspace bytes, 16-byte aligned); returns the
// first CUDA error.
extern "C" int gotennet_fused_gata_fwd(
    const void* t, const void* q, const void* k, const void* xg,
    const void* v, const float* rl, const float* X, const float* env,
    const float* scale, const float* wre, const float* bre, const float* wrs,
    const float* brs, float* dh, float* dx, float* attn, void* work, int G,
    int M, int D, int H, int lmax, int sep_dir, int sep_tensor,
    int scale_heads, int pair_bf16, int t_bf16, int node_bf16,
    void* stream) {
  Params p{};
  p.t = t; p.q = q; p.k = k; p.xg = xg; p.v = v;
  p.rl = rl; p.X = X; p.env = env; p.scale = scale;
  p.wre = wre; p.bre = bre; p.wrs = wrs; p.brs = brs;
  p.wt = static_cast<const __nv_bfloat16*>(work);
  p.dh = dh; p.dx = dx; p.attn = attn;
  p.G = G; p.M = M; p.D = D; p.H = H; p.lmax = lmax;
  p.L = (lmax + 1) * (lmax + 1) - 1;
  p.C = channels(D, lmax, sep_dir, sep_tensor);
  p.sep_dir = sep_dir; p.sep_tensor = sep_tensor; p.scale_heads = scale_heads;
  // about 64 pair rows per block; one destination row when M > 64
  p.TI = M >= 64 ? 1 : 64 / M;
  if (G <= 0 || M <= 0) return (int)cudaSuccess;
  if ((size_t)p.TI * M > (size_t)kMaxPairs || D % kNT || D % kKT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pair_bf16) return (int)dispatch_storage<false, 4>(p, t_bf16, node_bf16, s);
  __nv_bfloat16* wt = static_cast<__nv_bfloat16*>(work);
  const WPrep w{wre, wrs, wt, D, p.C};
  cudaError_t err = run(weights_bf16_kernel,
                        dim3((unsigned)(D + p.C + 31) / 32, (unsigned)(D + 31) / 32),
                        32 * 33 * sizeof(float), w, s);
  if (err != cudaSuccess) return (int)err;
  const RoundBF16 xr{X, wt + (size_t)(D + p.C) * D, (long long)G * M * p.L * D};
  p.xb = xr.y;
  err = run(round_bf16_kernel,
            dim3((unsigned)((xr.n / 4 + kThreads - 1) / kThreads)), 0, xr, s);
  if (err != cudaSuccess) return (int)err;
  err = p.TI * M <= 64 ? dispatch_storage<true, 2>(p, t_bf16, node_bf16, s)
                       : dispatch_storage<true, 4>(p, t_bf16, node_bf16, s);
  return (int)err;
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
