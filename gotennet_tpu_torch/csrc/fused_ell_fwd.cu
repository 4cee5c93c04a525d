// Fused GATA message + aggregation on the ELL layout, forward, for sm_90a.
//
// Replaces the TPU kernel `_ell_kernel` of gotennet_tpu/ops/pallas/fused_ell.py
// (launched by `_pallas_ell_forward`).  The math and the cast points are
// written out in gotennet_tpu_torch/ops/fused_ell.py, beside the plain
// PyTorch version this kernel is held against.
//
// What bounds it on an H100: the bytes, by a little.  One 600-700-atom frame
// (N = 704 rows, K = 36 slots, D = 256, mult = 5) reads t in float32 (26 MB)
// and the node tables, rl and the weights, and writes d_h and dX: about
// 50 MB, 0.015 ms at 3.35 TB/s.  The two pair projections t @ W_re and
// t @ W_rs, 2 * D * (D + mult*D) FLOP per valid slot, take about 0.011 ms
// at the bf16 tensor-core peak.  Every [slots, mult*D] tensor stays on chip,
// as the TPU kernel keeps them in VMEM, so the bytes stay at that minimum.
// What costs time instead is on chip: a block holds its rows' slots, their
// rounded t rows, a float32 product tile and the weight ring in most of an
// SM's shared memory, so its warps have to hide the latency of every
// gathered load and every bf16 rounding of its epilogues.
//
// Design:
//  * the TPU kernel selects neighbour rows with one-hot matmuls, a TPU
//    workaround for row gathers; here each slot reads its source row of
//    k, x_g, v and X straight from device memory by index (the tables, a
//    few MB at N = 704, stay in the 50 MB L2).  An index outside [0, N) is
//    clamped so no read leaves a table; callers pass indices in range;
//  * bf16 pair type: a first launch rounds W_re | W_rs to bf16 once, into a
//    workspace, in the orientation mma.sync's B fragments want
//    (fused_gata_tile.cuh), and one launch a table the node tables every
//    slot reads rounded (q, k, x_g, v when they are float32; X always), so
//    a gather is one 8-byte load of values that are already the rounded
//    ones;
//  * one thread block of 512 threads (16 warps, one block an SM) per TI
//    whole destination rows (TI * K <= 128 slots), so the masked softmax over
//    the K slots is exact and no block depends on another; at K = 36 three
//    rows a block, 235 blocks for a frame;
//  * a padded slot (env < 0) adds exact zeros to every sum (softmax weight 0,
//    envelope 0), so a block compacts its valid slots first and multiplies,
//    forms and sums only those (the frames' slots are about half padded);
//    its softmax output is written as the zero it is;
//  * the block keeps its valid slots' rounded t rows in shared memory and
//    streams the weights through a ring of three 64-deep stages of a
//    128-column slice (16-byte cp.async), one stream over every slice it
//    multiplies, so the next slice's first stages load while this slice's
//    epilogue runs.  Each warp owns a 32 x 32 piece of the slice (a warp
//    whose rows are all past the valid slots skips its products), fragments
//    by ldmatrix, float32 sums: the cast points of the TPU kernel's bf16
//    matmul.  Float32 pair type: 32-column slices as float32 FMAs
//    (product_tile_f32);
//  * each slice's product lands in a float32 shared tile, where the
//    epilogue forms the logit terms (W_re slices) or o (W_rs slices) in
//    place, four channels of a slot a step (no division in the loop) and two
//    values a bf16 rounding; the per-head sums (a thread per (slot, head),
//    channels in order), the softmax (a warp per (row, head), lanes over the
//    slots, the denominator in slot order) and the slot sums (a thread per
//    (row, four channels, SH component), slots in order) use the whole
//    block; the rows' dX for a 128-column slice stays in shared memory until
//    its direction and tensor blocks are added; every sum has one owner, no
//    atomics, and a rerun gives the same bits.
// The sums skip only exact zeros, so the results are those of a kernel that
// visits every slot (for finite inputs).

#include "fused_gata_tile.cuh"

namespace {

constexpr int kEThreads = 512;               // threads of the message kernel
constexpr int kEWarps = kEThreads / 32;
constexpr size_t kMaxSmem = 232448;          // shared memory a block can use
// the bf16 product: 4 column groups of 32 columns, kEWarps / 4 row groups
constexpr int kWN = 4;
constexpr int kWRows = kMaxPairs / (kEWarps / kWN);   // rows a warp owns
constexpr int kWMI = kWRows / 16;

struct Params {
  const void* t;       // [NR, K, D]    float or bf16
  const void* q;       // [NR, D]       node type (bf16 pairs: bf16)
  const void* k;       // [N, D]
  const void* xg;      // [N, C]
  const void* v;       // [N, C]
  const void* X;       // [N, L, D]     float (bf16 pairs: the bf16 copy)
  const float* rl;     // [NR, K, L]
  const float* env;    // [NR, K]
  const float* scale;  // [NR, K] or [NR, K, H]
  const int* nbr;      // [NR, K]  source rows
  const float* wre;    // [D, D]   (in, out)
  const float* bre;    // [D]
  const float* wrs;    // [D, C]   (in, out)
  const float* brs;    // [C]
  const __nv_bfloat16* wt;  // [D + C, D]: bf16 W_re | W_rs, transposed
  float* dh;           // [NR, D]
  float* dx;           // [NR, L, D]
  float* attn;         // [NR, K, H] pre-scale softmax, or null
  int NR, N, K, D, H, L, C, lmax, sep_dir, sep_tensor, scale_heads, TI;
  // shared-memory carve-up, in bytes from the base (see smem_layout)
  int off_a, off_c, off_lg, off_ap, off_ev, off_rl, off_nb, off_sl, off_ci,
      off_vf, off_rk, off_rs, off_red, off_dx, smem;
};

// product columns per slice and the row stride of the float32 tile
template <bool kBF> constexpr int kSlice = kBF ? kFN : kNT;
template <bool kBF> constexpr int kLdc = kBF ? kFN + 4 : kNT + 1;

// four neighbouring values of a row of the float32 tile: one 16-byte shared
// access when the rows are 16-byte aligned (the bf16 pair type's tile)
template <int LDC>
__device__ __forceinline__ float4 tile_load4(const float* p) {
  if constexpr (LDC % 4 == 0) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return float4{p[0], p[1], p[2], p[3]};
  }
}

template <int LDC>
__device__ __forceinline__ void tile_store4(float* p, float a, float b, float c,
                                            float d) {
  if constexpr (LDC % 4 == 0) {
    *reinterpret_cast<float4*>(p) = float4{a, b, c, d};
  } else {
    p[0] = a;
    p[1] = b;
    p[2] = c;
    p[3] = d;
  }
}

// rows of the shared t tile a block may use: whole warp row groups for the
// tensor cores, else the slots rounded up to 16
template <bool kBF>
__host__ __device__ int a_rows(int TB) {
  return kBF ? (TB + kWRows - 1) / kWRows * kWRows : round16(TB);
}

// The kernel.  GT is the type of the gathered tables q, k, x_g, v (bf16 for
// a bf16 pair type: the rounded copies or the bf16 inputs), AT that of X
// (the bf16 copy for a bf16 pair type).
template <bool kBF, typename TT, typename GT>
__global__ void __launch_bounds__(kEThreads, 1)
fused_ell_fwd_kernel(const Params p) {
  using AT = typename PairT<kBF>::type;
  constexpr int NS = kSlice<kBF>, LDC = kLdc<kBF>;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int r0 = blockIdx.x * p.TI;
  const int K = p.K, D = p.D, H = p.H, L = p.L, C = p.C;
  const int TI = min(p.TI, p.NR - r0);   // the last block may hold fewer
  const int TB = TI * K;
  const int lda = a_stride(D, kBF);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long pr0 = (long long)r0 * K;   // the block's first slot

  void* Wbuf = base;                      // bf16: the ring; f32: one W stage
  AT* As = reinterpret_cast<AT*>(base + p.off_a);        // [rows][lda] t
  float* Cs = reinterpret_cast<float*>(base + p.off_c);  // [rows][LDC]
  // per valid slot, in the block's slot order
  float* lg = reinterpret_cast<float*>(base + p.off_lg);  // [TB][H] logits
  float* ap = reinterpret_cast<float*>(base + p.off_ap);  // [TB][H] rnd(attn)
  float* ev = reinterpret_cast<float*>(base + p.off_ev);  // [TB] rnd(env)
  float* rls = reinterpret_cast<float*>(base + p.off_rl); // [TB][L] rnd(rl)
  int* nb = reinterpret_cast<int*>(base + p.off_nb);      // [TB] source row
  int* sl = reinterpret_cast<int*>(base + p.off_sl);      // [TB] block slot
  int* ci = reinterpret_cast<int*>(base + p.off_ci);      // [TB] its row
  // per block slot: valid flag, rank among its row's valid slots
  int* vf = reinterpret_cast<int*>(base + p.off_vf);      // [TB]
  int* rk = reinterpret_cast<int*>(base + p.off_rk);      // [TB]
  int* rs = reinterpret_cast<int*>(base + p.off_rs);      // [TI + 1] starts
  float* red = reinterpret_cast<float*>(base + p.off_red);  // [warps][33]
  float* dxs = reinterpret_cast<float*>(base + p.off_dx);   // [TI][L][NS]

  const TT* __restrict__ t = static_cast<const TT*>(p.t);
  const GT* __restrict__ q = static_cast<const GT*>(p.q);
  const GT* __restrict__ k = static_cast<const GT*>(p.k);
  const GT* __restrict__ xg = static_cast<const GT*>(p.xg);
  const GT* __restrict__ v = static_cast<const GT*>(p.v);
  const AT* __restrict__ X = static_cast<const AT*>(p.X);

  // The slices this block multiplies, in order: the W_re slices 0 .. nsl-1,
  // then for each D-slice ds the W_rs columns of ds in channel block
  // b = 0 .. nbk-1.  Column n of W_re | W_rs is row n of wt.
  const int nsl = (D + NS - 1) / NS, nbk = C / D;
  auto slice_col = [&](int s, int* width) {
    if (s < nsl) {
      *width = min(NS, D - s * NS);
      return s * NS;
    }
    const int ds = (s - nsl) / nbk, b = (s - nsl) % nbk;
    *width = min(NS, D - ds * NS);
    return D + b * D + ds * NS;
  };
  // bf16: the ring of weight tiles, one stream over every slice's kFK-deep
  // stages; tile u is stage u % nk of slice u / nk
  __nv_bfloat16* ring = static_cast<__nv_bfloat16*>(Wbuf);
  const int nk = (D + kFK - 1) / kFK;
  const int n_tiles = nsl * (1 + nbk) * nk;
  auto load_tile = [&](int u) {
    int width;
    const int col = slice_col(u / nk, &width);
    stage_w_tile<kEThreads>(ring + (u % kFStages) * kFN * kFLd, p.wt, D, col,
                            col + width, (u % nk) * kFK);
  };
  if constexpr (kBF) {
    for (int u = 0; u < kFStages - 1; ++u) {
      if (u < n_tiles) load_tile(u);
      cp_async_commit();
    }
  }

  // ---- stage 0: compact the valid slots; their t rows ------------------
  // valid slot e of row il = e / K goes to row rs[il] + rk[e] of the tile
  for (int e = tid; e < TB; e += kEThreads) vf[e] = p.env[pr0 + e] >= 0.f;
  __syncthreads();
  for (int e = tid; e < TB; e += kEThreads) {
    const int s0 = e / K * K;
    int rank = 0;
    for (int u = s0; u < e; ++u) rank += vf[u];
    rk[e] = rank;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int il = 0; il < TI; ++il) {
      rs[il] = n;
      n += rk[il * K + K - 1] + vf[il * K + K - 1];
    }
    rs[TI] = n;
  }
  __syncthreads();
  const int nv = rs[TI];   // valid slots of the block
  for (int e = tid; e < TB; e += kEThreads) {
    const long long pair = pr0 + e;
    if (vf[e]) {
      const int il = e / K, row = rs[il] + rk[e];
      sl[row] = e;
      ci[row] = il;
      nb[row] = min(max(p.nbr[pair], 0), p.N - 1);
      ev[row] = rnd<kBF>(fmaxf(p.env[pair], 0.f));
      for (int m = 0; m < L; ++m) rls[row * L + m] = rnd<kBF>(p.rl[pair * L + m]);
      for (int h = 0; h < H; ++h) lg[row * H + h] = 0.f;
    } else if (p.attn != nullptr) {
      for (int h = 0; h < H; ++h) p.attn[pair * H + h] = 0.f;
    }
  }
  __syncthreads();
  // the valid slots' t rows, rounded, four values a step; the rows up to
  // the last row group a warp multiplies are zero
  const int nv_rows = kBF ? a_rows<true>(nv) : nv;
#pragma unroll 4
  for (int e = tid; e < nv_rows * D / 4; e += kEThreads) {
    const int row = e / (D / 4), c = 4 * (e % (D / 4));
    float4 val = {0.f, 0.f, 0.f, 0.f};
    if (row < nv) val = load4(t + (pr0 + sl[row]) * D + c);
    if constexpr (kBF) {
      store4_bf16(As + row * lda + c, val);
    } else {
      As[row * lda + c] = val.x;
      As[row * lda + c + 1] = val.y;
      As[row * lda + c + 2] = val.z;
      As[row * lda + c + 3] = val.w;
    }
  }
  __syncthreads();

  // Cs[0:nv][0:NS] = As @ (slice s of W_re | W_rs); ends synchronised
  int tile = 0;   // bf16: the next tile of the stream
  auto product = [&](int s) {
    if constexpr (kBF) {
      const int wm = warp / kWN, wn = warp % kWN;
      const bool active = wm * kWRows < nv;
      const int gq = lane / 4, tq = lane % 4;
      float acc[kWMI][4][4];
#pragma unroll
      for (int a = 0; a < kWMI; ++a) {
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
        if (!active) continue;
        const __nv_bfloat16* Ws = ring + (tile % kFStages) * kFN * kFLd;
        const int k_hi = min(kFK, D - kt * kFK);   // a multiple of 16
        for (int kk = 0; kk < k_hi; kk += 16) {
          mma_16816_tile<kWMI, 4, false, false, true>(
              As + wm * kWRows * lda + kt * kFK + kk, lda,
              Ws + wn * 32 * kFLd + kk, kFLd, acc);
        }
      }
      if (active) {
#pragma unroll
        for (int a = 0; a < kWMI; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              Cs[(wm * kWRows + 16 * a + gq + (r >= 2 ? 8 : 0)) * LDC +
                 wn * 32 + 8 * b + 2 * tq + (r & 1)] = acc[a][b][r];
            }
          }
        }
      }
      __syncthreads();
    } else {
      int width;
      const int col = slice_col(s, &width);
      const bool rw = col >= D;
      product_tile_f32<kEThreads>(As, lda, nv, rw ? p.wrs : p.wre,
                                  rw ? C : D, rw ? col - D : col, D,
                                  static_cast<float*>(Wbuf), Cs);
    }
  };

  // ---- stage 1: ta = silu(t W_re + b_re); per-head logits --------------
  // The epilogues take four neighbouring channels of a slot a step: a
  // thread keeps the channels 4 (tid % w4) .. + 3 and takes the slots
  // tid / w4 + u (kEThreads / w4).
  const int Dh = D / H;
  for (int s = 0; s < nsl; ++s) {
    const int n0 = s * NS, w = min(NS, D - n0), w4 = w / 4;
    product(s);
    // each slot's logit terms q_r k_j ta, one per channel, in place of ta
    const int c = 4 * (tid % w4), rstep = kEThreads / w4;
    const int row0 = tid < rstep * w4 ? tid / w4 : nv;
    const float4 b4 = load4(p.bre + n0 + c);
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll 2
    for (int row = row0; row < nv; row += rstep) {
      float* cs = Cs + row * LDC + c;
      const float4 q4 = load4(q + (size_t)(r0 + ci[row]) * D + n0 + c);
      const float4 k4 = load4(k + (size_t)nb[row] * D + n0 + c);
      // bf16 pairs: the tables hold rounded values already
      float qv[4] = {q4.x, q4.y, q4.z, q4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w};
      const float4 z4 = tile_load4<LDC>(cs);
      const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
      float ta[4], lt[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float zz = zv[h] + bv[h];
        ta[h] = zz * (1.f / (1.f + expf(-zz)));
      }
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        rnd2<kBF>(ta[h], ta[h + 1]);
        float t0 = ta[h] * qv[h], t1 = ta[h + 1] * qv[h + 1];
        rnd2<kBF>(t0, t1);
        t0 *= kv[h];
        t1 *= kv[h + 1];
        rnd2<kBF>(t0, t1);
        lt[h] = t0;
        lt[h + 1] = t1;
      }
      tile_store4<LDC>(cs, lt[0], lt[1], lt[2], lt[3]);
    }
    __syncthreads();
    // per-head sums over the slice's channels (a head may span slices)
    const int h_lo = n0 / Dh, nh = (n0 + w - 1) / Dh - h_lo + 1;
    for (int e = tid; e < nv * nh; e += kEThreads) {
      const int row = e / nh, h = h_lo + e % nh;
      const int c_lo = max(h * Dh, n0), c_hi = min((h + 1) * Dh, n0 + w);
      float sum = 0.f;
      for (int cc = c_lo; cc < c_hi; ++cc) sum += Cs[row * LDC + cc - n0];
      lg[row * H + h] += sum;
    }
    __syncthreads();
  }

  // ---- stage 2: masked softmax over the slots, a warp per (row, head) ---
  // lanes over the row's valid slots; the maximum meets in `red`, and one
  // lane adds the exponentials in slot order
  for (int it0 = 0; it0 < TI * H; it0 += kEWarps) {
    const int it = it0 + warp, il = it / H, h = it % H;
    const bool on = it < TI * H;
    const int a = on ? rs[il] : 0, b = on ? rs[il + 1] : 0;
    float mx = -INFINITY;
    for (int row = a + lane; row < b; row += 32) mx = fmaxf(mx, lg[row * H + h]);
    red[warp * 33 + lane] = mx;
    __syncthreads();
    mx = -INFINITY;
    for (int l = 0; l < 32; ++l) mx = fmaxf(mx, red[warp * 33 + l]);
    for (int row = a + lane; row < b; row += 32) {
      lg[row * H + h] = expf(lg[row * H + h] - mx);
    }
    __syncthreads();
    if (lane == 0) {
      float den = 0.f;
      for (int row = a; row < b; ++row) den += lg[row * H + h];
      red[warp * 33 + 32] = den + 1e-16f;
    }
    __syncthreads();
    const float den = red[warp * 33 + 32];
    for (int row = a + lane; row < b; row += 32) {
      const long long pair = pr0 + sl[row];
      const float sm = lg[row * H + h] / den;
      if (p.attn != nullptr) p.attn[pair * H + h] = sm;
      const float sc = p.scale_heads ? p.scale[pair * H + h] : p.scale[pair];
      ap[row * H + h] = rnd<kBF>(sm * sc);
    }
    __syncthreads();   // `red` is reused by the next round
  }

  // ---- stage 3: channel blocks of o -> d_h, dX --------------------------
  const int e_per = C / H;
  const int n_dir = p.sep_dir ? p.lmax : 1;
  int s = nsl;
  for (int ds = 0; ds < nsl; ++ds) {
    const int d0 = ds * NS, w = min(NS, D - d0), w4 = w / 4;
    for (int b = 0; b < nbk; ++b, ++s) {
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
      // in place of t W_rs; the head of channel col0 + c (a head may end
      // inside a step)
      const int c = 4 * (tid % w4), rstep = kEThreads / w4;
      const int row0 = tid < rstep * w4 ? tid / w4 : nv;
      const int hd0 = (col0 + c) / e_per, hr0 = col0 + c - hd0 * e_per;
      int hd[4];
#pragma unroll
      for (int h = 0, hh = hd0, hr = hr0; h < 4; ++h, ++hr) {
        if (hr >= e_per) {
          hr -= e_per;
          ++hh;
        }
        hd[h] = hh;
      }
      const float4 b4 = load4(p.brs + col0 + c);
#pragma unroll 2
      for (int row = row0; row < nv; row += rstep) {
        float* cs = Cs + row * LDC + c;
        const size_t j = (size_t)nb[row];
        const float4 x4 = load4(xg + j * C + col0 + c);
        const float4 v4 = load4(v + j * C + col0 + c);
        const float e = ev[row];
        const float4 p4 = tile_load4<LDC>(cs);
        float tf[4] = {p4.x + b4.x, p4.y + b4.y, p4.z + b4.z, p4.w + b4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int h = 0; h < 4; h += 2) {
          rnd2<kBF>(tf[h], tf[h + 1]);
          float sp0 = tf[h] * xv[h], sp1 = tf[h + 1] * xv[h + 1];
          rnd2<kBF>(sp0, sp1);
          sp0 *= e;
          sp1 *= e;
          rnd2<kBF>(sp0, sp1);
          float se0 = ap[row * H + hd[h]] * vv[h];
          float se1 = ap[row * H + hd[h + 1]] * vv[h + 1];
          rnd2<kBF>(se0, se1);
          float o0 = sp0 + se0, o1 = sp1 + se1;
          rnd2<kBF>(o0, o1);
          tf[h] = o0;
          tf[h + 1] = o1;
        }
        tile_store4<LDC>(cs, tf[0], tf[1], tf[2], tf[3]);   // o in place of tf
      }
      __syncthreads();
      // slot sums: a thread per (row, four channels, SH component), the
      // row's valid slots in order; d_h straight to device memory, dX into
      // the slice's shared tile (the direction blocks write it, the tensor
      // blocks add to it)
      const int units = TI * w4, nm = kind == 0 ? 1 : mhi - mlo;
      for (int e = tid; e < units * nm; e += kEThreads) {
        const int unit = e % units, m = mlo + e / units;
        const int il = unit / w4, cc = 4 * (unit % w4);
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int row = rs[il]; row < rs[il + 1]; ++row) {
          const float4 o4 = tile_load4<LDC>(Cs + row * LDC + cc);
          float o[4] = {o4.x, o4.y, o4.z, o4.w};
          if (kind == 1) {
            const float r = rls[row * L + m];
#pragma unroll
            for (int u = 0; u < 4; ++u) o[u] *= r;
            rnd2<kBF>(o[0], o[1]);
            rnd2<kBF>(o[2], o[3]);
          } else if (kind == 2) {
            // rnd(o rnd(X)), X already rounded
            const float4 x4 = load4(X + ((size_t)nb[row] * L + m) * D + d0 + cc);
            o[0] *= x4.x;
            o[1] *= x4.y;
            o[2] *= x4.z;
            o[3] *= x4.w;
            rnd2<kBF>(o[0], o[1]);
            rnd2<kBF>(o[2], o[3]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) sum[u] += o[u];
        }
        if (kind == 0) {
          *reinterpret_cast<float4*>(p.dh + (size_t)(r0 + il) * D + d0 + cc) =
              float4{sum[0], sum[1], sum[2], sum[3]};
        } else {
          float* o = dxs + (il * L + m) * NS + cc;
#pragma unroll
          for (int u = 0; u < 4; ++u) o[u] = kind == 1 ? sum[u] : o[u] + sum[u];
        }
      }
      __syncthreads();   // Cs is written by the next product
    }
    // the slice's dX, every direction and tensor block added
    for (int e = tid; e < TI * L * w4; e += kEThreads) {
      const int cc = 4 * (e % w4), m = e / w4 % L, il = e / w4 / L;
      *reinterpret_cast<float4*>(p.dx + ((size_t)(r0 + il) * L + m) * D + d0 +
                                 cc) =
          *reinterpret_cast<const float4*>(dxs + (il * L + m) * NS + cc);
    }
    __syncthreads();   // dxs is written again by the next slice
  }
  if constexpr (kBF) cp_async_wait<0>();
}

// byte offsets of the shared arrays for p.TI rows a block; returns the total
template <bool kBF>
size_t smem_layout(Params& p) {
  const size_t TB = (size_t)p.TI * p.K, rows = a_rows<kBF>((int)TB);
  auto up16 = [](size_t x) { return (x + 15) / 16 * 16; };
  const size_t w = kBF ? (size_t)kFStages * kFN * kFLd * 2
                       : (size_t)kKT * kNT * sizeof(float);
  size_t off = up16(w);
  p.off_a = (int)off;
  off = up16(off + rows * a_stride(p.D, kBF) * (kBF ? 2 : sizeof(float)));
  p.off_c = (int)off;
  off += rows * kLdc<kBF> * sizeof(float);
  p.off_dx = (int)off;
  off += (size_t)p.TI * p.L * kSlice<kBF> * sizeof(float);
  p.off_lg = (int)off;
  off += TB * p.H * sizeof(float);
  p.off_ap = (int)off;
  off += TB * p.H * sizeof(float);
  p.off_ev = (int)off;
  off += TB * sizeof(float);
  p.off_rl = (int)off;
  off += TB * p.L * sizeof(float);
  p.off_nb = (int)off;
  off += TB * sizeof(int);
  p.off_sl = (int)off;
  off += TB * sizeof(int);
  p.off_ci = (int)off;
  off += TB * sizeof(int);
  p.off_vf = (int)off;
  off += TB * sizeof(int);
  p.off_rk = (int)off;
  off += TB * sizeof(int);
  p.off_rs = (int)off;
  off += ((size_t)p.TI + 1) * sizeof(int);
  p.off_red = (int)up16(off);
  off = p.off_red + (size_t)kEWarps * 33 * sizeof(float);
  p.smem = (int)off;
  return off;
}

// every launch of this file goes through here
template <int NT, typename K, typename A>
cudaError_t run(K kern, dim3 grid, size_t smem, const A& args,
                cudaStream_t stream) {
  kern<<<grid, NT, smem, stream>>>(args);
  return cudaGetLastError();
}

template <bool kBF, typename TT, typename GT>
cudaError_t launch(Params p, cudaStream_t stream) {
  // as many whole destination rows as fit 128 slots and the shared memory
  p.TI = kMaxPairs / p.K;
  while (p.TI > 0 && smem_layout<kBF>(p) > kMaxSmem) --p.TI;
  if (p.TI == 0) return cudaErrorInvalidValue;
  auto kern = fused_ell_fwd_kernel<kBF, TT, GT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  return run<kEThreads>(kern, dim3((p.NR + p.TI - 1) / p.TI), p.smem, p,
                        stream);
}

template <bool kBF, typename GT>
cudaError_t dispatch_t(const Params& p, int t_bf16, cudaStream_t s) {
  return t_bf16 ? launch<kBF, __nv_bfloat16, GT>(p, s)
                : launch<kBF, float, GT>(p, s);
}

int channels(int D, int lmax, int sep_dir, int sep_tensor) {
  return D * (1 + (sep_dir ? lmax : 1) + (sep_tensor ? lmax : 1));
}

// the workspace's parts, in bf16 values: the weights, then the rounded
// tables q, k, x_g, v and X
struct Work {
  long long wt, q, k, xg, v, X, total;
};

Work work_layout(int NR, int N, int D, int L, int C) {
  Work w;
  w.wt = 0;
  w.q = w.wt + (long long)(D + C) * D;
  w.k = w.q + (long long)NR * D;
  w.xg = w.k + (long long)N * D;
  w.v = w.xg + (long long)N * C;
  w.X = w.v + (long long)N * C;
  w.total = w.X + (long long)N * L * D;
  return w;
}

}  // namespace

// Workspace bytes the forward needs for these shapes: the bf16 weights and
// the bf16 node tables.
extern "C" long long gotennet_fused_ell_fwd_workspace(int NR, int N, int K,
                                                      int D, int H, int lmax,
                                                      int sep_dir,
                                                      int sep_tensor) {
  (void)K;
  (void)H;
  const int L = (lmax + 1) * (lmax + 1) - 1;
  return work_layout(NR, N, D, L, channels(D, lmax, sep_dir, sep_tensor))
             .total * 2;
}

// Launches on `stream` and allocates nothing (`work` holds at least
// gotennet_fused_ell_fwd_workspace bytes, 16-byte aligned); returns the
// first CUDA error.
extern "C" int gotennet_fused_ell_fwd(
    const void* t, const void* q, const void* k, const void* xg,
    const void* v, const float* rl, const float* X, const float* env,
    const float* scale, const int* nbr, const float* wre, const float* bre,
    const float* wrs, const float* brs, float* dh, float* dx, float* attn,
    void* work, int NR, int N, int K, int D, int H, int lmax, int sep_dir,
    int sep_tensor, int scale_heads, int pair_bf16, int t_bf16, int node_bf16,
    void* stream) {
  Params p{};
  p.t = t; p.q = q; p.k = k; p.xg = xg; p.v = v; p.X = X;
  p.rl = rl; p.env = env; p.scale = scale; p.nbr = nbr;
  p.wre = wre; p.bre = bre; p.wrs = wrs; p.brs = brs;
  p.dh = dh; p.dx = dx; p.attn = attn;
  p.NR = NR; p.N = N; p.K = K; p.D = D; p.H = H; p.lmax = lmax;
  p.L = (lmax + 1) * (lmax + 1) - 1;
  p.C = channels(D, lmax, sep_dir, sep_tensor);
  p.sep_dir = sep_dir; p.sep_tensor = sep_tensor; p.scale_heads = scale_heads;
  if (NR <= 0) return (int)cudaSuccess;
  if (K <= 0 || K > kMaxPairs || N < NR || D % kNT || D % kKT || D % H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pair_bf16) {
    return (int)(node_bf16 ? dispatch_t<false, __nv_bfloat16>(p, t_bf16, s)
                           : dispatch_t<false, float>(p, t_bf16, s));
  }
  // bf16 pair type: the weights, then the tables, rounded once
  using BF = __nv_bfloat16;
  BF* wb = static_cast<BF*>(work);
  const Work w = work_layout(NR, N, D, p.L, p.C);
  p.wt = wb + w.wt;
  const WPrep wp{wre, wrs, wb + w.wt, D, p.C};
  cudaError_t err = run<kThreads>(
      weights_bf16_kernel,
      dim3((unsigned)(D + p.C + 31) / 32, (unsigned)(D + 31) / 32),
      32 * 33 * sizeof(float), wp, s);
  if (err != cudaSuccess) return (int)err;
  // each table read rounded, one launch a table (round_bf16_kernel)
  auto round_table = [&](const void* x, long long at, long long n) {
    const RoundBF16 r{static_cast<const float*>(x), wb + at, n};
    if (err == cudaSuccess) {   // the first error is the one returned
      err = run<kRoundThreads>(round_bf16_kernel, round_bf16_grid(n), 0, r,
                               s);
    }
    return static_cast<const void*>(wb + at);
  };
  p.X = round_table(X, w.X, (long long)N * p.L * D);
  if (!node_bf16) {
    p.q = round_table(q, w.q, (long long)NR * D);
    p.k = round_table(k, w.k, (long long)N * D);
    p.xg = round_table(xg, w.xg, (long long)N * p.C);
    p.v = round_table(v, w.v, (long long)N * p.C);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_t<true, BF>(p, t_bf16, s);
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
