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
// at the bf16 tensor-core peak.  The design keeps every [pairs, mult*D]
// tensor on chip, as the TPU kernel keeps them in VMEM, so the bytes stay
// at that minimum.
//
// Design (simple first; wgmma/TMA/warp specialisation are later work):
//  * the TPU kernel selects neighbour rows with one-hot matmuls, a TPU
//    workaround for row gathers; here each slot reads its source row of
//    k, x_g, v and X straight from device memory by index (the tables, a
//    few MB at N = 704, stay in the 50 MB L2).  An index outside [0, N) is
//    clamped so no read leaves a table; callers pass indices in range;
//  * one thread block per TI whole destination rows (TI * K <= 128 pair
//    rows), so the masked softmax over the K slots is exact and no block
//    depends on another;
//  * the block's t rows (rounded to the pair type) stay in shared memory;
//    W_re and W_rs stream through shared memory one 32-column slice at a
//    time, on the tensor cores (mma.sync m16n8k16, bf16 operands, float32
//    accumulation) for a bf16 pair type and as float32 FMAs otherwise (the
//    tile code of the dense kernel, fused_gata_tile.cuh);
//  * t_filter and o exist only as one 32-column tile in shared memory; the
//    slot sums for d_h and dX are taken from it and written straight to
//    device memory, the tensor path added to the directional one;
//  * the output columns split over NZ blocks per row group (blockIdx.y)
//    while the grid fits one wave of resident blocks.
// A padded slot (env < 0) gets softmax weight exactly 0 and envelope 0, so
// its o is an exact zero; it still reads the row its index names.

#include "fused_gata_tile.cuh"

namespace {

struct Params {
  const void* t;       // [NR, K, D]    float or bf16
  const void* q;       // [NR, D]       node type
  const void* k;       // [N, D]
  const void* xg;      // [N, C]
  const void* v;       // [N, C]
  const float* rl;     // [NR, K, L]
  const float* X;      // [N, L, D]
  const float* env;    // [NR, K]
  const float* scale;  // [NR, K] or [NR, K, H]
  const int* nbr;      // [NR, K]  source rows
  const float* wre;    // [D, D]   (in, out)
  const float* bre;    // [D]
  const float* wrs;    // [D, C]   (in, out)
  const float* brs;    // [C]
  float* dh;           // [NR, D]
  float* dx;           // [NR, L, D]
  float* attn;         // [NR, K, H] pre-scale softmax, or null
  int NR, N, K, D, H, L, C, lmax, sep_dir, sep_tensor, scale_heads, TI;
  int NZ;  // column groups: block y takes the 32-column slices y, y+NZ, ...
  // shared-memory carve-up, in bytes from the base (see smem_layout)
  int off_a, off_c, off_lg, off_ap, off_ev, off_vd, off_rl, off_nb, smem;
};

template <bool kBF, typename TT, typename NT>
__global__ void __launch_bounds__(kThreads)
fused_ell_fwd_kernel(const Params p) {
  using AT = typename PairT<kBF>::type;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int r0 = blockIdx.x * p.TI;
  const int z = blockIdx.y;
  const int K = p.K, D = p.D, H = p.H, L = p.L, C = p.C;
  const int TI = min(p.TI, p.NR - r0);   // the last block may hold fewer
  const int TB = TI * K;
  const int TBp = round16(TB);
  const int lda = a_stride(D, kBF);
  const int tid = threadIdx.x;
  const long long pr0 = (long long)r0 * K;   // the block's first pair

  void* Wbuf = base;                                      // W slice
  AT* As = reinterpret_cast<AT*>(base + p.off_a);         // [TBp][lda] t rows
  float* Cs = reinterpret_cast<float*>(base + p.off_c);   // [TBp][kNT + 1]
  float* lg = reinterpret_cast<float*>(base + p.off_lg);  // [TB][H] logits
  float* ap = reinterpret_cast<float*>(base + p.off_ap);  // [TB][H] rnd(attn)
  float* ev = reinterpret_cast<float*>(base + p.off_ev);  // [TB] rnd(env+)
  float* vd = reinterpret_cast<float*>(base + p.off_vd);  // [TB] valid flag
  float* rls = reinterpret_cast<float*>(base + p.off_rl); // [TB][L] rnd(rl)
  int* nb = reinterpret_cast<int*>(base + p.off_nb);      // [TB] source row

  const TT* __restrict__ t = static_cast<const TT*>(p.t);
  const NT* __restrict__ q = static_cast<const NT*>(p.q);
  const NT* __restrict__ k = static_cast<const NT*>(p.k);
  const NT* __restrict__ xg = static_cast<const NT*>(p.xg);
  const NT* __restrict__ v = static_cast<const NT*>(p.v);

  // ---- stage 0: the block's pair rows into shared memory ----------------
  // pair row `row` = (r0 + row / K, slot row % K); rows past TB are zero
  for (int e = tid; e < TBp * D; e += kThreads) {
    const int row = e / D, c = e % D;
    const float val = row < TB ? to_f(t[(pr0 + row) * D + c]) : 0.f;
    if constexpr (kBF) {
      As[row * lda + c] = __float2bfloat16(val);
    } else {
      As[row * lda + c] = val;
    }
  }
  for (int row = tid; row < TB; row += kThreads) {
    const long long pair = pr0 + row;
    const float e = p.env[pair];
    vd[row] = e >= 0.f ? 1.f : 0.f;
    ev[row] = rnd<kBF>(fmaxf(e, 0.f));
    nb[row] = min(max(p.nbr[pair], 0), p.N - 1);
    for (int m = 0; m < L; ++m) rls[row * L + m] = rnd<kBF>(p.rl[pair * L + m]);
  }
  for (int e = tid; e < TB * H; e += kThreads) lg[e] = 0.f;
  __syncthreads();

  // ---- stage 1: ta = silu(t W_re + b_re); per-head logits --------------
  const int Dh = D / H;
  for (int n0 = 0; n0 < D; n0 += kNT) {
    product_tile<kBF>(As, lda, TB, p.wre, D, n0, D, Wbuf, Cs);
    // each pair's logit terms q_r k_j ta, one per channel, in place of ta
    for (int e = tid; e < TB * kNT; e += kThreads) {
      const int row = e / kNT, c = e % kNT, cc = n0 + c;
      const size_t r = (size_t)r0 + row / K;
      const float zz = Cs[row * (kNT + 1) + c] + p.bre[cc];
      const float ta = zz * (1.f / (1.f + expf(-zz)));
      const float qv = rnd<kBF>(to_f(q[r * D + cc]));
      const float kv = rnd<kBF>(to_f(k[(size_t)nb[row] * D + cc]));
      Cs[row * (kNT + 1) + c] = rnd<kBF>(rnd<kBF>(rnd<kBF>(ta) * qv) * kv);
    }
    __syncthreads();
    // per-head sums over the slice's channels (a head may span slices)
    const int h_lo = n0 / Dh, nh = (n0 + kNT - 1) / Dh - h_lo + 1;
    for (int e = tid; e < TB * nh; e += kThreads) {
      const int row = e / nh, h = h_lo + e % nh;
      const int c_lo = max(h * Dh, n0), c_hi = min((h + 1) * Dh, n0 + kNT);
      float s = 0.f;
      for (int c = c_lo; c < c_hi; ++c) s += Cs[row * (kNT + 1) + c - n0];
      lg[row * H + h] += s;
    }
    __syncthreads();
  }

  // ---- stage 2: masked softmax over the K slots per (row, head) ---------
  for (int e = tid; e < TI * H; e += kThreads) {
    const int il = e / H, h = e % H;
    float mx = -INFINITY;
    for (int s = 0; s < K; ++s) {
      const int row = il * K + s;
      mx = fmaxf(mx, vd[row] > 0.f ? lg[row * H + h] : -1e30f);
    }
    float den = 0.f;
    for (int s = 0; s < K; ++s) {
      const int row = il * K + s;
      const float l = vd[row] > 0.f ? lg[row * H + h] : -1e30f;
      const float ex = expf(l - mx) * vd[row];
      lg[row * H + h] = ex;
      den += ex;
    }
    den += 1e-16f;
    for (int s = 0; s < K; ++s) {
      const int row = il * K + s;
      const long long pair = pr0 + row;
      const float sm = lg[row * H + h] / den;
      if (p.attn != nullptr && z == 0) p.attn[pair * H + h] = sm;
      const float sc = p.scale_heads ? p.scale[pair * H + h] : p.scale[pair];
      ap[row * H + h] = rnd<kBF>(sm * sc);
    }
  }
  __syncthreads();

  // ---- stage 3: channel blocks of o -> d_h, dX --------------------------
  const int e_per = C / H;
  const int n_dir = p.sep_dir ? p.lmax : 1;
  for (int b = 0; b < C / D; ++b) {
    int kind = 0, mlo = 0, mhi = 0;   // 0 scalar, 1 direction, 2 tensor
    if (b >= 1) {
      kind = b <= n_dir ? 1 : 2;
      const bool sep = kind == 1 ? p.sep_dir : p.sep_tensor;
      const int l = kind == 1 ? b : b - n_dir;   // degree, when separate
      mlo = sep ? l * l - 1 : 0;
      mhi = sep ? (l + 1) * (l + 1) - 1 : L;
    }
    for (int n0 = z * kNT; n0 < D; n0 += p.NZ * kNT) {
      const int col0 = b * D + n0;
      product_tile<kBF>(As, lda, TB, p.wrs, C, col0, D, Wbuf, Cs);
      // o in place of t_filter
      for (int e = tid; e < TB * kNT; e += kThreads) {
        const int row = e / kNT, c = e % kNT, cc = col0 + c;
        const size_t j = (size_t)nb[row];
        const float tf = rnd<kBF>(Cs[row * (kNT + 1) + c] + p.brs[cc]);
        const float xv = rnd<kBF>(to_f(xg[j * C + cc]));
        const float vv = rnd<kBF>(to_f(v[j * C + cc]));
        const float sp = rnd<kBF>(rnd<kBF>(tf * xv) * ev[row]);
        const float se = rnd<kBF>(ap[row * H + cc / e_per] * vv);
        Cs[row * (kNT + 1) + c] = rnd<kBF>(sp + se);
      }
      __syncthreads();
      // slot sums, one thread per (row, m, channel).  The tensor blocks add
      // to the dX the direction blocks wrote; __syncthreads between blocks
      // makes those writes visible to every thread of the block.
      const int nm = kind == 0 ? 1 : mhi - mlo;
      for (int e = tid; e < TI * nm * kNT; e += kThreads) {
        const int c = e % kNT, m = mlo + e / kNT % nm, il = e / kNT / nm;
        const size_t r = (size_t)r0 + il;
        const int d = n0 + c;
        const float* oc = Cs + il * K * (kNT + 1) + c;
        float s = 0.f;
        if (kind == 0) {
          for (int sl = 0; sl < K; ++sl) s += oc[sl * (kNT + 1)];
          p.dh[r * D + d] = s;
        } else if (kind == 1) {
          const float* rr = rls + il * K * L + m;
          for (int sl = 0; sl < K; ++sl) {
            s += rnd<kBF>(rr[sl * L] * oc[sl * (kNT + 1)]);
          }
          p.dx[(r * L + m) * D + d] = s;
        } else {
          for (int sl = 0; sl < K; ++sl) {
            const size_t j = (size_t)nb[il * K + sl];
            const float xv = rnd<kBF>(p.X[(j * L + m) * D + d]);
            s += rnd<kBF>(oc[sl * (kNT + 1)] * xv);
          }
          p.dx[(r * L + m) * D + d] += s;
        }
      }
      __syncthreads();
    }
  }
}

// byte offsets of the shared arrays; returns the total
size_t smem_layout(Params& p, bool bf) {
  const size_t TB = (size_t)p.TI * p.K, TBp = round16((int)TB);
  auto up16 = [](size_t x) { return (x + 15) / 16 * 16; };
  const size_t w = bf ? (size_t)kNT * (p.D + kPadBF) * 2
                      : (size_t)kKT * kNT * sizeof(float);
  size_t off = up16(w);
  p.off_a = (int)off;
  off = up16(off + TBp * a_stride(p.D, bf) * (bf ? 2 : sizeof(float)));
  p.off_c = (int)off;
  off += TBp * (kNT + 1) * sizeof(float);
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
  p.off_nb = (int)off;
  off += TB * sizeof(int);
  p.smem = (int)off;
  return off;
}

// Column groups per row group: the output columns split over NZ blocks while
// the grid still fits one wave of resident blocks (as the dense kernel).
template <typename Kern>
int column_groups(const Params& p, Kern kern) {
  int dev = 0, n_sm = 1, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                p.smem);
  const int slots = n_sm * max(per_sm, 1);
  const int groups = (p.NR + p.TI - 1) / p.TI, n_slices = p.D / kNT;
  int nz = 1;
  while (n_slices % (2 * nz) == 0 && groups * 2 * nz <= slots) nz *= 2;
  return nz;
}

template <bool kBF, typename TT, typename NT>
cudaError_t launch(Params p, cudaStream_t stream) {
  auto kern = fused_ell_fwd_kernel<kBF, TT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  p.NZ = column_groups(p, kern);
  const dim3 grid((p.NR + p.TI - 1) / p.TI, p.NZ);
  kern<<<grid, kThreads, p.smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBF>
cudaError_t dispatch_storage(const Params& p, int t_bf16, int node_bf16,
                             cudaStream_t s) {
  if (t_bf16) {
    return node_bf16 ? launch<kBF, __nv_bfloat16, __nv_bfloat16>(p, s)
                     : launch<kBF, __nv_bfloat16, float>(p, s);
  }
  return node_bf16 ? launch<kBF, float, __nv_bfloat16>(p, s)
                   : launch<kBF, float, float>(p, s);
}

}  // namespace

// Launches on `stream`, allocates nothing; returns cudaGetLastError().
extern "C" int gotennet_fused_ell_fwd(
    const void* t, const void* q, const void* k, const void* xg,
    const void* v, const float* rl, const float* X, const float* env,
    const float* scale, const int* nbr, const float* wre, const float* bre,
    const float* wrs, const float* brs, float* dh, float* dx, float* attn,
    int NR, int N, int K, int D, int H, int lmax, int sep_dir, int sep_tensor,
    int scale_heads, int pair_bf16, int t_bf16, int node_bf16, void* stream) {
  Params p;
  p.t = t; p.q = q; p.k = k; p.xg = xg; p.v = v;
  p.rl = rl; p.X = X; p.env = env; p.scale = scale; p.nbr = nbr;
  p.wre = wre; p.bre = bre; p.wrs = wrs; p.brs = brs;
  p.dh = dh; p.dx = dx; p.attn = attn;
  p.NR = NR; p.N = N; p.K = K; p.D = D; p.H = H; p.lmax = lmax;
  p.L = (lmax + 1) * (lmax + 1) - 1;
  p.C = D * (1 + (sep_dir ? lmax : 1) + (sep_tensor ? lmax : 1));
  p.sep_dir = sep_dir; p.sep_tensor = sep_tensor; p.scale_heads = scale_heads;
  if (NR <= 0) return (int)cudaSuccess;
  if (K <= 0 || K > kMaxPairs || N < NR || D % kNT || D % kKT || D % H)
    return (int)cudaErrorInvalidValue;
  // as many whole destination rows as fit kMaxPairs pair rows
  p.TI = kMaxPairs / K;
  if (smem_layout(p, pair_bf16 != 0) > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pair_bf16 ? dispatch_storage<true>(p, t_bf16, node_bf16, s)
                                    : dispatch_storage<false>(p, t_bf16, node_bf16, s);
  return (int)err;
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
