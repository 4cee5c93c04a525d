// Fused dense-GATA message + aggregation, forward, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of gotennet_tpu/ops/pallas/fused_gata.py
// (launched by `_pallas_forward`).  The math and the cast points are written
// out in gotennet_tpu_torch/ops/fused_gata.py, beside the plain PyTorch
// version this kernel is held against.
//
// What bounds it on an H100: the two pair projections t @ W_re and
// t @ W_rs, 2 * pairs * D * (D + mult*D) FLOP, and the ~16 MB of inputs and
// outputs of one 8-graph chunk at M = 32 (D = 256, mult = 5).  Over the valid
// pairs (~2.6 GFLOP at QM9 density) the bytes bound it by a hair, over all
// padded pairs (6.4 GFLOP) the tensor-core rate does: either way a few
// microseconds.  The design keeps every [pairs, mult*D] tensor on chip, so
// the bytes stay at that minimum, and puts the products on the tensor cores.
// What it does not yet do is hide latency: each block walks its weight slices
// one after another (see PERF.md for its measured distance to the bound).
//
// Design (simple first; wgmma/TMA/warp specialisation are later work):
//  * one thread block per (graph, slab of TI destination rows) holds every
//    neighbour j of its rows, so the masked softmax over j is exact and no
//    block depends on another (the TPU kernel's sequential grid is not
//    needed for the forward);
//  * the slab's t rows (TI*M pairs, rounded to the pair type) stay in shared
//    memory; W_re and W_rs stream through shared memory one 32-column slice
//    at a time.  With a bf16 pair type each slice product runs on the tensor
//    cores (mma.sync m16n8k16, bf16 operands, float32 accumulation: the cast
//    points of the TPU kernel's bf16 matmul); with a float32 pair type it
//    runs as float32 FMAs over 32 x 32 tiles;
//  * the [pairs, mult*D] tensors t_filter and o exist only as one
//    32-column tile in shared memory; the j-sums for d_h and dX are taken
//    from that tile and written straight to device memory;
//  * the output columns split over NZ blocks per slab (blockIdx.z) while the
//    grid fits one wave of resident blocks, so small-M chunks still fill the
//    card; each such block recomputes the attention.
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
  float* dh;           // [G, M, D]
  float* dx;           // [G, M, L, D]
  float* attn;         // [G, M, M, H] pre-scale softmax, or null
  int G, M, D, H, L, C, lmax, sep_dir, sep_tensor, scale_heads, TI;
  int NZ;  // column groups: block z takes the 32-column slices z, z+NZ, ...
  // shared-memory carve-up, in bytes from the base (see smem_layout)
  int off_a, off_c, off_lg, off_ap, off_ev, off_vd, off_rl, smem;
};

template <bool kBF, typename TT, typename NT>
__global__ void __launch_bounds__(kThreads)
fused_gata_fwd_kernel(const Params p) {
  using AT = typename PairT<kBF>::type;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int g = blockIdx.y;
  const int i0 = blockIdx.x * p.TI;
  const int z = blockIdx.z;
  const int M = p.M, D = p.D, H = p.H, L = p.L, C = p.C;
  const int TB = p.TI * M;
  const int TBp = round16(TB);
  const int lda = a_stride(D, kBF);
  const int tid = threadIdx.x;

  void* Wbuf = base;                                   // W slice
  AT* As = reinterpret_cast<AT*>(base + p.off_a);      // [TBp][lda] t rows
  float* Cs = reinterpret_cast<float*>(base + p.off_c);   // [TBp][kNT + 1]
  float* lg = reinterpret_cast<float*>(base + p.off_lg);  // [TB][H] logits
  float* ap = reinterpret_cast<float*>(base + p.off_ap);  // [TB][H] rnd(attn)
  float* ev = reinterpret_cast<float*>(base + p.off_ev);  // [TB] rnd(env+)
  float* vd = reinterpret_cast<float*>(base + p.off_vd);  // [TB] valid flag
  float* rls = reinterpret_cast<float*>(base + p.off_rl); // [TB][L] rnd(rl)

  const TT* __restrict__ t = static_cast<const TT*>(p.t);
  const NT* __restrict__ q = static_cast<const NT*>(p.q);
  const NT* __restrict__ k = static_cast<const NT*>(p.k);
  const NT* __restrict__ xg = static_cast<const NT*>(p.xg);
  const NT* __restrict__ v = static_cast<const NT*>(p.v);
  const size_t gM = (size_t)g * M;

  // ---- stage 0: the slab's pair rows into shared memory ----------------
  // pair row `row` = (i0 + row / M, row % M); rows past the graph or the
  // slab are zero
  for (int e = tid; e < TBp * D; e += kThreads) {
    const int row = e / D, c = e % D;
    const int i = i0 + row / M, j = row % M;
    float val = 0.f;
    if (row < TB && i < M) val = to_f(t[((gM + i) * M + j) * D + c]);
    if constexpr (kBF) {
      As[row * lda + c] = __float2bfloat16(val);
    } else {
      As[row * lda + c] = val;
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

  // ---- stage 1: ta = silu(t W_re + b_re); per-head logits --------------
  const int Dh = D / H;
  for (int n0 = 0; n0 < D; n0 += kNT) {
    product_tile<kBF>(As, lda, TB, p.wre, D, n0, D, Wbuf, Cs);
    // each pair's logit terms q_i k_j ta, one per channel, in place of ta
    for (int e = tid; e < TB * kNT; e += kThreads) {
      const int row = e / kNT, c = e % kNT;
      const int i = i0 + row / M, j = row % M;
      float term = 0.f;
      if (i < M) {
        const int cc = n0 + c;
        const float z = Cs[row * (kNT + 1) + c] + p.bre[cc];
        const float ta = z * (1.f / (1.f + expf(-z)));
        const float qv = rnd<kBF>(to_f(q[(gM + i) * D + cc]));
        const float kv = rnd<kBF>(to_f(k[(gM + j) * D + cc]));
        term = rnd<kBF>(rnd<kBF>(rnd<kBF>(ta) * qv) * kv);
      }
      Cs[row * (kNT + 1) + c] = term;
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

  // ---- stage 2: masked softmax over j per (i, head) ---------------------
  for (int e = tid; e < p.TI * H; e += kThreads) {
    const int il = e / H, h = e % H;
    const int i = i0 + il;
    if (i >= M) continue;
    float mx = -INFINITY;
    for (int j = 0; j < M; ++j) {
      const int row = il * M + j;
      mx = fmaxf(mx, vd[row] > 0.f ? lg[row * H + h] : -1e30f);
    }
    float den = 0.f;
    for (int j = 0; j < M; ++j) {
      const int row = il * M + j;
      const float l = vd[row] > 0.f ? lg[row * H + h] : -1e30f;
      const float ex = expf(l - mx) * vd[row];
      lg[row * H + h] = ex;
      den += ex;
    }
    den += 1e-16f;
    for (int j = 0; j < M; ++j) {
      const int row = il * M + j;
      const size_t pair = (gM + i) * M + j;
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
        const int row = e / kNT, c = e % kNT;
        const int i = i0 + row / M, j = row % M;
        float o = 0.f;
        if (i < M) {
          const int cc = col0 + c;
          const float tf = rnd<kBF>(Cs[row * (kNT + 1) + c] + p.brs[cc]);
          const float xv = rnd<kBF>(to_f(xg[(gM + j) * C + cc]));
          const float vv = rnd<kBF>(to_f(v[(gM + j) * C + cc]));
          const float sp = rnd<kBF>(rnd<kBF>(tf * xv) * ev[row]);
          const float se = rnd<kBF>(ap[row * H + cc / e_per] * vv);
          o = rnd<kBF>(sp + se);
        }
        Cs[row * (kNT + 1) + c] = o;
      }
      __syncthreads();
      // j-sums, one thread per (i, m, channel).  The tensor blocks add to
      // the dX the direction blocks wrote; __syncthreads between blocks
      // makes those writes visible to every thread of the block.
      const int nm = kind == 0 ? 1 : mhi - mlo;
      for (int e = tid; e < p.TI * nm * kNT; e += kThreads) {
        const int c = e % kNT, m = mlo + e / kNT % nm, il = e / kNT / nm;
        const int i = i0 + il;
        if (i >= M) continue;
        const int d = n0 + c;
        const float* oc = Cs + il * M * (kNT + 1) + c;
        float s = 0.f;
        if (kind == 0) {
          for (int j = 0; j < M; ++j) s += oc[j * (kNT + 1)];
          p.dh[(gM + i) * D + d] = s;
        } else if (kind == 1) {
          const float* r = rls + il * M * L + m;
          for (int j = 0; j < M; ++j) s += r[j * L] * oc[j * (kNT + 1)];
          p.dx[((gM + i) * L + m) * D + d] = s;
        } else {
          for (int j = 0; j < M; ++j) {
            const float xv = rnd<kBF>(p.X[((gM + j) * L + m) * D + d]);
            s += rnd<kBF>(oc[j * (kNT + 1)] * xv);
          }
          p.dx[((gM + i) * L + m) * D + d] += s;
        }
      }
      __syncthreads();
    }
  }
}

// byte offsets of the shared arrays; returns the total
size_t smem_layout(Params& p, bool bf) {
  const size_t TB = (size_t)p.TI * p.M, TBp = round16((int)TB);
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
  p.smem = (int)off;
  return off;
}

// Column groups per slab: the output columns split over NZ blocks while the
// grid still fits one wave of resident blocks.  Each block recomputes the
// attention (the W_re product, a sixth of the work at mult = 5) and owns its
// columns of d_h and dX, so the blocks share nothing.
template <typename K>
int column_groups(const Params& p, K kern) {
  int dev = 0, n_sm = 1, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                p.smem);
  const int slots = n_sm * max(per_sm, 1);
  const int slabs = p.G * ((p.M + p.TI - 1) / p.TI), n_slices = p.D / kNT;
  int nz = 1;
  while (n_slices % (2 * nz) == 0 && slabs * 2 * nz <= slots) nz *= 2;
  return nz;
}

template <bool kBF, typename TT, typename NT>
cudaError_t launch(Params p, cudaStream_t stream) {
  auto kern = fused_gata_fwd_kernel<kBF, TT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  p.NZ = column_groups(p, kern);
  const dim3 grid((p.M + p.TI - 1) / p.TI, p.G, p.NZ);
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
extern "C" int gotennet_fused_gata_fwd(
    const void* t, const void* q, const void* k, const void* xg,
    const void* v, const float* rl, const float* X, const float* env,
    const float* scale, const float* wre, const float* bre, const float* wrs,
    const float* brs, float* dh, float* dx, float* attn, int G, int M, int D,
    int H, int lmax, int sep_dir, int sep_tensor, int scale_heads,
    int pair_bf16, int t_bf16, int node_bf16, void* stream) {
  Params p;
  p.t = t; p.q = q; p.k = k; p.xg = xg; p.v = v;
  p.rl = rl; p.X = X; p.env = env; p.scale = scale;
  p.wre = wre; p.bre = bre; p.wrs = wrs; p.brs = brs;
  p.dh = dh; p.dx = dx; p.attn = attn;
  p.G = G; p.M = M; p.D = D; p.H = H; p.lmax = lmax;
  p.L = (lmax + 1) * (lmax + 1) - 1;
  p.C = D * (1 + (sep_dir ? lmax : 1) + (sep_tensor ? lmax : 1));
  p.sep_dir = sep_dir; p.sep_tensor = sep_tensor; p.scale_heads = scale_heads;
  // about 64 pair rows per block; one destination row when M > 64
  p.TI = M >= 64 ? 1 : 64 / M;
  if (G <= 0 || M <= 0) return (int)cudaSuccess;
  if ((size_t)p.TI * M > (size_t)kMaxPairs || D % kNT || D % kKT)
    return (int)cudaErrorInvalidValue;
  if (smem_layout(p, pair_bf16 != 0) > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pair_bf16 ? dispatch_storage<true>(p, t_bf16, node_bf16, s)
                                    : dispatch_storage<false>(p, t_bf16, node_bf16, s);
  return (int)err;
}

extern "C" const char* gotennet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
