// Forward attention with an online softmax, for Hopper (sm_90a), behind a
// plain C interface that kernels/_build.py loads with ctypes.  The launcher
// enqueues on the caller's stream, allocates nothing, does not synchronise,
// and returns the cudaError_t of the launch.
//
// Replaces src/repro/kernels/flash_attention.py `_kernel` (built by
// `flash_attention_fwd`): out = softmax(scale * q k^T, masked) v per head,
// GQA through the head index (KV head = h / rep, K and V never repeated),
// causal masking on absolute positions (q_offset), masked logits -1e30,
// fp32 m, l and accumulators, the denominator clamped at 1e-30, the output
// cast to q's dtype.  q, k, v and o are (b, heads, seq, hd) with any strides
// over the first three dimensions and a contiguous last one, so the model's
// (b, seq, heads, hd) tensors are read in place.  Each dtype has one kernel:
//
// flash_attention_kernel (bf16)
//   Bound on this card: at the serving shape (b 4, h 32, s 1024, hd 80,
//   causal) 21.5 GFLOP of products against 989 TFLOP/s bf16, 0.022 ms,
//   and about as long for the bytes (q, k, v read once, o written once,
//   84 MB at 3.35 TB/s); only the tensor cores can come near it.
//   Design: one resident block of three warpgroups per SM, each walking a
//   list of (batch, head, 128-query tile) work tiles, each head's heaviest
//   causal tile first and a few heads at a time, so that K and V come from
//   L2 after their first read.  Warpgroup 2 is the producer: one thread
//   starts every TMA copy (cp.async.bulk.tensor), each completing on an
//   mbarrier: the query tile into one of two buffers, K and V tiles of 128
//   keys into two-stage rings, K of tile j + 1 ahead of V of tile j; it
//   gives its registers to the consumers (setmaxnreg).  Warpgroups 0 and 1
//   own 64 query rows each.  S = Q K^T runs on the tensor cores (wgmma,
//   bf16 in, fp32 accumulate, both operands in shared memory) and the scale
//   is applied to the fp32 scores; the online softmax works on the
//   accumulator fragment (row max and sum over a quad of lanes by
//   shuffles, 2^x by ex2); P, rounded to bf16 in registers, is the A
//   operand of O += P V (the S fragment is the A fragment, so P never goes
//   through shared memory), V read MN-major.  S of tile j is started with
//   P V of tile j - 1, so the softmax of tile j overlaps that product, and
//   the two consumer warpgroups take turns to start their products.  Each
//   consumer releases a K stage when its S is done and a V stage when its
//   P V is done, with one mbarrier arrive.
//   The head dim is cut into slabs of 16 columns, one TMA box and one
//   wgmma k-step each, in the 32-byte swizzle: any hd that is a multiple of
//   8 up to 128 (80 is five slabs; a partial slab is zero-filled by TMA).
//   Rows past sq or skv are zero-filled by TMA and keys past skv are masked
//   to -1e30; the mask is applied only on tiles that straddle the diagonal
//   or the ragged tail, and key tiles past a warpgroup's last row are only
//   released.  O = acc / max(l, 1e-30) is stored as bf16 from the fragment.
//   The tensor maps are encoded on the host by cuTensorMapEncodeTiled,
//   looked up through the CUDA runtime (no -lcuda), and passed as
//   __grid_constant__ parameters.

// flash_attention_fp32_kernel (fp32)
//   wgmma has no full-fp32 mode, and tf32 would not hold the reference's
//   fp32 tolerance, so fp32 stays on the CUDA cores: one block of 256
//   threads per (64-query tile, head, batch), the pre-scaled query tile in
//   shared memory, K (transposed) and V tiles of 64 keys staged in turn;
//   each thread owns 4 rows x 4 key columns of the scores and 4 rows x
//   hd/16 output columns; row maxima and sums reduce over 16 lanes by
//   shuffles; causal key tiles past the diagonal are skipped.
//
// flash_attention_probe_kernel checks, on the card, the fragment layouts
// the bf16 kernel rests on: one warpgroup computes S = Q K^T and then
// bf16(S) V with the same loads, descriptors and products, and writes each
// accumulator register where the kernel assumes its row and column to be.

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads32 = 256;
constexpr int kBQ32 = 64;
constexpr int kBK32 = 64;

// (batch, head, seq) strides in elements of q, k, v and o
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <int DPT>
constexpr int smem_floats() {
  return kBQ32 * (DPT * 16 + 1) + DPT * 16 * (kBK32 + 1) + kBK32 * DPT * 16 +
         kBQ32 * (kBK32 + 1);
}

// DPT = output columns per thread = padded head dim / 16
template <int DPT>
__global__ void __launch_bounds__(kThreads32)
flash_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, Strides st,
                            int rep, int sq, int skv, int hd, int causal, int q_offset,
                            float scale) {
  constexpr int HDP = DPT * 16;
  constexpr int QS = HDP + 1;    // row stride of the query tile
  constexpr int KS = kBK32 + 1;  // row stride of the transposed key tile and of P
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ32][QS]
  float* Kt = Qs + kBQ32 * QS;  // [HDP][KS]
  float* Vs = Kt + HDP * KS;    // [kBK32][HDP]
  float* Ps = Vs + kBK32 * HDP; // [kBQ32][KS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ32;
  const long long hh = blockIdx.y;
  const long long bb = blockIdx.z;
  const long long kh = hh / rep;
  const float* qb = q + bb * st.q[0] + hh * st.q[1];
  const float* kb = k + bb * st.k[0] + kh * st.k[1];
  const float* vb = v + bb * st.v[0] + kh * st.v[1];
  float* ob = o + bb * st.o[0] + hh * st.o[1];

  for (int idx = tid; idx < kBQ32 * HDP; idx += kThreads32) {
    const int r = idx / HDP;
    const int d = idx - r * HDP;
    float val = 0.f;
    if (q0 + r < sq && d < hd) val = qb[(long long)(q0 + r) * st.q[2] + d] * scale;
    Qs[r * QS + d] = val;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // keys past the last query's position are masked for every row of the tile
  int kv_end = skv;
  if (causal) {
    const long long last = (long long)q_offset + min(q0 + kBQ32, sq);
    kv_end = (int)(last < skv ? last : skv);
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK32) {
    __syncthreads();  // the previous tile's Kt, Vs and Ps are no longer read
    for (int idx = tid; idx < kBK32 * HDP; idx += kThreads32) {
      const int r = idx / HDP;
      const int d = idx - r * HDP;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < skv && d < hd) {
        kv = kb[(long long)(k0 + r) * st.k[2] + d];
        vv = vb[(long long)(k0 + r) * st.v[2] + d];
      }
      Kt[d * KS + r] = kv;
      Vs[r * HDP + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Kt[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = (long long)q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= skv || (causal && qpos < col)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * KS + tx + 16 * j] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

    const int kk_end = min(kBK32, skv - k0);  // padded keys have p = 0 and v = 0
    for (int kk = 0; kk < kk_end; ++kk) {
      float va[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) va[j] = Vs[kk * HDP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pa = Ps[(ty + 16 * i) * KS + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pa, va[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[(long long)row * st.o[2] + d] = acc[i][j] / den;
    }
  }
}

template <int DPT>
int launch_fp32(const float* q, const float* k, const float* v, float* o, const Strides& st,
                int b, int h, int rep, int sq, int skv, int hd, int causal, int q_offset,
                float scale, cudaStream_t stream) {
  const int smem = smem_floats<DPT>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fp32_kernel<DPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ32 - 1) / kBQ32, h, b);
  flash_attention_fp32_kernel<DPT><<<grid, kThreads32, smem, stream>>>(
      q, k, v, o, st, rep, sq, skv, hd, causal, q_offset, scale);
  return cudaGetLastError();
}

int dispatch_fp32(const void* q, const void* k, const void* v, void* o, const Strides& st,
                  int b, int h, int rep, int sq, int skv, int hd, int causal, int q_offset,
                  float scale, cudaStream_t s) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  float* o_ = static_cast<float*>(o);
#define REPRO_FA32(DPT) \
  case DPT: return launch_fp32<DPT>(q_, k_, v_, o_, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s)
  switch ((hd + 15) / 16) {
    REPRO_FA32(1); REPRO_FA32(2); REPRO_FA32(3); REPRO_FA32(4);
    REPRO_FA32(5); REPRO_FA32(6); REPRO_FA32(7); REPRO_FA32(8);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FA32
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int kBK = 128;       // keys per K or V tile
constexpr int kStages = 2;     // depth of the K/V ring
constexpr int kSlabQ = kBQ * kRowBytes;    // one slab of the query tile, 4 KB
constexpr int kSlabK = kBK * kRowBytes;    // one slab of a K or V tile, 4 KB
constexpr int kThreads = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces

// byte offsets from a 1024-aligned base; NS = slabs of 16 head-dim columns
template <int NS>
struct Smem {
  static constexpr int q = 0;                            // + buffer * NS * kSlabQ
  static constexpr int k = 2 * NS * kSlabQ;              // + stage * NS * kSlabK
  static constexpr int v = k + kStages * NS * kSlabK;    // + stage * NS * kSlabK
  static constexpr int bar = v + kStages * NS * kSlabK;  // the mbarriers
  static constexpr int bytes = bar + 8 * (6 + 4 * kStages) + 1024;  // + alignment slack
};

// S (64 x kBK, fp32 fragment) = Q_wg (64 x 16 NS) K^T: one k-step per slab,
// committed as one group; q and k are the shared addresses of slab 0 of
// this warpgroup's rows and of the key tile
template <int NS>
__device__ __forceinline__ void qk_start(float (&s)[kBK / 2], uint32_t q, uint32_t k) {
  uint64_t dq[NS], dk[NS];
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    dq[kk] = sw32_desc(q + kk * kSlabQ, 16, 256);
    dk[kk] = sw32_desc(k + kk * kSlabK, 16, 256);
  }
  fence_regs(dq);
  fence_regs(dk);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) wgmma_ss_n128(s, dq[kk], dk[kk], kk > 0);
  wgmma_commit();
  fence_regs(s);
}

// O (64 x 16 NS) += P (64 x kBK, bf16 A fragments) V (kBK x 16 NS): one
// k-step per 16 keys, all NS slabs of V in one product of width 16 NS,
// committed as one group
template <int NS>
__device__ __forceinline__ void pv_start(float (&o)[8 * NS], uint32_t (&p)[kBK / 4],
                                         uint32_t v) {
  uint64_t dv[kBK / 16];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) dv[kk] = sw32_desc(v + kk * 16 * kRowBytes, kSlabK, 256);
  fence_regs(dv);
  fence_regs(p);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs(o, &p[4 * kk], dv[kk], 1);
  wgmma_commit();
  fence_regs(o);
  fence_regs(p);
}

// The online softmax of one key tile on the S fragment: the mask (on a
// tile that straddles the diagonal or the ragged tail only: a separate
// instantiation, so the others carry no compare; key column c of a row is
// masked when c >= lim, lim already less this lane's first column, and a
// masked score is -1e30, so its scaled logit is as good as -inf), row
// maxima of the raw scores over the quad of lanes that holds a row,
// p = 2^(s c - m c) with c = scale log2(e) in one fused multiply-add, in
// place, this thread's share of the row sums, P packed as bf16 A fragments,
// and alpha, which rescales what was summed under the old maxima.  m is
// kept in raw units.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], uint32_t (&p)[kBK / 4],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const int (&lim)[2], float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    if (kMasked && 8 * (i >> 2) + (i & 1) >= lim[(i >> 1) & 1]) s[i] = kNegInf;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2((m[r] - m_new) * scale_log2);
    m[r] = m_new;
    ms[r] = m_new * scale_log2;
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -ms[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
  pack_bf16(s, p);
}

template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       long long o_sb, long long o_sh, long long o_ss, int heads, int n_bh,
                       int rep, int sq, int skv, int hd, int causal, int q_offset,
                       float scale_log2) {
  using L = Smem<NS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // mbarriers, 8 bytes each: query tile full and empty (2 buffers), then K
  // full and empty, V full and empty (kStages each)
  const uint32_t q_full = base + L::bar, q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16, k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages, v_empty = v_full + 8 * kStages;
  const uint32_t turn = v_empty + 8 * kStages;  // + 8 * consumer warpgroup
  const int nq = (sq + kBQ - 1) / kBQ;
  const int n_work = n_bh * nq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);   // the producer's arrive, then the bytes
      mbar_init(q_empty + 8 * i, 2);  // one arrive per consumer warpgroup
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 2);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, 2);
    }
    for (int w = 0; w < 2; ++w) mbar_init(turn + 8 * w, 4);  // one arrive per warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work tile n of this block, as (batch * heads + head, first query row,
  // key tiles), or false past the end.  Blocks stay resident and walk a
  // list of (batch, head, query tile), each head's heaviest causal tile
  // first, taking its rounds of gridDim.x in turn forwards and backwards so
  // that blocks get about the same number of key tiles.  The blocks of a
  // round cover a few heads whole, so each K and V tile is read from
  // device memory once and then from L2.
  auto work = [&](int n, int& bh, int& q0, int& n_tiles) {
    const int pos = n * (int)gridDim.x +
                    ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
    if (pos >= n_work) return false;
    bh = pos / nq;
    q0 = (nq - 1 - pos % nq) * kBQ;
    int kv_end = skv;
    if (causal) {
      const long long last = (long long)q_offset + min(q0 + kBQ, sq);
      kv_end = (int)(last < skv ? last : skv);
    }
    n_tiles = (kv_end + kBK - 1) / kBK;
    return true;
  };
  // key tile t (counted over all work tiles) lives in stage t % kStages,
  // in the phase of parity (t / kStages) & 1
  auto stage = [](int t) { return t % kStages; };
  auto phase = [](int t) { return (uint32_t)(t / kStages) & 1u; };

  if (wg == 2) {
    // producer: one thread starts every copy, in the order the consumers
    // use them (K of tile j + 1 before V of tile j), running ahead by the
    // rings' depth
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int bh, q0, n_tiles;
      int it = 0;  // key tiles before this work tile
      for (int n = 0; work(n, bh, q0, n_tiles); ++n) {
        const int head = bh % heads, batch = bh / heads, kvh = head / rep;
        const int qb = n & 1;
        mbar_wait(q_empty + 8 * qb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, NS * kSlabQ);
        for (int s = 0; s < NS; ++s)
          tma_load(base + L::q + (qb * NS + s) * kSlabQ, &tq, q_full + 8 * qb, kSlab * s, q0,
                   head, batch);
        for (int j = 0; j <= n_tiles; ++j) {
          if (j < n_tiles) {
            const int t = it + j;
            mbar_wait(k_empty + 8 * stage(t), phase(t) ^ 1);
            mbar_expect_tx(k_full + 8 * stage(t), NS * kSlabK);
            for (int s = 0; s < NS; ++s)
              tma_load(base + L::k + (stage(t) * NS + s) * kSlabK, &tk, k_full + 8 * stage(t),
                       kSlab * s, j * kBK, kvh, batch);
          }
          if (j > 0) {
            const int t = it + j - 1;
            mbar_wait(v_empty + 8 * stage(t), phase(t) ^ 1);
            mbar_expect_tx(v_full + 8 * stage(t), NS * kSlabK);
            for (int s = 0; s < NS; ++s)
              tma_load(base + L::v + (stage(t) * NS + s) * kSlabK, &tv, v_full + 8 * stage(t),
                       kSlab * s, (j - 1) * kBK, kvh, batch);
          }
        }
        it += n_tiles;
      }
    }
  } else {
    // consumers: 64 query rows of each work tile per warpgroup.  S of tile
    // j is computed while P V of tile j - 1 runs; the softmax of tile j
    // overlaps that product, and the accumulator is rescaled once it ends.
    // The two warpgroups take turns to start their products (one turn per
    // key tile and one more per work tile, for both), so that one's
    // products run on the tensor cores while the other computes its softmax.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t128 = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const bool signal = t128 == 0;  // arrives for this warpgroup
    int turns = 0;
    auto turn_begin = [&]() { mbar_wait(turn + 8 * wg, turns & 1); };
    auto turn_end = [&]() {
      if (lane == 0) mbar_arrive(turn + 8 * (1 - wg));
      ++turns;
    };
    if (wg == 1 && lane == 0) mbar_arrive(turn);  // warpgroup 0 goes first
    int bh, q0, n_tiles;
    int it = 0;  // key tiles before this work tile
    for (int n = 0; work(n, bh, q0, n_tiles); ++n) {
      const int head = bh % heads, batch = bh / heads;
      const int qb = n & 1;
      const int wg_row = q0 + 64 * wg;
      const int row = wg_row + frag_row(0, t128);  // and row + 8
      const long long qpos = (long long)q_offset + row;
      const bool live = wg_row < sq;
      const long long pos_lo = (long long)q_offset + wg_row;
      const long long pos_hi = (long long)q_offset + min(wg_row + 63, sq - 1);
      const uint32_t q_s = base + L::q + qb * NS * kSlabQ + 64 * wg * kRowBytes;
      auto k_s = [&](int t) { return base + L::k + stage(t) * NS * kSlabK; };
      auto v_s = [&](int t) { return base + L::v + stage(t) * NS * kSlabK; };
      // key tiles this warpgroup computes: a tile wholly past its last row
      // changes nothing (every row has seen key 0, so its m is real and p
      // is exactly 0 there), and the ones after them are only released
      int n_eff = live ? n_tiles : 0;
      if (causal && live) n_eff = min(n_tiles, (int)(pos_hi / kBK) + 1);

      float acc[8 * NS];
#pragma unroll
      for (int i = 0; i < 8 * NS; ++i) acc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums
      float alpha[2];
      // P of the tile whose P V is pending, in two buffers that swap roles
      // each tile: a copy from one to the other would let the compiler
      // rename registers the pending product still reads, and ptxas would
      // then serialize the wgmmas
      uint32_t pa[kBK / 4], pb[kBK / 4];

      // the softmax of the tile at key k0, masked where the tile straddles
      // the diagonal or the ragged tail
      auto softmax = [&](float (&s)[kBK / 2], uint32_t (&p)[kBK / 4], int k0) {
        if (k0 + kBK > skv || (causal && k0 + kBK - 1 > pos_lo)) {
          int lim[2];  // first masked column of each row, less this lane's
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const long long end = causal ? min((long long)skv, qpos + 8 * r + 1) : skv;
            lim[r] = (int)(end - k0) - 2 * (lane % 4);
          }
          softmax_tile<true>(s, p, m, l, alpha, lim, scale_log2);
        } else {
          const int lim[2] = {0, 0};
          softmax_tile<false>(s, p, m, l, alpha, lim, scale_log2);
        }
      };

      // tile j >= 1: S_j = Q K_j^T is started with P_{j-1} V_{j-1}; the
      // softmax of tile j runs while that product does, and the accumulator
      // is rescaled by the new maxima once it ends
      auto step = [&](int j, uint32_t (&p_prev)[kBK / 4], uint32_t (&p_next)[kBK / 4]) {
        const int t = it + j;
        mbar_wait(k_full + 8 * stage(t), phase(t));
        mbar_wait(v_full + 8 * stage(t - 1), phase(t - 1));
        float s[kBK / 2] = {};
        turn_begin();
        qk_start<NS>(s, q_s, k_s(t));
        pv_start<NS>(acc, p_prev, v_s(t - 1));
        turn_end();
        wgmma_wait<1>();
        fence_regs(s);
        if (signal) mbar_arrive(k_empty + 8 * stage(t));
        softmax(s, p_next, j * kBK);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p_prev);
        if (signal) mbar_arrive(v_empty + 8 * stage(t - 1));
#pragma unroll
        for (int i = 0; i < 8 * NS; ++i) acc[i] *= alpha[(i >> 1) & 1];
      };
      // the last tile's P V
      auto last = [&](uint32_t (&p_last)[kBK / 4]) {
        const int t = it + n_eff - 1;
        mbar_wait(v_full + 8 * stage(t), phase(t));
        turn_begin();
        pv_start<NS>(acc, p_last, v_s(t));
        turn_end();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p_last);
        if (signal) mbar_arrive(v_empty + 8 * stage(t));
      };

      mbar_wait(q_full + 8 * qb, (n >> 1) & 1);
      if (n_eff > 0) {
        mbar_wait(k_full + 8 * stage(it), phase(it));
        float s[kBK / 2] = {};  // not read: the first k-step has scale-d 0
        turn_begin();
        qk_start<NS>(s, q_s, k_s(it));
        turn_end();
        wgmma_wait<0>();
        fence_regs(s);
        if (signal) mbar_arrive(k_empty + 8 * stage(it));
        softmax(s, pa, 0);
        int j = 1;
        for (; j + 1 < n_eff; j += 2) {
          step(j, pa, pb);
          step(j + 1, pb, pa);
        }
        if (j < n_eff) {
          step(j, pa, pb);
          last(pb);
        } else {
          last(pa);
        }
      }
      for (int j = n_eff; j < n_tiles; ++j) {
        const int t = it + j;
        mbar_wait(k_full + 8 * stage(t), phase(t));
        mbar_wait(v_full + 8 * stage(t), phase(t));
        turn_begin();  // a turn with nothing to start
        turn_end();
        if (signal) {
          mbar_arrive(k_empty + 8 * stage(t));
          mbar_arrive(v_empty + 8 * stage(t));
        }
      }
      if (n_eff == 0) {  // the turn of the last P V
        turn_begin();
        turn_end();
      }
      it += n_tiles;
      if (signal) mbar_arrive(q_empty + 8 * qb);  // this warpgroup is done with the query tile

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      if (live) {
        __nv_bfloat16* ob = o + batch * o_sb + head * o_sh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = row + 8 * r;
          if (rr >= sq) continue;
          const float inv = 1.f / fmaxf(l[r], 1e-30f);  // one division per row
          __nv_bfloat16* orow = ob + (long long)rr * o_ss;
#pragma unroll
          for (int c = 0; c < 2 * NS; ++c) {
            const int col = 8 * c + 2 * (lane % 4);
            if (col < hd)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                  acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
          }
        }
      }
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(128)
flash_attention_probe_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, float* __restrict__ s_out,
                             float* __restrict__ o_out) {
  using L = Smem<NS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::bar;
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, NS * (kSlabQ + 2 * kSlabK));
    for (int s = 0; s < NS; ++s) {
      tma_load(base + L::q + s * kSlabQ, &tq, bar, kSlab * s, 0, 0, 0);
      tma_load(base + L::k + s * kSlabK, &tk, bar, kSlab * s, 0, 0, 0);
      tma_load(base + L::v + s * kSlabK, &tv, bar, kSlab * s, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float s[kBK / 2] = {};  // not read: the first k-step has scale-d 0
  qk_start<NS>(s, base + L::q, base + L::k);
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s_out[frag_row(i, t) * kBK + frag_col(i, t)] = s[i];
  uint32_t p[kBK / 4];
  pack_bf16(s, p);
  float acc[8 * NS];
#pragma unroll
  for (int i = 0; i < 8 * NS; ++i) acc[i] = 0.f;
  pv_start<NS>(acc, p, base + L::v);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(p);
#pragma unroll
  for (int i = 0; i < 8 * NS; ++i) o_out[frag_row(i, t) * 16 * NS + frag_col(i, t)] = acc[i];
}


template <int NS>
int launch_bf16(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
                const long long* so, int b, int h, int rep, int sq, int skv, int hd, int causal,
                int q_offset, float scale, cudaStream_t stream) {
  const int smem = Smem<NS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long work = (long long)b * h * ((sq + kBQ - 1) / kBQ);
  if (work > 0x7fffffffLL) return cudaErrorInvalidValue;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int blocks = (int)(work < sms ? work : sms);  // one resident block per SM
  flash_attention_kernel<NS><<<blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so[0], so[1], so[2], h, b * h, rep, sq, skv,
      hd, causal, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

template <int NS>
int launch_probe(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                 float* s_out, float* o_out, cudaStream_t stream) {
  const int smem = Smem<NS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_probe_kernel<NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_attention_probe_kernel<NS><<<1, 128, smem, stream>>>(tq, tk, tv, s_out, o_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 int64 (batch, head, seq) strides of q, k, v, o, in elements.
// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it).  bfloat16 needs
// hd % 8 == 0, 16-byte aligned q, k and v and strides of a multiple of 16
// bytes (the TMA's terms); the wrapper checks them before it calls.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const long long* strides, int b, int h, int kvh, int sq,
                           int skv, int hd, int dtype, int causal, int q_offset,
                           float scale, void* stream) {
  if (b == 0 || h == 0 || sq == 0) return cudaSuccess;
  if (kvh <= 0 || h % kvh != 0 || skv <= 0 || hd <= 0 || hd > 128 || q_offset < 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int rep = h / kvh;
  if (dtype == 0) {
    Strides st;
    for (int i = 0; i < 3; ++i) {
      st.q[i] = strides[i];
      st.k[i] = strides[3 + i];
      st.v[i] = strides[6 + i];
      st.o[i] = strides[9 + i];
    }
    return dispatch_fp32(q, k, v, o, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
  }
  if (dtype != 1 || hd % 8 != 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, hd, sq, h, b, strides, kBQ);
  if (err == cudaSuccess) err = encode_map(&tk, k, hd, skv, kvh, b, strides + 3, kBK);
  if (err == cudaSuccess) err = encode_map(&tv, v, hd, skv, kvh, b, strides + 6, kBK);
  if (err != cudaSuccess) return err;
#define REPRO_FA16(NS) \
  case NS: return launch_bf16<NS>(tq, tk, tv, o, strides + 9, b, h, rep, sq, skv, hd, causal, q_offset, scale, s)
  switch ((hd + kSlab - 1) / kSlab) {
    REPRO_FA16(1); REPRO_FA16(2); REPRO_FA16(3); REPRO_FA16(4);
    REPRO_FA16(5); REPRO_FA16(6); REPRO_FA16(7); REPRO_FA16(8);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FA16
}

// The fragment-layout check: q (64, hd), k and v (128, hd) contiguous bf16
// -> s_out (64, 128) = q k^T and o_out (64, 16 ceil(hd / 16)) = bf16(s) v,
// both fp32, each register written where the bf16 kernel assumes it lies.
int flash_attention_probe_launch(const void* q, const void* k, const void* v, float* s_out,
                                 float* o_out, int hd, void* stream) {
  if (hd <= 0 || hd > 128 || hd % 8 != 0) return cudaErrorInvalidValue;
  const long long sq_[3] = {64LL * hd, 64LL * hd, hd};
  const long long skv_[3] = {128LL * hd, 128LL * hd, hd};
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, hd, 64, 1, 1, sq_, kBQ);
  if (err == cudaSuccess) err = encode_map(&tk, k, hd, kBK, 1, 1, skv_, kBK);
  if (err == cudaSuccess) err = encode_map(&tv, v, hd, kBK, 1, 1, skv_, kBK);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_PROBE(NS) case NS: return launch_probe<NS>(tq, tk, tv, s_out, o_out, s)
  switch ((hd + kSlab - 1) / kSlab) {
    REPRO_PROBE(1); REPRO_PROBE(2); REPRO_PROBE(3); REPRO_PROBE(4);
    REPRO_PROBE(5); REPRO_PROBE(6); REPRO_PROBE(7); REPRO_PROBE(8);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PROBE
}

}  // extern "C"
