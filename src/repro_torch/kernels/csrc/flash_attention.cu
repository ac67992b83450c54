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
// Both forward kernels also write, when given a pointer, each query row's
// log-sum-exp of its scaled, masked logits (fp32, (b, h, sq)): m + log l.
//
// The backward (flash_attention_bwd_launch) replaces no TPU kernel: the
// JAX package differentiates its jnp attention and defines no gradient for
// its Pallas kernel, while the port's attention always launches the kernel
// on the card, so training needs this one.  Given q, k, v, o, do and the
// forward's lse, with P = exp(scale q k^T - lse) (masked entries 0) and
// D = rowsum(do o): dV = P^T do and dK = scale dS^T q summed over the query
// heads of a KV group, dS = P (do v^T - D), dQ = scale dS k.  FA2's split,
// three launches, no atomics: every output element is written by one block
// and summed in a fixed order, so the result is the same from run to run.
// Bound on this card: about 2.5x the forward's products (5 matrix products
// against 2), 172 GFLOP at qwen3-32b's training shape (b 4, h 64, kv 8,
// s 1024, hd 128, causal), 0.174 ms at 989 TFLOP/s bf16; the split
// recomputes S and dP in both passes (7 products, 241 GFLOP, 0.243 ms).
//   flash_attention_bwd_dot_kernel: D, one warp a query row (both dtypes;
//     for bf16 it also writes lse log2(e), both in rows padded to 64 with
//     zeros, so that a 64-row tile of them is one 256-byte bulk copy).
// bf16, on the tensor cores, in the forward's structure (one resident block
// of three warpgroups per SM walking a list of work tiles, the heaviest
// causal tile first; warpgroup 2 the producer, starting every TMA copy and
// giving its registers away; warpgroups 0 and 1 consumers of 64 rows each):
//   flash_attention_bwd_dkdv_bf16_kernel: a work tile is 128 keys of one
//     (batch, KV head), K and V loaded once (two buffers, so the next tile's
//     load overlaps this one's end); the producer streams Q, dO, lse log2(e)
//     and D of every 64-row query tile of every query head of the group that
//     the causal mask lets see the keys through a two-stage ring.  Each
//     consumer computes S^T = K_wg Q^T and dP^T = V_wg dO^T (wgmma, both
//     operands K-major in shared memory), P^T = 2^(S^T scale log2(e) - lse
//     log2(e)) and dS^T = P^T (dP^T - D) in the accumulator fragment (lse and
//     D by the fragment's column; the mask only on tiles that straddle the
//     diagonal or a ragged tail), packs both to bf16 A fragments in
//     registers, and runs dV += P^T dO and dK += dS^T Q from them (Q and dO
//     read MN-major from the same tiles).  dK scale and dV are written once.
//   flash_attention_bwd_dq_bf16_kernel: a work tile is 128 query rows of one
//     (batch, head), Q and dO in two buffers; K and V tiles of 64 keys
//     stream through a two-stage ring.  Each consumer computes S = Q_wg K^T
//     and dP = dO_wg V^T, P and dS in the fragment (lse and D by row), then
//     dQ += dS K (K MN-major); dQ scale is written once.
// fp32 keeps the first design, on the CUDA cores (any hd up to 128): 256
// threads, each 4 x 4 of the S and dP tiles and 4 x hd/16 of the
// accumulators, the operands staged in shared memory as fp32 with odd row
// strides:
//   flash_attention_bwd_dkdv_kernel: one block per (64-key tile, KV head,
//     batch), K and V resident, walking the 64-row query tiles of every
//     query head of its group that the causal mask lets see the tile;
//   flash_attention_bwd_dq_kernel: one block per (64-query tile, head,
//     batch), walking the key tiles the tile can see.
//
// flash_attention_probe_kernel checks, on the card, the fragment layouts
// the bf16 kernel rests on: one warpgroup computes S = Q K^T and then
// bf16(S) V with the same loads, descriptors and products, and writes each
// accumulator register where the kernel assumes its row and column to be.
// flash_attention_bwd_probe_kernel does the same for the bf16 backward's
// four operand uses: two warpgroups compute S^T = K_wg Q^T and dP^T =
// V_wg dO^T (K and V as A from a 128-row tile, Q and dO as n64 K-major B),
// then bf16(S^T) dO and bf16(dP^T) Q (dO and Q as MN-major B under a
// register A); the dQ kernel's products take the same layouts.

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
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, Strides st, int rep, int sq, int skv,
                            int hd, int causal, int q_offset, float scale) {
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
    // the row's log-sum-exp of the scaled logits (m is in scaled units here)
    if (lse != nullptr && tx == 0) lse[(bb * gridDim.y + hh) * sq + row] = m[i] + logf(den);
  }
}

template <int DPT>
int launch_fp32(const float* q, const float* k, const float* v, float* o, float* lse,
                const Strides& st, int b, int h, int rep, int sq, int skv, int hd, int causal,
                int q_offset, float scale, cudaStream_t stream) {
  const int smem = smem_floats<DPT>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fp32_kernel<DPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ32 - 1) / kBQ32, h, b);
  flash_attention_fp32_kernel<DPT><<<grid, kThreads32, smem, stream>>>(
      q, k, v, o, lse, st, rep, sq, skv, hd, causal, q_offset, scale);
  return cudaGetLastError();
}

int dispatch_fp32(const void* q, const void* k, const void* v, void* o, float* lse,
                  const Strides& st, int b, int h, int rep, int sq, int skv, int hd, int causal,
                  int q_offset, float scale, cudaStream_t s) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  float* o_ = static_cast<float*>(o);
#define REPRO_FA32(DPT) \
  case DPT: return launch_fp32<DPT>(q_, k_, v_, o_, lse, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s)
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

// kLse: also write each row's log-sum-exp (the training path's
// instantiation; serving's, without it, is the kernel as it was before the
// backward existed)
template <int NS, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, long long o_sb, long long o_sh, long long o_ss,
                       int heads, int n_bh,
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
        // with no wgmma to hold them in step, this warpgroup's warps meet
        // before the tile is released: a warp that lagged past the release
        // would find the stage reloaded twice (kStages on, the same parity),
        // wait for a load that needs its own turn, and trap (a warpgroup
        // past the sequence's end skips every tile: sq % 128 in 1..64)
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
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
          // the row's log-sum-exp of the scaled logits: m is in raw units and
          // l sums 2^(s c - m c), so lse = (m c + log2 l) ln 2
          if (kLse && lane % 4 == 0)
            lse[(long long)bh * sq + rr] =
                (m[r] * scale_log2 + __log2f(fmaxf(l[r], 1e-30f))) * 0.69314718055994531f;
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


template <int NS, bool kLse>
int launch_bf16(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
                float* lse, const long long* so, int b, int h, int rep, int sq, int skv, int hd,
                int causal, int q_offset, float scale, cudaStream_t stream) {
  const int smem = Smem<NS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<NS, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long work = (long long)b * h * ((sq + kBQ - 1) / kBQ);
  if (work > 0x7fffffffLL) return cudaErrorInvalidValue;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int blocks = (int)(work < sms ? work : sms);  // one resident block per SM
  flash_attention_kernel<NS, kLse><<<blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, so[0], so[1], so[2], h, b * h, rep, sq, skv,
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

// ---------------------------------------------------------------------------
// Backward: D for both dtypes; the fp32 kernels on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBQb = 64;  // query rows of a tile
constexpr int kBKb = 64;  // keys of a tile

// (batch, head, seq) strides in elements of q, k, v, o, do, dq, dk and dv
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// rows x HDP columns of a (seq, hd) slice into shared memory as fp32, row
// stride RS; rows past n and columns past hd are zero
template <typename T, int HDP, int RS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride, int r0,
                                          int rows, int n, int hd) {
  for (int idx = threadIdx.x; idx < rows * HDP; idx += kBwdThreads) {
    const int r = idx / HDP;
    const int d = idx - r * HDP;
    float val = 0.f;
    if (r0 + r < n && d < hd) val = to_f32(src[(long long)(r0 + r) * stride + d]);
    dst[r * RS + d] = val;
  }
}

// D_i = do_i . o_i for every (batch, head, query row), one warp a row, in
// rows of sq_pad (row i of (batch, head) bh at bh sq_pad + i); with lse2,
// also lse log2(e) there, and both 0 in the rows from sq to sq_pad
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                               float* __restrict__ D, BwdStrides st, int h, int sq, int hd,
                               long long n_rows, int sq_pad, const float* __restrict__ lse,
                               float* __restrict__ lse2) {
  const long long row = (long long)blockIdx.x * (kBwdThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const long long s = row % sq_pad, bh = row / sq_pad;
  if (s >= sq) {  // padding (bf16 only)
    if (lane == 0) D[row] = lse2[row] = 0.f;
    return;
  }
  const long long hh = bh % h, bb = bh / h;
  const T* orow = o + bb * st.o[0] + hh * st.o[1] + s * st.o[2];
  const T* drow = dout + bb * st.dout[0] + hh * st.dout[1] + s * st.dout[2];
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    D[row] = acc;
    if (lse2 != nullptr) lse2[row] = lse[bh * sq + s] * kLog2e;
  }
}

// S = Q K^T and dP = dO V^T of one (query tile, key tile) pair: each
// thread 4 query rows (ty + 16 i) by 4 keys (tx + 16 j); P = exp(scale S -
// lse) with masked entries 0 and dS = P (dP - D) go to shared memory
template <int HDP, int RS, int PS>
__device__ __forceinline__ void p_ds_tile(const float* Qs, const float* dOs, const float* Ks,
                                          const float* Vs, const float* Ls, const float* Ds,
                                          float* Ps, float* dSs, int q0, int k0, int sq,
                                          int skv, int causal, int q_offset, float scale) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float qa[4], da[4], ka[4], va[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(ty + 16 * i) * RS + d];
      da[i] = dOs[(ty + 16 * i) * RS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ka[j] = Ks[(tx + 16 * j) * RS + d];
      va[j] = Vs[(tx + 16 * j) * RS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const long long qpos = (long long)q_offset + q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool ok = q0 + r < sq && k0 + c < skv && (!causal || qpos >= k0 + c);
      const float p = ok ? expf(fmaf(s[i][j], scale, -Ls[r])) : 0.f;
      if (Ps != nullptr) Ps[r * PS + c] = p;
      dSs[r * PS + c] = p * (dp[i][j] - Ds[r]);
    }
  }
}

// dK and dV of one key tile of one KV head: the block walks the query tiles
// of every query head of its group that can see the tile, with the key and
// value tiles resident; dV += P^T dO and dK += scale dS^T Q in registers
// (4 keys by DPT columns a thread), written once at the end
template <typename T, int DPT>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ D,
                                T* __restrict__ dk, T* __restrict__ dv, BwdStrides st, int h,
                                int rep, int sq, int skv, int hd, int causal, int q_offset,
                                float scale) {
  constexpr int HDP = DPT * 16;
  constexpr int RS = HDP + 1;  // odd row strides: a warp's column reads hit distinct banks
  constexpr int PS = kBKb + 1;
  extern __shared__ float smem[];
  float* Ks = smem;             // [kBKb][RS]
  float* Vs = Ks + kBKb * RS;   // [kBKb][RS]
  float* Qs = Vs + kBKb * RS;   // [kBQb][RS]
  float* dOs = Qs + kBQb * RS;  // [kBQb][RS]
  float* Ps = dOs + kBQb * RS;  // [kBQb][PS]
  float* dSs = Ps + kBQb * PS;  // [kBQb][PS]
  float* Ls = dSs + kBQb * PS;  // [kBQb]
  float* Ds = Ls + kBQb;        // [kBQb]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBKb;
  const long long kh = blockIdx.y, bb = blockIdx.z;

  load_tile<T, HDP, RS>(Ks, k + bb * st.k[0] + kh * st.k[1], st.k[2], k0, kBKb, skv, hd);
  load_tile<T, HDP, RS>(Vs, v + bb * st.v[0] + kh * st.v[1], st.v[2], k0, kBKb, skv, hd);
  float adk[4][DPT], adv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adk[i][j] = adv[i][j] = 0.f;

  // under the causal mask, query rows before k0 - q_offset see no key here
  int q_first = 0;
  if (causal && k0 > q_offset) q_first = (k0 - q_offset) / kBQb * kBQb;
  for (int hi = 0; hi < rep; ++hi) {
    const long long hh = kh * rep + hi;
    const T* qb = q + bb * st.q[0] + hh * st.q[1];
    const T* db = dout + bb * st.dout[0] + hh * st.dout[1];
    const float* lb = lse + (bb * h + hh) * sq;
    const float* Db = D + (bb * h + hh) * sq;
    for (int q0 = q_first; q0 < sq; q0 += kBQb) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      load_tile<T, HDP, RS>(Qs, qb, st.q[2], q0, kBQb, sq, hd);
      load_tile<T, HDP, RS>(dOs, db, st.dout[2], q0, kBQb, sq, hd);
      if (threadIdx.x < kBQb) {
        const int r = q0 + threadIdx.x;
        Ls[threadIdx.x] = r < sq ? lb[r] : 0.f;
        Ds[threadIdx.x] = r < sq ? Db[r] : 0.f;
      }
      __syncthreads();
      p_ds_tile<HDP, RS, PS>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, sq, skv, causal,
                             q_offset, scale);
      __syncthreads();
      const int r_end = min(kBQb, sq - q0);  // rows past sq have P = dS = 0
      for (int r = 0; r < r_end; ++r) {
        float pa[4], sa[4], da[DPT], qa[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[r * PS + ty + 16 * i];
          sa[i] = dSs[r * PS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          da[j] = dOs[r * RS + tx + 16 * j];
          qa[j] = Qs[r * RS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            adv[i][j] = fmaf(pa[i], da[j], adv[i][j]);
            adk[i][j] = fmaf(sa[i], qa[j], adk[i][j]);
          }
      }
    }
  }
  T* dkb = dk + bb * st.dk[0] + kh * st.dk[1];
  T* dvb = dv + bb * st.dv[0] + kh * st.dv[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= skv) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dkb[(long long)key * st.dk[2] + d] = from_f32<T>(adk[i][j] * scale);
        dvb[(long long)key * st.dv[2] + d] = from_f32<T>(adv[i][j]);
      }
    }
  }
}

// dQ of one query tile of one head: the block walks the key tiles the tile
// can see; dQ += scale dS K in registers (4 rows by DPT columns a thread)
template <typename T, int DPT>
__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ D,
                              T* __restrict__ dq, BwdStrides st, int h, int rep, int sq, int skv,
                              int hd, int causal, int q_offset, float scale) {
  constexpr int HDP = DPT * 16;
  constexpr int RS = HDP + 1;
  constexpr int PS = kBKb + 1;
  extern __shared__ float smem[];
  float* Ks = smem;             // [kBKb][RS]
  float* Vs = Ks + kBKb * RS;   // [kBKb][RS]
  float* Qs = Vs + kBKb * RS;   // [kBQb][RS]
  float* dOs = Qs + kBQb * RS;  // [kBQb][RS]
  float* dSs = dOs + kBQb * RS; // [kBQb][PS]
  float* Ls = dSs + kBQb * PS;  // [kBQb]
  float* Ds = Ls + kBQb;        // [kBQb]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQb;
  const long long hh = blockIdx.y, bb = blockIdx.z;
  const long long kh = hh / rep;

  load_tile<T, HDP, RS>(Qs, q + bb * st.q[0] + hh * st.q[1], st.q[2], q0, kBQb, sq, hd);
  load_tile<T, HDP, RS>(dOs, dout + bb * st.dout[0] + hh * st.dout[1], st.dout[2], q0, kBQb,
                        sq, hd);
  if (threadIdx.x < kBQb) {
    const int r = q0 + threadIdx.x;
    Ls[threadIdx.x] = r < sq ? lse[(bb * h + hh) * sq + r] : 0.f;
    Ds[threadIdx.x] = r < sq ? D[(bb * h + hh) * sq + r] : 0.f;
  }
  float adq[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) adq[i][j] = 0.f;

  int kv_end = skv;  // keys past the tile's last query are masked for all its rows
  if (causal) {
    const long long last = (long long)q_offset + min(q0 + kBQb, sq);
    kv_end = (int)(last < skv ? last : skv);
  }
  const T* kb = k + bb * st.k[0] + kh * st.k[1];
  const T* vb = v + bb * st.v[0] + kh * st.v[1];
  for (int k0 = 0; k0 < kv_end; k0 += kBKb) {
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tile<T, HDP, RS>(Ks, kb, st.k[2], k0, kBKb, skv, hd);
    load_tile<T, HDP, RS>(Vs, vb, st.v[2], k0, kBKb, skv, hd);
    __syncthreads();
    p_ds_tile<HDP, RS, PS>(Qs, dOs, Ks, Vs, Ls, Ds, nullptr, dSs, q0, k0, sq, skv, causal,
                           q_offset, scale);
    __syncthreads();
    const int c_end = min(kBKb, skv - k0);  // keys past skv have dS = 0
    for (int c = 0; c < c_end; ++c) {
      float sa[4], ka[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) ka[j] = Ks[c * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) adq[i][j] = fmaf(sa[i], ka[j], adq[i][j]);
    }
  }
  T* dqb = dq + bb * st.dq[0] + hh * st.dq[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dqb[(long long)row * st.dq[2] + d] = from_f32<T>(adq[i][j] * scale);
    }
  }
}

template <int DPT>
constexpr int bwd_smem_bytes(bool dkdv) {
  return (int)sizeof(float) *
         ((kBKb + kBKb + kBQb + kBQb) * (DPT * 16 + 1) + (dkdv ? 2 : 1) * kBQb * (kBKb + 1) +
          2 * kBQb);
}

template <typename T, int DPT>
int launch_bwd(const T* q, const T* k, const T* v, const T* o, const T* dout, const float* lse,
               float* D, T* dq, T* dk, T* dv, const BwdStrides& st, int b, int h, int kvh,
               int sq, int skv, int hd, int causal, int q_offset, float scale,
               cudaStream_t stream) {
  const int rep = h / kvh;
  const long long n_rows = (long long)b * h * sq;
  const int rows_per_block = kBwdThreads / 32;
  const long long dot_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (dot_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_bwd_dot_kernel<T><<<(unsigned)dot_blocks, kBwdThreads, 0, stream>>>(
      o, dout, D, st, h, sq, hd, n_rows, sq, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem_kv = bwd_smem_bytes<DPT>(true);
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, DPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_kernel<T, DPT>
      <<<dim3((skv + kBKb - 1) / kBKb, kvh, b), kBwdThreads, smem_kv, stream>>>(
          q, k, v, dout, lse, D, dk, dv, st, h, rep, sq, skv, hd, causal, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem_q = bwd_smem_bytes<DPT>(false);
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, DPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq_kernel<T, DPT>
      <<<dim3((sq + kBQb - 1) / kBQb, h, b), kBwdThreads, smem_q, stream>>>(
          q, k, v, dout, lse, D, dq, st, h, rep, sq, skv, hd, causal, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, float* D, void* dq, void* dk, void* dv, const BwdStrides& st,
                 int b, int h, int kvh, int sq, int skv, int hd, int causal, int q_offset,
                 float scale, cudaStream_t s) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* d_ = static_cast<const T*>(dout);
  T* dq_ = static_cast<T*>(dq);
  T* dk_ = static_cast<T*>(dk);
  T* dv_ = static_cast<T*>(dv);
#define REPRO_FAB(DPT)                                                                   \
  case DPT:                                                                               \
    return launch_bwd<T, DPT>(q_, k_, v_, o_, d_, lse, D, dq_, dk_, dv_, st, b, h, kvh, sq, \
                              skv, hd, causal, q_offset, scale, s)
  switch ((hd + 15) / 16) {
    REPRO_FAB(1); REPRO_FAB(2); REPRO_FAB(3); REPRO_FAB(4);
    REPRO_FAB(5); REPRO_FAB(6); REPRO_FAB(7); REPRO_FAB(8);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FAB
}

// ---------------------------------------------------------------------------
// Backward, bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBN = 128;     // keys of a dK/dV work tile, query rows of a dQ work tile
constexpr int kBT = 64;      // query rows of a tile streamed to dK/dV, keys of one streamed to dQ
constexpr int kBStages = 2;  // depth of the streamed ring
constexpr int kSlabN = kBN * kRowBytes;  // one slab of a 128-row tile, 4 KB
constexpr int kSlabT = kBT * kRowBytes;  // one slab of a 64-row tile, 2 KB
constexpr int kRowPad = 64;  // D and lse log2(e) rows are padded to a multiple of this

// dK/dV: byte offsets from a 1024-aligned base; NS = slabs of 16 head-dim columns
template <int NS>
struct SmemKV {
  static constexpr int kv = 0;                                // + buffer * 2 NS kSlabN: K, then V
  static constexpr int q = 2 * 2 * NS * kSlabN;               // + stage * 2 NS kSlabT: Q, then dO
  static constexpr int rows = q + kBStages * 2 * NS * kSlabT; // + stage * 512: lse log2(e), then D
  static constexpr int bar = rows + kBStages * 2 * kBT * 4;
  static constexpr int bytes = bar + 8 * (4 + 2 * kBStages) + 1024;  // + alignment slack
};

// dQ
template <int NS>
struct SmemQ {
  static constexpr int q = 0;                          // + buffer * 2 NS kSlabN: Q, then dO
  static constexpr int kv = 2 * 2 * NS * kSlabN;       // + stage * 2 NS kSlabT: K, then V
  static constexpr int bar = kv + kBStages * 2 * NS * kSlabT;
  static constexpr int bytes = bar + 8 * (4 + 2 * kBStages) + 1024;
};

// C (64 x 64, fp32) = A B^T, A and B 64 rows x 16 NS columns in shared
// memory, both K-major (A's slabs a_slab bytes apart, B's kSlabT): one
// k-step per slab, committed as one group
template <int NS>
__device__ __forceinline__ void mma_abt(float (&c)[32], uint32_t a, int a_slab, uint32_t b) {
  uint64_t da[NS], db[NS];
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    da[kk] = sw32_desc(a + kk * a_slab, 16, 256);
    db[kk] = sw32_desc(b + kk * kSlabT, 16, 256);
  }
  fence_regs(da);
  fence_regs(db);
  fence_regs(c);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) wgmma_ss_n64(c, da[kk], db[kk], kk > 0);
  wgmma_commit();
  fence_regs(c);
}

// C (64 x 16 NS, fp32) += A B, A 64 x 64 as bf16 A fragments in registers
// (4 k-steps of 16), B 64 rows (the k dimension) x 16 NS columns in shared
// memory, MN-major (slabs kSlabT apart), all NS slabs in one product of
// width 16 NS per k-step, committed as one group
template <int NS>
__device__ __forceinline__ void mma_rs(float (&c)[8 * NS], uint32_t (&a)[16], uint32_t b) {
  uint64_t db[kBT / 16];
#pragma unroll
  for (int kk = 0; kk < kBT / 16; ++kk) db[kk] = sw32_desc(b + kk * 16 * kRowBytes, kSlabT, 256);
  fence_regs(db);
  fence_regs(a);
  fence_regs(c);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBT / 16; ++kk) wgmma_rs(c, &a[4 * kk], db[kk], 1);
  wgmma_commit();
  fence_regs(c);
}

// P^T and dS^T of a 64-key x 64-query tile in the fragment (row = key,
// column = query), in place of S^T and dP^T: lse2 and d are the tile's 64
// rows of lse log2(e) and D in shared memory.  kMasked: column c (counted
// from this lane's first) of fragment row half r is masked, P = 0, when c <
// lo[r] or c >= hi.  Then P^T and dS^T are packed as bf16 A fragments.
template <bool kMasked>
__device__ __forceinline__ void p_ds_cols(float (&s)[32], float (&dp)[32], uint32_t (&pf)[16],
                                          uint32_t (&dsf)[16], const float* lse2,
                                          const float* d, int lane, const int (&lo)[2], int hi,
                                          float scale_log2) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * jj + 2 * (lane % 4));
    const float2 dd = *reinterpret_cast<const float2*>(d + 8 * jj + 2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // register 4 jj + e: row half e / 2, column 8 jj + e % 2
      const int i = 4 * jj + e;
      float p = ex2(fmaf(s[i], scale_log2, -((e & 1) ? l.y : l.x)));
      if (kMasked) {
        const int c = 8 * jj + (e & 1);
        if (c < lo[e >> 1] || c >= hi) p = 0.f;
      }
      s[i] = p;
      dp[i] = p * (dp[i] - ((e & 1) ? dd.y : dd.x));
    }
  }
  pack_bf16(s, pf);
  pack_bf16(dp, dsf);
}

// dS of a 64-query x 64-key tile in the fragment (row = query, column =
// key), in place of dP, from S: lse2 and d of this thread's two rows.
// kMasked: column c (from this lane's first) of row half r is masked when
// c >= lim[r].  Then dS is packed as bf16 A fragments.
template <bool kMasked>
__device__ __forceinline__ void p_ds_rows(const float (&s)[32], float (&dp)[32],
                                          uint32_t (&dsf)[16], const float (&lse2)[2],
                                          const float (&d)[2], const int (&lim)[2],
                                          float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(fmaf(s[i], scale_log2, -lse2[r]));
    if (kMasked && 8 * (i >> 2) + (i & 1) >= lim[r]) p = 0.f;
    dp[i] = p * (dp[i] - d[r]);
  }
  pack_bf16(dp, dsf);
}

// this warpgroup's 128 threads meet (named barrier 1 + wg): before a
// release with no wgmma to hold its warps in step, so that no warp lags
// past a stage that is reloaded (see flash_attention_kernel's skip loop)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// the accumulator (64 rows x 16 NS, fp32) times `mul` as bf16 rows of a
// (b, heads, seq, hd) tensor at ob (this head's base, row stride os), rows
// from row0 (this thread's first; and row0 + 8) below n, columns below hd
template <int NS>
__device__ __forceinline__ void store_rows(const float (&acc)[8 * NS], __nv_bfloat16* ob,
                                           long long os, int row0, int n, int hd, float mul,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row0 + 8 * r;
    if (rr >= n) continue;
    __nv_bfloat16* orow = ob + (long long)rr * os;
#pragma unroll
    for (int c = 0; c < 2 * NS; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const float* __restrict__ lse2, const float* __restrict__ D,
                                     __nv_bfloat16* __restrict__ dk,
                                     __nv_bfloat16* __restrict__ dv, BwdStrides ost, int h,
                                     int kvh, int n_bkv, int rep, int sq,
                                     int sq_pad, int skv, int hd, int causal, int q_offset,
                                     float scale, float scale_log2) {
  using L = SmemKV<NS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - smem_addr(smem_raw));
  // mbarriers: K/V full and empty (2 buffers), then the ring's full and empty
  const uint32_t kv_full = base + L::bar, kv_empty = kv_full + 16;
  const uint32_t full = kv_empty + 16, empty = full + 8 * kBStages;
  const int nkt = (skv + kBN - 1) / kBN;
  const int n_work = n_bkv * nkt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full + 8 * i, 1);   // the producer's arrive, then the bytes
      mbar_init(kv_empty + 8 * i, 2);  // one arrive per consumer warpgroup
    }
    for (int st = 0; st < kBStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work tile n of this block as (batch * kvh + KV head, first key, first
  // query row, query tiles per head), or false past the end.  The list is
  // key-tile-major, the first key tiles (under the causal mask the ones the
  // most query rows see) first; blocks take its rounds of gridDim.x forwards
  // and backwards in turn, as the forward does.
  auto work = [&](int n, int& g, int& k0, int& q_first, int& n_qt) {
    const int pos = n * (int)gridDim.x +
                    ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
    if (pos >= n_work) return false;
    g = pos % n_bkv;
    k0 = (pos / n_bkv) * kBN;
    q_first = 0;
    if (causal && k0 > q_offset) q_first = (k0 - q_offset) / kBT * kBT;  // rows before see no key
    n_qt = q_first < sq ? (sq - q_first + kBT - 1) / kBT : 0;
    return true;
  };

  if (wg == 2) {
    // producer: K and V of each work tile, then every (head, query tile) of
    // it in the order the consumers take them, running ahead by the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int g, k0, q_first, n_qt;
      int it = 0;  // query tiles before this work tile
      for (int n = 0; work(n, g, k0, q_first, n_qt); ++n) {
        const int batch = g / kvh, kh = g % kvh;
        const int kb = n & 1;
        mbar_wait(kv_empty + 8 * kb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(kv_full + 8 * kb, 2 * NS * kSlabN);
        const uint32_t kv_s = base + L::kv + kb * 2 * NS * kSlabN;
        for (int s = 0; s < NS; ++s) {
          tma_load(kv_s + s * kSlabN, &tk, kv_full + 8 * kb, kSlab * s, k0, kh, batch);
          tma_load(kv_s + (NS + s) * kSlabN, &tv, kv_full + 8 * kb, kSlab * s, k0, kh, batch);
        }
        for (int hi = 0; hi < rep; ++hi) {
          const int head = kh * rep + hi;
          const long long row0 = ((long long)batch * h + head) * sq_pad;
          for (int j = 0; j < n_qt; ++j, ++it) {
            const int q0 = q_first + j * kBT;
            const int st = it % kBStages;
            mbar_wait(empty + 8 * st, ((it / kBStages) & 1) ^ 1);
            const uint32_t fb = full + 8 * st;
            mbar_expect_tx(fb, 2 * NS * kSlabT + 2 * kBT * 4);
            const uint32_t q_s = base + L::q + st * 2 * NS * kSlabT;
            for (int s = 0; s < NS; ++s) {
              tma_load(q_s + s * kSlabT, &tq, fb, kSlab * s, q0, head, batch);
              tma_load(q_s + (NS + s) * kSlabT, &tdo, fb, kSlab * s, q0, head, batch);
            }
            const uint32_t r_s = base + L::rows + st * 2 * kBT * 4;
            bulk_load(r_s, lse2 + row0 + q0, kBT * 4, fb);
            bulk_load(r_s + kBT * 4, D + row0 + q0, kBT * 4, fb);
          }
        }
      }
    }
  } else {
    // consumers: 64 keys of each work tile per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t128 = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const bool signal = t128 == 0;  // arrives for this warpgroup
    int g, k0, q_first, n_qt;
    int it = 0;
    for (int n = 0; work(n, g, k0, q_first, n_qt); ++n) {
      const int batch = g / kvh, kh = g % kvh;
      const int kb = n & 1;
      const int kw = k0 + 64 * wg;                 // this warpgroup's first key
      const int key = kw + frag_row(0, t128);      // this thread's keys: key, key + 8
      const uint32_t k_s = base + L::kv + kb * 2 * NS * kSlabN + 64 * wg * kRowBytes;
      const uint32_t v_s = k_s + NS * kSlabN;
      float adk[8 * NS], adv[8 * NS];
#pragma unroll
      for (int i = 0; i < 8 * NS; ++i) adk[i] = adv[i] = 0.f;
      mbar_wait(kv_full + 8 * kb, (n >> 1) & 1);
      for (int hi = 0; hi < rep; ++hi) {
        for (int j = 0; j < n_qt; ++j, ++it) {
          const int q0 = q_first + j * kBT;
          const int st = it % kBStages;
          mbar_wait(full + 8 * st, (it / kBStages) & 1);
          // no key of this warpgroup is seen by a query of the tile
          if (kw >= skv || (causal && (long long)q_offset + q0 + kBT - 1 < kw)) {
            wg_sync(wg);
            if (signal) mbar_arrive(empty + 8 * st);
            continue;
          }
          const uint32_t q_s = base + L::q + st * 2 * NS * kSlabT;
          const uint32_t do_s = q_s + NS * kSlabT;
          const float* r_s = reinterpret_cast<const float*>(sbase + L::rows + st * 2 * kBT * 4);
          float s[32] = {}, dp[32] = {};  // not read: the first k-step has scale-d 0
          mma_abt<NS>(s, k_s, kSlabN, q_s);
          mma_abt<NS>(dp, v_s, kSlabN, do_s);
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          uint32_t pf[16], dsf[16];
          // the mask where the tile straddles the diagonal or a ragged tail:
          // query c0 + c of key kr is masked when c0 + c >= sq, when kr >=
          // skv, or (causal) when q_offset + c0 + c < kr
          if (kw + 64 > skv || q0 + kBT > sq || (causal && (long long)q_offset + q0 < kw + 63)) {
            const int c0 = q0 + 2 * (lane % 4);
            int lo[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int kr = key + 8 * r;
              const long long first = causal ? (long long)kr - q_offset - c0 : -64;
              lo[r] = kr >= skv ? 64 : (int)max(-64ll, first);
            }
            p_ds_cols<true>(s, dp, pf, dsf, r_s, r_s + kBT, lane, lo, sq - c0, scale_log2);
          } else {
            const int lo[2] = {0, 0};
            p_ds_cols<false>(s, dp, pf, dsf, r_s, r_s + kBT, lane, lo, 64, scale_log2);
          }
          mma_rs<NS>(adv, pf, do_s);
          mma_rs<NS>(adk, dsf, q_s);
          wgmma_wait<0>();
          fence_regs(adv);
          fence_regs(adk);
          fence_regs(pf);
          fence_regs(dsf);
          if (signal) mbar_arrive(empty + 8 * st);
        }
      }
      wg_sync(wg);  // every warp is done with K and V
      if (signal) mbar_arrive(kv_empty + 8 * kb);
      store_rows<NS>(adk, dk + batch * ost.dk[0] + kh * ost.dk[1], ost.dk[2], key, skv, hd, scale,
                     lane);
      store_rows<NS>(adv, dv + batch * ost.dv[0] + kh * ost.dv[1], ost.dv[2], key, skv, hd, 1.f,
                     lane);
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tdo,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const float* __restrict__ lse2, const float* __restrict__ D,
                                   __nv_bfloat16* __restrict__ dq, BwdStrides ost, int heads,
                                   int n_bh, int rep, int sq, int sq_pad, int skv, int hd,
                                   int causal, int q_offset, float scale, float scale_log2) {
  using L = SmemQ<NS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // mbarriers: Q/dO full and empty (2 buffers), then the K/V ring's
  const uint32_t q_full = base + L::bar, q_empty = q_full + 16;
  const uint32_t kv_full = q_empty + 16, kv_empty = kv_full + 8 * kBStages;
  const int nq = (sq + kBN - 1) / kBN;
  const int n_work = n_bh * nq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 2);
    }
    for (int st = 0; st < kBStages; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // work tile n as (batch * heads + head, first query row, key tiles), as
  // the forward's: each head's heaviest causal tile (the last) first
  auto work = [&](int n, int& bh, int& q0, int& n_tiles) {
    const int pos = n * (int)gridDim.x +
                    ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
    if (pos >= n_work) return false;
    bh = pos / nq;
    q0 = (nq - 1 - pos % nq) * kBN;
    int kv_end = skv;
    if (causal) {
      const long long last = (long long)q_offset + min(q0 + kBN, sq);
      kv_end = (int)(last < skv ? last : skv);
    }
    n_tiles = (kv_end + kBT - 1) / kBT;
    return true;
  };
  auto stage = [](int t) { return t % kBStages; };
  auto phase = [](int t) { return (uint32_t)(t / kBStages) & 1u; };

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int bh, q0, n_tiles;
      int it = 0;  // key tiles before this work tile
      for (int n = 0; work(n, bh, q0, n_tiles); ++n) {
        const int head = bh % heads, batch = bh / heads, kh = head / rep;
        const int qb = n & 1;
        mbar_wait(q_empty + 8 * qb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, 2 * NS * kSlabN);
        const uint32_t q_s = base + L::q + qb * 2 * NS * kSlabN;
        for (int s = 0; s < NS; ++s) {
          tma_load(q_s + s * kSlabN, &tq, q_full + 8 * qb, kSlab * s, q0, head, batch);
          tma_load(q_s + (NS + s) * kSlabN, &tdo, q_full + 8 * qb, kSlab * s, q0, head, batch);
        }
        for (int j = 0; j < n_tiles; ++j) {
          const int t = it + j;
          mbar_wait(kv_empty + 8 * stage(t), phase(t) ^ 1);
          mbar_expect_tx(kv_full + 8 * stage(t), 2 * NS * kSlabT);
          const uint32_t k_s = base + L::kv + stage(t) * 2 * NS * kSlabT;
          for (int s = 0; s < NS; ++s) {
            tma_load(k_s + s * kSlabT, &tk, kv_full + 8 * stage(t), kSlab * s, j * kBT, kh, batch);
            tma_load(k_s + (NS + s) * kSlabT, &tv, kv_full + 8 * stage(t), kSlab * s, j * kBT, kh,
                     batch);
          }
        }
        it += n_tiles;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t128 = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const bool signal = t128 == 0;
    int bh, q0, n_tiles;
    int it = 0;
    for (int n = 0; work(n, bh, q0, n_tiles); ++n) {
      const int head = bh % heads, batch = bh / heads;
      const int qb = n & 1;
      const int wg_row = q0 + 64 * wg;
      const int row = wg_row + frag_row(0, t128);  // and row + 8
      const bool live = wg_row < sq;
      const long long pos_lo = (long long)q_offset + wg_row;
      const long long pos_hi = (long long)q_offset + min(wg_row + 63, sq - 1);
      // key tiles wholly past this warpgroup's last row are only released
      int n_eff = live ? n_tiles : 0;
      if (causal && live) n_eff = min(n_tiles, (int)(pos_hi / kBT) + 1);
      // rows past sq: Q and dO are zero-filled and lse2 and D read as 0,
      // so dS = 1 (0 - 0) = 0 there and nothing needs masking
      float l2[2], dd[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row + 8 * r;
        const long long at = (long long)bh * sq_pad + rr;
        l2[r] = rr < sq ? lse2[at] : 0.f;
        dd[r] = rr < sq ? D[at] : 0.f;
      }
      const uint32_t q_s = base + L::q + qb * 2 * NS * kSlabN + 64 * wg * kRowBytes;
      const uint32_t do_s = q_s + NS * kSlabN;
      float adq[8 * NS];
#pragma unroll
      for (int i = 0; i < 8 * NS; ++i) adq[i] = 0.f;
      mbar_wait(q_full + 8 * qb, (n >> 1) & 1);
      for (int j = 0; j < n_tiles; ++j) {
        const int t = it + j;
        mbar_wait(kv_full + 8 * stage(t), phase(t));
        if (j >= n_eff) {
          wg_sync(wg);
          if (signal) mbar_arrive(kv_empty + 8 * stage(t));
          continue;
        }
        const int k0 = j * kBT;
        const uint32_t k_s = base + L::kv + stage(t) * 2 * NS * kSlabT;
        const uint32_t v_s = k_s + NS * kSlabT;
        float s[32] = {}, dp[32] = {};  // not read: the first k-step has scale-d 0
        mma_abt<NS>(s, q_s, kSlabN, k_s);
        mma_abt<NS>(dp, do_s, kSlabN, v_s);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        uint32_t dsf[16];
        if (k0 + kBT > skv || (causal && k0 + kBT - 1 > pos_lo)) {
          int lim[2];  // first masked column of each row, less this lane's
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const long long end =
                causal ? min((long long)skv, (long long)q_offset + row + 8 * r + 1) : skv;
            lim[r] = (int)(end - k0) - 2 * (lane % 4);
          }
          p_ds_rows<true>(s, dp, dsf, l2, dd, lim, scale_log2);
        } else {
          const int lim[2] = {0, 0};
          p_ds_rows<false>(s, dp, dsf, l2, dd, lim, scale_log2);
        }
        mma_rs<NS>(adq, dsf, k_s);
        wgmma_wait<0>();
        fence_regs(adq);
        fence_regs(dsf);
        if (signal) mbar_arrive(kv_empty + 8 * stage(t));
      }
      it += n_tiles;
      wg_sync(wg);  // every warp is done with Q and dO
      if (signal) mbar_arrive(q_empty + 8 * qb);
      if (live)
        store_rows<NS>(adq, dq + batch * ost.dq[0] + head * ost.dq[1], ost.dq[2], row, sq, hd,
                       scale, lane);
    }
  }
}

// two warpgroups, the dK/dV kernel's loads, descriptors and products on
// k, v (128, hd) and q, do (64, hd): s_out, dp_out (128, 64) = k q^T,
// v do^T; dv_out, dk_out (128, 16 NS) = bf16(s) do, bf16(dp) q; each
// register written where the kernels take it to lie
template <int NS>
__global__ void __launch_bounds__(256)
flash_attention_bwd_probe_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv, float* __restrict__ s_out,
                                 float* __restrict__ dp_out, float* __restrict__ dv_out,
                                 float* __restrict__ dk_out) {
  using L = SmemKV<NS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::bar;
  const int t = threadIdx.x, wg = t / 128, t128 = t % 128;
  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, 2 * NS * (kSlabN + kSlabT));
    for (int s = 0; s < NS; ++s) {
      tma_load(base + L::kv + s * kSlabN, &tk, bar, kSlab * s, 0, 0, 0);
      tma_load(base + L::kv + (NS + s) * kSlabN, &tv, bar, kSlab * s, 0, 0, 0);
      tma_load(base + L::q + s * kSlabT, &tq, bar, kSlab * s, 0, 0, 0);
      tma_load(base + L::q + (NS + s) * kSlabT, &tdo, bar, kSlab * s, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  const uint32_t k_s = base + L::kv + 64 * wg * kRowBytes, v_s = k_s + NS * kSlabN;
  const uint32_t q_s = base + L::q, do_s = q_s + NS * kSlabT;
  float s[32] = {}, dp[32] = {};
  mma_abt<NS>(s, k_s, kSlabN, q_s);
  mma_abt<NS>(dp, v_s, kSlabN, do_s);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int at = (64 * wg + frag_row(i, t128)) * 64 + frag_col(i, t128);
    s_out[at] = s[i];
    dp_out[at] = dp[i];
  }
  uint32_t pf[16], dsf[16];
  pack_bf16(s, pf);
  pack_bf16(dp, dsf);
  float adv[8 * NS], adk[8 * NS];
#pragma unroll
  for (int i = 0; i < 8 * NS; ++i) adv[i] = adk[i] = 0.f;
  mma_rs<NS>(adv, pf, do_s);
  mma_rs<NS>(adk, dsf, q_s);
  wgmma_wait<0>();
  fence_regs(adv);
  fence_regs(adk);
  fence_regs(pf);
  fence_regs(dsf);
#pragma unroll
  for (int i = 0; i < 8 * NS; ++i) {
    const int at = (64 * wg + frag_row(i, t128)) * 16 * NS + frag_col(i, t128);
    dv_out[at] = adv[i];
    dk_out[at] = adk[i];
  }
}

// the tensor maps of the bf16 backward: q, do, k, v with boxes of 64 rows
// (t) and of 128 rows (n)
struct BwdMaps {
  CUtensorMap q_t, do_t, k_n, v_n, q_n, do_n, k_t, v_t;
};

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NS>
int launch_bwd_bf16(const BwdMaps& m, const float* lse2, const float* D, void* dq, void* dk,
                    void* dv, const BwdStrides& st, int b, int h, int kvh, int sq, int sq_pad,
                    int skv, int hd, int causal, int q_offset, float scale, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int rep = h / kvh;
  const long long kv_work = (long long)b * kvh * ((skv + kBN - 1) / kBN);
  const long long q_work = (long long)b * h * ((sq + kBN - 1) / kBN);
  if (kv_work > 0x7fffffffLL || q_work > 0x7fffffffLL) return cudaErrorInvalidValue;
  err = allow_smem(flash_attention_bwd_dkdv_bf16_kernel<NS>, SmemKV<NS>::bytes);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_bf16_kernel<NS>
      <<<(int)(kv_work < sms ? kv_work : sms), kThreads, SmemKV<NS>::bytes, stream>>>(
          m.q_t, m.do_t, m.k_n, m.v_n, lse2, D, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), st, h, kvh, b * kvh, rep, sq, sq_pad, skv, hd,
          causal, q_offset, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_attention_bwd_dq_bf16_kernel<NS>, SmemQ<NS>::bytes);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq_bf16_kernel<NS>
      <<<(int)(q_work < sms ? q_work : sms), kThreads, SmemQ<NS>::bytes, stream>>>(
          m.q_n, m.do_n, m.k_t, m.v_t, lse2, D, static_cast<__nv_bfloat16*>(dq), st, h, b * h,
          rep, sq, sq_pad, skv, hd, causal, q_offset, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int NS>
int launch_bwd_probe(const BwdMaps& m, float* s_out, float* dp_out, float* dv_out,
                     float* dk_out, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_attention_bwd_probe_kernel<NS>, SmemKV<NS>::bytes);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_probe_kernel<NS><<<1, 256, SmemKV<NS>::bytes, stream>>>(
      m.q_t, m.do_t, m.k_n, m.v_n, s_out, dp_out, dv_out, dk_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 int64 (batch, head, seq) strides of q, k, v, o, in elements.
// lse: null, or a contiguous (b, h, sq) fp32 tensor that takes each query
// row's log-sum-exp of its scaled, masked logits (the backward's input).
// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it).  bfloat16 needs
// hd % 8 == 0, 16-byte aligned q, k and v and strides of a multiple of 16
// bytes (the TMA's terms); the wrapper checks them before it calls.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, float* lse,
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
    return dispatch_fp32(q, k, v, o, lse, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
  }
  if (dtype != 1 || hd % 8 != 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, hd, sq, h, b, strides, kBQ);
  if (err == cudaSuccess) err = encode_map(&tk, k, hd, skv, kvh, b, strides + 3, kBK);
  if (err == cudaSuccess) err = encode_map(&tv, v, hd, skv, kvh, b, strides + 6, kBK);
  if (err != cudaSuccess) return err;
#define REPRO_FA16(NS) \
  case NS:                                                                        \
    return lse == nullptr                                                         \
        ? launch_bf16<NS, false>(tq, tk, tv, o, lse, strides + 9, b, h, rep, sq, skv, hd, \
                                 causal, q_offset, scale, s)                      \
        : launch_bf16<NS, true>(tq, tk, tv, o, lse, strides + 9, b, h, rep, sq, skv, hd, \
                                causal, q_offset, scale, s)
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

// The backward of attention: given q, k, v, the forward's output o and its
// lse (contiguous (b, h, sq) fp32), and do, write dq (q's shape) and dk, dv
// (k's shape), all of q's dtype (0 float32, 1 bfloat16).  strides: 24 int64
// (batch, head, seq) strides in elements of q, k, v, o, do, dq, dk, dv.  D
// is fp32 scratch: b h sq floats for float32; for bfloat16 2 b h sq_pad,
// sq_pad = sq rounded up to a multiple of 64 (D, then lse log2(e)).
// bfloat16 needs hd % 8 == 0 and 16-byte aligned tensors and strides (the
// TMA's terms), which the wrapper checks before it calls.  Three launches
// on the stream: D = rowsum(do o), then dK/dV, then dQ; no atomics, so the
// result is the same from run to run.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* D, void* dq, void* dk,
                               void* dv, const long long* strides, int b, int h, int kvh, int sq,
                               int skv, int hd, int dtype, int causal, int q_offset, float scale,
                               void* stream) {
  if (b == 0 || h == 0 || sq == 0) return cudaSuccess;
  if (kvh <= 0 || h % kvh != 0 || skv <= 0 || hd <= 0 || hd > 128 || q_offset < 0)
    return cudaErrorInvalidValue;
  BwdStrides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    st.dout[i] = strides[12 + i];
    st.dq[i] = strides[15 + i];
    st.dk[i] = strides[18 + i];
    st.dv[i] = strides[21 + i];
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(q, k, v, o, dout, lse, D, dq, dk, dv, st, b, h, kvh, sq, skv, hd,
                               causal, q_offset, scale, s);
  if (dtype != 1 || hd % 8 != 0) return cudaErrorInvalidValue;
  BwdMaps m;
  int err = encode_map(&m.q_t, q, hd, sq, h, b, strides, kBT);
  if (err == cudaSuccess) err = encode_map(&m.q_n, q, hd, sq, h, b, strides, kBN);
  if (err == cudaSuccess) err = encode_map(&m.k_t, k, hd, skv, kvh, b, strides + 3, kBT);
  if (err == cudaSuccess) err = encode_map(&m.k_n, k, hd, skv, kvh, b, strides + 3, kBN);
  if (err == cudaSuccess) err = encode_map(&m.v_t, v, hd, skv, kvh, b, strides + 6, kBT);
  if (err == cudaSuccess) err = encode_map(&m.v_n, v, hd, skv, kvh, b, strides + 6, kBN);
  if (err == cudaSuccess) err = encode_map(&m.do_t, dout, hd, sq, h, b, strides + 12, kBT);
  if (err == cudaSuccess) err = encode_map(&m.do_n, dout, hd, sq, h, b, strides + 12, kBN);
  if (err != cudaSuccess) return err;
  const int sq_pad = (sq + kRowPad - 1) / kRowPad * kRowPad;
  const long long n_rows = (long long)b * h * sq_pad;
  float* lse2 = D + n_rows;
  const long long dot_blocks = (n_rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  if (dot_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_bwd_dot_kernel<__nv_bfloat16><<<(unsigned)dot_blocks, kBwdThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), D, st, h, sq,
      hd, n_rows, sq_pad, lse, lse2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define REPRO_FAB16(NS)                                                                     \
  case NS:                                                                                  \
    return launch_bwd_bf16<NS>(m, lse2, D, dq, dk, dv, st, b, h, kvh, sq, sq_pad, skv, hd,  \
                               causal, q_offset, scale, s)
  switch ((hd + kSlab - 1) / kSlab) {
    REPRO_FAB16(1); REPRO_FAB16(2); REPRO_FAB16(3); REPRO_FAB16(4);
    REPRO_FAB16(5); REPRO_FAB16(6); REPRO_FAB16(7); REPRO_FAB16(8);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FAB16
}

// The bf16 backward's fragment-layout check: q, do (64, hd), k, v (128, hd)
// contiguous bf16 -> s_out, dp_out (128, 64) = k q^T, v do^T and dv_out,
// dk_out (128, 16 ceil(hd / 16)) = bf16(s) do, bf16(dp) q, all fp32, each
// register written where the backward kernels assume it lies.
int flash_attention_bwd_probe_launch(const void* q, const void* dout, const void* k,
                                     const void* v, float* s_out, float* dp_out, float* dv_out,
                                     float* dk_out, int hd, void* stream) {
  if (hd <= 0 || hd > 128 || hd % 8 != 0) return cudaErrorInvalidValue;
  const long long s64[3] = {64LL * hd, 64LL * hd, hd};
  const long long s128[3] = {128LL * hd, 128LL * hd, hd};
  BwdMaps m;
  int err = encode_map(&m.q_t, q, hd, 64, 1, 1, s64, kBT);
  if (err == cudaSuccess) err = encode_map(&m.do_t, dout, hd, 64, 1, 1, s64, kBT);
  if (err == cudaSuccess) err = encode_map(&m.k_n, k, hd, 128, 1, 1, s128, kBN);
  if (err == cudaSuccess) err = encode_map(&m.v_n, v, hd, 128, 1, 1, s128, kBN);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_BPROBE(NS) \
  case NS: return launch_bwd_probe<NS>(m, s_out, dp_out, dv_out, dk_out, s)
  switch ((hd + kSlab - 1) / kSlab) {
    REPRO_BPROBE(1); REPRO_BPROBE(2); REPRO_BPROBE(3); REPRO_BPROBE(4);
    REPRO_BPROBE(5); REPRO_BPROBE(6); REPRO_BPROBE(7); REPRO_BPROBE(8);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BPROBE
}

}  // extern "C"
