// Forward attention with an online softmax, for Hopper (sm_90a), behind a
// plain C interface that kernels/_build.py loads with ctypes.  The launcher
// enqueues on the caller's stream, allocates nothing, does not synchronise,
// and returns the cudaError_t of the launch.
//
// flash_attention_kernel
//   Replaces src/repro/kernels/flash_attention.py `_kernel` (built by
//   `flash_attention_fwd`): out = softmax(scale * q k^T, masked) v per head,
//   GQA through the head index (KV head = h / rep, K and V never repeated),
//   causal masking on absolute positions (q_offset), masked logits -1e30,
//   fp32 m, l and accumulators, the denominator clamped at 1e-30, the
//   output cast to q's dtype.  q, k, v and o are (b, heads, seq, hd) with
//   any strides over the first three dimensions and a contiguous last one,
//   so the model's (b, seq, heads, hd) tensors are read in place.
//   Bound on this card: at the serving shape (b 4, h 32, s 1024, hd 80,
//   causal) about 21 GFLOP of products against 989 TFLOP/s bf16 -- this
//   simple kernel multiplies in fp32 on the CUDA cores, so it runs far
//   above that bound; the bytes (q, k, v read once, o written once) are
//   a smaller term still.
//   Design: one block of 256 threads per (64-query tile, head, batch).  The
//   query tile (pre-scaled, fp32) stays in shared memory; K (transposed)
//   and V tiles of 64 keys are staged through shared memory in turn.  Each
//   thread owns 4 rows x 4 key columns of the score tile and 4 rows x hd/16
//   output columns in registers; row maxima and sums reduce over the 16
//   threads of a row with warp shuffles.  Key tiles past the causal
//   diagonal are skipped (they change nothing once a row has seen key 0),
//   and a ragged tail of queries or keys is masked, not asserted.  The head
//   dim is padded with zeros to a multiple of 16 inside the block only.
//   wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// (batch, head, seq) strides in elements of q, k, v and o
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <int DPT>
constexpr int smem_floats() {
  return kBQ * (DPT * 16 + 1) + DPT * 16 * (kBK + 1) + kBK * DPT * 16 + kBQ * (kBK + 1);
}

// DPT = output columns per thread = padded head dim / 16
template <int DPT, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Strides st,
                       int rep, int sq, int skv, int hd, int causal, int q_offset,
                       float scale) {
  constexpr int HDP = DPT * 16;
  constexpr int QS = HDP + 1;  // row stride of the query tile
  constexpr int KS = kBK + 1;  // row stride of the transposed key tile and of P
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][QS]
  float* Kt = Qs + kBQ * QS;    // [HDP][KS]
  float* Vs = Kt + HDP * KS;    // [kBK][HDP]
  float* Ps = Vs + kBK * HDP;   // [kBQ][KS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const long long hh = blockIdx.y;
  const long long bb = blockIdx.z;
  const long long kh = hh / rep;
  const T* qb = q + bb * st.q[0] + hh * st.q[1];
  const T* kb = k + bb * st.k[0] + kh * st.k[1];
  const T* vb = v + bb * st.v[0] + kh * st.v[1];
  T* ob = o + bb * st.o[0] + hh * st.o[1];

  for (int idx = tid; idx < kBQ * HDP; idx += kThreads) {
    const int r = idx / HDP;
    const int d = idx - r * HDP;
    float val = 0.f;
    if (q0 + r < sq && d < hd) val = to_f(qb[(long long)(q0 + r) * st.q[2] + d]) * scale;
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
    const long long last = (long long)q_offset + min(q0 + kBQ, sq);
    kv_end = (int)(last < skv ? last : skv);
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's Kt, Vs and Ps are no longer read
    for (int idx = tid; idx < kBK * HDP; idx += kThreads) {
      const int r = idx / HDP;
      const int d = idx - r * HDP;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < skv && d < hd) {
        kv = to_f(kb[(long long)(k0 + r) * st.k[2] + d]);
        vv = to_f(vb[(long long)(k0 + r) * st.v[2] + d]);
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

    const int kk_end = min(kBK, skv - k0);  // padded keys have p = 0 and v = 0
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
      if (d < hd) store_f(ob + (long long)row * st.o[2] + d, acc[i][j] / den);
    }
  }
}

template <int DPT, typename T>
int launch(const T* q, const T* k, const T* v, T* o, const Strides& st, int b, int h,
           int rep, int sq, int skv, int hd, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  const int smem = smem_floats<DPT>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DPT, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_attention_kernel<DPT, T><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, st, rep, sq, skv, hd, causal, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, const Strides& st,
             int b, int h, int rep, int sq, int skv, int hd, int causal, int q_offset,
             float scale, cudaStream_t s) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  T* o_ = static_cast<T*>(o);
  switch ((hd + 15) / 16) {
    case 1: return launch<1, T>(q_, k_, v_, o_, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
    case 2: return launch<2, T>(q_, k_, v_, o_, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
    case 3: return launch<3, T>(q_, k_, v_, o_, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
    case 4: return launch<4, T>(q_, k_, v_, o_, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
    case 5: return launch<5, T>(q_, k_, v_, o_, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
    case 6: return launch<6, T>(q_, k_, v_, o_, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
    case 7: return launch<7, T>(q_, k_, v_, o_, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
    case 8: return launch<8, T>(q_, k_, v_, o_, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 12 int64 (batch, head, seq) strides of q, k, v, o, in elements.
// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           const long long* strides, int b, int h, int kvh, int sq,
                           int skv, int hd, int dtype, int causal, int q_offset,
                           float scale, void* stream) {
  if (b == 0 || h == 0 || sq == 0) return cudaSuccess;
  if (kvh <= 0 || h % kvh != 0 || skv <= 0 || hd <= 0 || hd > 128 || q_offset < 0)
    return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int rep = h / kvh;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, st, b, h, rep, sq, skv, hd, causal, q_offset, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, st, b, h, rep, sq, skv, hd, causal, q_offset,
                                   scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
