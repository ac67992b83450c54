// The Mamba2 SSD intra-chunk term, for Hopper (sm_90a), behind a plain C
// interface that kernels/_build.py loads with ctypes.  The launcher
// enqueues on the caller's stream, allocates nothing, does not synchronise,
// and returns the cudaError_t of the launch.
//
// ssd_intra_chunk_kernel
//   Replaces src/repro/kernels/ssd_scan.py `_kernel` (built by
//   `ssd_intra_chunk`).  Per (head, chunk) of Q positions, in fp32:
//     cs      = cumsum(dt * A)                              (Q)
//     y_intra = ((C B^T) * tril(exp(cs_i - cs_j)) * dt_j) X  (Q, p)
//     state   = X^T (B * exp(cs_Q-1 - cs) * dt)              (p, n)
//   x, B, C are (bh, s, .) in fp32 or bf16, dt (bh, s) and A (bh) fp32;
//   y (bh, s, p) and the chunk states (bh, s / Q, p, n) are fp32.
//   Bound on this card: at the serving shape (bh 320, s 1024, p = n = 64,
//   Q 256) about 16 GFLOP of fp32 products (the causal half of C B^T and of
//   the weighted X product, and the state) -- this kernel runs them on the
//   CUDA cores, against 67 TFLOP/s; the bytes are a smaller term.
//   Design: the (Q x Q) fp32 score tile of the reference is 256 KB at
//   Q = 256, more than a block's 227 KB of shared memory, so the chunk is
//   tiled.  A launch has one block of 256 threads per (row tile, chunk,
//   head): row tile r < ceil(Q / 64) owns output rows [64 r, 64 r + 64) and
//   walks the column tiles j <= r, building C_i B_j^T (each thread 4 x 4),
//   masking and weighting it, and accumulating W X_j into 4 rows x p / 16
//   columns of registers.  The last block of each (chunk, head) computes the
//   chunk state the same way, 64 state columns at a time, in the same
//   launch.  Every block recomputes the chunk's cs (a warp scan in shared
//   memory): Q additions, cheaper than a second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;   // rows and columns of a tile
constexpr int kTS = kT + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// shared floats of the row-tile blocks (the state block needs fewer)
__host__ __device__ inline int smem_floats(int chunk, int n, int pp) {
  return 2 * chunk + kT * (n + 1) + n * kTS + kT * pp + kT * kTS;
}

// PPT = output columns per thread (p <= 16 * PPT)
template <int PPT, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ B,
                       const T* __restrict__ C, float* __restrict__ y,
                       float* __restrict__ states, int s, int p, int n, int chunk,
                       int n_row_tiles) {
  constexpr int PP = PPT * 16;
  extern __shared__ float smem[];
  float* cs = smem;           // [chunk] within-chunk cumulative log-decay
  float* dts = cs + chunk;    // [chunk]
  float* work = dts + chunk;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int tile = blockIdx.x;
  const int z = blockIdx.y;
  const int nc = gridDim.y;
  const long long g = blockIdx.z;
  const long long t0 = g * s + (long long)z * chunk;  // row of the chunk's start
  const T* xg = x + t0 * p;
  const T* Bg = B + t0 * n;
  const T* Cg = C + t0 * n;
  const float a = A[g];

  for (int t = tid; t < chunk; t += kThreads) dts[t] = dt[t0 + t];
  __syncthreads();
  if (tid < 32) {  // cs = cumsum(dt * a): each lane scans a run, then the runs
    const int per = (chunk + 31) / 32;
    const int lo = min(chunk, tid * per), hi = min(chunk, lo + per);
    float run = 0.f;
    for (int t = lo; t < hi; ++t) {
      run += dts[t] * a;
      cs[t] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += o;
    }
    const float before = incl - run;
    for (int t = lo; t < hi; ++t) cs[t] += before;
  }
  __syncthreads();

  if (tile < n_row_tiles) {
    float* Cs = work;             // [kT][n + 1]   C rows of this tile
    float* Bt = Cs + kT * (n + 1);  // [n][kTS]    B rows of a column tile, transposed
    float* Xs = Bt + n * kTS;     // [kT][PP]      x rows of a column tile
    float* Ws = Xs + kT * PP;     // [kT][kTS]     masked, weighted scores
    const int CS = n + 1;
    const int i0 = tile * kT;
    for (int idx = tid; idx < kT * n; idx += kThreads) {
      const int r = idx / n, c = idx - r * n;
      Cs[r * CS + c] = (i0 + r < chunk) ? to_f(Cg[(long long)(i0 + r) * n + c]) : 0.f;
    }
    float acc[4][PPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PPT; ++j) acc[i][j] = 0.f;

    for (int j0 = 0; j0 <= i0; j0 += kT) {
      __syncthreads();
      for (int idx = tid; idx < kT * n; idx += kThreads) {
        const int r = idx / n, c = idx - r * n;
        Bt[c * kTS + r] = (j0 + r < chunk) ? to_f(Bg[(long long)(j0 + r) * n + c]) : 0.f;
      }
      for (int idx = tid; idx < kT * PP; idx += kThreads) {
        const int r = idx / PP, c = idx - r * PP;
        Xs[idx] = (j0 + r < chunk && c < p) ? to_f(xg[(long long)(j0 + r) * p + c]) : 0.f;
      }
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < n; ++kk) {
        float ca[4], ba[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = Cs[(ty + 16 * i) * CS + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) ba[j] = Bt[kk * kTS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(ca[i], ba[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = i0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = j0 + tx + 16 * j;
          float w = 0.f;
          if (jj <= ii && ii < chunk) w = sc[i][j] * expf(cs[ii] - cs[jj]) * dts[jj];
          Ws[(ty + 16 * i) * kTS + tx + 16 * j] = w;
        }
      }
      __syncthreads();
      for (int c = 0; c < kT; ++c) {
        float xa[PPT];
#pragma unroll
        for (int j = 0; j < PPT; ++j) xa[j] = Xs[c * PP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wa = Ws[(ty + 16 * i) * kTS + c];
#pragma unroll
          for (int j = 0; j < PPT; ++j) acc[i][j] = fmaf(wa, xa[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + ty + 16 * i;
      if (r >= chunk) continue;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int c = tx + 16 * j;
        if (c < p) y[(t0 + r) * p + c] = acc[i][j];
      }
    }
    return;
  }

  // the chunk state: state[pp, nn] = sum_j x[j, pp] * B[j, nn] * exp(seg_end - cs_j) * dt_j
  float* Xs = work;           // [kT][PP]
  float* Bw = Xs + kT * PP;   // [kT][kT]  weighted B rows, 64 state columns
  const float seg_end = cs[chunk - 1];
  float* st = states + ((g * nc + z) * (long long)p) * n;
  for (int n0 = 0; n0 < n; n0 += kT) {
    float acc[PPT][4];
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int j0 = 0; j0 < chunk; j0 += kT) {
      __syncthreads();
      for (int idx = tid; idx < kT * PP; idx += kThreads) {
        const int r = idx / PP, c = idx - r * PP;
        Xs[idx] = (j0 + r < chunk && c < p) ? to_f(xg[(long long)(j0 + r) * p + c]) : 0.f;
      }
      for (int idx = tid; idx < kT * kT; idx += kThreads) {
        const int r = idx / kT, c = idx - r * kT;
        float w = 0.f;
        if (j0 + r < chunk && n0 + c < n)
          w = to_f(Bg[(long long)(j0 + r) * n + n0 + c]) *
              (expf(seg_end - cs[j0 + r]) * dts[j0 + r]);
        Bw[idx] = w;
      }
      __syncthreads();
      for (int c = 0; c < kT; ++c) {
        float xa[PPT], bw[4];
#pragma unroll
        for (int i = 0; i < PPT; ++i) xa[i] = Xs[c * PP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = Bw[c * kT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], bw[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int pp = ty + 16 * i;
      if (pp >= p) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = n0 + tx + 16 * j;
        if (nn < n) st[(long long)pp * n + nn] = acc[i][j];
      }
    }
  }
}

template <int PPT, typename T>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
           void* y, void* states, int bh, int s, int p, int n, int chunk, cudaStream_t st) {
  const int smem = smem_floats(chunk, n, PPT * 16) * (int)sizeof(float);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kern = ssd_intra_chunk_kernel<PPT, T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_row_tiles = (chunk + kT - 1) / kT;
  const dim3 grid(n_row_tiles + 1, s / chunk, bh);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(states), s, p, n, chunk, n_row_tiles);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* B, const void* C,
             void* y, void* states, int bh, int s, int p, int n, int chunk, cudaStream_t st) {
  const int ppt = (p + 15) / 16;
  if (ppt <= 1) return launch<1, T>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  if (ppt <= 2) return launch<2, T>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  if (ppt <= 4) return launch<4, T>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  if (ppt <= 8) return launch<8, T>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype of x, B and C: 0 float32, 1 bfloat16.  s must be a multiple of chunk.
int ssd_intra_chunk_launch(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, void* y, void* states, int bh, int s, int p,
                           int n, int chunk, int dtype, void* stream) {
  if (bh == 0 || s == 0) return cudaSuccess;
  if (chunk <= 0 || s % chunk != 0 || p <= 0 || n <= 0 || bh > 65535 || s / chunk > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
