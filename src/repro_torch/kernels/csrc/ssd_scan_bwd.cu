// The gradient of the Mamba2 SSD intra-chunk term, for Hopper (sm_90a),
// behind a plain C interface that kernels/_build.py loads with ctypes.  The
// launcher enqueues on the caller's stream, allocates nothing, does not
// synchronise, and returns the cudaError_t of the launches.
//
// Replaces no TPU kernel: the JAX package differentiates its jnp
// src/repro/models/ssm.py `ssd_chunked_ref`, since jax.grad cannot pass
// through the pallas_call of src/repro/kernels/ssd_scan.py.  This is the
// backward of that kernel's function (ssd_scan.cu, `ssd_intra_chunk_kernel`).
// Per (head, chunk) of Q positions, with cs = cumsum(dt A), S = C B^T,
// L_ij = exp(cs_i - cs_j) for i >= j (exp taken on the triangle only: above
// it the exponent is positive and overflows fp32 at Q = 256), W = S L dt_j,
// w_j = exp(cs_Q-1 - cs_j) dt_j, and the output gradients gy (Q, p) and
// gst (p, n), all in fp32:
//   dW = gy X^T, dS = dW L dt_j, G = dW W
//   dx = W^T gy + w (B gst^T)       dC = dS B       dB = dS^T C + w (X gst)
//   u_j = x_j . (gst B_j)
//   dcs = rowsum(G) - colsum(G) - w u,  dcs_Q-1 += sum_j w_j u_j
//   ddt = colsum(dW S L) + exp(cs_Q-1 - cs) u + A R,  dA = sum dt R
// with R_t = sum_{i >= t} dcs_i, dA summed over the chunks in order.  x, B,
// C and dx, dB, dC are (bh, s, .) in bf16 or fp32; dt (bh, s), A (bh), gy
// (bh, s, p), gst (bh, s / Q, p, n), ddt (bh, s) and dA (bh) fp32.  dcs sums
// to 0 over a chunk, so R and dA are differences of large sums: cs, the row
// and column sums of G and the scan run in fp64 (fp32 cs at -200 moves L by
// ~1e-5 relative, and dA then misses fp32's tolerance).
//
// Bound on this card: at mamba2-2.7b's training shape (bh 640, s 1024, p 64,
// n 128, Q 256, bf16 x/B/C) the bytes, ~1.1 GB (x, B, C, dt, gy, gst read
// once; dx, dB, dC, ddt written once) at 3.35 TB/s, ~0.33 ms; the products
// on the causal triangles, ~70 GFLOP counted once, would take 0.07 ms on the
// bf16 tensor cores and ~1.0 ms at the fp32 CUDA-core peak.
// Design (first, simple): fp32 on the CUDA cores, as the fp32 forward and
// the attention backward's first kernels; no atomics, so two calls give the
// same bits.  One kernel of 256-thread blocks in two roles, then a finish:
//   row role, a block per (64-row tile i, chunk, head): C_i and gy_i
//     resident in shared memory, it walks the column tiles j <= i, building
//     S = C_i B_j^T and dW = gy_i x_j^T (each thread 4 x 4 of the 64 x 64
//     tile), and accumulates dC_i = dS B_j in registers and the row sums of
//     G in fp64;
//   column role, a block per (64-row tile j, chunk, head): B_j and x_j
//     resident, first the state terms of its rows (gst in slabs of 64 of
//     its p rows), then it walks the row tiles i >= j, accumulating dx_j =
//     W^T gy_i, dB_j = dS^T C_i, the column sums of G (fp64) and the direct
//     ddt;
//   ssd_intra_chunk_bwd_finish_kernel, a warp per head: over the chunks in
//     order, dcs from the two roles' sums, its reverse scan (each lane a run
//     of Q / 32, the runs' totals by shuffles), ddt, and dA.
// Every block recomputes its chunk's cs.  Each role's shared memory: the
// chunk's cs (fp64) and dt, two (64, n) and two (64, p) fp32 tiles (columns
// padded to 16 x {1, 2, 4, 8}, plus one against bank conflicts) and two
// (64, 65) tiles of W and dS.  Domain: p and n up to 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;  // rows of a row or column tile
constexpr int kTS = kT + 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// shared memory of the backward kernel with (n, p) padded to (np, pp): cs
// (fp64) and the column sums' partials (16 x 64 fp64), then dt, the state
// terms of a column tile (2 x 64), and the six tiles
__host__ __device__ inline int bwd_smem_bytes(int chunk, int np, int pp) {
  return 12 * chunk + 8 * 16 * kT + 4 * 2 * kT +
         4 * (2 * kT * (np + 1) + 2 * kT * (pp + 1) + 2 * kT * kTS);
}

// cs = cumsum(dt * a) of a chunk in fp64, by the 32 lanes of one warp: each
// lane scans a run of chunk / 32 (rounded up), then the runs' totals are
// scanned by shuffles
__device__ __forceinline__ void chunk_cumsum64(double* cs, const float* dts, double a,
                                               int chunk, int lane) {
  const int per = (chunk + 31) / 32;
  const int lo = min(chunk, lane * per), hi = min(chunk, lo + per);
  double run = 0.0;
  for (int t = lo; t < hi; ++t) {
    run += (double)dts[t] * a;
    cs[t] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const double before = incl - run;
  for (int t = lo; t < hi; ++t) cs[t] += before;
}

// rows [row0, row0 + 64) of a (chunk, d) matrix (row stride d) into a
// (64, W + 1) fp32 tile, zero beyond the chunk and beyond d
template <int W, typename U>
__device__ __forceinline__ void load_tile(float* dst, const U* __restrict__ src, int row0,
                                          int rows, int d, int tid) {
  for (int idx = tid; idx < kT * W; idx += kThreads) {
    const int r = idx / W, c = idx - r * W;
    dst[r * (W + 1) + c] =
        (row0 + r < rows && c < d) ? to_f(src[(long long)(row0 + r) * d + c]) : 0.f;
  }
}

// acc[a][b] = sum_k P[(ty + 16 a) * LD + k] Q[(tx + 16 b) * LD + k], k < K:
// each thread 4 x 4 of a 64 x 64 product of two row-major tiles
template <int K, int LD>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* P, const float* Q,
                                         int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float pa[4], qa[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) pa[a] = P[(ty + 16 * a) * LD + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) qa[b] = Q[(tx + 16 * b) * LD + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(pa[a], qa[b], acc[a][b]);
  }
}

// PPT, NPT = columns of p and n per thread (p <= 16 PPT, n <= 16 NPT).
// blockIdx.x < n_tiles: row tile blockIdx.x; else column tile blockIdx.x -
// n_tiles.  scratch rows (each bh x s fp64): rowsum(G); colsum(G) + w u;
// w u; the direct and state ddt terms.
template <typename T, int PPT, int NPT>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const T* __restrict__ B,
                           const T* __restrict__ C, const float* __restrict__ gy,
                           const float* __restrict__ gst, T* __restrict__ dx,
                           T* __restrict__ dB, T* __restrict__ dC, double* __restrict__ scratch,
                           int s, int p, int n, int chunk, int n_tiles, long long plane) {
  constexpr int PP = 16 * PPT, NP = 16 * NPT;
  constexpr int PS = PP + 1, CS = NP + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cs = reinterpret_cast<double*>(smem_raw);  // [chunk]
  double* red = cs + chunk;                           // [16][64]
  float* dts = reinterpret_cast<float*>(red + 16 * kT);  // [chunk]
  float* st = dts + chunk;                            // [2][64] w u, state ddt
  float* R1 = st + 2 * kT;  // [64][CS] row: C_i; column: B_j
  float* S1 = R1 + kT * CS;  // [64][CS] row: B_j; column: C_i, a slab of gst
  float* R2 = S1 + kT * CS;  // [64][PS] row: gy_i; column: x_j
  float* S2 = R2 + kT * PS;  // [64][PS] row: x_j; column: gy_i
  float* T1 = S2 + kT * PS;  // [64][kTS] row: dS; column: W
  float* T2 = T1 + kT * kTS;  // [64][kTS] column: dS

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int z = blockIdx.y;
  const int nc = gridDim.y;
  const long long g = blockIdx.z;
  const long long t0 = g * s + (long long)z * chunk;  // row of the chunk's start
  const T* xg = x + t0 * p;
  const T* Bg = B + t0 * n;
  const T* Cg = C + t0 * n;
  const float* gyg = gy + t0 * p;

  for (int t = tid; t < chunk; t += kThreads) dts[t] = dt[t0 + t];
  __syncthreads();
  if (tid < 32) chunk_cumsum64(cs, dts, (double)A[g], chunk, tid);
  __syncthreads();

  if (blockIdx.x < n_tiles) {
    // ---- row role: dC_i and the row sums of G
    const int r = blockIdx.x;
    const int i0 = r * kT;
    load_tile<NP>(R1, Cg, i0, chunk, n, tid);
    load_tile<PP>(R2, gyg, i0, chunk, p, tid);
    float dc[4][NPT];
    double rg[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rg[a] = 0.0;
#pragma unroll
      for (int q = 0; q < NPT; ++q) dc[a][q] = 0.f;
    }
    for (int jt = 0; jt <= r; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();
      load_tile<NP>(S1, Bg, j0, chunk, n, tid);
      load_tile<PP>(S2, xg, j0, chunk, p, tid);
      __syncthreads();
      float sc[4][4], dw[4][4];
      tile_dot<NP, CS>(sc, R1, S1, ty, tx);
      tile_dot<PP, PS>(dw, R2, S2, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ii = i0 + ty + 16 * a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jj = j0 + tx + 16 * b;
          float ds = 0.f;
          if (jj <= ii && ii < chunk) {
            const float ldt = expf((float)(cs[ii] - cs[jj])) * dts[jj];
            ds = dw[a][b] * ldt;
            rg[a] += (double)(dw[a][b] * (sc[a][b] * ldt));
          }
          T1[(ty + 16 * a) * kTS + tx + 16 * b] = ds;
        }
      }
      __syncthreads();
      for (int c = 0; c < kT; ++c) {
        float bv[NPT];
#pragma unroll
        for (int q = 0; q < NPT; ++q) bv[q] = S1[c * CS + tx + 16 * q];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float d = T1[(ty + 16 * a) * kTS + c];
#pragma unroll
          for (int q = 0; q < NPT; ++q) dc[a][q] = fmaf(d, bv[q], dc[a][q]);
        }
      }
    }
    // the row sums over the 16 lanes of a row (lane tx == 0 writes)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rg[a] += __shfl_xor_sync(0xffffffffu, rg[a], off);
      const int ii = i0 + ty + 16 * a;
      if (tx == 0 && ii < chunk) scratch[t0 + ii] = rg[a];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ii = i0 + ty + 16 * a;
      if (ii >= chunk) continue;
#pragma unroll
      for (int q = 0; q < NPT; ++q) {
        const int c = tx + 16 * q;
        if (c < n) dC[(t0 + ii) * n + c] = from_f<T>(dc[a][q]);
      }
    }
    return;
  }

  // ---- column role: dx_j, dB_j, the column sums of G, ddt's direct and
  // state terms
  const int jt = blockIdx.x - n_tiles;
  const int j0 = jt * kT;
  load_tile<NP>(R1, Bg, j0, chunk, n, tid);
  load_tile<PP>(R2, xg, j0, chunk, p, tid);
  const double cs_end = cs[chunk - 1];
  float wr[4], dr[4];  // w_j and exp(cs_Q-1 - cs_j) of this thread's rows
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int jj = j0 + ty + 16 * a;
    dr[a] = jj < chunk ? expf((float)(cs_end - cs[jj])) : 0.f;
    wr[a] = jj < chunk ? dr[a] * dts[jj] : 0.f;
  }
  float dxa[4][PPT], dba[4][NPT], up[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    up[a] = 0.f;
#pragma unroll
    for (int b = 0; b < PPT; ++b) dxa[a][b] = 0.f;
#pragma unroll
    for (int q = 0; q < NPT; ++q) dba[a][q] = 0.f;
  }
  // the state terms: gst in slabs of 64 of its p rows
  const float* gs = gst + ((g * nc + z) * (long long)p) * n;
  constexpr int SB = PPT < 4 ? PPT : 4;  // 16-column groups of p in a slab
#pragma unroll
  for (int sl = 0; sl < (PPT + 3) / 4; ++sl) {
    const int pp0 = sl * kT;
    __syncthreads();
    load_tile<NP>(S1, gs, pp0, p, n, tid);
    __syncthreads();
    float gb[4][4];  // (gst B_j)[pp0 + tx + 16 b] of row ty + 16 a
    tile_dot<NP, CS>(gb, R1, S1, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        dxa[a][4 * sl + b] = fmaf(wr[a], gb[a][b], dxa[a][4 * sl + b]);
        up[a] = fmaf(R2[(ty + 16 * a) * PS + pp0 + tx + 16 * b], gb[a][b], up[a]);
      }
    constexpr int rows = PP < kT ? PP : kT;
    for (int r = 0; r < rows; ++r) {
      float sv[NPT];
#pragma unroll
      for (int q = 0; q < NPT; ++q) sv[q] = S1[r * CS + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float xv = wr[a] * R2[(ty + 16 * a) * PS + pp0 + r];
#pragma unroll
        for (int q = 0; q < NPT; ++q) dba[a][q] = fmaf(xv, sv[q], dba[a][q]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) up[a] += __shfl_xor_sync(0xffffffffu, up[a], off);
    if (tx == 0) {
      st[ty + 16 * a] = wr[a] * up[a];
      st[kT + ty + 16 * a] = dr[a] * up[a];
    }
  }

  double cg[4];
  float dd[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    cg[b] = 0.0;
    dd[b] = 0.f;
  }
  for (int it = jt; it < n_tiles; ++it) {
    const int i0 = it * kT;
    __syncthreads();
    load_tile<NP>(S1, Cg, i0, chunk, n, tid);
    load_tile<PP>(S2, gyg, i0, chunk, p, tid);
    __syncthreads();
    float sc[4][4], dw[4][4];
    tile_dot<NP, CS>(sc, S1, R1, ty, tx);  // rows i, columns j
    tile_dot<PP, PS>(dw, S2, R2, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ii = i0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jj = j0 + tx + 16 * b;
        float wv = 0.f, dsv = 0.f;
        if (jj <= ii && ii < chunk) {
          const float l = expf((float)(cs[ii] - cs[jj]));
          const float ldt = l * dts[jj];
          wv = sc[a][b] * ldt;
          dsv = dw[a][b] * ldt;
          cg[b] += (double)(dw[a][b] * wv);
          dd[b] = fmaf(dw[a][b], sc[a][b] * l, dd[b]);
        }
        T1[(ty + 16 * a) * kTS + tx + 16 * b] = wv;
        T2[(ty + 16 * a) * kTS + tx + 16 * b] = dsv;
      }
    }
    __syncthreads();
    for (int r = 0; r < kT; ++r) {
      float gv[PPT], cv[NPT];
#pragma unroll
      for (int b = 0; b < PPT; ++b) gv[b] = S2[r * PS + tx + 16 * b];
#pragma unroll
      for (int q = 0; q < NPT; ++q) cv[q] = S1[r * CS + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float wv = T1[r * kTS + ty + 16 * a];
        const float dsv = T2[r * kTS + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < PPT; ++b) dxa[a][b] = fmaf(wv, gv[b], dxa[a][b]);
#pragma unroll
        for (int q = 0; q < NPT; ++q) dba[a][q] = fmaf(dsv, cv[q], dba[a][q]);
      }
    }
  }
  // the column sums over the 16 thread rows, in order
  __syncthreads();
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    red[ty * kT + tx + 16 * b] = cg[b];
    T1[ty * kT + tx + 16 * b] = dd[b];
  }
  __syncthreads();
  if (tid < kT && j0 + tid < chunk) {
    double tot = 0.0;
    float td = 0.f;
    for (int r = 0; r < 16; ++r) {
      tot += red[r * kT + tid];
      td += T1[r * kT + tid];
    }
    const long long row = t0 + j0 + tid;
    const double wu = st[tid];
    scratch[plane + row] = tot + wu;
    scratch[2 * plane + row] = wu;
    scratch[3 * plane + row] = (double)(td + st[kT + tid]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int jj = j0 + ty + 16 * a;
    if (jj >= chunk) continue;
#pragma unroll
    for (int b = 0; b < PPT; ++b) {
      const int c = tx + 16 * b;
      if (c < p) dx[(t0 + jj) * p + c] = from_f<T>(dxa[a][b]);
    }
#pragma unroll
    for (int q = 0; q < NPT; ++q) {
      const int c = tx + 16 * q;
      if (c < n) dB[(t0 + jj) * n + c] = from_f<T>(dba[a][q]);
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// One warp per head, four heads a block: over the chunks in order, dcs =
// rowsum(G) - (colsum(G) + w u) (+ sum w u at the chunk's last row), R its
// reverse cumsum, ddt = the direct and state terms + A R, dA = sum dt R.
__global__ void __launch_bounds__(128)
ssd_intra_chunk_bwd_finish_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                                  const double* __restrict__ scratch, float* __restrict__ ddt,
                                  float* __restrict__ dA, int bh, int s, int chunk,
                                  long long plane) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (g >= bh) return;
  const double* rowG = scratch;
  const double* colGW = scratch + plane;
  const double* wu = scratch + 2 * plane;
  const double* ddtp = scratch + 3 * plane;
  const double a = A[g];
  const int per = (chunk + 31) / 32;
  const int lo = min(chunk, lane * per), hi = min(chunk, lo + per);
  double da = 0.0;
  for (int z = 0; z < s / chunk; ++z) {
    const long long base = g * s + (long long)z * chunk;
    double wsum = 0.0;
    for (int t = lo; t < hi; ++t) wsum += wu[base + t];
    wsum = warp_sum(wsum);
    double run = 0.0;
    for (int t = lo; t < hi; ++t)
      run += rowG[base + t] - colGW[base + t] + (t == chunk - 1 ? wsum : 0.0);
    double incl = run;  // this lane's run and every later lane's
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    double R = incl - run;
    double part = 0.0;
    for (int t = hi - 1; t >= lo; --t) {
      R += rowG[base + t] - colGW[base + t] + (t == chunk - 1 ? wsum : 0.0);
      ddt[base + t] = (float)(ddtp[base + t] + a * R);
      part += (double)dt[base + t] * R;
    }
    da += warp_sum(part);
  }
  if (lane == 0) dA[g] = (float)da;
}

struct BwdArgs {
  const void *x, *dt, *A, *B, *C, *gy, *gst;
  void *dx, *ddt, *dA, *dB, *dC;
  double* scratch;
  int bh, s, p, n, chunk;
  cudaStream_t st;
};

template <typename T, int PPT, int NPT>
int launch_bwd(const BwdArgs& r) {
  const int smem = bwd_smem_bytes(r.chunk, 16 * NPT, 16 * PPT);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kern = ssd_intra_chunk_bwd_kernel<T, PPT, NPT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (r.chunk + kT - 1) / kT;
  const long long plane = (long long)r.bh * r.s;
  const dim3 grid(2 * n_tiles, r.s / r.chunk, r.bh);
  kern<<<grid, kThreads, smem, r.st>>>(
      static_cast<const T*>(r.x), static_cast<const float*>(r.dt),
      static_cast<const float*>(r.A), static_cast<const T*>(r.B), static_cast<const T*>(r.C),
      static_cast<const float*>(r.gy), static_cast<const float*>(r.gst), static_cast<T*>(r.dx),
      static_cast<T*>(r.dB), static_cast<T*>(r.dC), r.scratch, r.s, r.p, r.n, r.chunk, n_tiles,
      plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_intra_chunk_bwd_finish_kernel<<<(r.bh + 3) / 4, 128, 0, r.st>>>(
      static_cast<const float*>(r.dt), static_cast<const float*>(r.A), r.scratch,
      static_cast<float*>(r.ddt), static_cast<float*>(r.dA), r.bh, r.s, r.chunk, plane);
  return cudaGetLastError();
}

// the least of 1, 2, 4, 8 columns of 16 that covers d, or 0 past 128
inline int cols16(int d) { return d <= 16 ? 1 : d <= 32 ? 2 : d <= 64 ? 4 : d <= 128 ? 8 : 0; }

template <typename T, int PPT>
int with_n(const BwdArgs& r) {
  switch (cols16(r.n)) {
    case 1: return launch_bwd<T, PPT, 1>(r);
    case 2: return launch_bwd<T, PPT, 2>(r);
    case 4: return launch_bwd<T, PPT, 4>(r);
    case 8: return launch_bwd<T, PPT, 8>(r);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int with_p(const BwdArgs& r) {
  switch (cols16(r.p)) {
    case 1: return with_n<T, 1>(r);
    case 2: return with_n<T, 2>(r);
    case 4: return with_n<T, 4>(r);
    case 8: return with_n<T, 8>(r);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of x, B, C and dx, dB, dC: 0 float32, 1 bfloat16.  s must be a
// multiple of chunk; p and n from 1 to 128; the chunk's cs, dt and tiles
// within a block's shared memory; at most 65535 heads and chunks (the
// wrapper's check_bwd_domain).  scratch: 4 x bh x s fp64.
int ssd_intra_chunk_bwd_launch(const void* x, const void* dt, const void* A, const void* B,
                               const void* C, const void* gy, const void* gst, void* dx,
                               void* ddt, void* dA, void* dB, void* dC, void* scratch, int bh,
                               int s, int p, int n, int chunk, int dtype, void* stream) {
  if (bh == 0 || s == 0) return cudaSuccess;
  if (chunk <= 0 || s % chunk != 0 || p <= 0 || n <= 0 || s / chunk > 65535 || bh > 65535)
    return cudaErrorInvalidValue;
  const BwdArgs r{x, dt, A, B, C, gy, gst, dx, ddt, dA, dB, dC, static_cast<double*>(scratch),
                  bh, s, p, n, chunk, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return with_p<float>(r);
  if (dtype == 1) return with_p<__nv_bfloat16>(r);
  return cudaErrorInvalidValue;
}

}  // extern "C"
