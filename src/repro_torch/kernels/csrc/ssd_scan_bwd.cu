// The gradient of the Mamba2 SSD intra-chunk term, for Hopper (sm_90a),
// behind a plain C interface that kernels/_build.py loads with ctypes.  The
// launchers enqueue on the caller's stream, allocate nothing, do not
// synchronise, and return the cudaError_t of the launches.
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
// ~1e-5 relative, and dA then misses fp32's tolerance).  No atomics: every
// sum has a fixed order, so two calls give the same bits.
//
// Bound on this card: at mamba2-2.7b's training shape (bh 640, s 1024, p 64,
// n 128, Q 256, bf16 x/B/C) the bytes, ~1.1 GB (x, B, C, dt, gy, gst read
// once; dx, dB, dC, ddt written once) at 3.35 TB/s, ~0.33 ms; the products
// on the causal triangles, ~108 GFLOP counted once, take ~0.2 ms on the bf16
// tensor cores with each product of an fp32 operand counted twice, and ~1.6
// ms at the fp32 CUDA-core peak.  Each dtype has its kernels, all ending in
// ssd_intra_chunk_bwd_finish_kernel (a warp per head: over the chunks in
// order, dcs from the passes' sums in the fp64 scratch, its reverse scan,
// ddt and dA):
//
// ssd_bwd_col_bf16_kernel, ssd_bwd_row_bf16_kernel (bf16 x, B, C)
//   Every product on wgmma (bf16 in, fp32 sums); an fp32 operand is split
//   into bf16 terms whose products with the bf16 operand are exact: three
//   (hi, mid, lo) for gy and gst, whose products feed G, u and so ddt and dA
//   (one bf16 rounding misses them by up to 200x: dcs is a difference of
//   large sums), two (hi, lo) for W and dS, which feed only dx, dB and dC,
//   rounded to bf16 at the end.  gy and gst come in fp32 and are split in
//   shared memory by the loading warpgroup, in no pre-pass.  Both passes
//   are persistent (two 256-thread blocks an SM: warpgroup 0 computes,
//   warpgroup 1 loads and splits, two stages of a ring so that the next
//   tile's loads run while one is on the tensor cores) and walk (head,
//   chunk, pair of 64-row tiles t and Q/64 - 1 - t) items: every item has
//   Q/64 + 1 tile products, so the triangle's work is balanced.
//   Column pass, per column tile j: B_j and X_j resident; first the state
//     terms, gB_j = B_j gst^T and X_j gst (gst in steps of its n columns),
//     u_j = x_j . gB_j, dx_j = w_j gB_j, dB_j = w_j X_j gst; then per row
//     tile i >= j, C_i by TMA and gy_i split: S^T = B_j C_i^T and dW^T =
//     X_j gy_i^T, so that W^T and dS^T lie in the accumulator fragments as
//     the register A operands of dx_j += W^T gy_i and dB_j += dS^T C_i; G's
//     column sums (quad shuffles) and ddt's direct term per row of j, G's
//     row sums per (row, column tile) to the scratch.  S and G are built
//     once per tile pair.
//   Row pass, per row tile i: gy_i split (two terms) resident, B_j and X_j
//     by TMA for j <= i: dW = gy_i X_j^T again (K = p; no S, no G), dS in
//     the fragment as the A operand of dC_i += dS B_j.  Recomputing dW
//     costs a third of the column pass's products and keeps each pass's
//     accumulators (dx_j and dB_j, or dC_i) in one warpgroup's registers.
//   Domain (the wrapper's check_bf16_bwd_domain): Q a multiple of 64, p and
//   n multiples of 16 up to 128 (computed in 64 or 128 columns,
//   zero-padded), 16-byte aligned operands, both passes within a block's
//   shared memory.
//
// ssd_intra_chunk_bwd_kernel (fp32, and bf16 outside that domain)
//   fp32 on the CUDA cores; 256-thread blocks in two roles:
//   row role, a block per (64-row tile i, chunk, head): C_i and gy_i
//     resident in shared memory, it walks the column tiles j <= i, building
//     S = C_i B_j^T and dW = gy_i x_j^T (each thread 4 x 4 of the 64 x 64
//     tile), and accumulates dC_i = dS B_j in registers and the row sums of
//     G in fp64;
//   column role, a block per (64-row tile j, chunk, head): B_j and x_j
//     resident, first the state terms of its rows (gst in slabs of 64 of
//     its p rows), then it walks the row tiles i >= j, accumulating dx_j =
//     W^T gy_i, dB_j = dS^T C_i, the column sums of G (fp64) and the direct
//     ddt.
//   Every block recomputes its chunk's cs.  Each role's shared memory: the
//   chunk's cs (fp64) and dt, two (64, n) and two (64, p) fp32 tiles
//   (columns padded to 16 x {1, 2, 4, 8}, plus one against bank conflicts)
//   and two (64, 65) tiles of W and dS.  Domain: p and n up to 128.
//
// ssd_bwd_probe_kernel checks, on the card, the fragment layouts the bf16
// passes rest on, with their loads, splits, descriptors and products.

#include "hopper.cuh"

#include <cstdint>
#include <type_traits>
#include <utility>

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
      if (tx == 0 && ii < chunk) scratch[3 * plane + t0 + ii] = rg[a];
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
    scratch[row] = tot + wu;
    scratch[plane + row] = wu;
    scratch[2 * plane + row] = (double)(td + st[kT + tid]);
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
// scratch planes (each bh x s fp64): colsum(G) + w u; w u; ddt's direct and
// state terms; then row_planes planes of rowsum(G) partials, plane k over
// the columns of 64-row tile k (row t sums planes 0 .. min(t / 64,
// row_planes - 1), in order; one plane holds the whole sums).
__global__ void __launch_bounds__(128)
ssd_intra_chunk_bwd_finish_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                                  const double* __restrict__ scratch, float* __restrict__ ddt,
                                  float* __restrict__ dA, int bh, int s, int chunk,
                                  long long plane, int row_planes) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (g >= bh) return;
  const double* colGW = scratch;
  const double* wu = scratch + plane;
  const double* ddtp = scratch + 2 * plane;
  const double* rowG = scratch + 3 * plane;
  const double a = A[g];
  const int per = (chunk + 31) / 32;
  const int lo = min(chunk, lane * per), hi = min(chunk, lo + per);
  double da = 0.0;
  for (int z = 0; z < s / chunk; ++z) {
    const long long base = g * s + (long long)z * chunk;
    double wsum = 0.0;
    for (int t = lo; t < hi; ++t) wsum += wu[base + t];
    wsum = warp_sum(wsum);
    // dcs of row t of this chunk
    auto dcs = [&](int t) {
      double r = 0.0;
      const int last = min(t / kT, row_planes - 1);
      for (int k = 0; k <= last; ++k) r += rowG[k * plane + base + t];
      return r - colGW[base + t] + (t == chunk - 1 ? wsum : 0.0);
    };
    double run = 0.0;
    for (int t = lo; t < hi; ++t) run += dcs(t);
    double incl = run;  // this lane's run and every later lane's
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    double R = incl - run;
    double part = 0.0;
    for (int t = hi - 1; t >= lo; --t) {
      R += dcs(t);
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
      static_cast<float*>(r.ddt), static_cast<float*>(r.dA), r.bh, r.s, r.chunk, plane, 1);
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

// ---------------------------------------------------------------------------
// bf16: wgmma, a column pass and a row pass
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                    // threads of a warpgroup
constexpr int kTileBytes = kT * kRowBytes;  // one slab of a 64-row tile: 2 KB
constexpr int kSmemLimit = 232448;
constexpr int kRedBytes = 2 * 4 * kT * 8;   // two buffers of G's per-warp column sums
constexpr int kBarBytes = 64;
constexpr double kLog2eD = 1.4426950408889634;
constexpr int kAlign = 256;  // slack to align the base to the 32-byte swizzle's period

// the computing warpgroup's 128 threads meet (named barrier 1)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// this thread's generic writes to shared memory made visible to wgmma and
// the TMA (the async proxy), before the barrier that releases them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of element (r, c), c < 16, in a slab of 32-byte rows under
// the 32-byte swizzle (the TMA's and wgmma's): a row's two 16-byte halves
// swap when bit 2 of r is set
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRowBytes + ((((c >> 3) & 1) ^ ((r >> 2) & 1)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return sw32_desc(addr, 16, 256); }
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int slab) {
  return sw32_desc(addr, slab, 256);
}

// D (64 x 64 or 64 x 128) (+)= A B^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n64(d, a, b, acc);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n128(d, a, b, acc);
}

// ROWS x COLS of a row-major fp32 matrix at src (row stride ld floats; rows
// from rows_real on and columns from cols_real on read as 0; COLS and
// cols_real multiples of 4) as TERMS bf16 terms in shared memory at dst,
// term k at dst + k term_bytes, each [COLS / 16 slabs slab_bytes apart][ROWS
// rows][16] under the 32-byte swizzle: v = hi + mid + lo (the first TERMS),
// hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), each difference
// exact in fp32.  By the 128 threads of a warpgroup (t = 0 .. 127), four
// 16-byte loads in flight each.  Unit u is 4 columns of one row, slab by
// slab: a warp stores 8 whole 32-byte rows of one slab, 256 contiguous
// bytes, and no two of its lanes meet in a bank (slabs 2 KB apart would).
template <int TERMS, int ROWS, int COLS>
__device__ __forceinline__ void split_tile(uint8_t* dst, int term_bytes, int slab_bytes,
                                           const float* __restrict__ src, long long ld,
                                           int rows_real, int cols_real, int t) {
  constexpr int kIters = ROWS * COLS / 4 / kWg;
  constexpr int kBatch = kIters < 4 ? kIters : 4;
  static_assert(ROWS * COLS / 4 % kWg == 0 && kIters % kBatch == 0, "whole batches of units");
  static_assert(ROWS % 8 == 0, "a warp's units in one slab");
#pragma unroll 1
  for (int i0 = 0; i0 < kIters; i0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = t + (i0 + b) * kWg;
      const int r = (u / 4) % ROWS, c = u / (4 * ROWS) * kSlab + (u % 4) * 4;
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows_real && c < cols_real)
        v[b] = __ldg(reinterpret_cast<const float4*>(src + r * ld + c));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = t + (i0 + b) * kWg;
      const int r = (u / 4) % ROWS, c = u / (4 * ROWS) * kSlab + (u % 4) * 4;
      uint8_t* d = dst + (c / kSlab) * slab_bytes + swz(r, c % kSlab);
      float a[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
#pragma unroll
      for (int k = 0; k < TERMS; ++k) {
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(a[0], a[1]);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(a[2], a[3]);
        uint2 bits;
        bits.x = *reinterpret_cast<const uint32_t*>(&h0);
        bits.y = *reinterpret_cast<const uint32_t*>(&h1);
        *reinterpret_cast<uint2*>(d + k * term_bytes) = bits;
        a[0] -= __low2float(h0);
        a[1] -= __high2float(h0);
        a[2] -= __low2float(h1);
        a[3] -= __high2float(h1);
      }
    }
  }
}

// `bytes` (a multiple of 16) of shared memory at dst set to 0 by the 128
// threads of a warpgroup
__device__ __forceinline__ void zero_smem(uint8_t* dst, int bytes, int t) {
  for (int o = 16 * t; o < bytes; o += 16 * kWg)
    *reinterpret_cast<uint4*>(dst + o) = make_uint4(0u, 0u, 0u, 0u);
}

// w (fp32 fragment) -> hi = bf16(w) and lo = bf16(w - hi), packed in pairs
// as A fragments
template <int N>
__device__ __forceinline__ void split2(const float (&w)[N], uint32_t (&hi)[N / 2],
                                       uint32_t (&lo)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(w[2 * i], w[2 * i + 1]);
    __nv_bfloat162 l = __floats2bfloat162_rn(w[2 * i] - __low2float(h),
                                             w[2 * i + 1] - __high2float(h));
    hi[i] = *reinterpret_cast<uint32_t*>(&h);
    lo[i] = *reinterpret_cast<uint32_t*>(&l);
  }
}

// the A fragments of a 64-row bf16 tile of 16 NS columns (K-major slabs at
// x): k-step kk in registers 4 kk .. 4 kk + 3, register q holding row
// frag_row + 8 (q & 1) at columns 16 kk + 8 (q >> 1) + 2 (lane % 4) and the
// next, the pair that accumulator registers 8 kk + 2 q and + 1 hold
template <int NS>
__device__ __forceinline__ void a_frags(uint32_t (&a)[4 * NS], const uint8_t* x, int t128) {
  const int r = frag_row(0, t128), c = 2 * (t128 % 4);
#pragma unroll
  for (int kk = 0; kk < NS; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[4 * kk + q] = *reinterpret_cast<const uint32_t*>(
          x + kk * kTileBytes + swz(r + 8 * (q & 1), 8 * (q >> 1) + c));
}

// cs of the chunk in fp64 (chunk_cumsum64), then csl_t = log2(e) (cs_t -
// cs_b) in fp32, b the first row of t's 64-row tile (kEnd false) or its
// last (kEnd true), by the 32 lanes of one warp.  Off the diagonal tile,
// L = exp(cs_i - cs_j) is 2^(a + b) with a and b fp32 roundings of log2(e)
// times fp64 differences of one sign (cs falls along the chunk): the
// exponent's error is ~6e-8 of |cs_i - cs_j| and L's at most ~2e-8 of 1.
// On the diagonal tile such offsets would cancel, and L is 2^ of the fp64
// difference rounded once.
template <bool kEnd>
__device__ __forceinline__ void chunk_decay(double* cs, float* csl, const float* dts, double a,
                                            int chunk, int lane) {
  chunk_cumsum64(cs, dts, a, chunk, lane);
  __syncwarp();
  for (int t = lane; t < chunk; t += 32)
    csl[t] = (float)((cs[t] - cs[kEnd ? t | (kT - 1) : t & ~(kT - 1)]) * kLog2eD);
}

// f(std::integral_constant<int, I>{}) for I = 0 .. N - 1, in order
template <typename F, int... I>
__device__ __forceinline__ void static_for_impl(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// Shared memory of the column pass: the resident part (B_j and X_j slabs,
// the chunk's dt, its cs in fp64, then csl: log2(e) (cs - cs at the start
// of the row's 64-row tile) in fp32), two ring stages, two buffers of G's
// per-warp column sums, the mbarriers.  A stage holds a row tile's C_i
// slabs and gy_i's three terms, or a step of gst: GS of its 16-column slabs
// of n, 16 NSP rows each (gB's wgmma width), in three terms.
template <int NSN, int NSP>
struct ColLayout {
  static constexpr int NP = 16 * NSP;
  static constexpr int kSlabG = NP * kRowBytes;  // one 16-column slab of one gst term
  static constexpr int kStage = (NSN + 3 * NSP) * kTileBytes;
  static constexpr int GS = 4;
  static_assert(NSN % GS == 0 && 3 * GS * kSlabG <= kStage, "a step of gst fits a stage");
  static __host__ __device__ int res_bytes(int chunk) {
    return ((NSN + NSP) * kTileBytes + 16 * chunk + 255) & ~255;
  }
  static __host__ __device__ int bytes(int chunk) {
    return res_bytes(chunk) + 2 * kStage + kRedBytes + kBarBytes + kAlign;
  }
};

// Shared memory of the row pass: the resident part (gy_i's two terms, the
// chunk's dt, cs and csl), two ring stages (B_j and X_j slabs), the
// mbarriers.
template <int NSN, int NSP>
struct RowLayout {
  static constexpr int kStage = (NSN + NSP) * kTileBytes;
  static __host__ __device__ int res_bytes(int chunk) {
    return (2 * NSP * kTileBytes + 16 * chunk + 255) & ~255;
  }
  static __host__ __device__ int bytes(int chunk) {
    return res_bytes(chunk) + 2 * kStage + kBarBytes + kAlign;
  }
};

// S^T = B_j C_i^T (NSN k-steps over n) and dW^T = X_j gy_i^T (NSP k-steps
// over p, one product per term of gy), two commit groups, waited for: b and
// x the slabs of B_j and X_j, c those of C_i, g those of gy's term 0 (the
// terms NSP slabs apart), each kTileBytes apart
template <int NSN, int NSP>
__device__ __forceinline__ void col_scores(float (&sc)[32], float (&dw)[32], uint32_t b,
                                           uint32_t x, uint32_t c, uint32_t g) {
  {
    uint64_t da[NSN], db[NSN];
#pragma unroll
    for (int kk = 0; kk < NSN; ++kk) {
      da[kk] = kmajor(b + kk * kTileBytes);
      db[kk] = kmajor(c + kk * kTileBytes);
    }
    fence_regs(da);
    fence_regs(db);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NSN; ++kk) wgmma_ss_n64(sc, da[kk], db[kk], kk > 0);
    wgmma_commit();
  }
  uint64_t dx[NSP], dg[3 * NSP];
#pragma unroll
  for (int kk = 0; kk < NSP; ++kk) {
    dx[kk] = kmajor(x + kk * kTileBytes);
#pragma unroll
    for (int t = 0; t < 3; ++t) dg[t * NSP + kk] = kmajor(g + (t * NSP + kk) * kTileBytes);
  }
  fence_regs(dx);
  fence_regs(dg);
  fence_regs(dw);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NSP; ++kk)
#pragma unroll
    for (int t = 0; t < 3; ++t) wgmma_ss_n64(dw, dx[kk], dg[t * NSP + kk], kk > 0 || t > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dw);
}

// dx_j += W^T gy_i (hi.hi, hi.mid and lo.hi) and dB_j += dS^T C_i (hi and
// lo), per k-step of 16 rows of i, gy's terms and C_i read MN-major (slabs
// kTileBytes apart), one commit group, not waited for
template <int NSN, int NSP>
__device__ __forceinline__ void col_updates(float (&dx)[8 * NSP], float (&db)[8 * NSN],
                                            uint32_t (&wh)[16], uint32_t (&wl)[16],
                                            uint32_t (&sh)[16], uint32_t (&sl)[16], uint32_t c,
                                            uint32_t g) {
  uint64_t d0[4], d1[4], dc[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    d0[kk] = mnmajor(g + kk * 16 * kRowBytes, kTileBytes);
    d1[kk] = mnmajor(g + NSP * kTileBytes + kk * 16 * kRowBytes, kTileBytes);
    dc[kk] = mnmajor(c + kk * 16 * kRowBytes, kTileBytes);
  }
  fence_regs(d0);
  fence_regs(d1);
  fence_regs(dc);
  fence_regs(wh);
  fence_regs(wl);
  fence_regs(sh);
  fence_regs(sl);
  fence_regs(dx);
  fence_regs(db);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(dx, &wh[4 * kk], d0[kk], 1);
    wgmma_rs(dx, &wh[4 * kk], d1[kk], 1);
    wgmma_rs(dx, &wl[4 * kk], d0[kk], 1);
    wgmma_rs(db, &sh[4 * kk], dc[kk], 1);
    wgmma_rs(db, &sl[4 * kk], dc[kk], 1);
  }
  wgmma_commit();
}

// step ST of a column tile's state terms, waited for: gb (+)= B_j gst^T
// over the step's GS slabs of n (three terms of gst, K-major), and dB's
// columns of those slabs = X_j gst (two terms, MN-major; X_j as the
// register A fragments xa).  b: B_j's slabs; g: gst's term 0, [GS slabs][NP
// rows][16], the terms GS slabs apart.
template <int NSN, int NSP, int GS, int NP, int ST>
__device__ __forceinline__ void col_state(float (&gb)[NP / 2], float (&db)[8 * NSN],
                                          uint32_t (&xa)[4 * NSP], uint32_t b, uint32_t g) {
  constexpr int kSlabG = NP * kRowBytes, kTerm = GS * kSlabG;
  float(&sub)[8 * GS] = *reinterpret_cast<float(*)[8 * GS]>(&db[8 * GS * ST]);
  uint64_t da[GS], dg[3 * GS], dm[2 * NSP];
#pragma unroll
  for (int kk = 0; kk < GS; ++kk) {
    da[kk] = kmajor(b + (ST * GS + kk) * kTileBytes);
#pragma unroll
    for (int t = 0; t < 3; ++t) dg[t * GS + kk] = kmajor(g + t * kTerm + kk * kSlabG);
  }
#pragma unroll
  for (int kk = 0; kk < NSP; ++kk)
#pragma unroll
    for (int t = 0; t < 2; ++t)
      dm[t * NSP + kk] = mnmajor(g + t * kTerm + kk * 16 * kRowBytes, kSlabG);
  fence_regs(da);
  fence_regs(dg);
  fence_regs(dm);
  fence_regs(xa);
  fence_regs(gb);
  fence_regs(sub);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < GS; ++kk)
#pragma unroll
    for (int t = 0; t < 3; ++t) wgmma_ss(gb, da[kk], dg[t * GS + kk], ST > 0 || kk > 0 || t > 0);
#pragma unroll
  for (int kk = 0; kk < NSP; ++kk)
#pragma unroll
    for (int t = 0; t < 2; ++t) wgmma_rs(sub, &xa[4 * kk], dm[t * NSP + kk], kk > 0 || t > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(gb);
  fence_regs(sub);
  fence_regs(xa);
}

// u of this thread's rows (frag_row and + 8): x_j . gB_j over its columns of
// p (gb's registers below 8 NSP; xa the same elements of X_j), summed over
// the four lanes of a row
template <int NSP, int NPH>
__device__ __forceinline__ void state_u(float (&u)[2], const float (&gb)[NPH],
                                        const uint32_t (&xa)[4 * NSP]) {
  u[0] = u[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 8 * NSP; ++i) {
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&xa[i / 2]);
    const float xf = (i & 1) ? __high2float(xv) : __low2float(xv);
    u[(i >> 1) & 1] = fmaf(gb[i], xf, u[(i >> 1) & 1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    u[h] += __shfl_xor_sync(0xffffffffu, u[h], 1);
    u[h] += __shfl_xor_sync(0xffffffffu, u[h], 2);
  }
}

// dW = gy_i X_j^T: gy's two terms (g, K-major, NSP slabs apart) times X_j
// (x, K-major), NSP k-steps each, waited for
template <int NSP>
__device__ __forceinline__ void row_scores(float (&dw)[32], uint32_t g, uint32_t x) {
  uint64_t dg[2 * NSP], dx[NSP];
#pragma unroll
  for (int kk = 0; kk < NSP; ++kk) {
    dx[kk] = kmajor(x + kk * kTileBytes);
#pragma unroll
    for (int t = 0; t < 2; ++t) dg[t * NSP + kk] = kmajor(g + (t * NSP + kk) * kTileBytes);
  }
  fence_regs(dg);
  fence_regs(dx);
  fence_regs(dw);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NSP; ++kk)
#pragma unroll
    for (int t = 0; t < 2; ++t) wgmma_ss_n64(dw, dg[t * NSP + kk], dx[kk], kk > 0 || t > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dw);
}

// dC_i += dS B_j (hi and lo), B_j read MN-major, waited for
template <int NSN>
__device__ __forceinline__ void row_update(float (&dc)[8 * NSN], uint32_t (&sh)[16],
                                           uint32_t (&sl)[16], uint32_t b) {
  uint64_t d[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) d[kk] = mnmajor(b + kk * 16 * kRowBytes, kTileBytes);
  fence_regs(d);
  fence_regs(sh);
  fence_regs(sl);
  fence_regs(dc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(dc, &sh[4 * kk], d[kk], 1);
    wgmma_rs(dc, &sl[4 * kk], d[kk], 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dc);
  fence_regs(sh);
  fence_regs(sl);
}

// a 64-row tile (rows frag_row and + 8 of this thread from row0) of an fp32
// accumulator of 16 NS columns as bf16 rows of width d at out (row stride
// d), columns below d
template <int NS>
__device__ __forceinline__ void store_tile(const float (&acc)[8 * NS], __nv_bfloat16* out,
                                           long long row0, int d, int t128) {
  const int r = frag_row(0, t128), c = 2 * (t128 % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* orow = out + (row0 + r + 8 * h) * d;
#pragma unroll
    for (int q = 0; q < 2 * NS; ++q)
      if (8 * q + c < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * q + c) =
            __floats2bfloat162_rn(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
  }
}

// work item w of a pass: head g, chunk z and the pair of 64-row tiles pr
// and T - 1 - pr (one tile when they meet), each pair Q/64 + 1 tile products
struct Item {
  int g, z, pr;
  __device__ Item(int w, int nc, int n_pairs)
      : g(w / (nc * n_pairs)), z((w / n_pairs) % nc), pr(w % n_pairs) {}
};

// The column pass: dx, dB, the column sums of G and w u, ddt's direct and
// state terms, and G's row sums per column tile, in the fp64 scratch
// (planes: colsum(G) + w u; w u; ddt's terms; then one plane per column
// tile of rowsum(G) partials).  Warpgroup 1 loads: per column tile, the
// ring's steps, first the state's (gst split into three terms), then each
// row tile's (C_i by TMA, gy_i split into three terms), and after the first
// two, once warpgroup 0 is done with the last tile's, the resident B_j, X_j
// and dt.  Warpgroup 0 computes.
// Per stage, mbarriers: full (warpgroup 1's 128 threads and the TMA's
// bytes) and empty (warpgroup 0's four warps); res_full and res_empty the
// same for the resident part.
template <int NSN, int NSP>
__global__ void __launch_bounds__(2 * kWg, 2)
ssd_bwd_col_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap tc, const float* __restrict__ dt,
                        const float* __restrict__ A, const float* __restrict__ gy,
                        const float* __restrict__ gst, __nv_bfloat16* __restrict__ dx,
                        __nv_bfloat16* __restrict__ dB, double* __restrict__ scratch, int s,
                        int p, int n, int chunk, int n_items, long long plane) {
  using L = ColLayout<NSN, NSP>;
  constexpr int GS = L::GS, NP = L::NP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  uint8_t* sb = smem_raw + (base - raw);
  const int T = chunk / kT, nc = s / chunk, n_pairs = (T + 1) / 2;
  const int nsn = n / kSlab, nsp = p / kSlab;
  const int res = L::res_bytes(chunk);
  const uint32_t res_b = base, res_x = base + NSN * kTileBytes;
  float* dts = reinterpret_cast<float*>(sb + (NSN + NSP) * kTileBytes);
  double* cs = reinterpret_cast<double*>(dts + chunk);
  float* csl = reinterpret_cast<float*>(cs + chunk);
  double* red = reinterpret_cast<double*>(sb + res + 2 * L::kStage);  // [2][4 warps][64]
  const uint32_t bars = base + res + 2 * L::kStage + kRedBytes;
  const uint32_t res_full = bars, res_empty = bars + 8;
  auto stage = [&](int b) { return base + res + b * L::kStage; };
  auto full = [&](int b) { return bars + 16 + 8 * b; };
  auto empty = [&](int b) { return bars + 32 + 8 * b; };
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(res_full, 1);
    mbar_init(res_empty, 4);
    for (int b = 0; b < 2; ++b) {
      mbar_init(full(b), kWg + 1);
      mbar_init(empty(b), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the resident slabs past n and p (16 NSN and 16 NSP columns are
  // computed) stay 0; no load writes them
  if (tid < kWg) {
    zero_smem(sb + nsn * kTileBytes, (NSN - nsn) * kTileBytes, tid);
    zero_smem(sb + (NSN + nsp) * kTileBytes, (NSP - nsp) * kTileBytes, tid);
    fence_async_smem();
  }
  __syncthreads();

  if (tid >= kWg) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int t = tid - kWg;
    int step = 0, k = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const Item it(w, nc, n_pairs);
      const long long t0 = (long long)it.g * s + (long long)it.z * chunk;
      const float* gs = gst + ((long long)it.g * nc + it.z) * p * n;
      for (int half = 0; half < 2; ++half) {
        const int jt = half ? T - 1 - it.pr : it.pr;
        if (half && jt == it.pr) break;
        // B_j, X_j and dt, once the last column tile is done with
        auto resident = [&]() {
          mbar_wait(res_empty, (k & 1) ^ 1);
          ++k;
          if (t != 0) return;
          const int row = it.z * chunk + jt * kT;
          mbar_expect_tx(res_full, (nsn + nsp) * kTileBytes + chunk * 4);
          for (int sl = 0; sl < nsn; ++sl)
            tma_load(res_b + sl * kTileBytes, &tb, res_full, kSlab * sl, row, it.g, 0);
          for (int sl = 0; sl < nsp; ++sl)
            tma_load(res_x + sl * kTileBytes, &tx, res_full, kSlab * sl, row, it.g, 0);
          bulk_load(smem_addr(dts), dt + t0, chunk * 4, res_full);
        };
        // the ring steps: NSN / GS of gst, then the row tiles i >= j; the
        // computing warpgroup takes none before the resident part, so that
        // is loaded before a third step waits for a stage
        const int n_steps = NSN / GS + T - jt;
        for (int q = 0; q < n_steps; ++q, ++step) {
          if (q == 2) resident();
          const int b = step & 1;
          uint8_t* sp = sb + (stage(b) - base);
          mbar_wait(empty(b), ((step >> 1) & 1) ^ 1);
          if (q < NSN / GS) {
            if (t == 0) mbar_expect_tx(full(b), 0);
            split_tile<3, NP, 16 * GS>(sp, GS * L::kSlabG, L::kSlabG, gs + 16 * GS * q, n, p,
                                       n - 16 * GS * q, t);
          } else {
            const int i = jt + q - NSN / GS;
            if (t == 0) {
              mbar_expect_tx(full(b), nsn * kTileBytes);
              for (int sl = 0; sl < nsn; ++sl)
                tma_load(stage(b) + sl * kTileBytes, &tc, full(b), kSlab * sl,
                         it.z * chunk + i * kT, it.g, 0);
            }
            zero_smem(sp + nsn * kTileBytes, (NSN - nsn) * kTileBytes, t);
            split_tile<3, kT, 16 * NSP>(sp + NSN * kTileBytes, NSP * kTileBytes, kTileBytes,
                                        gy + (t0 + i * kT) * p, p, kT, p, t);
          }
          fence_async_smem();
          mbar_arrive(full(b));
        }
        if (n_steps <= 2) resident();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = frag_row(0, tid);  // this thread's rows of a tile: r0, r0 + 8
  const int cq = 2 * (lane % 4);    // and its first column of each 8
  int step = 0, k = 0, buf = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const Item it(w, nc, n_pairs);
    const long long t0 = (long long)it.g * s + (long long)it.z * chunk;
    for (int half = 0; half < 2; ++half) {
      const int jt = half ? T - 1 - it.pr : it.pr;
      if (half && jt == it.pr) break;
      const int j0 = jt * kT;
      mbar_wait(res_full, k & 1);
      ++k;
      if (warp == 0) chunk_decay<false>(cs, csl, dts, (double)A[it.g], chunk, lane);
      compute_sync();
      const double cs_end = cs[chunk - 1];
      double csj[2];
      float dtj[2], dec[2], wj[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        csj[h] = cs[j0 + r0 + 8 * h];
        dtj[h] = dts[j0 + r0 + 8 * h];
        dec[h] = expf((float)(cs_end - csj[h]));
        wj[h] = dec[h] * dtj[h];
      }
      // the state terms: gB_j, u_j, dx_j = w_j gB_j and dB_j = w_j X_j gst
      uint32_t xa[4 * NSP];
      a_frags<NSP>(xa, sb + NSN * kTileBytes, tid);
      float dxa[8 * NSP], dba[8 * NSN] = {}, gb[NP / 2] = {};  // the first products have scale-d 0
      auto state_step = [&](auto st) {
        const int b = step & 1;
        mbar_wait(full(b), (step >> 1) & 1);
        col_state<NSN, NSP, GS, NP, decltype(st)::value>(gb, dba, xa, res_b, stage(b));
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(b));
        ++step;
      };
      static_for<NSN / GS>(state_step);
      float u[2];
      state_u<NSP>(u, gb, xa);
#pragma unroll
      for (int i = 0; i < 8 * NSP; ++i) dxa[i] = wj[(i >> 1) & 1] * gb[i];
#pragma unroll
      for (int i = 0; i < 8 * NSN; ++i) dba[i] *= wj[(i >> 1) & 1];

      // the row tiles i >= j
      double colg[2] = {0.0, 0.0};
      float dd[2] = {0.f, 0.f};
      for (int i = jt; i < T; ++i, ++step) {
        const int b = step & 1, i0 = i * kT;
        const uint32_t c_s = stage(b), g_s = stage(b) + NSN * kTileBytes;
        mbar_wait(full(b), (step >> 1) & 1);
        float sc[32] = {}, dw[32] = {};  // not read: the first k-steps have scale-d 0
        col_scores<NSN, NSP>(sc, dw, res_b, res_x, c_s, g_s);
        // W^T, dS^T in place of S^T, dW^T; G's sums and ddt's direct term.
        // Register 4 q + 2 h + e holds row r0 + 8 h of j and column c + e
        // of i, c = 8 q + cq.  The diagonal tile keeps i >= j only, with L =
        // 2^(log2(e) (cs_i - cs_j)); the others take L = 2^(csl_i + bj),
        // bj = log2(e) (cs_i0 - cs_j) (chunk_decay).
        float bj[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) bj[h] = (float)((cs[i0] - csj[h]) * kLog2eD);
        auto elementwise = [&](auto diag_c) {
          constexpr bool diag = decltype(diag_c)::value;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = 8 * q + cq;
            const double2 ci = *reinterpret_cast<const double2*>(cs + i0 + c);
            const float2 cl = *reinterpret_cast<const float2*>(csl + i0 + c);
            double cg[2] = {0.0, 0.0};  // G's sums over this thread's rows, columns c and c + 1
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = 4 * q + 2 * h + e;
                float wv = 0.f, dsv = 0.f;
                if (!diag || c + e >= r0 + 8 * h) {
                  const float l = diag ? ex2((float)(((e ? ci.y : ci.x) - csj[h]) * kLog2eD))
                                       : ex2((e ? cl.y : cl.x) + bj[h]);
                  const float ldt = l * dtj[h];
                  const float sv = sc[idx], dv = dw[idx];
                  wv = sv * ldt;
                  dsv = dv * ldt;
                  const double gv = (double)(dv * wv);
                  colg[h] += gv;
                  cg[e] += gv;
                  dd[h] = fmaf(dv, sv * l, dd[h]);
                }
                sc[idx] = wv;
                dw[idx] = dsv;
              }
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              cg[0] += __shfl_xor_sync(0xffffffffu, cg[0], off);
              cg[1] += __shfl_xor_sync(0xffffffffu, cg[1], off);
            }
            if (lane < 4) {
              red[(buf * 4 + warp) * kT + c] = cg[0];
              red[(buf * 4 + warp) * kT + c + 1] = cg[1];
            }
          }
        };
        if (i == jt)
          elementwise(std::true_type{});
        else
          elementwise(std::false_type{});
        uint32_t wh[16], wl[16], sh[16], sl[16];
        split2(sc, wh, wl);
        split2(dw, sh, sl);
        col_updates<NSN, NSP>(dxa, dba, wh, wl, sh, sl, c_s, g_s);
        // G's row sums over this column tile, the four warps' in order
        compute_sync();
        if (tid < kT) {
          const double* rb = red + buf * 4 * kT + tid;
          scratch[(3 + jt) * plane + t0 + i0 + tid] = ((rb[0] + rb[kT]) + rb[2 * kT]) + rb[3 * kT];
        }
        buf ^= 1;
        wgmma_wait<0>();
        fence_regs(dxa);
        fence_regs(dba);
        fence_regs(wh);
        fence_regs(wl);
        fence_regs(sh);
        fence_regs(sl);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(b));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        colg[h] += __shfl_xor_sync(0xffffffffu, colg[h], 1);
        colg[h] += __shfl_xor_sync(0xffffffffu, colg[h], 2);
        dd[h] += __shfl_xor_sync(0xffffffffu, dd[h], 1);
        dd[h] += __shfl_xor_sync(0xffffffffu, dd[h], 2);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(res_empty);  // B_j, X_j, dt and cs are read
      if (lane % 4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = t0 + j0 + r0 + 8 * h;
          const float wu = wj[h] * u[h];
          scratch[row] = colg[h] + (double)wu;
          scratch[plane + row] = (double)wu;
          scratch[2 * plane + row] = (double)(dd[h] + dec[h] * u[h]);
        }
      }
      store_tile<NSP>(dxa, dx, t0 + j0, p, tid);
      store_tile<NSN>(dba, dB, t0 + j0, n, tid);
    }
  }
}

// The row pass: dC.  Warpgroup 1 loads: per row tile i, the first column
// tile's B_j and X_j by TMA, then gy_i split into two terms and dt
// (resident, once warpgroup 0 is done with the last tile's), then the
// other column tiles j <= i.  Warpgroup 0 computes.
template <int NSN, int NSP>
__global__ void __launch_bounds__(2 * kWg, 2)
ssd_bwd_row_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tb, const float* __restrict__ dt,
                        const float* __restrict__ A, const float* __restrict__ gy,
                        __nv_bfloat16* __restrict__ dC, int s, int p, int n, int chunk,
                        int n_items) {
  using L = RowLayout<NSN, NSP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  uint8_t* sb = smem_raw + (base - raw);
  const int T = chunk / kT, nc = s / chunk, n_pairs = (T + 1) / 2;
  const int nsn = n / kSlab, nsp = p / kSlab;
  const int res = L::res_bytes(chunk);
  float* dts = reinterpret_cast<float*>(sb + 2 * NSP * kTileBytes);
  double* cs = reinterpret_cast<double*>(dts + chunk);
  float* csl = reinterpret_cast<float*>(cs + chunk);
  const uint32_t bars = base + res + 2 * L::kStage;
  const uint32_t res_full = bars, res_empty = bars + 8;
  auto stage = [&](int b) { return base + res + b * L::kStage; };
  auto full = [&](int b) { return bars + 16 + 8 * b; };
  auto empty = [&](int b) { return bars + 32 + 8 * b; };
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(res_full, kWg + 1);
    mbar_init(res_empty, 4);
    for (int b = 0; b < 2; ++b) {
      mbar_init(full(b), 1);
      mbar_init(empty(b), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the stages' slabs past n and p stay 0; no load writes them
  if (tid < kWg) {
    for (int b = 0; b < 2; ++b) {
      uint8_t* sp = sb + res + b * L::kStage;
      zero_smem(sp + nsn * kTileBytes, (NSN - nsn) * kTileBytes, tid);
      zero_smem(sp + (NSN + nsp) * kTileBytes, (NSP - nsp) * kTileBytes, tid);
    }
    fence_async_smem();
  }
  __syncthreads();

  if (tid >= kWg) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int t = tid - kWg;
    int step = 0, k = 0;
    // column tile j of row tile i of item `it` into the ring (thread 0)
    auto tiles = [&](const Item& it, int j) {
      const int b = step & 1;
      mbar_wait(empty(b), ((step >> 1) & 1) ^ 1);
      mbar_expect_tx(full(b), (nsn + nsp) * kTileBytes);
      const int row = it.z * chunk + j * kT;
      for (int sl = 0; sl < nsn; ++sl)
        tma_load(stage(b) + sl * kTileBytes, &tb, full(b), kSlab * sl, row, it.g, 0);
      for (int sl = 0; sl < nsp; ++sl)
        tma_load(stage(b) + (NSN + sl) * kTileBytes, &tx, full(b), kSlab * sl, row, it.g, 0);
    };
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const Item it(w, nc, n_pairs);
      const long long t0 = (long long)it.g * s + (long long)it.z * chunk;
      for (int half = 0; half < 2; ++half) {
        const int i = half ? it.pr : T - 1 - it.pr;
        if (half && i == T - 1 - it.pr) break;
        if (t == 0) tiles(it, 0);
        ++step;
        mbar_wait(res_empty, (k & 1) ^ 1);
        ++k;
        if (t == 0) {
          mbar_expect_tx(res_full, chunk * 4);
          bulk_load(smem_addr(dts), dt + t0, chunk * 4, res_full);
        }
        split_tile<2, kT, 16 * NSP>(sb, NSP * kTileBytes, kTileBytes, gy + (t0 + i * kT) * p, p,
                                    kT, p, t);
        fence_async_smem();
        mbar_arrive(res_full);
        for (int j = 1; j <= i; ++j, ++step)
          if (t == 0) tiles(it, j);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = frag_row(0, tid);
  const int cq = 2 * (lane % 4);
  int step = 0, k = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const Item it(w, nc, n_pairs);
    const long long t0 = (long long)it.g * s + (long long)it.z * chunk;
    for (int half = 0; half < 2; ++half) {
      const int i = half ? it.pr : T - 1 - it.pr;
      if (half && i == T - 1 - it.pr) break;
      const int i0 = i * kT;
      mbar_wait(res_full, k & 1);
      ++k;
      if (warp == 0) chunk_decay<true>(cs, csl, dts, (double)A[it.g], chunk, lane);
      compute_sync();
      const double csi[2] = {cs[i0 + r0], cs[i0 + r0 + 8]};
      float dca[8 * NSN];
#pragma unroll
      for (int q = 0; q < 8 * NSN; ++q) dca[q] = 0.f;
      for (int j = 0; j <= i; ++j, ++step) {
        const int b = step & 1, j0 = j * kT;
        mbar_wait(full(b), (step >> 1) & 1);
        float dw[32] = {};  // not read: the first k-step has scale-d 0
        row_scores<NSP>(dw, base, stage(b) + NSN * kTileBytes);
        // dS in place of dW: register 4 q + 2 h + e holds row r0 + 8 h of i
        // and column c + e of j, c = 8 q + cq.  The diagonal keeps j <= i
        // only, with L = 2^(log2(e) (cs_i - cs_j)); the other tiles take L
        // = 2^(ai - csl_j), ai = log2(e) (cs_i - cs_j1), j1 the tile's last
        // row (chunk_decay).
        float ai[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) ai[h] = (float)((csi[h] - cs[j0 + kT - 1]) * kLog2eD);
        auto elementwise = [&](auto diag_c) {
          constexpr bool diag = decltype(diag_c)::value;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = 8 * q + cq;
            const double2 cj = *reinterpret_cast<const double2*>(cs + j0 + c);
            const float2 cl = *reinterpret_cast<const float2*>(csl + j0 + c);
            const float2 dj = *reinterpret_cast<const float2*>(dts + j0 + c);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = 4 * q + 2 * h + e;
                float ds = 0.f;
                if (!diag || c + e <= r0 + 8 * h) {
                  const float l = diag ? ex2((float)((csi[h] - (e ? cj.y : cj.x)) * kLog2eD))
                                       : ex2(ai[h] - (e ? cl.y : cl.x));
                  ds = dw[idx] * (l * (e ? dj.y : dj.x));
                }
                dw[idx] = ds;
              }
          }
        };
        if (j == i)
          elementwise(std::true_type{});
        else
          elementwise(std::false_type{});
        uint32_t sh[16], sl[16];
        split2(dw, sh, sl);
        row_update<NSN>(dca, sh, sl, stage(b));
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(b));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(res_empty);  // gy_i, dt and cs are read
      store_tile<NSN>(dca, dC, t0 + i0, n, tid);
    }
  }
}

// The fragment-layout check: one warpgroup loads B and C (64, n) and X (64,
// p) by TMA and splits gy (64, p) and gst (p, n) into three terms as the
// passes do, then writes each accumulator register where the passes take it
// to lie: s_out = B C^T and dw_out = X gy^T (the column pass's S^T and
// dW^T, 64 x 64), dx_out = W^T gy (64, p) and db_out = dS^T C (64, n) from
// given W^T and dS^T (64 x 64, split into two terms as register A
// operands), gb_out = B gst^T (64, p), xg_out = X gst (64, n), u_out = the
// row sums of X gB (64), and dwr_out = gy X^T from gy's first two terms (the
// row pass's dW, 64 x 64).
template <int NSN, int NSP>
__global__ void __launch_bounds__(kWg)
ssd_bwd_probe_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc, const float* __restrict__ gy,
                     const float* __restrict__ gst, const float* __restrict__ Wt,
                     const float* __restrict__ Dt, float* __restrict__ s_out,
                     float* __restrict__ dw_out, float* __restrict__ dx_out,
                     float* __restrict__ db_out, float* __restrict__ gb_out,
                     float* __restrict__ xg_out, float* __restrict__ u_out,
                     float* __restrict__ dwr_out, int p, int n) {
  constexpr int NP = ColLayout<NSN, NSP>::NP, kSlabG = NP * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  uint8_t* sb = smem_raw + (base - raw);
  const uint32_t b_s = base, c_s = b_s + NSN * kTileBytes, x_s = c_s + NSN * kTileBytes;
  const uint32_t g_s = x_s + NSP * kTileBytes, st_s = g_s + 3 * NSP * kTileBytes;
  const uint32_t bar = st_s + 3 * NSN * kSlabG;
  const int t = threadIdx.x, nsn = n / kSlab, nsp = p / kSlab;
  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_smem(sb + (b_s - base) + nsn * kTileBytes, (NSN - nsn) * kTileBytes, t);
  zero_smem(sb + (c_s - base) + nsn * kTileBytes, (NSN - nsn) * kTileBytes, t);
  zero_smem(sb + (x_s - base) + nsp * kTileBytes, (NSP - nsp) * kTileBytes, t);
  split_tile<3, kT, 16 * NSP>(sb + (g_s - base), NSP * kTileBytes, kTileBytes, gy, p, kT, p, t);
  split_tile<3, NP, 16 * NSN>(sb + (st_s - base), NSN * kSlabG, kSlabG, gst, n, p, n, t);
  fence_async_smem();
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, (2 * nsn + nsp) * kTileBytes);
    for (int sl = 0; sl < nsn; ++sl) {
      tma_load(b_s + sl * kTileBytes, &tb, bar, kSlab * sl, 0, 0, 0);
      tma_load(c_s + sl * kTileBytes, &tc, bar, kSlab * sl, 0, 0, 0);
    }
    for (int sl = 0; sl < nsp; ++sl) tma_load(x_s + sl * kTileBytes, &tx, bar, kSlab * sl, 0, 0, 0);
  }
  mbar_wait(bar, 0);

  float sc[32] = {}, dw[32] = {};
  col_scores<NSN, NSP>(sc, dw, b_s, x_s, c_s, g_s);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s_out[frag_row(i, t) * kT + frag_col(i, t)] = sc[i];
    dw_out[frag_row(i, t) * kT + frag_col(i, t)] = dw[i];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = Wt[frag_row(i, t) * kT + frag_col(i, t)];
    dw[i] = Dt[frag_row(i, t) * kT + frag_col(i, t)];
  }
  uint32_t wh[16], wl[16], sh[16], sl[16];
  split2(sc, wh, wl);
  split2(dw, sh, sl);
  float dxa[8 * NSP], dba[8 * NSN];
#pragma unroll
  for (int i = 0; i < 8 * NSP; ++i) dxa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8 * NSN; ++i) dba[i] = 0.f;
  col_updates<NSN, NSP>(dxa, dba, wh, wl, sh, sl, c_s, g_s);
  wgmma_wait<0>();
  fence_regs(dxa);
  fence_regs(dba);
#pragma unroll
  for (int i = 0; i < 8 * NSP; ++i)
    if (frag_col(i, t) < p) dx_out[frag_row(i, t) * p + frag_col(i, t)] = dxa[i];
#pragma unroll
  for (int i = 0; i < 8 * NSN; ++i)
    if (frag_col(i, t) < n) db_out[frag_row(i, t) * n + frag_col(i, t)] = dba[i];

  uint32_t xa[4 * NSP];
  a_frags<NSP>(xa, sb + (x_s - base), t);
  float gb[NP / 2] = {};
  col_state<NSN, NSP, NSN, NP, 0>(gb, dba, xa, b_s, st_s);
  float u[2];
  state_u<NSP>(u, gb, xa);
#pragma unroll
  for (int i = 0; i < 8 * NSP; ++i)
    if (frag_col(i, t) < p) gb_out[frag_row(i, t) * p + frag_col(i, t)] = gb[i];
#pragma unroll
  for (int i = 0; i < 8 * NSN; ++i)
    if (frag_col(i, t) < n) xg_out[frag_row(i, t) * n + frag_col(i, t)] = dba[i];
  if (t % 4 == 0) {
    u_out[frag_row(0, t)] = u[0];
    u_out[frag_row(0, t) + 8] = u[1];
  }
  row_scores<NSP>(dw, g_s, x_s);
#pragma unroll
  for (int i = 0; i < 32; ++i) dwr_out[frag_row(i, t) * kT + frag_col(i, t)] = dw[i];
}

// 4-D map (cols, s, bh, 1) of a contiguous (bh, s, cols) bf16 tensor, boxes
// of 16 columns x 64 rows
int encode_rows(CUtensorMap* map, const void* ptr, int cols, int s, int bh) {
  const long long st[3] = {(long long)s * cols, (long long)s * cols, cols};
  return encode_map(map, ptr, cols, s, bh, 1, st, kT);
}

// the bf16 passes' shape domain (the wrapper's check_bf16_bwd_domain, with
// the operands' alignment)
bool bf16_bwd_domain(int chunk, int p, int n) {
  return chunk > 0 && chunk % kT == 0 && p % kSlab == 0 && n % kSlab == 0 && p > 0 && n > 0 &&
         p <= 128 && n <= 128;
}

struct Bf16BwdLaunch {
  const CUtensorMap *tx, *tb, *tc;
  const float *dt, *A, *gy, *gst;
  __nv_bfloat16 *dx, *dB, *dC;
  float *ddt, *dA;
  double* scratch;
  int bh, s, p, n, chunk;
  cudaStream_t stream;

  // the persistent grid of a pass: as many blocks as fit on the card at
  // once, at most one per work item
  template <typename K>
  int blocks(K kern, int smem, long long items, int* out) const {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = sm_count(&sms);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 2 * kWg, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *out = (int)(items < (long long)per_sm * sms ? items : (long long)per_sm * sms);
    return cudaSuccess;
  }

  // NSN, NSP: n and p in 16-column slabs, rounded up to 1, 2, 4 or 8
  template <int NSN, int NSP>
  int run() const {
    const int smem_c = ColLayout<NSN, NSP>::bytes(chunk);
    const int smem_r = RowLayout<NSN, NSP>::bytes(chunk);
    if (smem_c > kSmemLimit || smem_r > kSmemLimit) return cudaErrorInvalidValue;
    const int T = chunk / kT;
    const long long items = (long long)bh * (s / chunk) * ((T + 1) / 2);
    if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
    const long long plane = (long long)bh * s;
    auto col = ssd_bwd_col_bf16_kernel<NSN, NSP>;
    auto row = ssd_bwd_row_bf16_kernel<NSN, NSP>;
    int grid = 0;
    int err = blocks(col, smem_c, items, &grid);
    if (err != cudaSuccess) return err;
    col<<<grid, 2 * kWg, smem_c, stream>>>(*tx, *tb, *tc, dt, A, gy, gst, dx, dB, scratch, s, p, n,
                                          chunk, (int)items, plane);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = blocks(row, smem_r, items, &grid);
    if (err != cudaSuccess) return err;
    row<<<grid, 2 * kWg, smem_r, stream>>>(*tx, *tb, dt, A, gy, dC, s, p, n, chunk, (int)items);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_intra_chunk_bwd_finish_kernel<<<(bh + 3) / 4, 128, 0, stream>>>(dt, A, scratch, ddt, dA, bh,
                                                                         s, chunk, plane, T);
    return cudaGetLastError();
  }
};

struct ProbeLaunch {
  const CUtensorMap *tx, *tb, *tc;
  const float *gy, *gst, *Wt, *Dt;
  float *s_out, *dw_out, *dx_out, *db_out, *gb_out, *xg_out, *u_out, *dwr_out;
  int p, n;
  cudaStream_t stream;

  template <int NSN, int NSP>
  int run() const {
    constexpr int NP = ColLayout<NSN, NSP>::NP;
    const int smem =
        (2 * NSN + 4 * NSP) * kTileBytes + 3 * NSN * NP * kRowBytes + kBarBytes + kAlign;
    auto kern = ssd_bwd_probe_kernel<NSN, NSP>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<1, kWg, smem, stream>>>(*tx, *tb, *tc, gy, gst, Wt, Dt, s_out, dw_out, dx_out, db_out,
                                   gb_out, xg_out, u_out, dwr_out, p, n);
    return cudaGetLastError();
  }
};

// f.run<NSN, NSP>() for n and p in 16-column slabs, computed as 4 (up to
// 64 columns) or 8 (up to 128): four instantiations of each kernel
template <int NSN, typename F>
int with_p64(int p, const F& f) {
  if (p <= 64) return f.template run<NSN, 4>();
  if (p <= 128) return f.template run<NSN, 8>();
  return cudaErrorInvalidValue;
}

template <typename F>
int with_slabs(int n, int p, const F& f) {
  if (n <= 64) return with_p64<4>(p, f);
  if (n <= 128) return with_p64<8>(p, f);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// ssd_intra_chunk_bwd_kernel and the finish.  dtype of x, B, C and dx, dB,
// dC: 0 float32, 1 bfloat16.  s must be a multiple of chunk; p and n from 1
// to 128; the chunk's cs, dt and tiles within a block's shared memory; at
// most 65535 heads and chunks (the wrapper's check_bwd_domain).  scratch: 4
// x bh x s fp64.
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

// The bf16 passes and the finish: x, B, C, dx, dB, dC bf16, the rest as
// above; chunk a multiple of 64, p and n multiples of 16 up to 128, every
// operand 16-byte aligned, both passes within a block's shared memory (the
// wrapper's check_bf16_bwd_domain).  scratch: (3 + chunk / 64) x bh x s
// fp64.
int ssd_intra_chunk_bwd_bf16_launch(const void* x, const void* dt, const void* A, const void* B,
                                    const void* C, const void* gy, const void* gst, void* dx,
                                    void* ddt, void* dA, void* dB, void* dC, void* scratch,
                                    int bh, int s, int p, int n, int chunk, void* stream) {
  if (bh == 0 || s == 0) return cudaSuccess;
  if (s % chunk != 0 || !bf16_bwd_domain(chunk, p, n)) return cudaErrorInvalidValue;
  const void* operands[] = {x, dt, B, C, gy, gst};
  for (const void* ptr : operands)
    if (!aligned16(ptr)) return cudaErrorInvalidValue;
  CUtensorMap tx, tb, tc;
  int err = encode_rows(&tx, x, p, s, bh);
  if (err == cudaSuccess) err = encode_rows(&tb, B, n, s, bh);
  if (err == cudaSuccess) err = encode_rows(&tc, C, n, s, bh);
  if (err != cudaSuccess) return err;
  const Bf16BwdLaunch f{&tx, &tb, &tc,
                        static_cast<const float*>(dt), static_cast<const float*>(A),
                        static_cast<const float*>(gy), static_cast<const float*>(gst),
                        static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(dB),
                        static_cast<__nv_bfloat16*>(dC), static_cast<float*>(ddt),
                        static_cast<float*>(dA), static_cast<double*>(scratch),
                        bh, s, p, n, chunk, static_cast<cudaStream_t>(stream)};
  return with_slabs(n, p, f);
}

// The fragment-layout check (ssd_bwd_probe_kernel): B and C (64, n), X (64,
// p) contiguous bf16; gy (64, p), gst (p, n), Wt and Dt (64, 64) contiguous
// fp32; p and n multiples of 16 up to 128.  Outputs fp32: s_out, dw_out,
// dwr_out (64, 64), dx_out and gb_out (64, p), db_out and xg_out (64, n),
// u_out (64).
int ssd_bwd_probe_launch(const void* B, const void* C, const void* X, const float* gy,
                         const float* gst, const float* Wt, const float* Dt, float* s_out,
                         float* dw_out, float* dx_out, float* db_out, float* gb_out,
                         float* xg_out, float* u_out, float* dwr_out, int p, int n,
                         void* stream) {
  if (!bf16_bwd_domain(kT, p, n) || !aligned16(gy) || !aligned16(gst))
    return cudaErrorInvalidValue;
  CUtensorMap tx, tb, tc;
  int err = encode_rows(&tx, X, p, kT, 1);
  if (err == cudaSuccess) err = encode_rows(&tb, B, n, kT, 1);
  if (err == cudaSuccess) err = encode_rows(&tc, C, n, kT, 1);
  if (err != cudaSuccess) return err;
  const ProbeLaunch f{&tx, &tb, &tc, gy, gst, Wt, Dt, s_out, dw_out, dx_out, db_out,
                      gb_out, xg_out, u_out, dwr_out, p, n, static_cast<cudaStream_t>(stream)};
  return with_slabs(n, p, f);
}

}  // extern "C"
