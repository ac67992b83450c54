// The Mamba2 SSD intra-chunk term, for Hopper (sm_90a), behind a plain C
// interface that kernels/_build.py loads with ctypes.  The launcher
// enqueues on the caller's stream, allocates nothing, does not synchronise,
// and returns the cudaError_t of the launch.
//
// Replaces src/repro/kernels/ssd_scan.py `_kernel` (built by
// `ssd_intra_chunk`).  Per (head, chunk) of Q positions, in fp32:
//   cs      = cumsum(dt * A)                              (Q)
//   y_intra = ((C B^T) * tril(exp(cs_i - cs_j)) * dt_j) X  (Q, p)
//   state   = X^T (B * exp(cs_Q-1 - cs) * dt)              (p, n)
// x, B, C are (bh, s, .) in bf16 or fp32, dt (bh, s) and A (bh) fp32;
// y (bh, s, p) and the chunk states (bh, s / Q, p, n) are fp32.  cs is
// computed by one warp: each lane scans a run of Q / 32, then the runs'
// totals are scanned by shuffles.  Each dtype has one kernel:
//
// ssd_intra_chunk_kernel (bf16)
//   Bound on this card: at the serving shape (bh 320, s 1024, p = n = 64,
//   Q 256) the bytes, 232 MB at 3.35 TB/s, 0.069 ms (x, B, C and dt read
//   once, y and the states written once); the products, 21.5 GFLOP with
//   the split below, take 0.022 ms at the bf16 tensor-core rate.
//   Design: a persistent block per SM walks (head, chunk) work items, each
//   chunk's C, B, X and dt whole in shared memory (bf16, 96 KB at the
//   serving shape), in two stages where they fit, so that the next item's
//   TMA loads run while an item is computed.  The operands are cut into
//   slabs of 16 columns (32-byte swizzle), as in flash_attention.cu.
//   Warpgroup 3 starts the loads; warpgroups 0 and 1 own the 64-row tiles r
//   of y, row tiles 0, 3, 4, 7.. and 1, 2, 5, 6.. (equal work: row tile r
//   has r + 1 column tiles).  Per column tile j <= r: S = C_r B_j^T on the
//   tensor cores (wgmma, bf16 in, fp32 sums, both operands K-major in
//   shared memory: exact products); W = S * exp(cs_i - cs_j) * dt_j on the
//   accumulator fragment (the mask on the diagonal tile only); W split into
//   hi = bf16(W) and lo = bf16(W - hi), both A fragments in registers;
//   y_r += hi X_j + lo X_j, X read MN-major.  X is bf16, so both products
//   are exact and the split keeps about 16 bits of W (one bf16 rounding of
//   W would miss the reference's fp32 tolerance).  Warpgroup 2 computes the
//   chunk state the same way, (X w)^T B with w_j = exp(cs_Q-1 - cs_j) dt_j:
//   the A fragments of (X w)^T come from the X slabs by ldmatrix.trans,
//   split into hi + lo, B read MN-major; then it computes the next item's
//   cs and w.  y and the state go from the accumulators straight to device
//   memory.  Domain: Q a multiple of 64, p and n multiples of 16 up to 128,
//   one chunk within shared memory.
//
// ssd_intra_chunk_fp32_kernel (fp32)
//   wgmma has no full-fp32 mode, so fp32 stays on the CUDA cores.  The
//   (Q x Q) fp32 score tile is 256 KB at Q = 256, more than a block's 227 KB
//   of shared memory, so the chunk is tiled: one block of 256 threads per
//   (row tile, chunk, head); row tile r < ceil(Q / 64) owns output rows
//   [64 r, 64 r + 64) and walks the column tiles j <= r, building C_i B_j^T
//   (each thread 4 x 4), masking and weighting it, and accumulating W X_j
//   into 4 rows x p / 16 columns of registers.  The last block of each
//   (chunk, head) computes the chunk state the same way, 64 state columns at
//   a time.  Every block recomputes the chunk's cs.
//
// ssd_probe_kernel checks, on the card, the fragment layouts the bf16 kernel
// rests on: one warpgroup computes S = C B^T, (hi + lo)(W) X for a given W,
// and one state product, with the kernel's loads, descriptors and products,
// and writes each accumulator register where the kernel assumes it lies.

#include "hopper.cuh"

namespace {

// cs = cumsum(dt * a) of a chunk, by the 32 lanes of one warp: each lane
// scans a run of chunk / 32 (rounded up), then the runs' totals are scanned
// by shuffles; dts holds the chunk's dt in shared memory
__device__ __forceinline__ void chunk_cumsum(float* cs, const float* dts, float a, int chunk,
                                             int lane) {
  const int per = (chunk + 31) / 32;
  const int lo = min(chunk, lane * per), hi = min(chunk, lo + per);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    run += dts[t] * a;
    cs[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float before = incl - run;
  for (int t = lo; t < hi; ++t) cs[t] += before;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads32 = 256;
constexpr int kT = 64;   // rows and columns of a tile
constexpr int kTS = kT + 1;

// shared floats of the row-tile blocks (the state block needs fewer)
inline int smem_floats(int chunk, int n, int pp) {
  return 2 * chunk + kT * (n + 1) + n * kTS + kT * pp + kT * kTS;
}

// PPT = output columns per thread (p <= 16 * PPT)
template <int PPT>
__global__ void __launch_bounds__(kThreads32)
ssd_intra_chunk_fp32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ A, const float* __restrict__ B,
                            const float* __restrict__ C, float* __restrict__ y,
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
  const float* xg = x + t0 * p;
  const float* Bg = B + t0 * n;
  const float* Cg = C + t0 * n;

  for (int t = tid; t < chunk; t += kThreads32) dts[t] = dt[t0 + t];
  __syncthreads();
  if (tid < 32) chunk_cumsum(cs, dts, A[g], chunk, tid);
  __syncthreads();

  if (tile < n_row_tiles) {
    float* Cs = work;             // [kT][n + 1]   C rows of this tile
    float* Bt = Cs + kT * (n + 1);  // [n][kTS]    B rows of a column tile, transposed
    float* Xs = Bt + n * kTS;     // [kT][PP]      x rows of a column tile
    float* Ws = Xs + kT * PP;     // [kT][kTS]     masked, weighted scores
    const int CS = n + 1;
    const int i0 = tile * kT;
    for (int idx = tid; idx < kT * n; idx += kThreads32) {
      const int r = idx / n, c = idx - r * n;
      Cs[r * CS + c] = (i0 + r < chunk) ? Cg[(long long)(i0 + r) * n + c] : 0.f;
    }
    float acc[4][PPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PPT; ++j) acc[i][j] = 0.f;

    for (int j0 = 0; j0 <= i0; j0 += kT) {
      __syncthreads();
      for (int idx = tid; idx < kT * n; idx += kThreads32) {
        const int r = idx / n, c = idx - r * n;
        Bt[c * kTS + r] = (j0 + r < chunk) ? Bg[(long long)(j0 + r) * n + c] : 0.f;
      }
      for (int idx = tid; idx < kT * PP; idx += kThreads32) {
        const int r = idx / PP, c = idx - r * PP;
        Xs[idx] = (j0 + r < chunk && c < p) ? xg[(long long)(j0 + r) * p + c] : 0.f;
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
      for (int idx = tid; idx < kT * PP; idx += kThreads32) {
        const int r = idx / PP, c = idx - r * PP;
        Xs[idx] = (j0 + r < chunk && c < p) ? xg[(long long)(j0 + r) * p + c] : 0.f;
      }
      for (int idx = tid; idx < kT * kT; idx += kThreads32) {
        const int r = idx / kT, c = idx - r * kT;
        float w = 0.f;
        if (j0 + r < chunk && n0 + c < n)
          w = Bg[(long long)(j0 + r) * n + n0 + c] * (expf(seg_end - cs[j0 + r]) * dts[j0 + r]);
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

template <int PPT>
int launch_fp32(const void* x, const void* dt, const void* A, const void* B, const void* C,
                void* y, void* states, int bh, int s, int p, int n, int chunk,
                cudaStream_t st) {
  const int smem = smem_floats(chunk, n, PPT * 16) * (int)sizeof(float);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kern = ssd_intra_chunk_fp32_kernel<PPT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_row_tiles = (chunk + kT - 1) / kT;
  const dim3 grid(n_row_tiles + 1, s / chunk, bh);
  kern<<<grid, kThreads32, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(states), s, p, n, chunk, n_row_tiles);
  return cudaGetLastError();
}

int dispatch_fp32(const void* x, const void* dt, const void* A, const void* B, const void* C,
                  void* y, void* states, int bh, int s, int p, int n, int chunk,
                  cudaStream_t st) {
  if (bh > 65535) return cudaErrorInvalidValue;
  const int ppt = (p + 15) / 16;
  if (ppt <= 1) return launch_fp32<1>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  if (ppt <= 2) return launch_fp32<2>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  if (ppt <= 4) return launch_fp32<4>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  if (ppt <= 8) return launch_fp32<8>(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the whole chunk, loaded by TMA
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                        // rows of a row or column tile
constexpr int kTileBytes = kTile * kRowBytes;    // one tile of one slab, 2 KB
constexpr int kConsumers = 384;                  // warpgroups 0, 1: y; 2: the chunk state
constexpr int kThreads16 = kConsumers + 128;     // warpgroup 3 starts the loads

// one stage of the bf16 kernel's shared memory: a chunk's C, B and X slabs
// (chunk rows of 32 bytes each), then its dt, cs and the state's weights w
// (chunk floats each)
__host__ __device__ inline int stage_bytes(int chunk, int p, int n) {
  return chunk * kRowBytes * (2 * (n / kSlab) + p / kSlab) + 3 * chunk * 4;
}

// dynamic shared memory of the bf16 kernel with `stages` chunk buffers: the
// stages, three mbarriers each, and slack to align the base to 1024 bytes
__host__ __device__ inline int bf16_smem_bytes(int chunk, int p, int n, int stages) {
  return stages * (stage_bytes(chunk, p, n) + 24) + 1024;
}

// rows of one TMA box of a chunk: the chunk, or the largest of 256, 128
// and 64 that divides it (a box spans at most 256 rows)
__host__ __device__ inline int box_rows(int chunk) {
  return chunk <= 256 ? chunk : chunk % 256 == 0 ? 256 : chunk % 128 == 0 ? 128 : kTile;
}

// the y warpgroup of row tile r: 0 for r = 0, 3, 4, 7, .., 1 for 1, 2, 5, 6, ..
__device__ __forceinline__ int y_owner(int r) { return (r ^ (r >> 1)) & 1; }

// w (fp32 fragment) -> hi = bf16(w) and lo = bf16(w - hi), packed in pairs
// as A fragments (pack_bf16's order)
template <int N>
__device__ __forceinline__ void split_bf16(const float (&w)[N], uint32_t (&hi)[N / 2],
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

// S (64 x 64 fp32 fragment) = C_r B_j^T: one k-step per slab of n, both
// operands K-major; c and b are the shared addresses of slab 0 of the row
// tile and of the column tile, slab the bytes of one slab
template <int NSN>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t c, uint32_t b, int slab) {
  uint64_t dc[NSN], db[NSN];
#pragma unroll
  for (int kk = 0; kk < NSN; ++kk) {
    dc[kk] = sw32_desc(c + kk * slab, 16, 256);
    db[kk] = sw32_desc(b + kk * slab, 16, 256);
  }
  fence_regs(dc);
  fence_regs(db);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NSN; ++kk) wgmma_ss_n64(s, dc[kk], db[kk], kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// W = S * exp(cs_i - cs_j) * dt_j on the S fragment of the row tile at i0
// and the column tile at j0 (chunk positions), masked to j <= i on the
// diagonal tile only (a separate instantiation), then split into hi + lo A
// fragments.  Registers 4 q + 2 h + e hold row frag_row + 8 h and column
// 8 q + 2 (lane % 4) + e, so cs and dt are read in pairs.
template <bool kDiag>
__device__ __forceinline__ void weights(float (&s)[32], uint32_t (&hi)[16], uint32_t (&lo)[16],
                                        const float* cs, const float* dts, int i0, int j0,
                                        int t128) {
  const int row = frag_row(0, t128);
  const float csi[2] = {cs[i0 + row], cs[i0 + row + 8]};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int col = 8 * q + 2 * (t128 % 4);
    const float2 csj = *reinterpret_cast<const float2*>(cs + j0 + col);
    const float2 dtj = *reinterpret_cast<const float2*>(dts + j0 + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * q + 2 * h;
      float w0 = s[i] * ex2((csi[h] - csj.x) * kLog2e) * dtj.x;
      float w1 = s[i + 1] * ex2((csi[h] - csj.y) * kLog2e) * dtj.y;
      if (kDiag) {
        if (col > row + 8 * h) w0 = 0.f;
        if (col + 1 > row + 8 * h) w1 = 0.f;
      }
      s[i] = w0;
      s[i + 1] = w1;
    }
  }
  split_bf16(s, hi, lo);
}

// D (64 x 16 NS) += (hi + lo) (64 x 64 keys) T (64 keys x 16 NS): per k-step
// of 16 keys one product of each term, T read MN-major from its tile at t
// (LBO = one slab); the y product (T = X_j) and the state's (T = B_j)
template <int NS>
__device__ __forceinline__ void split_product(float (&d)[8 * NS], uint32_t (&hi)[16],
                                              uint32_t (&lo)[16], uint32_t t, int slab) {
  uint64_t desc[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) desc[kk] = sw32_desc(t + kk * 16 * kRowBytes, slab, 256);
  fence_regs(desc);
  fence_regs(hi);
  fence_regs(lo);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(d, &hi[4 * kk], desc[kk], 1);
    wgmma_rs(d, &lo[4 * kk], desc[kk], 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(hi);
  fence_regs(lo);
}

// four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 (16 bytes) of matrix l / 8 and gets, in register q,
// the elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of matrix q
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// hi + lo A fragments of (X w)^T for the keys j0 .. j0 + 63 and the state
// rows m0 .. m0 + 63 (head-dim columns of X, 0 from 16 NSP on), read from
// the X slabs at xs by ldmatrix.trans: per k-step, matrix q of a warp holds
// its rows + 8 (q & 1) and keys + 8 (q >> 1), the A fragment's register q.
// A 16-byte row of 8 columns stays whole in the 32-byte swizzle, which only
// swaps the two halves of a row (bit 4 of the offset flipped by its bit 7).
template <int NSP>
__device__ __forceinline__ void state_frags(uint32_t (&hi)[16], uint32_t (&lo)[16],
                                            uint32_t xs, int slab, const float* ws, int j0,
                                            int m0, int t128) {
  const int lane = t128 % 32;
  const int mb = m0 + 16 * (t128 / 32);  // this warp's 16 state rows
  if (mb >= 16 * NSP) {
#pragma unroll
    for (int i = 0; i < 16; ++i) hi[i] = lo[i] = 0u;
    return;
  }
  const int half = (lane >> 3) & 1;                // columns mb + 8 half ..
  const int jr = 8 * (lane >> 4) + (lane & 7);     // key of this lane's row
  const uint32_t col = xs + (mb / kSlab) * slab;
  float v[32];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j = j0 + 16 * kk + jr;
    uint32_t r[4];
    ldmatrix_x4_trans(r, col + j * kRowBytes + ((half ^ ((j >> 2) & 1)) << 4));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 w = *reinterpret_cast<const float2*>(
          ws + j0 + 16 * kk + 8 * (q >> 1) + 2 * (lane % 4));
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&r[q]);
      v[8 * kk + 2 * q] = __low2float(x) * w.x;
      v[8 * kk + 2 * q + 1] = __high2float(x) * w.y;
    }
  }
  split_bf16(v, hi, lo);
}

// Persistent: block k takes the (head, chunk) work items k, k + gridDim.x,
// ..; item it of the block is loaded into stage it % stages, the next
// stages - 1 items' loads in flight while it is computed.  A warpgroup of
// its own starts the loads (a stage in a few TMA boxes of a slab of up to
// 256 rows each): the thread that starts them waits while the TMA queue is
// full, and no consumer's products should wait with it.  It gives its
// registers to the consumers (setmaxnreg: 3 x 152 + 40 of the 512 that a
// lane of each of the SM's four register files holds for the block's four
// warps on it).  With two stages the first warp of warpgroup 2 computes the
// next item's cs and w once its state is done, so that only the first item
// waits for a scan.  Per stage, mbarriers: full (the loads' bytes),
// scanned (cs and w written), empty (every consumer warp is done with it).
template <int NSN, int NSP>
__global__ void __launch_bounds__(kThreads16, 1)
ssd_intra_chunk_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tc, const float* __restrict__ dt,
                       const float* __restrict__ A, float* __restrict__ y,
                       float* __restrict__ states, int s, int chunk, int n_work, int stages) {
  constexpr int P = 16 * NSP, N = 16 * NSN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const int n_tiles = chunk / kTile;
  const int rows = box_rows(chunk);
  const int slab = chunk * kRowBytes;
  const int sb = stage_bytes(chunk, P, N);
  const int dt_off = (2 * NSN + NSP) * slab;  // dt, cs and w within a stage
  const uint32_t bar0 = base + stages * sb;
  const int nc = s / chunk;
  const int tid = threadIdx.x;
  auto c_s = [&](int b) { return base + b * sb; };
  auto b_s = [&](int b) { return base + b * sb + NSN * slab; };
  auto x_s = [&](int b) { return base + b * sb + 2 * NSN * slab; };
  auto dt_s = [&](int b) { return reinterpret_cast<float*>(sbase + b * sb + dt_off); };
  auto full = [&](int b) { return bar0 + 24 * b; };
  auto scanned = [&](int b) { return bar0 + 24 * b + 8; };
  auto empty = [&](int b) { return bar0 + 24 * b + 16; };

  if (tid == 0) {
    for (int b = 0; b < stages; ++b) {
      mbar_init(full(b), 1);
      mbar_init(scanned(b), 1);
      mbar_init(empty(b), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kConsumers) {
    // every copy of each work item: its dt, then its slabs in boxes of
    // `rows`, into a stage that every consumer warp is done with
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != kConsumers) return;
    for (int it = 0;; ++it) {
      const int w = blockIdx.x + it * gridDim.x;
      if (w >= n_work) return;
      const int g = w / nc, z = w % nc, b = it % stages;
      if (it >= stages) mbar_wait(empty(b), (it / stages - 1) & 1);
      mbar_expect_tx(full(b), dt_off + chunk * 4);
      bulk_load(base + b * sb + dt_off, dt + (long long)g * s + z * chunk, chunk * 4, full(b));
      for (int r0 = 0; r0 < chunk; r0 += rows) {
        const int row = z * chunk + r0;
        for (int sl = 0; sl < NSN; ++sl) {
          tma_load(c_s(b) + sl * slab + r0 * kRowBytes, &tc, full(b), kSlab * sl, row, g, 0);
          tma_load(b_s(b) + sl * slab + r0 * kRowBytes, &tb, full(b), kSlab * sl, row, g, 0);
        }
        for (int sl = 0; sl < NSP; ++sl)
          tma_load(x_s(b) + sl * slab + r0 * kRowBytes, &tx, full(b), kSlab * sl, row, g, 0);
      }
    }
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
  // cs and w of work item it from its dt, by one warp, then its scanned
  // barrier; nothing past the last item
  auto decay = [&](int it, int lane) {
    const int w = blockIdx.x + it * gridDim.x;
    if (w >= n_work) return;
    const int b = it % stages;
    const float* dts = dt_s(b);
    float* cs = dt_s(b) + chunk;
    float* ws = cs + chunk;
    mbar_wait(full(b), (it / stages) & 1);
    chunk_cumsum(cs, dts, A[w / nc], chunk, lane);
    __syncwarp();
    const float seg_end = cs[chunk - 1];
    for (int t = lane; t < chunk; t += 32) ws[t] = expf(seg_end - cs[t]) * dts[t];
    __syncwarp();
    if (lane == 0) mbar_arrive(scanned(b));
  };

  const int wg = tid / 128, t128 = tid % 128;
  const bool scan_warp = tid / 32 == 8;  // the first warp of warpgroup 2
  const int row = frag_row(0, t128);    // and row + 8
  for (int it = 0;; ++it) {
    const int w = blockIdx.x + it * gridDim.x;
    if (w >= n_work) break;
    const int g = w / nc, z = w % nc, b = it % stages;
    const uint32_t parity = (it / stages) & 1;
    const long long t0 = (long long)g * s + (long long)z * chunk;  // row of the chunk's start
    const float* dts = dt_s(b);
    const float* cs = dts + chunk;
    const float* ws = cs + chunk;
    if (scan_warp && (it == 0 || stages == 1)) decay(it, tid % 32);
    mbar_wait(full(b), parity);
    mbar_wait(scanned(b), parity);

    if (wg < 2) {
      for (int r = 0; r < n_tiles; ++r) {
        if (y_owner(r) != wg) continue;
        float acc[8 * NSP];
#pragma unroll
        for (int i = 0; i < 8 * NSP; ++i) acc[i] = 0.f;
        for (int j = 0; j <= r; ++j) {
          float sc[32] = {};  // not read: the first k-step has scale-d 0
          scores<NSN>(sc, c_s(b) + r * kTileBytes, b_s(b) + j * kTileBytes, slab);
          uint32_t hi[16], lo[16];
          if (j == r)
            weights<true>(sc, hi, lo, cs, dts, r * kTile, j * kTile, t128);
          else
            weights<false>(sc, hi, lo, cs, dts, r * kTile, j * kTile, t128);
          split_product<NSP>(acc, hi, lo, x_s(b) + j * kTileBytes, slab);
        }
        float* yr = y + (t0 + r * kTile + row) * P;
#pragma unroll
        for (int q = 0; q < 2 * NSP; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(yr + 8 * h * P + 8 * q + 2 * (t128 % 4)) =
                make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
      }
    } else {
      float* st = states + ((long long)g * nc + z) * (P * N);
      for (int m0 = 0; m0 < P; m0 += kTile) {
        float acc[8 * NSN];
#pragma unroll
        for (int i = 0; i < 8 * NSN; ++i) acc[i] = 0.f;
        for (int t = 0; t < n_tiles; ++t) {
          uint32_t hi[16], lo[16];
          state_frags<NSP>(hi, lo, x_s(b), slab, ws, t * kTile, m0, t128);
          split_product<NSN>(acc, hi, lo, b_s(b) + t * kTileBytes, slab);
        }
#pragma unroll
        for (int q = 0; q < 2 * NSN; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + row + 8 * h;
            if (m < P)
              *reinterpret_cast<float2*>(st + m * N + 8 * q + 2 * (t128 % 4)) =
                  make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
          }
      }
      if (stages > 1 && scan_warp) decay(it + 1, tid % 32);
    }
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(empty(b));  // this warp is done with the stage
  }
}

template <int NSN, int NSP>
__global__ void __launch_bounds__(128)
ssd_probe_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc, const float* __restrict__ W,
                 const float* __restrict__ w, float* __restrict__ s_out,
                 float* __restrict__ y_out, float* __restrict__ st_out) {
  constexpr int P = 16 * NSP, N = 16 * NSN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const int slab = kTileBytes;  // a chunk of one tile, in one stage
  const uint32_t c_s = base, b_s = c_s + NSN * slab, x_s = b_s + NSN * slab;
  float* ws = reinterpret_cast<float*>(sbase + (2 * NSN + NSP) * slab) + 2 * kTile;
  const uint32_t bar = base + stage_bytes(kTile, P, N);
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, (2 * NSN + NSP) * kTileBytes);
    for (int sl = 0; sl < NSN; ++sl) {
      tma_load(c_s + sl * slab, &tc, bar, kSlab * sl, 0, 0, 0);
      tma_load(b_s + sl * slab, &tb, bar, kSlab * sl, 0, 0, 0);
    }
    for (int sl = 0; sl < NSP; ++sl) tma_load(x_s + sl * slab, &tx, bar, kSlab * sl, 0, 0, 0);
  }
  if (t < kTile) ws[t] = w[t];
  __syncthreads();
  mbar_wait(bar, 0);

  float sc[32] = {};  // not read: the first k-step has scale-d 0
  scores<NSN>(sc, c_s, b_s, slab);
#pragma unroll
  for (int i = 0; i < 32; ++i) s_out[frag_row(i, t) * kTile + frag_col(i, t)] = sc[i];

  uint32_t hi[16], lo[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = W[frag_row(i, t) * kTile + frag_col(i, t)];
  split_bf16(sc, hi, lo);
  float acc[8 * NSP];
#pragma unroll
  for (int i = 0; i < 8 * NSP; ++i) acc[i] = 0.f;
  split_product<NSP>(acc, hi, lo, x_s, slab);
#pragma unroll
  for (int i = 0; i < 8 * NSP; ++i) y_out[frag_row(i, t) * P + frag_col(i, t)] = acc[i];

  for (int m0 = 0; m0 < P; m0 += kTile) {
    float st[8 * NSN];
#pragma unroll
    for (int i = 0; i < 8 * NSN; ++i) st[i] = 0.f;
    state_frags<NSP>(hi, lo, x_s, slab, ws, 0, m0, t);
    split_product<NSN>(st, hi, lo, b_s, slab);
#pragma unroll
    for (int i = 0; i < 8 * NSN; ++i) {
      const int m = m0 + frag_row(i, t);
      if (m < P) st_out[m * N + frag_col(i, t)] = st[i];
    }
  }
}

// 4-D map (cols, s, bh, 1) of a contiguous (bh, s, cols) bf16 tensor, boxes
// of 16 columns x `rows` rows
int encode_rows(CUtensorMap* map, const void* ptr, int cols, int s, int bh, int rows) {
  const long long st[3] = {(long long)s * cols, (long long)s * cols, cols};
  return encode_map(map, ptr, cols, s, bh, 1, st, rows);
}

// the chunk's rows, p and n cut into slabs the kernels take
bool bf16_domain(int chunk, int p, int n) {
  return chunk > 0 && chunk % kTile == 0 && p % kSlab == 0 && n % kSlab == 0 && p > 0 &&
         n > 0 && p <= 128 && n <= 128 && bf16_smem_bytes(chunk, p, n, 1) <= 232448;
}

struct Bf16Launch {
  const CUtensorMap *tx, *tb, *tc;
  const float *dt, *A;
  float *y, *states;
  int bh, s, chunk;
  cudaStream_t stream;

  // two chunk buffers where they fit, else one; one resident block per SM
  template <int NSN, int NSP>
  int run() const {
    const int stages = bf16_smem_bytes(chunk, 16 * NSP, 16 * NSN, 2) <= 232448 ? 2 : 1;
    const int smem = bf16_smem_bytes(chunk, 16 * NSP, 16 * NSN, stages);
    auto kern = ssd_intra_chunk_kernel<NSN, NSP>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const long long work = (long long)bh * (s / chunk);
    if (work > 0x7fffffffLL) return cudaErrorInvalidValue;
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const int blocks = (int)(work < sms ? work : sms);
    kern<<<blocks, kThreads16, smem, stream>>>(*tx, *tb, *tc, dt, A, y, states, s, chunk,
                                               (int)work, stages);
    return cudaGetLastError();
  }
};

struct ProbeLaunch {
  const CUtensorMap *tx, *tb, *tc;
  const float *W, *w;
  float *s_out, *y_out, *st_out;
  cudaStream_t stream;

  template <int NSN, int NSP>
  int run() const {
    const int smem = bf16_smem_bytes(kTile, 16 * NSP, 16 * NSN, 1);
    auto kern = ssd_probe_kernel<NSN, NSP>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<1, 128, smem, stream>>>(*tx, *tb, *tc, W, w, s_out, y_out, st_out);
    return cudaGetLastError();
  }
};

// f.run<n / 16, p / 16>() for p and n multiples of 16 up to 128
template <int NSN, typename F>
int with_p(int p, const F& f) {
  switch (p / kSlab) {
    case 1: return f.template run<NSN, 1>();
    case 2: return f.template run<NSN, 2>();
    case 3: return f.template run<NSN, 3>();
    case 4: return f.template run<NSN, 4>();
    case 5: return f.template run<NSN, 5>();
    case 6: return f.template run<NSN, 6>();
    case 7: return f.template run<NSN, 7>();
    case 8: return f.template run<NSN, 8>();
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
int with_slabs(int n, int p, const F& f) {
  switch (n / kSlab) {
    case 1: return with_p<1>(p, f);
    case 2: return with_p<2>(p, f);
    case 3: return with_p<3>(p, f);
    case 4: return with_p<4>(p, f);
    case 5: return with_p<5>(p, f);
    case 6: return with_p<6>(p, f);
    case 7: return with_p<7>(p, f);
    case 8: return with_p<8>(p, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of x, B and C: 0 float32, 1 bfloat16.  s must be a multiple of
// chunk.  bfloat16 needs chunk % 64 == 0, p and n multiples of 16 up to 128,
// the chunk's C, B and X within shared memory and 16-byte aligned x, dt, B
// and C (the TMA's terms); the wrapper checks them before it calls.
int ssd_intra_chunk_launch(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, void* y, void* states, int bh, int s, int p,
                           int n, int chunk, int dtype, void* stream) {
  if (bh == 0 || s == 0) return cudaSuccess;
  if (chunk <= 0 || s % chunk != 0 || p <= 0 || n <= 0 || s / chunk > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fp32(x, dt, A, B, C, y, states, bh, s, p, n, chunk, st);
  if (dtype != 1 || !bf16_domain(chunk, p, n) || reinterpret_cast<uintptr_t>(dt) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tb, tc;
  const int rows = box_rows(chunk);
  int err = encode_rows(&tx, x, p, s, bh, rows);
  if (err == cudaSuccess) err = encode_rows(&tb, B, n, s, bh, rows);
  if (err == cudaSuccess) err = encode_rows(&tc, C, n, s, bh, rows);
  if (err != cudaSuccess) return err;
  const Bf16Launch f{&tx, &tb, &tc, static_cast<const float*>(dt), static_cast<const float*>(A),
                     static_cast<float*>(y), static_cast<float*>(states), bh, s, chunk, st};
  return with_slabs(n, p, f);
}

// The fragment-layout check: C and B (64, n), X (64, p) contiguous bf16, W
// (64, 64) and w (64) fp32 -> s_out (64, 64) = C B^T, y_out (64, p) =
// (hi + lo)(W) X, st_out (p, n) = (hi + lo)(X w)^T B, all fp32, each
// register written where the bf16 kernel assumes it lies.
int ssd_probe_launch(const void* C, const void* B, const void* X, const float* W,
                     const float* w, float* s_out, float* y_out, float* st_out, int p, int n,
                     void* stream) {
  if (!bf16_domain(kTile, p, n)) return cudaErrorInvalidValue;
  CUtensorMap tx, tb, tc;
  int err = encode_rows(&tx, X, p, kTile, 1, kTile);
  if (err == cudaSuccess) err = encode_rows(&tb, B, n, kTile, 1, kTile);
  if (err == cudaSuccess) err = encode_rows(&tc, C, n, kTile, 1, kTile);
  if (err != cudaSuccess) return err;
  const ProbeLaunch f{&tx, &tb, &tc, W, w, s_out, y_out, st_out,
                      static_cast<cudaStream_t>(stream)};
  return with_slabs(n, p, f);
}

}  // extern "C"
