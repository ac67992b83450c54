// The two kernels of the device-priced replica polish, for Hopper (sm_90a),
// behind a plain C interface that kernels/_build.py loads with ctypes.
// Every launcher enqueues on the caller's stream, allocates nothing,
// does not synchronise, and returns the cudaError_t of the launch.
//
// bfs_sweep_kernel
//   Replaces src/repro/kernels/bfs_sweep.py `_kernel` (built by
//   `_pallas_sweep`): multi-source BFS with frontier F and visited set V
//   packed 32 sources per uint32 word, the whole level loop in one launch.
//   Bound on this card: writing dist, b * sw_pad * 32 * n * 4 bytes, at
//   3.35 TB/s; the gather-OR work is about 2 * b * n * kmax * sw_pad word
//   operations per level, far below the integer rate.
//   Design: one block per (source word, graph).  The reference tiled 4 words
//   x n vertices into a 16 MB VMEM; here F and V of one word live in dynamic
//   shared memory (2 * n * 4 bytes, 64 KB at n = 8192, so n <= 29056), nb and
//   vm are read from global memory (512 KB per graph at n = 8192, k = 8, held
//   in L2).  Each thread keeps the new frontier of its vertices in registers
//   until a barrier, then writes F and V; the loop ends on
//   __syncthreads_or(any new bit).  Every (row, vertex) of dist is written
//   exactly once -- 0 at the sources, d when first reached, the sentinel
//   after the loop -- with neighbouring threads on neighbouring vertices of
//   one row, so the writes coalesce and no initialisation pass is needed.
//
// minplus_patch_kernel
//   Replaces src/repro/kernels/bfs_sweep.py `_patch_kernel` (built by
//   `_pallas_patch`): d'(r, y) = min(d(r, y), min_j tmp[r, j] + crows[j, y]).
//   Bound on this card: reading and writing dist, 2 * b * s * n * 4 bytes,
//   plus b * mmax * n * 4 bytes of crows, at 3.35 TB/s.
//   Design: a block owns a 32-row x 128-column tile of one proposal; each of
//   its 1024 threads owns one column and 4 rows in registers.  tmp[rows, j]
//   and crows[j, cols] are staged in shared memory 32 endpoints at a time,
//   so dist is read and written once and crows is re-read from L2 once per
//   32 rows.  All sums stay below 2^21 + n, inside int32.  `out` may alias
//   `dist`: each element is read and written by the same thread only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSweepThreads = 1024;

// dist[j, v] = value for every set bit j of `bits` (rows = one source word's
// 32 rows).  The loop over j is uniform across the warp, so lanes holding
// neighbouring v store to neighbouring addresses of the same row.
__device__ __forceinline__ void write_bits(int32_t* rows, long long n, int v,
                                           uint32_t bits, int32_t value) {
  if (bits == 0u) return;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    if ((bits >> j) & 1u) rows[j * n + v] = value;
  }
}

// VPT = vertices per thread (ceil(n / 1024) rounded up to a power of two),
// a compile-time bound so the per-thread new-frontier words stay in registers.
template <int VPT>
__global__ void __launch_bounds__(kSweepThreads)
bfs_sweep_kernel(const int32_t* __restrict__ nb, const uint32_t* __restrict__ vm,
                 const uint32_t* __restrict__ f0, int32_t* __restrict__ dist,
                 int n, int kmax, int sw_pad, int sentinel) {
  extern __shared__ uint32_t smem[];
  uint32_t* F = smem;
  uint32_t* V = smem + n;
  const int w = blockIdx.x;
  const long long g = blockIdx.y;
  const long long nn = n;
  const int32_t* nbg = nb + g * nn * kmax;
  const uint32_t* vmg = vm + g * nn * kmax;
  const uint32_t* f0g = f0 + g * nn * sw_pad;
  int32_t* rows = dist + (g * sw_pad + w) * 32LL * nn;

  int any = 0;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * kSweepThreads;
    if (v < n) {
      const uint32_t f = f0g[(long long)v * sw_pad + w];
      F[v] = f;
      V[v] = f;
      any |= (f != 0u);
      write_bits(rows, nn, v, f, 0);
    }
  }
  any = __syncthreads_or(any);

  int32_t d = 0;
  while (any) {
    ++d;
    uint32_t nf[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = threadIdx.x + i * kSweepThreads;
      uint32_t acc = 0u;
      if (v < n) {
        const int32_t* nr = nbg + (long long)v * kmax;
        const uint32_t* mr = vmg + (long long)v * kmax;
        for (int j = 0; j < kmax; ++j) acc |= F[nr[j]] & mr[j];
        acc &= ~V[v];
      }
      nf[i] = acc;
    }
    __syncthreads();  // every read of this level's F is done
    int local = 0;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = threadIdx.x + i * kSweepThreads;
      if (v < n) {
        F[v] = nf[i];
        V[v] |= nf[i];
        local |= (nf[i] != 0u);
        write_bits(rows, nn, v, nf[i], d);
      }
    }
    any = __syncthreads_or(local);  // also orders the writes before the next level
  }

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * kSweepThreads;
    if (v < n) write_bits(rows, nn, v, ~V[v], sentinel);
  }
}

template <int VPT>
cudaError_t launch_sweep(const int32_t* nb, const uint32_t* vm, const uint32_t* f0,
                         int32_t* dist, int b, int n, int kmax, int sw_pad,
                         int sentinel, cudaStream_t stream) {
  const int smem = 2 * n * (int)sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      bfs_sweep_kernel<VPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bfs_sweep_kernel<VPT><<<dim3(sw_pad, b), kSweepThreads, smem, stream>>>(
      nb, vm, f0, dist, n, kmax, sw_pad, sentinel);
  return cudaGetLastError();
}

constexpr int kPatchX = 128;   // columns per block, one per thread
constexpr int kPatchY = 8;     // thread rows per block
constexpr int kPatchRPT = 4;   // rows per thread
constexpr int kPatchRows = kPatchY * kPatchRPT;
constexpr int kPatchM = 32;    // endpoints staged per pass

__global__ void __launch_bounds__(kPatchX * kPatchY)
minplus_patch_kernel(const int32_t* dist, const int32_t* __restrict__ tmp,
                     const int32_t* __restrict__ crows, int32_t* out,
                     int s, int n, int mmax) {
  __shared__ int32_t ts[kPatchRows][kPatchM];
  __shared__ int32_t cs[kPatchM][kPatchX];
  const long long g = blockIdx.z;
  const long long nn = n;
  const int y = blockIdx.x * kPatchX + threadIdx.x;
  const int r0 = blockIdx.y * kPatchRows;
  const int tid = threadIdx.y * kPatchX + threadIdx.x;

  int32_t acc[kPatchRPT];
#pragma unroll
  for (int i = 0; i < kPatchRPT; ++i) {
    const int r = r0 + threadIdx.y + i * kPatchY;
    acc[i] = (r < s && y < n) ? dist[(g * s + r) * nn + y] : 0;
  }
  for (int j0 = 0; j0 < mmax; j0 += kPatchM) {
    const int mc = min(kPatchM, mmax - j0);
    for (int e = tid; e < kPatchRows * kPatchM; e += kPatchX * kPatchY) {
      const int rr = e / kPatchM, jj = e % kPatchM, r = r0 + rr;
      ts[rr][jj] = (r < s && jj < mc) ? tmp[(g * s + r) * mmax + j0 + jj] : 0;
    }
    for (int e = tid; e < kPatchM * kPatchX; e += kPatchX * kPatchY) {
      const int jj = e / kPatchX, xx = e % kPatchX, yy = blockIdx.x * kPatchX + xx;
      cs[jj][xx] = (jj < mc && yy < n) ? crows[(g * mmax + j0 + jj) * nn + yy] : 0;
    }
    __syncthreads();
    for (int jj = 0; jj < mc; ++jj) {
      const int32_t c = cs[jj][threadIdx.x];
#pragma unroll
      for (int i = 0; i < kPatchRPT; ++i)
        acc[i] = min(acc[i], ts[threadIdx.y + i * kPatchY][jj] + c);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPatchRPT; ++i) {
    const int r = r0 + threadIdx.y + i * kPatchY;
    if (r < s && y < n) out[(g * s + r) * nn + y] = acc[i];
  }
}

}  // namespace

extern "C" {

int bfs_sweep_launch(const void* nb, const void* vm, const void* f0, void* dist,
                     int b, int n, int kmax, int sw_pad, int sentinel,
                     void* stream) {
  if (b == 0 || n == 0 || sw_pad == 0) return cudaSuccess;
  const int vpt = (n + kSweepThreads - 1) / kSweepThreads;
  const auto* nb_ = static_cast<const int32_t*>(nb);
  const auto* vm_ = static_cast<const uint32_t*>(vm);
  const auto* f0_ = static_cast<const uint32_t*>(f0);
  auto* d_ = static_cast<int32_t*>(dist);
  auto st = static_cast<cudaStream_t>(stream);
  if (vpt <= 1) return launch_sweep<1>(nb_, vm_, f0_, d_, b, n, kmax, sw_pad, sentinel, st);
  if (vpt <= 2) return launch_sweep<2>(nb_, vm_, f0_, d_, b, n, kmax, sw_pad, sentinel, st);
  if (vpt <= 4) return launch_sweep<4>(nb_, vm_, f0_, d_, b, n, kmax, sw_pad, sentinel, st);
  if (vpt <= 8) return launch_sweep<8>(nb_, vm_, f0_, d_, b, n, kmax, sw_pad, sentinel, st);
  if (vpt <= 16) return launch_sweep<16>(nb_, vm_, f0_, d_, b, n, kmax, sw_pad, sentinel, st);
  if (vpt <= 32) return launch_sweep<32>(nb_, vm_, f0_, d_, b, n, kmax, sw_pad, sentinel, st);
  return cudaErrorInvalidValue;
}

int minplus_patch_launch(const void* dist, const void* tmp, const void* crows,
                         void* out, int b, int s, int n, int mmax, void* stream) {
  if (b == 0 || s == 0 || n == 0) return cudaSuccess;
  const dim3 grid((n + kPatchX - 1) / kPatchX, (s + kPatchRows - 1) / kPatchRows, b);
  minplus_patch_kernel<<<grid, dim3(kPatchX, kPatchY), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dist), static_cast<const int32_t*>(tmp),
      static_cast<const int32_t*>(crows), static_cast<int32_t*>(out), s, n, mmax);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
