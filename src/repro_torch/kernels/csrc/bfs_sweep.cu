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
//   3.35 TB/s (0.67 ms for the polish's full re-sweep, b = 32, n = 8192,
//   sw_pad = 64); the gather-OR work is about 2 * b * n * kmax * sw_pad word
//   operations per level (0.23 ms at the 14 levels there).
//   Design: persistent blocks of 1024 threads, each taking a contiguous run
//   of the b * sw_pad (graph, source word) items, so a run spans one or two
//   graphs.  Thread t owns vertices t, t + 1024, ... (vpt of them).
//   - The graph is read once per graph, not once per level: the "shared"
//     instantiation (kmax <= 8, n <= 8192) packs each vertex's row into one
//     16-byte row of 16-bit byte offsets in shared memory (128 KB at
//     n = 8192), a masked slot pointing at a zero frontier word.  That is
//     exact for vm words of 0 and 0xFFFFFFFF, all that pack_nbr makes; a
//     graph with any other word is swept reading nb and vm from device
//     memory, as the "global" instantiation does for graphs too wide or too
//     large for the table (16-byte row loads where kmax % 4 == 0).
//   - F is double-buffered in shared memory and V lives in registers (only
//     its own thread reads it), so a level ends in one __syncthreads_or.
//   - Shared instantiation: levels 1..15 go into four bit-planes per vertex
//     in registers, and a final pass writes every (row, vertex) once,
//     coalesced: the level from the planes, or the sentinel.
//     Level 0 and levels from 16 on (and every level in the global
//     instantiation) are written when found, a warp paying one reduction
//     when none of its vertices has a new bit, else one store per set bit
//     of the warp's OR.
//   - No spills in the shared instantiations: per-vertex addresses are not
//     hoisted out of the level loop (the thread index is read anew), and
//     the run's state lives in shared memory across an item.
//   sweep_plan (kernels/bfs_sweep.py) picks the instantiation from n and
//   kmax; the launcher checks the plan against the shape.
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

constexpr int kSweepMaxThreads = 1024;
// table columns: one 16-byte row per vertex of 16-bit byte offsets into F
// (n * 4 <= 32768, as the table takes n <= 8192)
constexpr int kTableK = 8;
constexpr int kTableMaxVPT = 8;       // 8192 vertices over 1024 threads
constexpr int kPlanes = 4;            // levels 1..15 are kept as bit-planes
enum { kGraphGlobal = 0, kGraphShared = 1 };

__host__ __device__ constexpr int sweep_words(int n, int graph) {
  // frontier words per buffer: n, and in the shared instantiation a zero
  // word at index n, rounded up so the table after both buffers is 16-byte aligned
  return graph == kGraphShared ? (n + 1 + 3) / 4 * 4 : n;
}

// warp-collective: rows[j * n + v] = value for every set bit j of this
// lane's `bits`; the loop over the warp's OR keeps each store on one row,
// lanes on neighbouring v.  Every lane of the warp must call it.
__device__ __forceinline__ void write_new(int32_t* rows, long long n, int v,
                                          uint32_t bits, int32_t value) {
  uint32_t todo = __reduce_or_sync(0xffffffffu, bits);
  while (todo) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1u;
    if ((bits >> j) & 1u) rows[j * n + v] = value;
  }
}

// bits 0..7 of x to bits 0, 4, ..., 28
__device__ __forceinline__ uint32_t spread_nibbles(uint32_t x) {
  x &= 0xFFu;
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

__device__ __forceinline__ uint32_t partial_word(uint32_t m) {
  return (m != 0u) & (m != 0xFFFFFFFFu);
}

// Fill the shared table from one graph's (n, kmax) rows, each entry the byte
// offset of the neighbour's frontier word (n * 4 for a masked slot: the zero
// word); returns, to every thread, whether some vm word is neither 0 nor
// 0xFFFFFFFF.
__device__ int load_table(uint4* tab, const int32_t* nbg, const uint32_t* vmg,
                          int n, int kmax, bool vec) {
  uint32_t partial = 0u;
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int32_t* nr = nbg + (long long)v * kmax;
    const uint32_t* mr = vmg + (long long)v * kmax;
    uint32_t e[kTableK];
    if (vec) {
#pragma unroll
      for (int h = 0; h < kTableK; h += 4) {
        if (h < kmax) {
          const int4 a = __ldg(reinterpret_cast<const int4*>(nr + h));
          const uint4 m = __ldg(reinterpret_cast<const uint4*>(mr + h));
          e[h] = (m.x ? (uint32_t)a.x : (uint32_t)n) * 4u;
          e[h + 1] = (m.y ? (uint32_t)a.y : (uint32_t)n) * 4u;
          e[h + 2] = (m.z ? (uint32_t)a.z : (uint32_t)n) * 4u;
          e[h + 3] = (m.w ? (uint32_t)a.w : (uint32_t)n) * 4u;
          partial |= partial_word(m.x) | partial_word(m.y) | partial_word(m.z) |
                     partial_word(m.w);
        } else {
          e[h] = e[h + 1] = e[h + 2] = e[h + 3] = (uint32_t)n * 4u;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTableK; ++j) {
        const uint32_t m = j < kmax ? mr[j] : 0u;
        e[j] = (m ? (uint32_t)nr[j] : (uint32_t)n) * 4u;
        partial |= partial_word(m);
      }
    }
    tab[v] = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                        e[6] | e[7] << 16);
  }
  return __syncthreads_or(partial);
}

// N[v] from the shared table: masked slots read the zero word
__device__ __forceinline__ uint32_t gather_table(const uint32_t* F, uint4 q) {
  const char* f = reinterpret_cast<const char*>(F);
  auto at = [f](uint32_t off) { return *reinterpret_cast<const uint32_t*>(f + off); };
  return at(q.x & 0xFFFFu) | at(q.x >> 16) | at(q.y & 0xFFFFu) | at(q.y >> 16) |
         at(q.z & 0xFFFFu) | at(q.z >> 16) | at(q.w & 0xFFFFu) | at(q.w >> 16);
}

// N[v] from the rows in device memory, every vm word applied
__device__ __forceinline__ uint32_t gather_rows(const uint32_t* F, const int32_t* nr,
                                                const uint32_t* mr, int kmax, bool vec) {
  uint32_t acc = 0u;
  if (vec) {
    for (int j = 0; j < kmax; j += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(nr + j));
      const uint4 m = __ldg(reinterpret_cast<const uint4*>(mr + j));
      acc |= (F[a.x] & m.x) | (F[a.y] & m.y) | (F[a.z] & m.z) | (F[a.w] & m.w);
    }
  } else {
    for (int j = 0; j < kmax; ++j) acc |= F[nr[j]] & mr[j];
  }
  return acc;
}

// threadIdx.x, read anew where it is called: what is computed from it is
// not hoisted out of the level loop (per-vertex addresses of every slot
// would take more registers than the level codes)
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// One (graph, source word) item: seed, level loop, final pass.  Vertex
// v = threadIdx.x + i * blockDim.x is thread-private slot i.
template <int VPT, int P, bool TABLE>
__device__ __forceinline__ void sweep_item(
    uint32_t* Fa, uint32_t* Fb, const uint4* tab, const int32_t* nbg,
    const uint32_t* vmg, const uint32_t* f0g, int32_t* rows, int n, int kmax,
    int sw_pad, int w, int sentinel, bool vec) {
  constexpr int kLate = 1 << P;  // levels from here on are written when found
  const int T = blockDim.x;
  const long long nn = n;
  uint32_t V[VPT];
  uint32_t L[VPT][P > 0 ? P : 1];
  uint32_t seeded = 0u;
  // the seed words first, all loads in flight together (a word's column of
  // F0 is strided by sw_pad), then level 0
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * T;
    V[i] = v < n ? f0g[(long long)v * sw_pad + w] : 0u;
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * T;
    if (v < n) Fa[v] = V[i];
#pragma unroll
    for (int p = 0; p < P; ++p) L[i][p] = 0u;
    seeded |= V[i];
    write_new(rows, nn, v, V[i], 0);
  }
  int any = __syncthreads_or(seeded != 0u);

  uint32_t* cur = Fa;
  uint32_t* nxt = Fb;
  int32_t d = 0;
  // slot i's new frontier at level d (reads cur, writes nxt, updates V)
  auto advance = [&](int i, int v) -> uint32_t {
    if (v >= n) return 0u;
    const uint32_t acc =
        TABLE ? gather_table(cur, tab[v])
              : gather_rows(cur, nbg + (long long)v * kmax, vmg + (long long)v * kmax, kmax, vec);
    const uint32_t nf = acc & ~V[i];
    nxt[v] = nf;
    V[i] |= nf;
    return nf;
  };
  while (any) {
    ++d;
    uint32_t local = 0u;
    const int tid = fresh_tid();
    if (d < kLate) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const uint32_t nf = advance(i, tid + i * T);
#pragma unroll
        for (int p = 0; p < P; ++p)
          if ((d >> p) & 1) L[i][p] |= nf;
        local |= nf;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = tid + i * T;
        const uint32_t nf = advance(i, v);
        write_new(rows, nn, v, nf, d);
        local |= nf;
      }
    }
    any = __syncthreads_or(local != 0u);  // also orders this level's F writes before the next
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  // every (row, vertex) not yet written: its level from the planes, or the
  // sentinel; rows 8q..8q+7 of a vertex as nibbles of one word
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = fresh_tid() + i * T;
    if (v >= n) continue;
    int32_t* out = rows + v;  // row j of vertex v, one row further each step
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t codes = 0u;
#pragma unroll
      for (int p = 0; p < P; ++p) codes |= spread_nibbles(L[i][p] >> (8 * q)) << p;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj, out += nn) {
        const int32_t c = (int32_t)((codes >> (4 * jj)) & 15u);
        const bool reached = (V[i] >> (8 * q + jj)) & 1u;
        if (!reached || c) *out = reached ? c : sentinel;
      }
    }
  }
}

// The block's contiguous run of the b * sw_pad (graph, source word) items
// (< 2^31, checked at launch).  `at` holds its state: graph, word, items
// done, items.  Every thread writes the same values, reads them before a
// barrier and advances them after it, so in shared memory (the shared
// instantiation, whose item body needs every register) nothing of the loop
// stays in a register across an item.
template <int VPT, int P, int GRAPH>
__device__ __forceinline__ void run_items(int* at, uint32_t* Fa, uint32_t* Fb, uint4* tab,
                                          const int32_t* nb, const uint32_t* vm,
                                          const uint32_t* f0, int32_t* dist, int b, int n,
                                          int kmax, int sw_pad, int sentinel) {
  const long long nn = n;
  const bool vec = (kmax % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(nb) | reinterpret_cast<uintptr_t>(vm)) & 15u) == 0;
  {
    const int items = b * sw_pad;
    const int share = items / gridDim.x, extra = items % gridDim.x;
    const int first = blockIdx.x * share + min((int)blockIdx.x, extra);
    at[0] = first / sw_pad;
    at[1] = first % sw_pad;
    at[2] = 0;
    at[3] = share + ((int)blockIdx.x < extra);
  }
  for (;;) {
    const int g = at[0], w = at[1], k = at[2];
    const bool done = k == at[3];
    __syncthreads();  // every thread has read this item's state
    if (done) break;
    at[0] = w + 1 == sw_pad ? g + 1 : g;
    at[1] = w + 1 == sw_pad ? 0 : w + 1;
    at[2] = k + 1;
    const int32_t* nbg = nb + g * nn * kmax;
    const uint32_t* vmg = vm + g * nn * kmax;
    const uint32_t* f0g = f0 + g * nn * sw_pad;
    int32_t* rows = dist + ((long long)g * sw_pad + w) * 32LL * nn;
    if constexpr (GRAPH == kGraphShared) {
      // whether the graph in the table has vm words other than 0 and ~0
      // (shared like the item state)
      __shared__ int partial;
      if (k == 0 || w == 0) partial = load_table(tab, nbg, vmg, n, kmax, vec);  // a new graph
      if (!partial)
        sweep_item<VPT, P, true>(Fa, Fb, tab, nbg, vmg, f0g, rows, n, kmax, sw_pad, w,
                                 sentinel, vec);
      else  // rare; without planes, so it adds no registers to the kernel
        sweep_item<VPT, 0, false>(Fa, Fb, tab, nbg, vmg, f0g, rows, n, kmax, sw_pad, w,
                                  sentinel, vec);
    } else {
      sweep_item<VPT, P, false>(Fa, Fb, tab, nbg, vmg, f0g, rows, n, kmax, sw_pad, w,
                                sentinel, vec);
    }
  }
}

template <int VPT, int GRAPH>
__global__ void __launch_bounds__(kSweepMaxThreads, 1)
bfs_sweep_kernel(const int32_t* __restrict__ nb, const uint32_t* __restrict__ vm,
                 const uint32_t* __restrict__ f0, int32_t* __restrict__ dist,
                 int b, int n, int kmax, int sw_pad, int sentinel) {
  // level bit-planes in the shared instantiation only (the global one keeps
  // V alone in registers and writes every level when it is found)
  constexpr int P = GRAPH == kGraphShared ? kPlanes : 0;
  extern __shared__ __align__(16) uint32_t smem[];
  const int words = sweep_words(n, GRAPH);
  uint32_t* Fa = smem;
  uint32_t* Fb = smem + words;
  uint4* tab = reinterpret_cast<uint4*>(smem + 2 * words);
  if constexpr (GRAPH == kGraphShared) {
    if (threadIdx.x == 0) Fa[n] = Fb[n] = 0u;  // the zero word masked slots read
    __shared__ int at[4];
    run_items<VPT, P, GRAPH>(at, Fa, Fb, tab, nb, vm, f0, dist, b, n, kmax, sw_pad, sentinel);
  } else {
    // no static shared memory: at n = MAX_SWEEP_N the frontier buffers take it all
    int at[4];
    run_items<VPT, P, GRAPH>(at, Fa, Fb, tab, nb, vm, f0, dist, b, n, kmax, sw_pad, sentinel);
  }
}

// What a launch needs besides its arguments, looked up once per device and
// instantiation: the SM count, and the blocks of this shape an SM holds.
// (Host statics without a lock: launches come from one host thread.)
struct SweepLaunchInfo {
  int threads = 0, smem = -1, blocks = 0;
};
constexpr int kMaxDevices = 64;

template <int VPT, int GRAPH>
cudaError_t launch_sweep(const int32_t* nb, const uint32_t* vm, const uint32_t* f0,
                         int32_t* dist, int b, int n, int kmax, int sw_pad,
                         int sentinel, int threads, int smem, cudaStream_t stream) {
  static SweepLaunchInfo info[kMaxDevices];
  auto kern = bfs_sweep_kernel<VPT, GRAPH>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  SweepLaunchInfo& li = info[dev];
  if (li.threads != threads || li.smem != smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
            cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    li = {threads, smem, sms * per_sm};
  }
  const int items = b * sw_pad;
  kern<<<items < li.blocks ? items : li.blocks, threads, smem, stream>>>(
      nb, vm, f0, dist, b, n, kmax, sw_pad, sentinel);
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
                     int b, int n, int kmax, int sw_pad, int sentinel, int shared_graph,
                     int threads, int vpt, int smem, void* stream) {
  if (b == 0 || n == 0 || sw_pad == 0) return cudaSuccess;
  // the plan (kernels/bfs_sweep.py sweep_plan) must cover the shape
  const int graph = shared_graph ? kGraphShared : kGraphGlobal;
  const long long need = 2LL * sweep_words(n, graph) * 4 +
                         (shared_graph ? (long long)n * kTableK * 2 : 0);
  if ((long long)b * sw_pad > 0x7FFFFFFF || threads < 32 || threads > kSweepMaxThreads ||
      threads % 32 != 0 ||
      (long long)threads * vpt < n || smem != need || kmax < 0 ||
      (shared_graph && (kmax > kTableK || vpt > kTableMaxVPT)))
    return cudaErrorInvalidValue;
  const auto* nb_ = static_cast<const int32_t*>(nb);
  const auto* vm_ = static_cast<const uint32_t*>(vm);
  const auto* f0_ = static_cast<const uint32_t*>(f0);
  auto* d_ = static_cast<int32_t*>(dist);
  auto st = static_cast<cudaStream_t>(stream);
#define SWEEP_CASE(V, G) \
  if (vpt == V)          \
  return launch_sweep<V, G>(nb_, vm_, f0_, d_, b, n, kmax, sw_pad, sentinel, threads, smem, st)
  if (shared_graph) {
    SWEEP_CASE(1, kGraphShared);
    SWEEP_CASE(2, kGraphShared);
    SWEEP_CASE(4, kGraphShared);
    SWEEP_CASE(8, kGraphShared);
  } else {
    SWEEP_CASE(1, kGraphGlobal);
    SWEEP_CASE(2, kGraphGlobal);
    SWEEP_CASE(4, kGraphGlobal);
    SWEEP_CASE(8, kGraphGlobal);
    SWEEP_CASE(16, kGraphGlobal);
    SWEEP_CASE(32, kGraphGlobal);
  }
#undef SWEEP_CASE
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
