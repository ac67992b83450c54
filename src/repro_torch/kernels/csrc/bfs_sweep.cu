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
//   `_pallas_patch`): d'(r, y) = min(d(r, y), min_j tmp[r, j] + crows[j, y])
//   over (b, s, n) int32 states, (b, s, mmax) tmp and (b, mmax, n) crows.
//   Bound on this card at the polish's shape (b = 32, s = 2048, n = 8192,
//   mmax = 16): bytes, dist read and written plus tmp and crows, 4.32 GB at
//   3.35 TB/s = 1.288 ms; operations, an add and a min per element and
//   endpoint, 17.2 G int32 at 16.7 Tops = 1.03 ms.
//   Design (the "stream" instantiations: mmax = M in 1, 2, 4, ..., 32,
//   n % 4 == 0, 16-byte aligned tensors):
//   - Bytes: dist is streamed once, with loads always in flight.  A
//     persistent block walks an equal share of the (proposal, column strip,
//     row) units in order.  Its producer lane fills a ring of shared-memory
//     stages, each `rows` row segments of one strip (one cp.async.bulk a
//     row, completing on the stage's mbarrier), while the consumer warps
//     take the oldest stage, patch it in registers, store each row with
//     16-byte coalesced streaming stores and release the stage.  A consumer
//     thread owns 4 adjacent columns of the strip.  The polish's plan is 3
//     stages of 8 rows of 1024 columns (100 KB), two blocks an SM.
//   - crows stays out of the stream: a thread keeps crows[g, :, its
//     columns] in registers (4 M of them) and reloads them only when its
//     block moves to the next (proposal, strip).  Two 9-warp blocks an SM
//     cap a thread at 96 registers, which M = 16 fills without a spill
//     because the stage bookkeeping is 32-bit.
//   - tmp comes with the stage (one bulk copy of its rows, contiguous in
//     tmp[g]) and is read as 16-byte broadcasts; for M = 1 and 2 (rows not
//     16-byte aligned) from L1.
//   - Operations: __viaddmin_s32, Hopper's fused add-min (DPX), one
//     VIADDMNMX per element and endpoint instead of an add and a min
//     (ptxas also fuses a plain min(a, t + c) into it).
//   All sums stay below 2^21 + n, inside int32.
//   The "tile" instantiation (a block per 32-row x 128-column tile, tmp and
//   crows staged in shared memory 32 endpoints at a time) covers every
//   other shape exactly, untuned: n % 4 != 0, other mmax, unaligned
//   tensors.  patch_plan (kernels/bfs_sweep.py) picks the instantiation and
//   the ring; the launcher checks the plan against the shape.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
struct LaunchInfo {
  int threads = 0, smem = -1, blocks = 0;
};
constexpr int kMaxDevices = 64;

// the persistent grid of `kern` at this block shape: every SM full
template <typename Kernel>
cudaError_t resident_blocks(Kernel kern, LaunchInfo (&info)[kMaxDevices], int threads, int smem,
                            int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  LaunchInfo& li = info[dev];
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
  *blocks = li.blocks;
  return cudaSuccess;
}

template <int VPT, int GRAPH>
cudaError_t launch_sweep(const int32_t* nb, const uint32_t* vm, const uint32_t* f0,
                         int32_t* dist, int b, int n, int kmax, int sw_pad,
                         int sentinel, int threads, int smem, cudaStream_t stream) {
  static LaunchInfo info[kMaxDevices];
  auto kern = bfs_sweep_kernel<VPT, GRAPH>;
  int blocks = 0;
  const cudaError_t e = resident_blocks(kern, info, threads, smem, &blocks);
  if (e != cudaSuccess) return e;
  const int items = b * sw_pad;
  kern<<<items < blocks ? items : blocks, threads, smem, stream>>>(
      nb, vm, f0, dist, b, n, kmax, sw_pad, sentinel);
  return cudaGetLastError();
}

// ---- minplus_patch_kernel ------------------------------------------------

constexpr int kPatchMaxWarps = 8;      // consumer warps: a strip of up to 1024 columns
constexpr int kPatchThreads = 32 * (kPatchMaxWarps + 1);
constexpr int kPatchMaxStages = 32;
constexpr int kPatchMaxRows = 64;

// dynamic shared memory of a stream instantiation: the stages (dist rows,
// then tmp rows where they come by bulk copy), then two mbarriers a stage
__host__ __device__ constexpr int patch_stage_bytes(int m, int strip, int rows) {
  return rows * strip * 4 + (m % 4 == 0 ? rows * m * 4 : 0);
}
__host__ __device__ constexpr int patch_smem(int m, int strip, int rows, int stages) {
  return stages * (patch_stage_bytes(m, strip, rows) + 16);
}

// a = min(a, t + c) in each lane, by the fused add-min
__device__ __forceinline__ void addmin4(int4& a, int32_t t, const int4& c) {
  a.x = __viaddmin_s32(t, c.x, a.x);
  a.y = __viaddmin_s32(t, c.y, a.y);
  a.z = __viaddmin_s32(t, c.z, a.z);
  a.w = __viaddmin_s32(t, c.w, a.w);
}

// The block's share of the b * strips * s (proposal, strip, row) units
// (< 2^31, checked at launch, so 32-bit bookkeeping: registers are what
// the instantiations run short of), cut into stages of at most `rows` rows
// of one (proposal, strip); producer and consumers walk the same sequence.
struct PatchStage {
  int gs;         // proposal * strips + strip
  int row;        // first row, as g * s + r
  int g, x0, nr;  // proposal, first column, rows
};

__device__ __forceinline__ PatchStage patch_stage(int pos, int end, int s, int strips,
                                                  int strip, int rows) {
  PatchStage st;
  st.gs = pos / s;
  const int r = pos - st.gs * s;
  st.g = st.gs / strips;
  st.x0 = (st.gs - st.g * strips) * strip;
  st.row = st.g * s + r;
  st.nr = min(min(rows, s - r), end - pos);
  return st;
}

template <int M>
__global__ void __launch_bounds__(kPatchThreads, M <= 16 ? 2 : 1)
minplus_patch_kernel(const int32_t* __restrict__ dist, const int32_t* __restrict__ tmp,
                     const int32_t* __restrict__ crows, int32_t* __restrict__ out, int b,
                     int s, int n, int strip, int rows, int stages) {
  constexpr bool kTmpBulk = M % 4 == 0;
  extern __shared__ __align__(128) uint8_t ring[];  // the stages, then their mbarriers
  const int consumers = blockDim.x - 32;
  const int strips = (n + strip - 1) / strip;
  const int seg = rows * strip * 4;
  const int sb = patch_stage_bytes(M, strip, rows);
  const uint32_t base = smem_addr(ring);
  const uint32_t bar0 = base + stages * sb;
  auto full = [&](int k) { return bar0 + 16 * k; };
  auto empty = [&](int k) { return bar0 + 16 * k + 8; };
  const long long units = (long long)b * strips * s;
  const int begin = (int)(units * blockIdx.x / gridDim.x);
  const int end = (int)(units * (blockIdx.x + 1) / gridDim.x);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(full(k), 1);
      mbar_init(empty(k), consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= consumers) {
    // the producer: each stage's row segments (and tmp rows) into a stage
    // that every consumer warp has released
    if (tid != consumers) return;
    int it = 0;
    for (int pos = begin; pos < end; ++it) {
      const PatchStage st = patch_stage(pos, end, s, strips, strip, rows);
      const int cols = min(strip, n - st.x0);
      const int k = it % stages;
      if (it >= stages) mbar_wait(empty(k), (it / stages - 1) & 1);
      mbar_expect_tx(full(k), st.nr * cols * 4 + (kTmpBulk ? st.nr * M * 4 : 0));
      const uint32_t dst = base + k * sb;
      for (int i = 0; i < st.nr; ++i)
        bulk_load(dst + i * strip * 4, dist + (long long)(st.row + i) * n + st.x0, cols * 4,
                  full(k));
      if constexpr (kTmpBulk)
        bulk_load(dst + seg, tmp + (long long)st.row * M, st.nr * M * 4, full(k));
      pos += st.nr;
    }
    return;
  }

  // the consumers: thread tid owns columns x0 + 4 tid .. + 3 of each row
  const int xt = 4 * tid;
  int4 c[M];  // crows[g, j, those columns]
  int cur = -1;
  int it = 0;
  for (int pos = begin; pos < end; ++it) {
    const PatchStage st = patch_stage(pos, end, s, strips, strip, rows);
    const int x = st.x0 + xt;
    const bool on = x < n;  // n % 4 == 0: all four columns or none
    if (st.gs != cur) {
      cur = st.gs;
      if (on) {
#pragma unroll
        for (int j = 0; j < M; ++j)
          c[j] = __ldg(reinterpret_cast<const int4*>(crows + ((long long)st.g * M + j) * n + x));
      }
    }
    const int k = it % stages;
    mbar_wait(full(k), (it / stages) & 1);
    const uint8_t* stage = ring + k * sb;
    if (on) {
#pragma unroll 2
      for (int i = 0; i < st.nr; ++i) {
        int4 a = *reinterpret_cast<const int4*>(stage + (i * strip + xt) * 4);
        if constexpr (kTmpBulk) {
          const int4* tr = reinterpret_cast<const int4*>(stage + seg + i * M * 4);
#pragma unroll
          for (int j = 0; j < M; j += 4) {
            const int4 t = tr[j / 4];  // the same 16 bytes for every lane
            addmin4(a, t.x, c[j]);
            addmin4(a, t.y, c[j + 1]);
            addmin4(a, t.z, c[j + 2]);
            addmin4(a, t.w, c[j + 3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < M; ++j)
            addmin4(a, __ldg(tmp + (long long)(st.row + i) * M + j), c[j]);
        }
        // evict-first: the state outruns the L2
        __stcs(reinterpret_cast<int4*>(out + (long long)(st.row + i) * n + x), a);
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty(k));  // this warp is done with the stage
    pos += st.nr;
  }
}

// The "tile" instantiation: any n, mmax and alignment.
constexpr int kTileX = 128;   // columns per block, one per thread
constexpr int kTileY = 8;     // thread rows per block
constexpr int kTileRPT = 4;   // rows per thread
constexpr int kTileRows = kTileY * kTileRPT;
constexpr int kTileM = 32;    // endpoints staged per pass
constexpr int kTileSmem = (kTileRows * kTileM + kTileM * kTileX) * 4;

__global__ void __launch_bounds__(kTileX * kTileY)
minplus_patch_tile_kernel(const int32_t* __restrict__ dist, const int32_t* __restrict__ tmp,
                          const int32_t* __restrict__ crows, int32_t* __restrict__ out,
                          int s, int n, int mmax) {
  __shared__ int32_t ts[kTileRows][kTileM];
  __shared__ int32_t cs[kTileM][kTileX];
  const long long g = blockIdx.z;
  const long long nn = n;
  const int y = blockIdx.x * kTileX + threadIdx.x;
  const int r0 = blockIdx.y * kTileRows;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  int32_t acc[kTileRPT];
#pragma unroll
  for (int i = 0; i < kTileRPT; ++i) {
    const int r = r0 + threadIdx.y + i * kTileY;
    acc[i] = (r < s && y < n) ? dist[(g * s + r) * nn + y] : 0;
  }
  for (int j0 = 0; j0 < mmax; j0 += kTileM) {
    const int mc = min(kTileM, mmax - j0);
    for (int e = tid; e < kTileRows * kTileM; e += kTileX * kTileY) {
      const int rr = e / kTileM, jj = e % kTileM, r = r0 + rr;
      ts[rr][jj] = (r < s && jj < mc) ? tmp[(g * s + r) * mmax + j0 + jj] : 0;
    }
    for (int e = tid; e < kTileM * kTileX; e += kTileX * kTileY) {
      const int jj = e / kTileX, xx = e % kTileX, yy = blockIdx.x * kTileX + xx;
      cs[jj][xx] = (jj < mc && yy < n) ? crows[(g * mmax + j0 + jj) * nn + yy] : 0;
    }
    __syncthreads();
    for (int jj = 0; jj < mc; ++jj) {
      const int32_t c = cs[jj][threadIdx.x];
#pragma unroll
      for (int i = 0; i < kTileRPT; ++i)
        acc[i] = min(acc[i], ts[threadIdx.y + i * kTileY][jj] + c);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTileRPT; ++i) {
    const int r = r0 + threadIdx.y + i * kTileY;
    if (r < s && y < n) out[(g * s + r) * nn + y] = acc[i];
  }
}

template <int M>
cudaError_t launch_patch(const int32_t* dist, const int32_t* tmp, const int32_t* crows,
                         int32_t* out, int b, int s, int n, int threads, int strip, int rows,
                         int stages, int smem, cudaStream_t stream) {
  static LaunchInfo info[kMaxDevices];
  auto kern = minplus_patch_kernel<M>;
  int blocks = 0;
  const cudaError_t e = resident_blocks(kern, info, threads, smem, &blocks);
  if (e != cudaSuccess) return e;
  const long long units = (long long)b * ((n + strip - 1) / strip) * s;
  kern<<<units < blocks ? (int)units : blocks, threads, smem, stream>>>(
      dist, tmp, crows, out, b, s, n, strip, rows, stages);
  return cudaGetLastError();
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

int minplus_patch_launch(const void* dist, const void* tmp, const void* crows, void* out,
                         int b, int s, int n, int mmax, int stream_m, int threads, int strip,
                         int rows, int stages, int smem, void* stream) {
  if (b <= 0 || s <= 0 || n <= 0 || mmax < 0) return cudaErrorInvalidValue;
  const auto* d_ = static_cast<const int32_t*>(dist);
  const auto* t_ = static_cast<const int32_t*>(tmp);
  const auto* c_ = static_cast<const int32_t*>(crows);
  auto* o_ = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // the plan (kernels/bfs_sweep.py patch_plan) must fit the shape
  if (stream_m == 0) {
    if (threads != kTileX * kTileY || strip != kTileX || rows != kTileRows || stages != 0 ||
        smem != kTileSmem || b > 65535 || (s + kTileRows - 1) / kTileRows > 65535)
      return cudaErrorInvalidValue;
    const dim3 grid((n + kTileX - 1) / kTileX, (s + kTileRows - 1) / kTileRows, b);
    minplus_patch_tile_kernel<<<grid, dim3(kTileX, kTileY), 0, st>>>(d_, t_, c_, o_, s, n, mmax);
    return cudaGetLastError();
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dist) | reinterpret_cast<uintptr_t>(tmp) |
                         reinterpret_cast<uintptr_t>(crows) | reinterpret_cast<uintptr_t>(out);
  if (mmax != stream_m || n % 4 != 0 || (addr & 15u) != 0 || threads % 32 != 0 ||
      threads < 64 || threads > kPatchThreads || strip != 4 * (threads - 32) ||
      (long long)b * ((n + strip - 1) / strip) * s > 0x7FFFFFFF || rows < 1 ||
      rows > kPatchMaxRows || stages < 1 || stages > kPatchMaxStages ||
      smem != patch_smem(mmax, strip, rows, stages))
    return cudaErrorInvalidValue;
#define PATCH_CASE(M) \
  if (mmax == M)      \
  return launch_patch<M>(d_, t_, c_, o_, b, s, n, threads, strip, rows, stages, smem, st)
  PATCH_CASE(1);
  PATCH_CASE(2);
  PATCH_CASE(4);
  PATCH_CASE(8);
  PATCH_CASE(16);
  PATCH_CASE(32);
#undef PATCH_CASE
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
