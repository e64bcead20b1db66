// Per-lane table-fetch probes for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probes of the JAX package that price per-lane fetch
// mechanisms (tools, not render paths):
//   tools/exp_gather.py   A `kernel` (:52)  in-kernel gather of column 0
//                         A2 `kernel` (:76) take_along_axis along lanes
//                         B `kernel` (:100) DMA'd window, one-hot matmul
//                         C `kernel` (:141) DMA'd window, select scan
//   tools/exp_gather2.py  rowgather (:39), sublane (:61), dma_test (:82),
//                         dma_scan (:114), dma_rowgather (:148)
// Each computes a per-lane f32 sum over ITERS fetches, added in iteration
// order from 0; probes/fetch.py holds the plain versions and maps every JAX
// body to a mode.
//
// pf_lane<MODE, PATH>: the launcher takes one of three paths from what it
// can see (the mode, the table's bytes, R, the card's SMs and opt-in shared
// memory) and reports it:
//   P_STAGED    the values the mode reads go to shared memory, as the TPU
//               probe A holds its table in VMEM: column 0 (COL0, made
//               contiguous by a pre-pass, pf_column_kernel, on the same
//               stream), the whole table (SUBLANE), or the rows and then one
//               sum a row (ROWSUM: the block sums each staged row once,
//               columns in order, so a lane fetches 4 bytes, not 64). One
//               thread issues the TMA bulk copy (cp.async.bulk, completed on
//               an mbarrier) while every thread loads its first index rows.
//               Taken where the bytes fit the opt-in limit (less
//               PF_STAGE_RESERVE): always for ROWSUM; for COL0 and SUBLANE
//               only when R fills every SM at 4 lanes a thread (with fewer
//               lanes, few blocks each copy the whole table for few fetches).
//   P_IN_PLACE  one lane a thread, __ldg in place, PF_LANE_UNROLL
//               iterations' loads in flight (ROWSUM: a row's float4 loads).
//               LANE always (a warp reads one 512-byte row, which L1
//               serves), and whatever is not staged or quad.
//   P_QUAD      ROWSUM of a table over PF_QUAD_MIN_BYTES that does not fit,
//               when R fills every SM: a row read by the 4 threads of a quad
//               through a padded warp buffer, so a load covers 8 rows' whole
//               lines (a smaller table hits L1 enough that one lane a thread
//               is faster).
// In place runs pf_lane_thread_kernel, a block for every 256 lanes; the
// staged and quad paths run pf_lane_kernel's persistent blocks (the
// occupancy API's count an SM), in which a thread owns 4 neighbouring
// lanes, loads their indices as one streaming 16-byte load (__ldcs: each
// index is read once), keeps PF_LANE_UNROLL iterations' loads in flight,
// then fetches and adds in iteration order. ROWS (the glue's row gather, ops/vec.fetch_rows) is
// pf_rows_kernel, one thread a float4 of the output.
//
// pf_window<MODE, CONS>: one block a 1024-lane tile: CONS consumer threads
// (8 lanes each, 4 for ROWSUM: more warps for its row sums) and a producer
// warp. Iteration i's tile takes lo = min(idx[i]) over the tile, clamped to
// N - CHUNK as the TPU probes do, and each lane reads window row j - lo (0
// outside): column 0 (COL0), column 0 rounded to bf16 as the one-hot bf16
// matmul rounds it (COL0_BF16), the row's column sum (ROWSUM: each window
// row summed once by the consumers, then read by its lanes), or
// window[0][0] for every lane (COPY, dma_test's dynamic-offset copy). The
// TPU's one-hot matmul and select scan both compute window[rel][0]; on the
// card that is one shared-memory read. What a window stages:
//   column modes  per iteration, CHUNK (+ up to 3) floats of column 0 by TMA
//                 bulk copy, from a contiguous copy made once a call by
//                 pf_column_kernel, when every lane of the tile reads in the
//                 window; else nothing, and each lane reads its own row in
//                 place (__ldg; a spread-out tile would copy a window it
//                 barely reads, and every such window starts near row 0: one
//                 hot L2 region);
//   ROWSUM, COPY  the CHUNK contiguous rows, by TMA bulk copy.
// The producer's first thread issues every copy: the tile's index rows
// into a ring of S = A + D + 1 stages, up to A + D iterations ahead, and
// each window into a ring of W = A + 1 stages once its lo is known. The
// consumers meet at one named barrier an iteration (ROWSUM two), where they
// take the tile minimum of iteration i + A; they wait on mbarriers for the
// copies and free each index stage with an mbarrier arrive. A and D come
// from the launcher: the deepest pair whose shared memory keeps every tile
// resident, else the shallowest with A >= 1; (0, 1), one window and two
// index tiles, only where no other fits the card.
//
// What bounds them: reading idx once (ITERS * R * 4 bytes) at the HBM rate;
// the staged values come from L2. Every mbarrier wait is bounded (__trap
// after PF_WAIT_CYCLES), so a protocol fault fails the launch, not the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PF_TILE 1024
#define PF_LANE_THREADS 256   // pf_rows_kernel, and pf_lane_kernel in place
#define PF_ROW_LANES 128      // lanes of an (8, 128) TPU tile row
#define PF_LANE_BLOCK 512     // pf_lane_kernel, staged and quad
#define PF_LANE_UNROLL 4      // iterations whose index loads are in flight
#define PF_LPT 4              // lanes a thread, staged and quad (one 16-byte index load)
#define PF_QUAD_MIN_BYTES (1 << 20)  // smallest table a quad row sum reads
#define PF_WIN_CONS 128       // pf_window_kernel's consumer threads (8 lanes each) ...
#define PF_WIN_CONS_ROWS 256  // ... and for row sums (4 lanes each: more warps)
#define PF_WIN_MAX_WARPS (PF_WIN_CONS_ROWS / 32)
#define PF_RING_MAX 8         // most stages of either ring
#define PF_STAGE_RESERVE 128  // bytes of the opt-in limit kept for static shared memory
#define PF_BULK_BYTES 32768   // bytes a bulk-copy instruction moves
#define PF_WAIT_CYCLES (1ll << 33)

enum { L_COL0, L_LANE, L_ROWSUM, L_SUBLANE, L_ROWS, L_COUNT };
enum { W_COL0, W_COL0_BF16, W_ROWSUM, W_COPY, W_COUNT };
enum { P_IN_PLACE, P_STAGED, P_QUAD, P_COUNT };  // pf_lane's paths
enum { WP_COLUMN, WP_ROWS };                      // what pf_window stages

// ---------------------------------------------------------------------------
// The bulk copy and its mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned pf_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void pf_mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(pf_saddr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void pf_mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(pf_saddr(bar)) : "memory");
}

// The consumer warps of pf_window meet here (named barrier 1; the producer
// warp does not take part).
template <int CONS>
__device__ __forceinline__ void pf_bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONS) : "memory");
}

__device__ __forceinline__ void pf_fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The block's earlier shared-memory reads come before a bulk copy's writes.
__device__ __forceinline__ void pf_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global src to shared dst; the copy completes phase of `bar`.
__device__ __forceinline__ void pf_bulk(void* dst, const void* src, int bytes,
                                        unsigned long long* bar) {
  const unsigned b = pf_saddr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  for (int off = 0; off < bytes; off += PF_BULK_BYTES) {
    const int n = min(PF_BULK_BYTES, bytes - off);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(pf_saddr(dst) + off),
        "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(b)
        : "memory");
  }
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void pf_mbar_wait(unsigned long long* bar, int parity) {
  const unsigned b = pf_saddr(bar);
  const long long t0 = clock64();
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > PF_WAIT_CYCLES) __trap();
  } while (!done);
}

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

// Sum of the C4 float4 column groups of a row in shared memory, in column
// order. Threads summing neighbouring 64-byte rows (C = 16) would read group
// g at once in two of the eight 16-byte bank groups; each reads its row's
// groups in an order rotated by `rot` (0-3), which spreads them, and the
// sum still takes them in order.
__device__ __forceinline__ float pf_row_sum_smem(const float4* row4, int C4, int rot) {
  float s = 0.0f;
  int k = 0;
  for (; k + 4 <= C4; k += 4) {
    float4 q[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) q[m] = row4[k + ((m + rot) & 3)];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int m = (g - rot) & 3;  // group k + g was read as q[m]
      const float4 v = m == 0 ? q[0] : (m == 1 ? q[1] : (m == 2 ? q[2] : q[3]));
      s = s + v.x;
      s = s + v.y;
      s = s + v.z;
      s = s + v.w;
    }
  }
  for (; k < C4; ++k) {
    const float4 v = row4[k];
    s = s + v.x;
    s = s + v.y;
    s = s + v.z;
    s = s + v.w;
  }
  return s;
}

// col[k] = table[k * C] for k < N, 0 up to n: column 0 made contiguous (and
// padded) for a bulk copy.
__global__ void pf_column_kernel(const float* __restrict__ table, int N, int C,
                                 float* __restrict__ col, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) col[k] = k < N ? __ldg(table + (size_t)k * C) : 0.0f;
}

// ---------------------------------------------------------------------------
// pf_lane
// ---------------------------------------------------------------------------

struct PfLane {
  const float* table;  // (M, C)
  const float* stage;  // what a staged launch copies: the column or the table
  const int* idx;      // (iters, R)
  float* out;          // (R,)
  int M, C, iters, R;
  int stage_bytes;     // bytes a staged launch copies
  int vec;             // R % 4 == 0 and idx, out 16-byte aligned
};

// The indices of iteration i for the LPT lanes from r0 (0 past R: a lane
// the warp carries without work reads row 0); 4 lanes as one streaming
// 16-byte load (each index is read once), one lane through the read-only
// path.
template <int LPT>
__device__ __forceinline__ void pf_load(const PfLane& a, int i, int r0, int (&j)[LPT]) {
  const int* p = a.idx + (size_t)i * a.R + r0;
  if (r0 >= a.R) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) j[k] = 0;
    return;
  }
  if constexpr (LPT == 4) {
    if (a.vec) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
      j[0] = q.x;
      j[1] = q.y;
      j[2] = q.z;
      j[3] = q.w;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < LPT; ++k) j[k] = r0 + k < a.R ? (LPT == 1 ? __ldg(p + k) : __ldcs(p + k)) : 0;
}

// One fetch of a column mode: from shared memory (tab) or in place.
template <int MODE, bool STAGED>
__device__ __forceinline__ float pf_lane_value(const PfLane& a, const float* tab, int j, int r) {
  if (MODE == L_COL0) return STAGED ? tab[j] : __ldg(a.table + (size_t)j * a.C);
  const size_t cell = MODE == L_LANE
                          ? (size_t)((r / PF_ROW_LANES) % a.M) * a.C + (j % PF_ROW_LANES)
                          : (size_t)j * a.C + (r % PF_ROW_LANES);  // L_SUBLANE
  return STAGED ? tab[cell] : __ldg(a.table + cell);
}

// In place, one thread: the in-order column sum of row j, as float4 loads.
__device__ __forceinline__ float pf_row_sum_ldg(const PfLane& a, int j) {
  const int C4 = a.C / 4;
  const float4* row4 = reinterpret_cast<const float4*>(a.table) + (size_t)j * C4;
  float s = 0.0f;
  for (int k = 0; k < C4; ++k) {
    const float4 v = __ldg(row4 + k);
    s = s + v.x;
    s = s + v.y;
    s = s + v.z;
    s = s + v.w;
  }
  return s;
}

// In place, the in-order column sum of row j (each thread's own) for the
// 32 threads of a warp at once, 4 column groups at a time: the 4 threads of
// a quad load 16 contiguous bytes each of one row, so a warp's load covers
// 8 rows' whole lines instead of touching 32; the groups go through the
// warp's buffer of 32 rows, 5 float4 apart (conflict-free), and each thread
// adds its own row's columns in order. Every lane of the warp calls it.
__device__ __forceinline__ float pf_quad_row_sum(const PfLane& a, float* tab, int j) {
  const int lane = threadIdx.x & 31, quad = lane >> 2, p = lane & 3, C4 = a.C / 4;
  float4* buf = reinterpret_cast<float4*>(tab) + (threadIdx.x >> 5) * 32 * 5;
  const float4* table4 = reinterpret_cast<const float4*>(a.table);
  float s = 0.0f;
  for (int c0 = 0; c0 < C4; c0 += 4) {
    float4 q[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int jj = __shfl_sync(0xffffffffu, j, 8 * m + quad);
      if (c0 + p < C4) q[m] = __ldg(table4 + (size_t)jj * C4 + c0 + p);
    }
    __syncwarp();  // every lane has read the buffer's last groups
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (c0 + p < C4) buf[(8 * m + quad) * 5 + p] = q[m];
    __syncwarp();
    for (int g = 0; g < 4 && c0 + g < C4; ++g) {
      const float4 v = buf[lane * 5 + g];
      s = s + v.x;
      s = s + v.y;
      s = s + v.z;
      s = s + v.w;
    }
  }
  return s;
}

// NB iterations from i0 for the LPT lanes from r0: the index loads first,
// then the fetches, then the adds, each lane's in iteration order.
template <int MODE, int PATH, int LPT, int NB>
__device__ __forceinline__ void pf_lane_batch(const PfLane& a, float* tab, int i0, int r0,
                                              float (&acc)[LPT], bool& ready,
                                              unsigned long long* bar) {
  constexpr bool STAGED = PATH == P_STAGED;
  int j[NB][LPT];
#pragma unroll
  for (int u = 0; u < NB; ++u) pf_load<LPT>(a, i0 + u, r0, j[u]);
  if (STAGED && !ready) {
    pf_mbar_wait(bar, 0);
    ready = true;
  }
  if (MODE == L_ROWSUM && STAGED) {  // tab holds the staged rows' sums
#pragma unroll
    for (int u = 0; u < NB; ++u)
#pragma unroll
      for (int k = 0; k < LPT; ++k) acc[k] = acc[k] + tab[j[u][k]];
  } else if (MODE == L_ROWSUM) {
#pragma unroll
    for (int u = 0; u < NB; ++u)
#pragma unroll
      for (int k = 0; k < LPT; ++k)
        acc[k] = acc[k] + (PATH == P_QUAD ? pf_quad_row_sum(a, tab, j[u][k])
                                          : pf_row_sum_ldg(a, j[u][k]));
  } else {
    float v[NB][LPT];
#pragma unroll
    for (int u = 0; u < NB; ++u)
#pragma unroll
      for (int k = 0; k < LPT; ++k) v[u][k] = pf_lane_value<MODE, STAGED>(a, tab, j[u][k], r0 + k);
#pragma unroll
    for (int u = 0; u < NB; ++u)
#pragma unroll
      for (int k = 0; k < LPT; ++k) acc[k] = acc[k] + v[u][k];
  }
}

// In place: one lane a thread, a block for every 256 lanes. Single floats
// run at full occupancy (a lane's fetches wait on L1 or L2, so resident
// warps hide them) with PF_LANE_UNROLL iterations' loads in flight; a row
// sum keeps one row's float4 loads in flight at half occupancy, 64
// registers (on the H100 faster than 32 registers or no bound: PERF.md).
template <int MODE>
__global__ void __launch_bounds__(PF_LANE_THREADS, (MODE == L_ROWSUM ? 1024 : 2048) / PF_LANE_THREADS)
pf_lane_thread_kernel(PfLane a) {
  constexpr int NB = MODE == L_ROWSUM ? 1 : PF_LANE_UNROLL;
  const int r = blockIdx.x * PF_LANE_THREADS + threadIdx.x;
  if (r >= a.R) return;
  float acc[1] = {0.0f};
  bool ready = true;
  int i0 = 0;
  for (; i0 + NB <= a.iters; i0 += NB)
    pf_lane_batch<MODE, P_IN_PLACE, 1, NB>(a, nullptr, i0, r, acc, ready, nullptr);
  for (; i0 < a.iters; ++i0)
    pf_lane_batch<MODE, P_IN_PLACE, 1, 1>(a, nullptr, i0, r, acc, ready, nullptr);
  a.out[r] = acc[0];
}

// Staged and quad: persistent blocks, 4 lanes a thread.
template <int MODE, int PATH>
__global__ void __launch_bounds__(PF_LANE_BLOCK, 2) pf_lane_kernel(PfLane a) {
  constexpr bool STAGED = PATH == P_STAGED;
  constexpr int LPT = PF_LPT;
  // Quad row sums keep their row loads in flight instead of indices.
  constexpr int NB = MODE == L_ROWSUM && !STAGED ? 1 : PF_LANE_UNROLL;
  extern __shared__ __align__(128) float pf_tab[];
  __shared__ __align__(8) unsigned long long bar;
  const int tid = threadIdx.x;
  if (STAGED) {
    if (tid == 0) {
      pf_mbar_init(&bar, 1);
      pf_fence_mbar_init();
      pf_bulk(pf_tab, a.stage, a.stage_bytes, &bar);  // overlaps the first index loads
    }
    __syncthreads();
  }
  bool ready = !STAGED;
  float* vals = pf_tab;
  if (STAGED && MODE == L_ROWSUM) {
    // Each staged row is summed once (columns in order), into M floats after
    // the rows; the lanes then fetch 4-byte sums, not 64-byte rows.
    pf_mbar_wait(&bar, 0);
    ready = true;
    const int C4 = a.C / 4;
    vals = pf_tab + (size_t)a.M * a.C;
    for (int k = tid; k < a.M; k += blockDim.x)
      vals[k] = pf_row_sum_smem(reinterpret_cast<const float4*>(pf_tab) + (size_t)k * C4, C4, k & 3);
    __syncthreads();
  }
  const int groups = (a.R + LPT - 1) / LPT;
  // The warp goes round together (the quad's shuffles take every lane); a
  // lane past the last group carries no work.
  for (int g = blockIdx.x * blockDim.x + tid; g - (tid & 31) < groups;
       g += gridDim.x * blockDim.x) {
    const int r0 = g * LPT;
    float acc[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) acc[k] = 0.0f;
    int i0 = 0;
    for (; i0 + NB <= a.iters; i0 += NB)
      pf_lane_batch<MODE, PATH, LPT, NB>(a, vals, i0, r0, acc, ready, &bar);
    for (; i0 < a.iters; ++i0)
      pf_lane_batch<MODE, PATH, LPT, 1>(a, vals, i0, r0, acc, ready, &bar);
    if (g >= groups) continue;
    if (a.vec) {
      reinterpret_cast<float4*>(a.out)[g] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      continue;
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (r0 + k < a.R) a.out[r0 + k] = acc[k];
  }
  // A thread with no lane (or no iteration) still waits: the copy into the
  // block's shared memory ends before the block does.
  if (STAGED && !ready) pf_mbar_wait(&bar, 0);
}

// The glue's row gather: one thread per float4 of the (R, C) output.
__global__ void __launch_bounds__(PF_LANE_THREADS)
pf_rows_kernel(const float* __restrict__ table, int M, int C, const int* __restrict__ idx,
               int iters, int R, float* __restrict__ out) {
  const size_t t = (size_t)blockIdx.x * PF_LANE_THREADS + threadIdx.x;
  const int c4 = C / 4;
  if (t >= (size_t)R * c4) return;
  const size_t r = t / c4;
  const int k = (int)(t % c4);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = 0; i < iters; ++i) {
    const int j = idx[(size_t)i * R + r];
    const float4 q = __ldg(reinterpret_cast<const float4*>(table + (size_t)j * C) + k);
    acc.x = acc.x + q.x;
    acc.y = acc.y + q.y;
    acc.z = acc.z + q.z;
    acc.w = acc.w + q.w;
  }
  reinterpret_cast<float4*>(out)[t] = acc;
}

// ---------------------------------------------------------------------------
// pf_window
// ---------------------------------------------------------------------------

struct PfWin {
  const float* table;  // (N, C)
  const float* col;    // column 0, contiguous and padded (column modes)
  const int* idx;      // (iters, T * 1024)
  float* out;          // (T * 1024,)
  int N, C, iters, chunk;
  int ahead, depth;    // windows A and index tiles A + D iterations ahead
  int win_floats;      // floats of one window stage (a multiple of 4)
  int sums_bytes;      // ROWSUM: shared bytes of the window's row sums
};

template <int MODE>
__host__ __device__ constexpr bool pf_column_mode() {
  return MODE == W_COL0 || MODE == W_COL0_BF16;
}

// Lane value of window `win` (lo its first row) for index j: a column mode
// reads the staged column 0 (STAGED) or its own row in place; ROWSUM the
// window's row sums; COPY window[0][0].
template <int MODE, bool STAGED>
__device__ __forceinline__ float pf_window_value(const PfWin& a, const float* win, int lo, int j) {
  if (MODE == W_COPY) return win[0];
  const int rel = j - lo;
  if (rel < 0 || rel >= a.chunk) return 0.0f;
  if (MODE == W_ROWSUM) return win[rel];
  float v = STAGED ? win[(lo & 3) + rel] : __ldg(a.table + (size_t)j * a.C);
  if (MODE == W_COL0_BF16) v = __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// The barriers of pf_window's rings: full when a copy has landed (or, for
// a column-mode iteration read in place, when the producer says so),
// idx_free when the consumer warps have read an index tile, lo_full when
// lo of an iteration is known. A window stage needs no free barrier: the
// consumers take lo of iteration n after reading window n - W from it.
struct PfRings {
  unsigned long long idx_full[PF_RING_MAX], idx_free[PF_RING_MAX];
  unsigned long long win_full[PF_RING_MAX], lo_full[PF_RING_MAX];
  int lo[PF_RING_MAX];
  int staged[PF_RING_MAX];
  int wmin[2][PF_WIN_MAX_WARPS], wmax[2][PF_WIN_MAX_WARPS];
};

// The producer (one thread): window n into stage n % W once its lo is known
// (the stage is free by then), and index tile f into stage f % S once the
// consumers have freed it, up to A + D iterations ahead of the window.
template <int MODE>
__device__ void pf_window_producer(const PfWin& a, int* ring, float* wring, PfRings& r,
                                   size_t R, size_t tile0) {
  const int A = a.ahead, D = a.depth, S = A + D + 1, W = A + 1;
  int f = 0;
  for (; f < A + D && f < a.iters; ++f)
    pf_bulk(ring + f * PF_TILE, a.idx + (size_t)f * R + tile0, PF_TILE * 4, &r.idx_full[f]);
  for (int n = 0; n < a.iters; ++n) {
    pf_mbar_wait(&r.lo_full[n % W], (n / W) & 1);
    const int lo = r.lo[n % W];
    float* win = wring + (n % W) * a.win_floats;
    if (pf_column_mode<MODE>() && !r.staged[n % W]) {
      pf_mbar_arrive(&r.win_full[n % W]);  // read in place: nothing to copy
    } else if (pf_column_mode<MODE>()) {
      pf_fence_proxy_async();
      pf_bulk(win, a.col + (lo & ~3), (((lo & 3) + a.chunk + 3) & ~3) * 4, &r.win_full[n % W]);
    } else {
      pf_fence_proxy_async();
      pf_bulk(win, a.table + (size_t)lo * a.C, a.chunk * a.C * 4, &r.win_full[n % W]);
    }
    for (; f <= n + A + D && f < a.iters; ++f) {
      if (f >= S) pf_mbar_wait(&r.idx_free[f % S], ((f / S) - 1) & 1);
      pf_fence_proxy_async();
      pf_bulk(ring + (f % S) * PF_TILE, a.idx + (size_t)f * R + tile0, PF_TILE * 4,
              &r.idx_full[f % S]);
    }
  }
}

// A consumer thread's lanes of window `win`, added to acc in order.
template <int MODE, bool STAGED, int CONS, int NQ>
__device__ __forceinline__ void pf_window_add(const PfWin& a, const float* win, int lo,
                                              const int4* st, float* acc) {
#pragma unroll
  for (int h = 0; h < NQ; ++h) {
    const int4 q = st[h * CONS];
    float* ac = acc + 4 * h;
    ac[0] = ac[0] + pf_window_value<MODE, STAGED>(a, win, lo, q.x);
    ac[1] = ac[1] + pf_window_value<MODE, STAGED>(a, win, lo, q.y);
    ac[2] = ac[2] + pf_window_value<MODE, STAGED>(a, win, lo, q.z);
    ac[3] = ac[3] + pf_window_value<MODE, STAGED>(a, win, lo, q.w);
  }
}

// One block a tile: CONS consumer threads, each owning 1024 / CONS lanes in
// runs of 4 (lanes 4t..4t+3, then 4 * CONS further on), and a producer warp
// whose first thread issues every copy. Each iteration i the consumers take
// the minimum (and, column modes, the maximum) of index tile i + A (one
// named barrier among them; thread 0 publishes lo), then read window i and
// free its index tile.
template <int MODE, int CONS>
__global__ void __launch_bounds__(CONS + 32) pf_window_kernel(PfWin a) {
  constexpr int WARPS = CONS / 32, NQ = PF_TILE / (4 * CONS);
  constexpr bool COLUMN = pf_column_mode<MODE>();
  extern __shared__ __align__(128) int pf_ring[];  // S index tiles, then W windows
  __shared__ PfRings r;
  const int tid = threadIdx.x;
  const int A = a.ahead, D = a.depth, S = A + D + 1, W = A + 1;
  const size_t R = (size_t)gridDim.x * PF_TILE;
  const size_t tile0 = (size_t)blockIdx.x * PF_TILE;
  float* wring = reinterpret_cast<float*>(pf_ring + S * PF_TILE);
  float* sums = wring + W * a.win_floats;  // ROWSUM: the current window's row sums
  if (tid == 0) {
    for (int k = 0; k < S; ++k) {
      pf_mbar_init(&r.idx_full[k], 1);
      pf_mbar_init(&r.idx_free[k], WARPS);
    }
    for (int k = 0; k < W; ++k) {
      pf_mbar_init(&r.win_full[k], 1);
      pf_mbar_init(&r.lo_full[k], 1);
    }
    pf_fence_mbar_init();
  }
  __syncthreads();
  if (tid >= CONS) {
    if (tid == CONS) pf_window_producer<MODE>(a, pf_ring, wring, r, R, tile0);
    return;
  }
  const int lane = tid & 31;
  float acc[4 * NQ];
#pragma unroll
  for (int k = 0; k < 4 * NQ; ++k) acc[k] = 0.0f;
  for (int i = -A; i < a.iters; ++i) {
    const int n = i + A;  // the iteration whose lo is taken now
    if (n < a.iters) {
      pf_mbar_wait(&r.idx_full[n % S], (n / S) & 1);
      const int4* st = reinterpret_cast<const int4*>(pf_ring + (n % S) * PF_TILE);
      int lo = 0x7fffffff, hi = -0x7fffffff - 1;
#pragma unroll
      for (int h = 0; h < NQ; ++h) {
        const int4 q = st[tid + h * CONS];
        lo = min(lo, min(min(q.x, q.y), min(q.z, q.w)));
        hi = max(hi, max(max(q.x, q.y), max(q.z, q.w)));
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      if (COLUMN) hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        r.wmin[n & 1][tid >> 5] = lo;
        if (COLUMN) r.wmax[n & 1][tid >> 5] = hi;
      }
    }
    pf_bar_consumers<CONS>();
    if (tid == 0 && n < a.iters) {
      int lo = r.wmin[n & 1][0];
      for (int w = 1; w < WARPS; ++w) lo = min(lo, r.wmin[n & 1][w]);
      lo = min(lo, a.N - a.chunk);
      r.lo[n % W] = lo;
      if (COLUMN) {  // stage the window only when every lane reads in it
        int hi = r.wmax[n & 1][0];
        for (int w = 1; w < WARPS; ++w) hi = max(hi, r.wmax[n & 1][w]);
        r.staged[n % W] = hi - lo < a.chunk;
      }
      pf_mbar_arrive(&r.lo_full[n % W]);
    }
    if (i >= 0) {
      pf_mbar_wait(&r.win_full[i % W], (i / W) & 1);
      const int lo = r.lo[i % W];
      const float* win = wring + (i % W) * a.win_floats;
      if (MODE == W_ROWSUM) {
        // Each window row is summed once (columns in order) and the lanes read
        // the sums. The sums of iteration i - 1 were read before the barrier
        // above.
        const int C4 = a.C / 4;
        for (int k = tid; k < a.chunk; k += CONS)
          sums[k] = pf_row_sum_smem(reinterpret_cast<const float4*>(win) + (size_t)k * C4, C4, k & 3);
        pf_bar_consumers<CONS>();
        win = sums;
      }
      const int4* st = reinterpret_cast<const int4*>(pf_ring + (i % S) * PF_TILE) + tid;
      // A column-mode iteration reads the staged column or in place (the
      // block takes one branch).
      if (COLUMN && !r.staged[i % W]) {
        pf_window_add<MODE, false, CONS, NQ>(a, win, lo, st, acc);
      } else {
        pf_window_add<MODE, true, CONS, NQ>(a, win, lo, st, acc);
      }
      __syncwarp();
      if (lane == 0) pf_mbar_arrive(&r.idx_free[i % S]);
    }
  }
  float4* out4 = reinterpret_cast<float4*>(a.out + tile0);
#pragma unroll
  for (int h = 0; h < NQ; ++h)
    out4[tid + h * CONS] = make_float4(acc[4 * h], acc[4 * h + 1], acc[4 * h + 2], acc[4 * h + 3]);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Layout constants, checked by ops/_native.load against probes/fetch.py.
extern "C" int pf_layout(int which) {
  switch (which) {
    case 0: return PF_TILE;
    case 1: return L_COUNT;
    case 2: return W_COUNT;
    case 3: return PF_ROW_LANES;
    case 4: return P_COUNT;
    default: return -1;
  }
}

// Floats of the scratch that holds column 0 of an n-row table for the bulk
// copies (pf_lane's col, pf_window's col): n + 3 rounded up to 16 bytes, as
// a window starts at lo rounded down to 16 bytes.
extern "C" int pf_col_floats(int n) { return (n + 6) & ~3; }

static int pf_attr(cudaDeviceAttr attr) {
  int dev = 0, v = -1;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return -1;
  return v;
}

// The shared bytes a staged pf_lane takes (column 0 in 16-byte units; the
// table; ROWSUM the rows and their sums), or -1 where the mode stages
// nothing.
static long long pf_lane_stage_bytes(int mode, int M, int C) {
  if (mode == L_COL0) return 4ll * ((M + 3) & ~3);
  if (mode == L_SUBLANE) return 4ll * M * C;
  if (mode == L_ROWSUM) return 4ll * M * (C + 1);
  return -1;
}

template <int MODE, int PATH>
static cudaError_t pf_lane_launch(const PfLane& a, int* info, cudaStream_t s) {
  int per_sm = 0;
  if constexpr (PATH == P_IN_PLACE) {
    const int blocks = (a.R + PF_LANE_THREADS - 1) / PF_LANE_THREADS;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pf_lane_thread_kernel<MODE>, PF_LANE_THREADS, 0);
    if (err != cudaSuccess) return err;
    info[1] = blocks;
    info[2] = per_sm;
    info[3] = 0;
    pf_lane_thread_kernel<MODE><<<blocks, PF_LANE_THREADS, 0, s>>>(a);
  } else {
    // A staged launch holds the table; a quad row sum its warps' buffers (32
    // rows of 5 float4 a warp).
    const int smem = PATH == P_STAGED ? (int)pf_lane_stage_bytes(MODE, a.M, a.C)
                                      : PF_LANE_BLOCK * 5 * 16;
    cudaError_t err = cudaFuncSetAttribute(pf_lane_kernel<MODE, PATH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pf_lane_kernel<MODE, PATH>,
                                                        PF_LANE_BLOCK, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long groups = ((long long)a.R + PF_LPT - 1) / PF_LPT;
    const long long need = (groups + PF_LANE_BLOCK - 1) / PF_LANE_BLOCK;
    const long long most = (long long)per_sm * pf_attr(cudaDevAttrMultiProcessorCount);
    const int blocks = (int)(need < most ? need : most);
    info[1] = blocks;
    info[2] = per_sm;
    info[3] = smem;
    pf_lane_kernel<MODE, PATH><<<blocks, PF_LANE_BLOCK, smem, s>>>(a);
  }
  return cudaGetLastError();
}

// idx (iters, R) int32, table (M, C) f32 (16-byte aligned). out: (R,) f32,
// or (R, C) for ROWS. col: col_len >= pf_col_floats(M) floats of scratch for
// COL0, else null. info (4 ints, out): the path (P_*), blocks, blocks an SM,
// dynamic shared bytes. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int pf_lane(int mode, const float* table, int M, int C, const int* idx, int iters,
                       int R, float* col, int col_len, float* out, int* info, void* stream) {
  info[0] = P_IN_PLACE;
  info[1] = info[2] = info[3] = 0;
  if (R <= 0) return 0;
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if ((mode == L_ROWSUM || mode == L_ROWS) && C % 4 != 0) return (int)cudaErrorInvalidValue;
  if ((mode == L_LANE || mode == L_SUBLANE) && C != PF_ROW_LANES)
    return (int)cudaErrorInvalidValue;
  if (mode == L_COL0 && (col == nullptr || col_len < pf_col_floats(M)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == L_ROWS) {
    const size_t threads = (size_t)R * (C / 4);
    const unsigned blocks = (unsigned)((threads + PF_LANE_THREADS - 1) / PF_LANE_THREADS);
    pf_rows_kernel<<<blocks, PF_LANE_THREADS, 0, s>>>(table, M, C, idx, iters, R, out);
    info[1] = (int)blocks;
    return (int)cudaGetLastError();
  }
  const int optin = pf_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int sms = pf_attr(cudaDevAttrMultiProcessorCount);
  if (optin < 0 || sms < 0) return (int)cudaErrorInvalidValue;
  const long long bytes = pf_lane_stage_bytes(mode, M, C);
  const bool fits = bytes >= 0 && bytes <= optin - PF_STAGE_RESERVE;
  const bool wide = (long long)R >= (long long)PF_LPT * PF_LANE_BLOCK * sms;
  int path = P_IN_PLACE;
  if (mode == L_ROWSUM) {
    path = fits ? P_STAGED : (wide && 4ll * M * C > PF_QUAD_MIN_BYTES ? P_QUAD : P_IN_PLACE);
  } else if (fits && wide) {
    path = P_STAGED;
  }
  PfLane a{table, mode == L_COL0 ? col : table, idx, out, M, C, iters, R,
           mode == L_COL0 ? 4 * ((M + 3) & ~3) : 4 * M * C, 0};
  a.vec = R % PF_LPT == 0 && (uintptr_t)idx % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (path == P_STAGED && mode == L_COL0) {
    const int n = (M + 3) & ~3;
    pf_column_kernel<<<(n + 255) / 256, 256, 0, s>>>(table, M, C, col, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  info[0] = path;
  cudaError_t err = cudaErrorInvalidValue;
#define PF_CASE(MD, PT) \
  if (mode == MD && path == PT) err = pf_lane_launch<MD, PT>(a, info, s);
  PF_CASE(L_COL0, P_IN_PLACE)
  PF_CASE(L_COL0, P_STAGED)
  PF_CASE(L_LANE, P_IN_PLACE)
  PF_CASE(L_ROWSUM, P_IN_PLACE)
  PF_CASE(L_ROWSUM, P_STAGED)
  PF_CASE(L_ROWSUM, P_QUAD)
  PF_CASE(L_SUBLANE, P_IN_PLACE)
  PF_CASE(L_SUBLANE, P_STAGED)
#undef PF_CASE
  return (int)err;
}

static int pf_win_smem(int A, int D, int win_floats, int sums_bytes) {
  return 4 * ((A + D + 1) * PF_TILE + (A + 1) * win_floats) + sums_bytes;
}

template <int MODE>
static cudaError_t pf_window_launch(PfWin a, int T, int* info, cudaStream_t s) {
  constexpr int CONS = MODE == W_ROWSUM ? PF_WIN_CONS_ROWS : PF_WIN_CONS;
  // The deepest (A, D) whose shared memory keeps every tile resident at
  // once; else the shallowest with A >= 1 that fits the card; (0, 1), one
  // window and no copy ahead, only where no other fits.
  static const int pairs[][2] = {{2, 3}, {2, 2}, {1, 2}, {1, 1}, {0, 1}};
  const int sms = pf_attr(cudaDevAttrMultiProcessorCount);
  const int optin = pf_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (sms < 0 || optin < 0) return cudaErrorInvalidValue;
  int per_sm = 0, smem = 0, best = -1;
  for (int k = 0; k < 5; ++k) {
    const int need = pf_win_smem(pairs[k][0], pairs[k][1], a.win_floats, a.sums_bytes);
    if (need > optin) continue;
    int fit = 0;
    cudaError_t err = cudaFuncSetAttribute(pf_window_kernel<MODE, CONS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, pf_window_kernel<MODE, CONS>,
                                                        CONS + 32, need);
    if (err != cudaSuccess) return err;
    if (fit < 1) continue;
    if (best >= 0 && pairs[k][0] == 0) break;
    best = k;
    per_sm = fit;
    smem = need;
    if ((long long)fit * sms >= T) break;
  }
  if (best < 0) {  // no ring fits: the card's limit and the smallest ring's bytes
    info[3] = optin;
    info[4] = pf_win_smem(0, 1, a.win_floats, a.sums_bytes);
    return cudaErrorInvalidValue;
  }
  a.ahead = pairs[best][0];
  a.depth = pairs[best][1];
  cudaError_t err = cudaFuncSetAttribute(pf_window_kernel<MODE, CONS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  info[1] = a.ahead;
  info[2] = a.depth;
  info[3] = per_sm;
  info[4] = smem;
  pf_window_kernel<MODE, CONS><<<T, CONS + 32, smem, s>>>(a);
  return cudaGetLastError();
}

// idx (iters, T * 1024) int32 and table (N, C) f32, both 16-byte aligned,
// with C % 4 == 0 and N >= chunk; out (T * 1024,) f32. The column modes take
// col, col_len >= pf_col_floats(N) floats of scratch. info (5 ints, out):
// what a window stages (WP_COLUMN, WP_ROWS), the rings' A and D, blocks an
// SM, dynamic shared bytes; where no ring fits the card, info[3] its opt-in
// shared bytes and info[4] the smallest ring's, with cudaErrorInvalidValue.
extern "C" int pf_window(int mode, const float* table, int N, int C, const int* idx, int iters,
                         int T, int chunk, float* col, int col_len, float* out, int* info,
                         void* stream) {
  for (int k = 0; k < 5; ++k) info[k] = 0;
  if (T <= 0) return 0;
  if (C <= 0 || C % 4 != 0 || chunk <= 0 || N < chunk) return (int)cudaErrorInvalidValue;
  const bool column = mode == W_COL0 || mode == W_COL0_BF16;
  if (column && (col == nullptr || col_len < pf_col_floats(N))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (column) {
    const int n = pf_col_floats(N);
    pf_column_kernel<<<(n + 255) / 256, 256, 0, s>>>(table, N, C, col, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  PfWin a{table, col, idx, out, N, C, iters, chunk, 0, 0,
          column ? pf_col_floats(chunk) : chunk * C, mode == W_ROWSUM ? 4 * chunk : 0};
  info[0] = column ? WP_COLUMN : WP_ROWS;
  cudaError_t err = cudaErrorInvalidValue;
  switch (mode) {
    case W_COL0: err = pf_window_launch<W_COL0>(a, T, info, s); break;
    case W_COL0_BF16: err = pf_window_launch<W_COL0_BF16>(a, T, info, s); break;
    case W_ROWSUM: err = pf_window_launch<W_ROWSUM>(a, T, info, s); break;
    case W_COPY: err = pf_window_launch<W_COPY>(a, T, info, s); break;
    default: break;
  }
  return (int)err;
}
