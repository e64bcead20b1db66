// Dynamic-offset copy probes for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probes of the JAX package that looked for a windowed
// HBM -> VMEM copy Mosaic would compile (tools, not render paths):
//   tools/exp_dma.py   k_static, k_smem, k_vmin, k_vmin_smem, k_hbm (:44-105,
//                      call :29): 64 copies of a (256, 16) window
//   tools/exp_dma2.py  k1-k5 (:30-82, call :14): whole table, static slice,
//                      a loop of 4, run_scoped, a (1, 1) out
//   tools/exp_dma3.py  kA-kF (:35-92, call :17): block index static, from
//                      SMEM, from a vector min, in a loop; kE cannot trace
//                      (probes/dma.py holds it to what it means)
//   tools/exp_dma4.py  kE, kE3, kG2, kJ (:33-77, call :15): 1-D offsets, a
//                      dynamic-row read, a whole table into a larger
//                      destination (kG is a stub nothing runs)
// probes/dma.py holds the plain version and maps every body to its
// parameters: how the offset comes (OFFSET), what is read (OUT).
//
// pd_copy<MECH, OFFSET>: one block of PD_RING_THREADS (128) threads a window
// (B windows at once). Each copy takes its offset the way the body does: a
// constant; a constant through shared memory (written once, read back for
// every copy); a device int array; the minimum of an (8, 128) index tile
// (__reduce_min_sync a warp, then every thread reads the 4 warp minima); or
// that minimum routed through one shared int (warp 0 reduces the warp
// minima). It stages the window into dynamic shared memory by MECH:
//   CP_ASYNC  16-byte cp.async by every thread, one commit group a copy;
//   BULK      the TMA 1-D bulk copy (cp.async.bulk.shared::cluster.global)
//             issued by one thread, completed on the slot's mbarrier through
//             expect_tx.
// Offsets are whole 16-byte units (64-byte rows), so both stay aligned.
//
// A ring of copies in flight (C46): K = min(PD_RING, copies) slots of the
// destination, shrunk to fit the opt-in shared memory. Copy c goes to slot
// c % K; before it is issued, copy c - K, the slot's last, is waited for
// and read, so K copies fly while one is read. The only thread that reads a
// window before the last is thread 0 (acc = acc + window[0], in copy
// order; with CP_ASYNC window[0] is its own piece), so a slot is refilled
// with no block barrier: BULK by thread 0 alone (the static, shared and
// array routes run their whole loop on it; its fence.proxy.async orders its
// read of a slot before the refill), CP_ASYNC by each thread over its own
// pieces (wait_group K - 1, then the refill). The tile-minimum routes
// compute copy c's offset with every thread before copy c - K is waited for
// (the indices of copy c + 1 load meanwhile; no load depends on a copy);
// their warp minima and shared int live in buffers by copy % 4. The last
// copy's slot is never refilled: after one barrier every thread reads it
// (OUT_COL; BULK waits on its mbarrier's last phase, CP_ASYNC on its group).
// A destination larger than one block's shared memory (exp_dma2 k1: 262,144
// bytes; exp_dma4 kJ: 278,528 against 232,448) runs on a 2-block cluster
// (__cluster_dims__(2, 1, 1)) of PD_THREADS threads, one copy at a time:
// each block stages its half into its own shared memory; rank 0, once its
// half has landed, arrives on rank 1's mbarrier (release at cluster scope),
// and rank 1 reads what it needs from rank 0's half through distributed
// shared memory (cluster.map_shared_rank) after its acquire wait; rows 0..7
// lie in rank 0's half, so the read crosses SMs. One cluster barrier a copy
// keeps rank 0 from restaging, or exiting, while rank 1 still reads its
// half.
// OUT_ROWS (exp_dma4 kG2) copies nothing: the 8 rows at the offset are one
// coalesced load, a thread an element.
//
// What bounds it: how fast one SM's copy engine fills shared memory (a 16
// KB bulk copy ~240 ns with copies in flight, cp.async ~350 ns; PERF.md);
// a 16 KB window at 3.35 TB/s is 4.9 ns of bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_report.cuh"

namespace cg = cooperative_groups;

#define PD_THREADS 1024
#define PD_TILE 1024
#define PD_BULK_BYTES 32768  // bytes a bulk instruction (the window is split)
#define PD_BUFS 4            // a route's shared values, by copy % PD_BUFS (a power of 2)

// Copies a block keeps in flight at most (the ring's slots), and the ring
// kernel's threads (the cluster kernel keeps PD_THREADS).
constexpr int PD_RING = 4;
constexpr int PD_RING_THREADS = 128;
static_assert(PD_RING >= 1 && PD_RING <= 8, "pd_cp_wait covers wait_group 0..7");

enum { M_CP_ASYNC, M_BULK, M_COUNT };
enum { O_STATIC, O_SMEM, O_ARRAY, O_VMIN, O_VMIN_SMEM, O_COUNT };
enum { OUT_SUM1, OUT_SUM, OUT_COL, OUT_ROWS, OUT_COUNT };

struct PdArgs {
  const float* table;  // flat f32
  int count;           // floats copied
  int dest;            // floats of destination (>= count)
  int base, unit, div, stride;
  const int* offs;     // (B, iters) array, (B, iters, 1024) tile minimum
  int iters;
  int out_mode;
  int half;            // cluster: floats a block holds; 0: one block
  float* out;          // (B, 1) or (B, 1024)
  int slots;           // the ring's K (one block)
  int slot;            // floats between slots
};

struct PdShared {
  unsigned long long bar[PD_RING];  // BULK: slot k's copies
  unsigned long long peer;          // cluster: rank 0's half has landed (rank 1's)
  int wmin[PD_BUFS][PD_THREADS / 32];
  int val[PD_BUFS];
};

__device__ __forceinline__ unsigned pd_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void pd_mbar_wait(unsigned bar, unsigned phase) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// The same wait with acquire at cluster scope: what a peer block released
// before arriving is visible after it.
__device__ __forceinline__ void pd_mbar_wait_cluster(unsigned bar, unsigned phase) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void pd_mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(pd_saddr(bar)) : "memory");
}

// cp.async.wait_group takes an immediate: the ring's K - 1 picks it.
__device__ __forceinline__ void pd_cp_wait(int pending) {
  switch (pending) {
#define PD_WAIT(N)                                                     \
  case N:                                                              \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); \
    break;
    PD_WAIT(1)
    PD_WAIT(2)
    PD_WAIT(3)
    PD_WAIT(4)
    PD_WAIT(5)
    PD_WAIT(6)
    PD_WAIT(7)
#undef PD_WAIT
    default:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// The stages of copy c's offset (c < a.iters), by the body's route, for a
// block of T threads.
// Load: what this thread contributes, into a register (the tile minimum: the
// least of its 1024 / T indices).
template <int KIND, int T>
__device__ __forceinline__ int pd_load(const PdArgs& a, int b, int c) {
  if (c < 0 || c >= a.iters) return 0;
  if (KIND == O_ARRAY) return a.offs[(size_t)b * a.iters + c];
  if (KIND == O_VMIN || KIND == O_VMIN_SMEM) {
    const int* tile = a.offs + ((size_t)b * a.iters + c) * PD_TILE + threadIdx.x;
    int m = tile[0];
#pragma unroll
    for (int j = 1; j < PD_TILE / T; ++j) m = min(m, tile[j * T]);
    return m;
  }
  return a.base;
}

// Post, before a barrier: the route's values in shared memory.
template <int KIND>
__device__ __forceinline__ void pd_post(const PdArgs& a, PdShared& sh, int c, int x) {
  if (c < 0 || c >= a.iters) return;
  if (KIND == O_SMEM && threadIdx.x == 0) sh.val[c & (PD_BUFS - 1)] = x;
  if (KIND == O_VMIN || KIND == O_VMIN_SMEM) {
    const int m = __reduce_min_sync(0xffffffffu, x);
    if ((threadIdx.x & 31) == 0) sh.wmin[c & (PD_BUFS - 1)][threadIdx.x >> 5] = m;
  }
}

// Relay, after that barrier (vmin_smem): warp 0 reduces the warp minima into
// the shared int.
template <int KIND, int T>
__device__ __forceinline__ void pd_relay(const PdArgs& a, PdShared& sh, int c) {
  if (KIND != O_VMIN_SMEM || c < 0 || c >= a.iters || threadIdx.x >= 32) return;
  const int* w = sh.wmin[c & (PD_BUFS - 1)];
  const int mm = __reduce_min_sync(0xffffffffu, threadIdx.x < T / 32 ? w[threadIdx.x] : INT32_MAX);
  if (threadIdx.x == 0) sh.val[c & (PD_BUFS - 1)] = mm;
}

// Take, after a barrier that follows the post (and the relay): the offset in
// floats. x is this thread's loaded value (static, array).
template <int KIND, int T>
__device__ __forceinline__ int pd_take(const PdArgs& a, const PdShared& sh, int c, int x) {
  int raw = x;
  if (KIND == O_SMEM || KIND == O_VMIN_SMEM) {
    raw = sh.val[c & (PD_BUFS - 1)];
  } else if (KIND == O_VMIN) {
    const int* w = sh.wmin[c & (PD_BUFS - 1)];
    raw = w[0];
#pragma unroll
    for (int k = 1; k < T / 32; ++k) raw = min(raw, w[k]);
  }
  return (a.div == 1 ? raw : raw / a.div) * a.unit;
}

// One copy's offset at once (the cluster kernel, OUT_ROWS): every thread of
// the block calls it.
template <int KIND, int T>
__device__ __forceinline__ int pd_offset(const PdArgs& a, PdShared& sh, int b, int c) {
  const int x = pd_load<KIND, T>(a, b, c);
  pd_post<KIND>(a, sh, c, x);
  if (KIND == O_SMEM || KIND == O_VMIN || KIND == O_VMIN_SMEM) __syncthreads();
  pd_relay<KIND, T>(a, sh, c);
  if (KIND == O_VMIN_SMEM) __syncthreads();
  return pd_take<KIND, T>(a, sh, c, x);
}

// Issue the copy of n floats (a multiple of 4) from global src into shared
// dst: cp.async parts by every thread (committed by the caller), or one bulk
// copy on mbarrier bar by thread 0.
template <int MECH, int T>
__device__ __forceinline__ void pd_issue(float* dst, const float* src, int n,
                                         unsigned long long* bar) {
  if (MECH == M_CP_ASYNC) {
    for (int k = threadIdx.x; k < n / 4; k += T) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(pd_saddr(dst + 4 * k)),
                   "l"(src + 4 * k)
                   : "memory");
    }
  } else if (threadIdx.x == 0) {
    const unsigned b = pd_saddr(bar);
    // The block's earlier reads of dst come before the copy's writes.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(n * 4)
                 : "memory");
    for (int off = 0; off < n * 4; off += PD_BULK_BYTES) {
      const int bytes = min(PD_BULK_BYTES, n * 4 - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(pd_saddr(dst) + off),
          "l"(reinterpret_cast<const char*>(src) + off), "r"(bytes), "r"(b)
          : "memory");
    }
  }
}

// One copy at a time (the cluster kernel): issue, wait; on return every
// thread of the block sees the floats. `phase` is bar's next parity.
template <int MECH, int T>
__device__ __forceinline__ void pd_stage(float* dst, const float* src, int n,
                                         unsigned long long* bar, unsigned& phase) {
  if (n <= 0) return;
  pd_issue<MECH, T>(dst, src, n, bar);
  if (MECH == M_CP_ASYNC) {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  } else {
    pd_mbar_wait(pd_saddr(bar), phase);
    phase ^= 1u;
  }
}

// The cluster kernel's output, a block of T threads.
template <int T>
__device__ __forceinline__ void pd_write(const PdArgs& a, int b, float acc, float col) {
  if (a.out_mode == OUT_SUM1) {
    if (threadIdx.x == 0) a.out[b] = acc;
    return;
  }
  for (int k = threadIdx.x; k < PD_TILE; k += T)
    a.out[(size_t)b * PD_TILE + k] = a.out_mode == OUT_COL ? col : acc;
}

// The ring: PD_RING_THREADS threads a block, K = a.slots slots of a.slot
// floats. Copy c goes to slot c % K; the n-th copy into a slot completes its
// mbarrier's phase n (BULK). Thread 0 is the only thread that reads a window
// before the last (acc = acc + window[0], window[0] being its own cp.async
// piece), so a slot is refilled, by the thread that read it, with no block
// barrier; the last copy's slot is never refilled, and every thread reads it
// after the loop (OUT_COL).
template <int MECH, int KIND>
__global__ void __launch_bounds__(PD_RING_THREADS) pd_copy_kernel(PdArgs a) {
  constexpr int T = PD_RING_THREADS;
  constexpr bool VMIN = KIND == O_VMIN || KIND == O_VMIN_SMEM;
  // Bulk copies of a route without a block reduction are thread 0's alone.
  constexpr bool SOLO = MECH == M_BULK && !VMIN;
  extern __shared__ __align__(128) float pd_win[];
  __shared__ PdShared sh;
  __shared__ float total;
  const int b = blockIdx.x, tid = threadIdx.x;
  if (a.out_mode == OUT_ROWS) {
    const int off = pd_offset<KIND, T>(a, sh, b, a.iters - 1);
    for (int k = tid; k < PD_TILE; k += T) a.out[(size_t)b * PD_TILE + k] = __ldg(a.table + off + k);
    return;
  }
  const int K = a.slots, n = a.iters;
  if (tid == 0) {
    if (MECH == M_BULK) {
      for (int k = 0; k < K; ++k) pd_mbar_init(&sh.bar[k]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (KIND == O_SMEM) sh.val[0] = a.base;  // the constant, read back for every copy
  }
  __syncthreads();
  float acc = 0.0f;
  if (!SOLO || tid == 0) {
    int x = pd_load<KIND, T>(a, b, 0);
    int s = 0, q = 0;  // c = q * K + s: copy c goes to slot s, after copy c - K
    for (int c = 0; c < n + K; ++c) {
      int off = 0;
      if (c < n) {  // copy c's offset: no load here depends on a copy
        if (VMIN) {
          pd_post<KIND>(a, sh, c, x);
          x = pd_load<KIND, T>(a, b, c + 1);
          __syncthreads();
          pd_relay<KIND, T>(a, sh, c);
          if (KIND == O_VMIN_SMEM) __syncthreads();
          off = pd_take<KIND, T>(a, sh, c, 0);
        } else {
          off = pd_take<KIND, T>(a, sh, KIND == O_SMEM ? 0 : c, x);
          x = pd_load<KIND, T>(a, b, c + 1);
        }
      }
      if (c >= K) {  // copy c - K has landed in slot s: thread 0 reads it
        if (MECH == M_BULK) {
          if (tid == 0) pd_mbar_wait(pd_saddr(&sh.bar[s]), (unsigned)(q - 1) & 1u);
        } else {
          pd_cp_wait(K - 1);
        }
        if (tid == 0) acc = acc + pd_win[(size_t)s * a.slot];
      }
      if (c < n) {
        pd_issue<MECH, T>(pd_win + (size_t)s * a.slot, a.table + off, a.count, &sh.bar[s]);
      }
      if (MECH == M_CP_ASYNC) asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (++s == K) s = 0, ++q;
    }
  }
  // Every thread sees the last window (its slot's last phase has completed).
  if (MECH == M_CP_ASYNC) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (tid == 0) total = acc;
  __syncthreads();
  if (MECH == M_BULK) pd_mbar_wait(pd_saddr(&sh.bar[(n - 1) % K]), (unsigned)((n - 1) / K) & 1u);
  if (a.out_mode == OUT_SUM1) {
    if (tid == 0) a.out[b] = acc;
    return;
  }
  const float* last = pd_win + (size_t)((n - 1) % K) * a.slot;
  for (int k = tid; k < PD_TILE; k += T)
    a.out[(size_t)b * PD_TILE + k] = a.out_mode == OUT_COL ? last[(k >> 7) * a.stride] : total;
}

// Element k of a window held in two halves by the cluster's blocks.
__device__ __forceinline__ float pd_dsmem(cg::cluster_group& cluster, float* win, int half,
                                          int k) {
  return cluster.map_shared_rank(win, (unsigned)(k / half))[k % half];
}

template <int MECH, int KIND>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(PD_THREADS)
pd_cluster_kernel(PdArgs a) {
  extern __shared__ __align__(128) float pd_win[];
  __shared__ PdShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int b = blockIdx.x / 2, tid = threadIdx.x;
  if (tid == 0) {
    pd_mbar_init(&sh.bar[0]);
    pd_mbar_init(&sh.peer);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // rank 1's barrier is initialised before rank 0 arrives on it
  const int start = (int)rank * a.half;
  const int n = min(a.half, a.count - start);
  unsigned phase = 0;
  float acc = 0.0f, col = 0.0f;
  for (int i = 0; i < a.iters; ++i) {
    const int off = pd_offset<KIND, PD_THREADS>(a, sh, b, i);
    pd_stage<MECH, PD_THREADS>(pd_win, a.table + off + start, n, &sh.bar[0], phase);
    if (rank == 0) {
      if (tid == 0) {  // rank 0's half is in (thread 0 saw it land): tell rank 1
        unsigned remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote)
                     : "r"(pd_saddr(&sh.peer)), "r"(1));
        asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
                     : "memory");
      }
    } else {
      pd_mbar_wait_cluster(pd_saddr(&sh.peer), (unsigned)i & 1u);
      acc = acc + pd_dsmem(cluster, pd_win, a.half, 0);
      if (a.out_mode == OUT_COL) col = pd_dsmem(cluster, pd_win, a.half, (tid >> 7) * a.stride);
    }
    cluster.sync();  // rank 1's reads are done before the next copy, and before exit
  }
  if (rank == 1) pd_write<PD_THREADS>(a, b, acc, col);
}

// Floats between the ring's slots (128-byte aligned), and the ring's K for
// `iters` copies of a destination of `dest` floats within `limit` bytes of
// dynamic shared memory (0: even the smallest ring does not fit).
static int pd_slot(int dest) { return (dest + 31) & ~31; }

static int pd_slots(int iters, int dest, int limit) {
  for (int k = min(PD_RING, iters); k >= 1; --k)
    if ((long long)k * pd_slot(dest) * 4 <= limit) return k;
  return 0;
}

static int pd_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

template <int MECH, int KIND>
static int pd_launch(PdArgs a, int B, cudaStream_t s) {
  cudaError_t err;
  if (a.half > 0) {
    const int bytes = a.half * 4;
    err = cudaFuncSetAttribute(pd_cluster_kernel<MECH, KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    pd_cluster_kernel<MECH, KIND><<<2 * B, PD_THREADS, bytes, s>>>(a);
    return (int)cudaGetLastError();
  }
  int bytes = 0;
  if (a.out_mode != OUT_ROWS) {
    int optin = 0;
    cudaFuncAttributes attr;
    int e = pd_optin(&optin);
    if (e == 0) e = (int)cudaFuncGetAttributes(&attr, pd_copy_kernel<MECH, KIND>);
    if (e != 0) return e;
    a.slot = pd_slot(a.dest);
    a.slots = pd_slots(a.iters, a.dest, optin - (int)attr.sharedSizeBytes);
    if (a.slots == 0) return (int)cudaErrorInvalidValue;  // not even one slot fits
    bytes = a.slots * a.slot * 4;
  }
  err = cudaFuncSetAttribute(pd_copy_kernel<MECH, KIND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  pd_copy_kernel<MECH, KIND><<<B, PD_RING_THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int MECH>
static int pd_kind(int kind, const PdArgs& a, int B, cudaStream_t s) {
  switch (kind) {
    case O_STATIC: return pd_launch<MECH, O_STATIC>(a, B, s);
    case O_SMEM: return pd_launch<MECH, O_SMEM>(a, B, s);
    case O_ARRAY: return pd_launch<MECH, O_ARRAY>(a, B, s);
    case O_VMIN: return pd_launch<MECH, O_VMIN>(a, B, s);
    case O_VMIN_SMEM: return pd_launch<MECH, O_VMIN_SMEM>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// table: flat f32, 16-byte aligned; count floats copied a copy (a multiple
// of 4) into a destination of dest floats; offset (raw / div) * unit floats,
// raw from `kind` (base, or offs); iters copies; B windows; half > 0 runs
// each window on a 2-block cluster holding `half` floats a block. out (B, 1)
// for OUT_SUM1, else (B, 1024). Returns the cudaError_t of the attribute call
// or the launch (0 on success); cudaErrorInvalidValue where half is 0 and one
// destination does not fit one block's shared memory.
extern "C" int pd_copy(int mech, int kind, int out_mode, const float* table, int count,
                       int dest, int base, int unit, int div, int stride, const int* offs,
                       int iters, int B, int half, float* out, void* stream) {
  if (B <= 0) return 0;
  const int align = kind <= O_SMEM && div > 0 ? base / div * unit : unit;  // floats
  if (count <= 0 || count % 4 || dest < count || align % 4 || div <= 0 || iters <= 0 ||
      out_mode < 0 || out_mode >= OUT_COUNT || half < 0 || half % 4 ||
      (half > 0 && 2 * half < dest) || (out_mode == OUT_COL && 7 * stride >= count) ||
      (kind >= O_ARRAY && offs == nullptr))
    return (int)cudaErrorInvalidValue;
  const PdArgs a = {table, count, dest, base, unit, div, stride, offs, iters, out_mode,
                    half, out, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (mech == M_CP_ASYNC) return pd_kind<M_CP_ASYNC>(kind, a, B, s);
  if (mech == M_BULK) return pd_kind<M_BULK>(kind, a, B, s);
  return (int)cudaErrorInvalidValue;
}

// The compiler's and the occupancy API's report of the ring kernel
// pd_copy<mech, kind> with the ring of `iters` copies of a destination of
// `dest` floats (kernel_report.cuh); out[6] = the ring's K. Returns a
// cudaError_t.
extern "C" int pd_kernel_info(int mech, int kind, int dest, int iters, int* out) {
  const void* k = nullptr;
#define PD_INFO(M, O)                               \
  if (mech == M && kind == O) k = (const void*)pd_copy_kernel<M, O>;
  PD_INFO(M_CP_ASYNC, O_STATIC) PD_INFO(M_CP_ASYNC, O_SMEM) PD_INFO(M_CP_ASYNC, O_ARRAY)
  PD_INFO(M_CP_ASYNC, O_VMIN) PD_INFO(M_CP_ASYNC, O_VMIN_SMEM)
  PD_INFO(M_BULK, O_STATIC) PD_INFO(M_BULK, O_SMEM) PD_INFO(M_BULK, O_ARRAY)
  PD_INFO(M_BULK, O_VMIN) PD_INFO(M_BULK, O_VMIN_SMEM)
#undef PD_INFO
  if (k == nullptr || dest <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaFuncAttributes attr;
  int e = pd_optin(&optin);
  if (e == 0) e = (int)cudaFuncGetAttributes(&attr, k);
  if (e != 0) return e;
  const int slots = pd_slots(iters, dest, optin - (int)attr.sharedSizeBytes);
  if (slots == 0) return (int)cudaErrorInvalidValue;
  const int bytes = slots * pd_slot(dest) * 4;
  e = (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == 0) e = kernel_report(k, PD_RING_THREADS, out, bytes);
  out[6] = slots;
  return e;
}

// Layout constants, checked by ops/_native.load against probes/dma.py.
extern "C" int pd_layout(int which) {
  switch (which) {
    case 0: return PD_TILE;
    case 1: return M_COUNT;
    case 2: return O_COUNT;
    case 3: return OUT_COUNT;
    default: return -1;
  }
}
