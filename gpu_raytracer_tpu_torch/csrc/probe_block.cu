// Block-synchronous pop loop for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probe tools/exp_blocksync.py `make_pop_kernel.kernel`
// (:46), run by its `wrapper` through `kernel_flat` (call :101; the probe's
// other call, `f` at :90, cannot trace: ROADMAP C). One stack of node ids for
// a whole (8, 128) tile; each pop reads the node's (64,) row, slab-tests its
// 8 children on all 1024 lanes, pushes (node * 8 + c + 1) % N for each child
// any lane hits (sp < 64), and caps sp at 48. probes/block.py holds the plain
// version.
//
// Layout (redesigned for Hopper, ROADMAP C45): the tile's 1,024 lanes are
// spread over a cluster of PB_CLUSTER blocks (lane rank * PB_THREADS + t), so
// the slab test of a pop runs on PB_CLUSTER SMs. A pop:
//   - fetches the rows the next pop may read, before its slab test: the 8
//     children it may push, (node * 8 + c + 1) % N, and the entry below the
//     popped one (stack[sp - 1], or the popped node itself where sp is 0);
//     their 48 bounds land in registers and go to the block's candidate
//     buffer of the other parity after the slab test, so the loads overlap it;
//   - slab-tests the popped row (read by broadcast from the candidate buffer)
//     in child order against each lane's own best_t, keeping an 8-bit hit mask;
//   - ORs the warp's masks (__reduce_or_sync) and stores the word into every
//     block's shared memory by st.async (distributed shared memory, a buffer
//     of each parity), each store completing 4 bytes on the receiving
//     block's mbarrier of that parity, which expects the tile's 32 words
//     (128 bytes) a phase; one block barrier puts the candidate rows in; a
//     warp waits on its own block's mbarrier and ORs the 32 words into the
//     tile's any-mask. No cluster barrier: one a pop (release, acquire) took
//     1.4x as long (PERF.md, with the other exchanges and cluster sizes
//     measured);
//   - replays the stack: the pushes and the next pop follow from the any-mask
//     alone, so every warp keeps its own copy, two slots a lane in registers
//     (lane l: slots l and 32 + l). Child c goes to sp + the set bits below c;
//     sp = min(sp + pushes, 48); the new top is a shuffle, and its row is the
//     candidate of the pushed child on top, or the entry below where nothing
//     was pushed. sp < 48 after a pop and 8 pushes at most, so the plain
//     version's sp < 64 check never binds, and no slot past 55 is written.
// No pusher thread, no cluster barrier in the loop, no load on the chain.
//
// What bounds it: a chain of 256 dependent pops. The bytes (a 256-byte row a
// pop) and operations (30 a lane and child) over the card's rates are far
// below the time; a pop waits on its slab test (PB_THREADS lanes an SM), the
// exchange of the masks across the cluster, and the replayed pushes.
//
// Float semantics follow the plain version, built with -fmad=false: ix = 1 /
// dx (IEEE division), the slab terms (b - o) * ix, min/max in the probe's
// order (no NaN reaches them), best_t = min(best_t, tn + 1e30).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_report.cuh"

namespace cg = cooperative_groups;

#define PB_LANES 1024
#define PB_ROW 64
#define PB_STACK 64
#define PB_SP_CAP 48
#define PB_FAR 1e30f
#define PB_FULL_MASK 0xffffffffu
#define PB_BOUNDS 48  // floats of a row the slab test reads
#define PB_CAND 9     // rows the next pop may read: 8 children, the entry below

// Blocks a tile (a cluster): 8, the largest portable size.
constexpr int PB_CLUSTER = 8;
constexpr int PB_THREADS = PB_LANES / PB_CLUSTER;
constexpr int PB_WARPS = PB_THREADS / 32;
constexpr int PB_CAND_Q = PB_CAND * PB_BOUNDS / 4;  // float4s of the candidates
constexpr int PB_PRE = (PB_CAND_Q + PB_THREADS - 1) / PB_THREADS;  // a thread's

struct __align__(16) PbShared {
  float4 cand[2][PB_CAND][PB_BOUNDS / 4];  // each parity's candidate rows' bounds
  unsigned masks[2][32];                   // each parity's warp words of the tile
  unsigned long long mbar[2];              // each parity's: the words' 128 bytes
};

__device__ __forceinline__ unsigned pb_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ unsigned pb_mapa(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(pb_saddr(p)), "r"(rank));
  return r;
}

// The position of set bit k (0 the lowest) of an 8-bit mask with more than k
// set bits.
__device__ __forceinline__ int pb_nth_bit(unsigned m, int k) {
#pragma unroll
  for (int i = 0; i < 7; ++i)
    if (i < k) m &= m - 1;
  return __ffs(m) - 1;
}

__global__ void __launch_bounds__(PB_THREADS)
pb_pop_kernel(const float* __restrict__ tab, int N, const float* __restrict__ o,
              const float* __restrict__ d, int pops, float* __restrict__ out) {
  __shared__ PbShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int tid = rank * PB_THREADS + threadIdx.x;                   // the tile's lane
  const unsigned word = rank * PB_WARPS + (threadIdx.x >> 5);       // this warp's word
  const float ox = o[tid], oy = o[PB_LANES + tid], oz = o[2 * PB_LANES + tid];
  const float ix = 1.0f / d[tid], iy = 1.0f / d[PB_LANES + tid],
              iz = 1.0f / d[2 * PB_LANES + tid];
  float best = PB_FAR;
  if (threadIdx.x < PB_BOUNDS / 4)  // the root's row
    sh.cand[0][0][threadIdx.x] = __ldg(reinterpret_cast<const float4*>(tab) + threadIdx.x);
  if (threadIdx.x < 2) {  // one arrival a phase: thread 0's expect_tx
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(pb_saddr(&sh.mbar[threadIdx.x]))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // the root's row in, every block's mbarriers initialised

  // The warp's copy of the stack (lane l: slots l and 32 + l; slot 0 the
  // root) after the first pop: the root, sp 1 -> 0.
  int s_lo = 0, s_hi = 0;
  int node = 0, sp = 0;
  int sel = 0;  // the popped node's row in the candidate buffer
  for (int it = 0; it < pops; ++it) {
    const int cur = it & 1;
    // ---- the next pop's candidate rows, in flight during the slab test ----
    const int child = (node * 8 + min(lane, 7) + 1) % N;  // lane c < 8: child c
    const int bs = max(sp - 1, 0);
    const int below = __shfl_sync(PB_FULL_MASK, bs < 32 ? s_lo : s_hi, bs & 31);
    float4 pre[PB_PRE];
#pragma unroll
    for (int j = 0; j < PB_PRE; ++j) {
      const int q = threadIdx.x + j * PB_THREADS, c = q / (PB_BOUNDS / 4);
      const int cn = __shfl_sync(PB_FULL_MASK, child, min(c, 7));
      if (q < PB_CAND_Q)
        pre[j] = __ldg(reinterpret_cast<const float4*>(tab + (size_t)(c < 8 ? cn : below) *
                                                                 PB_ROW) +
                       q % (PB_BOUNDS / 4));
    }
    // ---- slab test of the popped row, in child order ----
    const float* row = reinterpret_cast<const float*>(sh.cand[cur][sel]);
    unsigned hits = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float* b = row + 6 * c;
      const float tx0 = (b[0] - ox) * ix, tx1 = (b[3] - ox) * ix;
      const float ty0 = (b[1] - oy) * iy, ty1 = (b[4] - oy) * iy;
      const float tz0 = (b[2] - oz) * iz, tz1 = (b[5] - oz) * iz;
      const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
      const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
      const bool hit = (tn <= tf) && (tf > 0.0f) && (tn < best);
      hits |= (unsigned)hit << c;
      if (hit) best = fminf(best, tn + PB_FAR);
    }
    const unsigned wm = __reduce_or_sync(PB_FULL_MASK, hits);
    // ---- the candidates in; the warp's word into every block; the tile's mask ----
#pragma unroll
    for (int j = 0; j < PB_PRE; ++j) {
      const int q = threadIdx.x + j * PB_THREADS;
      if (q < PB_CAND_Q) sh.cand[cur ^ 1][q / (PB_BOUNDS / 4)][q % (PB_BOUNDS / 4)] = pre[j];
    }
    if (threadIdx.x == 0)  // this block's 32 words of the pop: 128 bytes
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 128;\n" ::"r"(
                       pb_saddr(&sh.mbar[cur]))
                   : "memory");
    if (lane < PB_CLUSTER)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
              pb_mapa(&sh.masks[cur][word], lane)),
          "r"(wm), "r"(pb_mapa(&sh.mbar[cur], lane))
          : "memory");
    __syncthreads();  // the block's candidate rows in (and the last pop's read)
    unsigned done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(pb_saddr(&sh.mbar[cur])), "r"((unsigned)(it >> 1) & 1u)
          : "memory");
    } while (!done);
    const unsigned any = __reduce_or_sync(PB_FULL_MASK, sh.masks[cur][lane]);
    // ---- the pushes and the next pop, replayed by every warp ----
    const int n = __popc(any);
    const int k_lo = lane - sp, k_hi = lane + 32 - sp;  // ranks of the slots' pushes
    const int v_lo = __shfl_sync(PB_FULL_MASK, child, pb_nth_bit(any, k_lo) & 7);
    const int v_hi = __shfl_sync(PB_FULL_MASK, child, pb_nth_bit(any, k_hi) & 7);
    if (k_lo >= 0 && k_lo < n) s_lo = v_lo;
    if (k_hi >= 0 && k_hi < n) s_hi = v_hi;
    const int top = max(min(sp + n, PB_SP_CAP) - 1, 0);
    sel = n > 0 ? pb_nth_bit(any, top - sp) : PB_CAND - 1;
    node = __shfl_sync(PB_FULL_MASK, top < 32 ? s_lo : s_hi, top & 31);
    sp = top;
  }
  out[tid] = best;
}

// tab (N, 64) f32, 16-byte aligned, N <= 2^28 (node * 8 + 8 stays an int);
// o, d (3, 1024) f32 (x, y, z planes of the (8, 128) tile); out (1024,) f32.
// One cluster of PB_CLUSTER blocks. Returns the cudaError_t of the launch.
extern "C" int pb_pop(const float* tab, int N, const float* o, const float* d, int pops,
                      float* out, void* stream) {
  if (N <= 0 || N > (1 << 28) || pops < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(PB_CLUSTER, 1, 1);
  cfg.blockDim = dim3(PB_THREADS, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PB_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, pb_pop_kernel, tab, N, o, d, pops, out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The compiler's and the occupancy API's report of pb_pop, a block of its
// cluster (kernel_report.cuh). Returns a cudaError_t.
extern "C" int pb_kernel_info(int* out) {
  return kernel_report((const void*)pb_pop_kernel, PB_THREADS, out);
}

// Layout constants, checked by ops/_native.load against probes/block.py.
extern "C" int pb_layout(int which) {
  switch (which) {
    case 0: return PB_LANES;
    case 1: return PB_ROW;
    case 2: return PB_STACK;
    case 3: return PB_SP_CAP;
    case 4: return PB_CLUSTER;
    default: return -1;
  }
}
