// The price of one cluster barrier on Hopper (sm_90a), and of the hit-mask
// exchange that `pb_pop` (gpu_raytracer_tpu_torch/csrc/probe_block.cu) runs
// once a pop. A microbenchmark built and run by tools/torch_cluster_barrier.py;
// not part of the port's kernel library.
//
// One cluster of `cluster` blocks holds the probe's 1,024 lanes (1024 /
// cluster threads a block) and loops `iters` times over one of:
//   CB_SYNCTHREADS  __syncthreads (the block barrier, for scale);
//   CB_BARRIER      barrier.cluster.arrive.release + wait.acquire;
//   CB_RELAXED      barrier.cluster.arrive.relaxed + wait (no memory order);
//   CB_EXCHANGE     a warp's __reduce_or_sync, its word stored into every
//                   block's shared memory (distributed shared memory, a
//                   buffer of each parity), the cluster barrier, and every
//                   warp's __reduce_or_sync of the 32 words: the tile's 8-bit
//                   any-hit mask, as a pop of pb_pop needs it;
//   CB_MBAR         the same words, each followed by a remote
//                   mbarrier.arrive.release.cluster on the block it went to;
//                   every thread waits on its own block's mbarrier (32
//                   arrivals a phase, one of each parity);
//   CB_FLAGS        the same words tagged with the iteration (tag << 8 |
//                   mask, st.relaxed.cluster); every lane spins on its own
//                   block's word until the tag is the iteration's;
//   CB_ASYNC        the same words by st.async, each completing 4 bytes on
//                   the receiving block's mbarrier, which expects 128 bytes
//                   a phase (thread 0's arrival); every thread waits on its
//                   own block's mbarrier: pb_pop's exchange.
// Each iteration's value feeds the next, so nothing is hoisted.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

enum {
  CB_SYNCTHREADS, CB_BARRIER, CB_RELAXED, CB_EXCHANGE, CB_MBAR, CB_FLAGS, CB_ASYNC, CB_COUNT
};

__device__ __forceinline__ unsigned cb_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of `p` in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ unsigned cb_mapa(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(cb_saddr(p)), "r"(rank));
  return r;
}

template <int MODE>
__global__ void __launch_bounds__(1024) cb_kernel(int iters, unsigned* out) {
  __shared__ unsigned words[2][32];
  __shared__ unsigned long long mbar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned rank = cluster.block_rank(), size = cluster.num_blocks();
  const unsigned slot = rank * (blockDim.x >> 5) + warp;  // this warp's word
  unsigned v = threadIdx.x ^ (rank << 10);
  if (threadIdx.x < 64) words[threadIdx.x >> 5][lane] = ~0u;  // no iteration's tag
  if (threadIdx.x < 2) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(cb_saddr(&mbar[threadIdx.x])),
                 "r"(MODE == CB_ASYNC ? 1 : 32)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block has started and initialised before a remote store
  for (int i = 0; i < iters; ++i) {
    if (MODE == CB_SYNCTHREADS) {
      __syncthreads();
      v = v * 3u + 1u;
    } else if (MODE == CB_BARRIER || MODE == CB_RELAXED) {
      if (MODE == CB_BARRIER)
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      else
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      v = v * 3u + 1u;
    } else {
      const unsigned par = i & 1;
      const unsigned w = __reduce_or_sync(0xffffffffu, 1u << (v & 7u));
      unsigned got;
      if (MODE == CB_EXCHANGE) {
        if (lane < size) *cluster.map_shared_rank(&words[par][slot], lane) = w;
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
        got = words[par][lane];
      } else if (MODE == CB_MBAR) {
        if (lane < size) {
          asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(cb_mapa(&words[par][slot], lane)),
                       "r"(w)
                       : "memory");
          asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                           cb_mapa(&mbar[par], lane))
                       : "memory");
        }
        unsigned done = 0;
        do {
          asm volatile(
              "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
              "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done)
              : "r"(cb_saddr(&mbar[par])), "r"((unsigned)(i >> 1) & 1u)
              : "memory");
        } while (!done);
        got = words[par][lane];
      } else if (MODE == CB_ASYNC) {
        if (threadIdx.x == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 128;\n" ::"r"(
                           cb_saddr(&mbar[par]))
                       : "memory");
        if (lane < size)
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                  cb_mapa(&words[par][slot], lane)),
              "r"(w), "r"(cb_mapa(&mbar[par], lane))
              : "memory");
        unsigned done = 0;
        do {
          asm volatile(
              "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
              " selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done)
              : "r"(cb_saddr(&mbar[par])), "r"((unsigned)(i >> 1) & 1u)
              : "memory");
        } while (!done);
        got = words[par][lane];
      } else {
        const unsigned tag = ((unsigned)i & 0xffffffu) << 8;
        if (lane < size)
          asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;\n" ::"r"(
                           cb_mapa(&words[par][slot], lane)),
                       "r"(tag | w)
                       : "memory");
        do {
          asm volatile("ld.relaxed.cluster.shared::cta.u32 %0, [%1];\n"
                       : "=r"(got)
                       : "r"(cb_saddr(&words[par][lane]))
                       : "memory");
        } while (!__all_sync(0xffffffffu, (got & ~0xffu) == tag));
        got &= 0xffu;
      }
      v = v * 3u + __reduce_or_sync(0xffffffffu, got);
    }
  }
  cluster.sync();  // no block leaves while another may still store into it
  out[blockIdx.x * blockDim.x + threadIdx.x] = v;
}

template <int MODE>
static int cb_launch(int cluster, int iters, unsigned* out, cudaStream_t s) {
  if (cluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        cb_kernel<MODE>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(1024 / cluster, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, cb_kernel<MODE>, iters, out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// One launch: `cluster` in {1, 2, 4, 8, 16} blocks of 1024 / cluster
// threads; out (1024,) u32. Returns the cudaError_t (0 on success).
extern "C" int cb_run(int mode, int cluster, int iters, unsigned* out, void* stream) {
  if (cluster < 1 || cluster > 16 || 1024 % cluster || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case CB_SYNCTHREADS: return cb_launch<CB_SYNCTHREADS>(cluster, iters, out, s);
    case CB_BARRIER: return cb_launch<CB_BARRIER>(cluster, iters, out, s);
    case CB_RELAXED: return cb_launch<CB_RELAXED>(cluster, iters, out, s);
    case CB_EXCHANGE: return cb_launch<CB_EXCHANGE>(cluster, iters, out, s);
    case CB_MBAR: return cb_launch<CB_MBAR>(cluster, iters, out, s);
    case CB_FLAGS: return cb_launch<CB_FLAGS>(cluster, iters, out, s);
    case CB_ASYNC: return cb_launch<CB_ASYNC>(cluster, iters, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
