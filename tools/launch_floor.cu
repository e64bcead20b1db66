// The launch floor on Hopper (sm_90a): an empty kernel, launched in the
// shapes of the probes that do about one launch's work (pr_read<ceiling>,
// pd_copy's one-copy bodies), so that their times can be set against the
// least a launch costs. A microbenchmark built and run by
// tools/torch_launch_floor.py; not part of the port's kernel library.

#include <cuda_runtime.h>

__global__ void lf_empty() {}

// Lets lf_empty take `smem` bytes of dynamic shared memory. Returns the
// cudaError_t.
extern "C" int lf_prepare(int smem) {
  return (int)cudaFuncSetAttribute(lf_empty, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// One launch of `blocks` blocks of `threads` threads with `smem` bytes of
// dynamic shared memory, in clusters of `cluster` blocks (1: no cluster).
// Returns the cudaError_t.
extern "C" int lf_launch(int blocks, int threads, int smem, int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, lf_empty);
}
