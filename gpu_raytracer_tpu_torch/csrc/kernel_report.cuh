// What the compiler and the occupancy API report for a kernel launched with
// `threads` threads a block and no dynamic shared memory, for each kernel's
// `*_kernel_info` entry point: out = {registers a thread, local (stack
// frame) bytes a thread, static shared bytes a block, threads a block,
// blocks an SM, SMs}. Returns a cudaError_t.
#ifndef KERNEL_REPORT_CUH
#define KERNEL_REPORT_CUH

#include <cuda_runtime.h>

static inline int kernel_report(const void* kernel, int threads, int* out) {
  cudaFuncAttributes a;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = threads;
  out[4] = per_sm;
  out[5] = sms;
  return 0;
}

#endif  // KERNEL_REPORT_CUH
