// What the compiler and the occupancy API report for a kernel launched with
// `threads` threads a block and `dynamic_bytes` of dynamic shared memory
// (none unless given; the kernel's attribute must allow it), for each kernel's
// `*_kernel_info` entry point: out = {registers a thread, local (stack
// frame) bytes a thread, static shared bytes a block, threads a block,
// blocks an SM, SMs}. Returns a cudaError_t.
#ifndef KERNEL_REPORT_CUH
#define KERNEL_REPORT_CUH

#include <cuda_runtime.h>

static inline int kernel_report(const void* kernel, int threads, int* out,
                                size_t dynamic_bytes = 0) {
  cudaFuncAttributes a;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                        dynamic_bytes);
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
