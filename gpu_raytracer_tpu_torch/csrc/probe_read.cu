// Scalar-read and shared-memory-ceiling probes for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probes of the JAX package that chose the node-table layout
// and measured the fast-memory ceiling (tools, not render paths):
//   tools/exp_scalar_read.py  A (:38), B (:60), C (:80), D (:105), E (`makeE`
//                             :132, never called; `kernelE` :150, the same
//                             body): 20 dynamic single-element reads a pop
//   tools/exp_vmem2.py        `kernel_roll` (:41): a dynamic roll + extract;
//                             `vmem_probe.kernel` (:14): the VMEM ceiling
//   tools/exp_blocksync.py    `vmem_probe.kernel` (:25): the same
// probes/read.py holds the plain versions and what each body sums.
//
// pr_read<BODY, SHARED>: one 1024-thread block computes the probe's scalar
// (pop i reads at node (i * 1237) % n, so no read depends on another; only
// the f32 sum is a chain) and every thread writes it to its element of the
// (8, 128) output. Pops are taken PR_CHUNK at a time:
//   1. gather: the round's K values a pop (K = 20, or 16 for C and the
//      roll) are read by all 1024 threads at once, 4-5 independent loads a
//      thread, into shared memory as vals[pop][k] (rows of K + 1 floats: no
//      bank conflict); D decodes its bytes here. The row-major bodies (B,
//      C, roll) go pop-major, so a warp reads one or two pops' K floats,
//      one 128-byte line each, each pop's node staged in shared memory; the
//      component-major ones (A, D, E) go read-major, the node of a thread's
//      pop in a register (a pop's K values lie in K lines either way);
//   2. per-pop sums: thread p adds pop p's K values in the probe's order
//      from 0.0f (s = s + v_0, ..., s = s + v_{K-1});
//   3. the chain: thread 0 adds the round's sums to acc in pop order, acc
//      carried from round to round;
//   4. broadcast: acc through shared memory to the 1024 outputs.
// That is the probe's own f32 order, so the result is bit-equal to the
// plain version by construction, for any pops (0, ragged, more than a
// block has threads). A pop's node, (i * 1237) % n, is carried from round
// to round modulo n (one add), not divided anew. LDG reads the table in
// place through the read-only path (__ldg: L1, then L2); SHARED first
// stages the whole table into dynamic shared memory with float4 copies
// (where it fits one block beside the 19-24 KB of static staging: the
// roll's 32 KB; the probes' other tables do not). A per-lane variant (each
// lane its own node) would compute what the TPU probe does not; it is left
// out.
//
// pr_ceiling: stores x[0, :] into dynamic shared memory of the asked size and
// fills (8, 128) with its element 0, after cudaFuncSetAttribute(...,
// MaxDynamicSharedMemorySize, bytes). The kernel has no static shared memory,
// so the largest size that launches is the opt-in limit itself; a larger one
// is refused (cudaErrorInvalidValue), which probes/read.smem_ceiling counts as
// that rung's outcome.
//
// What bounds it: the launch and one SM. The bytes (at most 80 a pop) and
// the operations over the card's rates are nanoseconds. An empty launch of
// this block takes ~2.3 us (the ceiling body), the chain of 256 dependent
// adds ~0.6; B, C and the roll read 256-512 lines and take 4.1-4.7 us. A, D
// and E read 5,120 values, every one in a line of its own: one SM's L1
// takes about one line a cycle (~2.8 us at 1.8 GHz), so they take ~6.1 us, where
// `index_select` spreads the same 5,120 reads over 40 blocks (5.9 us). The
// first design ran the whole pop loop on every thread, 20 loads and 20
// dependent adds a pop one pop after another: 0.07-0.42 ms (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_report.cuh"

#define PR_THREADS 1024
#define PR_ROW 128
#define PR_STRIDE 1237
#define PR_READS 20
#define PR_EXTRACT 16
#define PR_CHUNK 256  // pops a round: gather, per-pop sums, chain

enum { B_A, B_B, B_C, B_D, B_E, B_ROLL, B_CEILING, B_COUNT };
enum { SP_LDG, SP_SHARED, SP_COUNT };

// How many nodes pop i's index runs over (node = (i * STRIDE) % n; the roll:
// row i % rows), and the stride.
template <int BODY>
__device__ __forceinline__ int pr_nodes(int rows, int cols) {
  return BODY == B_B || BODY == B_ROLL ? rows : BODY == B_C ? 8 * rows : cols;
}

// Value k of the pop at `node` (its slot p in a round: the roll's shift), as
// the probe reads and (D) decodes it: table f32 (int32 for D), row-major
// (rows, cols), in place (__ldg) or staged.
template <int BODY, bool SHARED>
__device__ __forceinline__ float pr_value(const float* tf, const int* ti, int cols, int node,
                                          int k, int p) {
  int at;
  if (BODY == B_A || BODY == B_E || BODY == B_D) {
    at = k * cols + node;
  } else if (BODY == B_B) {
    at = node * cols + k;
  } else if (BODY == B_C) {
    at = (node / 8) * cols + (node % 8) * PR_EXTRACT + k;
  } else {  // B_ROLL: row i % rows rotated left by (i % 8) * 16; its first 16
    at = node * cols + (k + (p % 8) * PR_EXTRACT) % PR_ROW;
  }
  if (BODY == B_D) {
    const int w = SHARED ? ti[at] : __ldg(ti + at);
    return (float)((w & 0xFF) + ((w >> 8) & 0xFF) + ((w >> 16) & 0xFF) + ((w >> 24) & 0xFF));
  }
  return SHARED ? tf[at] : __ldg(tf + at);
}

template <int BODY, bool SHARED>
__global__ void __launch_bounds__(PR_THREADS)
pr_read_kernel(const void* __restrict__ table, int rows, int cols, int pops,
               float* __restrict__ out) {
  constexpr int K = (BODY == B_C || BODY == B_ROLL) ? PR_EXTRACT : PR_READS;
  constexpr int PER = K * PR_CHUNK / PR_THREADS;  // loads a thread a round
  constexpr int ROW = K + 1;                       // vals row of a pop (odd: no bank conflict)
  constexpr int STRIDE = BODY == B_ROLL ? 1 : PR_STRIDE;
  constexpr int KSTEP = PR_THREADS / PR_CHUNK;  // read-major: between a thread's reads
  constexpr bool POP_MAJOR = BODY == B_B || BODY == B_C || BODY == B_ROLL;  // row-major tables
  static_assert(K * PR_CHUNK % PR_THREADS == 0, "a round's reads split evenly");
  extern __shared__ float4 pr_smem4[];
  __shared__ float vals[PR_CHUNK * ROW];  // value k of pop p at p * ROW + k
  __shared__ float sums[PR_CHUNK];
  __shared__ int nodes[PR_CHUNK];
  __shared__ float total;
  const float* tf = reinterpret_cast<const float*>(table);
  const int* ti = reinterpret_cast<const int*>(table);
  if (SHARED) {
    const float4* src = reinterpret_cast<const float4*>(table);
    const int n4 = rows * cols / 4;
    for (int k = threadIdx.x; k < n4; k += PR_THREADS) pr_smem4[k] = __ldg(src + k);
    __syncthreads();
    tf = reinterpret_cast<const float*>(pr_smem4);
    ti = reinterpret_cast<const int*>(pr_smem4);
  }
  // Thread t carries the node of the pop in slot t % CHUNK, (i * STRIDE) % n
  // for pop i = p0 + t % CHUNK, modulo n from round to round.
  const unsigned n = (unsigned)pr_nodes<BODY>(rows, cols);
  const unsigned step = (unsigned)((unsigned long long)PR_CHUNK * STRIDE % n);
  unsigned node = (unsigned)((unsigned long long)(threadIdx.x % PR_CHUNK) * STRIDE % n);
  float acc = 0.0f;  // thread 0's
  for (long long p0 = 0; p0 < pops; p0 += PR_CHUNK) {
    const int m = (int)min((long long)PR_CHUNK, pops - p0);
    if (POP_MAJOR) {
      if (threadIdx.x < PR_CHUNK) nodes[threadIdx.x] = (int)node;
      __syncthreads();
    }
    // The gather, element j of thread t: pop-major (B, C, roll: value
    // e % K of the pop in slot e / K, e = t + THREADS j, so a warp reads one
    // or two pops' K floats, which lie in one 128-byte line), or read-major
    // (A, D, E: value t / CHUNK + KSTEP j of the pop in slot t % CHUNK, whose
    // node stays in a register; a pop's values lie in K lines either way).
    float v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {  // every load issued before any store
      const int e = threadIdx.x + j * PR_THREADS;
      const int p = POP_MAJOR ? e / K : threadIdx.x % PR_CHUNK;
      const int k = POP_MAJOR ? e % K : (int)threadIdx.x / PR_CHUNK + KSTEP * j;
      v[j] = p < m ? pr_value<BODY, SHARED>(tf, ti, cols, POP_MAJOR ? nodes[p] : (int)node, k, p)
                   : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = threadIdx.x + j * PR_THREADS;
      vals[POP_MAJOR ? e / K * ROW + e % K
                     : threadIdx.x % PR_CHUNK * ROW + threadIdx.x / PR_CHUNK + KSTEP * j] = v[j];
    }
    __syncthreads();
    if ((int)threadIdx.x < m) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) s = s + vals[threadIdx.x * ROW + k];
      sums[threadIdx.x] = s;
    }
    __syncthreads();
    // The next round's sums and nodes are written only after its barriers,
    // which thread 0 reaches once this chain is done.
    if (threadIdx.x == 0) {
#pragma unroll 32
      for (int q = 0; q < m; ++q) acc = acc + sums[q];  // loads ahead of the adds
    }
    node = node + step >= n ? node + step - n : node + step;  // node, step < n < 2^31
  }
  if (threadIdx.x == 0) total = acc;
  __syncthreads();
  out[threadIdx.x] = total;
}

__global__ void __launch_bounds__(PR_THREADS)
pr_ceiling_kernel(const float* __restrict__ x, float* __restrict__ out) {
  extern __shared__ float pr_scratch[];
  if (threadIdx.x < PR_ROW) pr_scratch[threadIdx.x] = x[threadIdx.x];
  __syncthreads();
  out[threadIdx.x] = pr_scratch[0];
}

template <int BODY, bool SHARED>
static int pr_launch(const void* table, int rows, int cols, int pops, float* out,
                     cudaStream_t s) {
  int bytes = 0;
  if (SHARED) {
    bytes = rows * cols * 4;
    const cudaError_t err = cudaFuncSetAttribute(
        pr_read_kernel<BODY, SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  pr_read_kernel<BODY, SHARED><<<1, PR_THREADS, bytes, s>>>(table, rows, cols, pops, out);
  return (int)cudaGetLastError();
}

// The opt-in shared memory limit of a block on the current device
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or -1.
extern "C" int pr_smem_optin(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return v;
}

// table (rows, cols) 16-byte aligned, rows * cols a multiple of 4; out (1024,)
// f32. `ceiling` takes x (8, 128) as the table and launches with smem_bytes of
// dynamic shared memory. Returns the cudaError_t of the attribute call or the
// launch (0 on success).
extern "C" int pr_read(int body, int space, const void* table, int rows, int cols, int pops,
                       int smem_bytes, float* out, void* stream) {
  if (rows <= 0 || cols <= 0 || pops < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (body == B_CEILING) {
    if (cols != PR_ROW || smem_bytes < 4 * PR_ROW) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        pr_ceiling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    pr_ceiling_kernel<<<1, PR_THREADS, smem_bytes, s>>>((const float*)table, out);
    const cudaError_t launch = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : launch);
  }
  if ((body == B_B || body == B_C || body == B_ROLL) && cols != PR_ROW)
    return (int)cudaErrorInvalidValue;
#define PR_CASE(B)                                                              \
  case B:                                                                       \
    return space == SP_SHARED ? pr_launch<B, true>(table, rows, cols, pops, out, s) \
                              : pr_launch<B, false>(table, rows, cols, pops, out, s);
  switch (body) {
    PR_CASE(B_A)
    PR_CASE(B_B)
    PR_CASE(B_C)
    PR_CASE(B_D)
    PR_CASE(B_E)
    PR_CASE(B_ROLL)
    default:
      break;
  }
#undef PR_CASE
  return (int)cudaErrorInvalidValue;
}

// The compiler's and the occupancy API's report of pr_read<body, space>
// (kernel_report.cuh); the ceiling body has its own kernel. Returns a
// cudaError_t.
extern "C" int pr_kernel_info(int body, int space, int* out) {
  const void* k = nullptr;
#define PR_INFO(B)                                                                   \
  case B:                                                                            \
    k = space == SP_SHARED ? (const void*)pr_read_kernel<B, true>                    \
                           : (const void*)pr_read_kernel<B, false>;                  \
    break;
  switch (body) {
    PR_INFO(B_A)
    PR_INFO(B_B)
    PR_INFO(B_C)
    PR_INFO(B_D)
    PR_INFO(B_E)
    PR_INFO(B_ROLL)
    case B_CEILING:
      k = (const void*)pr_ceiling_kernel;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PR_INFO
  return kernel_report(k, PR_THREADS, out);
}

// Layout constants, checked by ops/_native.load against probes/read.py.
extern "C" int pr_layout(int which) {
  switch (which) {
    case 0: return PR_THREADS;
    case 1: return B_COUNT;
    case 2: return SP_COUNT;
    case 3: return PR_STRIDE;
    case 4: return PR_CHUNK;
    default: return -1;
  }
}
