// Gang-primitive probes for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probes of the JAX package that priced the 8-gang
// traversal's primitives (tools, not render paths):
//   tools/exp_gang_prims.py   k_single (:64), k_stack (:82), k_scratch (:100),
//                             k_full (:121), k_smem (:146), k_cond (:177),
//                             k_maskupd (:201), all through `run` (call :53)
//   tools/exp_gang_prims2.py  k_v1 (:52), k_v2 (:62), k_v3 (:72), k_v4 (:85),
//                             through `run` (call :43)
// probes/prims.py holds the plain versions and what each body computes.
//
// pp_gang_kernel<BODY> (single, stack, scratch, cond, maskupd, v3, v4): one
// 1024-thread block is the (8, 128) tile; gang g is threads 128g .. 128g + 127
// (4 warps), lane l = thread % 128 owns out[g, l]. Each gang keeps its own
// chased row index (every lane of the gang holds the same value, so no
// exchange is needed); a row load is each lane's own column (four coalesced
// 128-byte lines a gang) with row[5], the next index, read by every lane as a
// warp-uniform broadcast. `cond` is a gang-uniform branch between the two
// tables. These bodies are chains of dependent row loads, one block on one
// SM: on the probe's own table every chase reads row 0 from its second
// iteration on (an L1 hit); on a chase table whose column 5 is a random cycle
// over the 2 MB table each iteration waits on an L2 hit. They sit at the
// card's load prices (PERF.md), and their design is the first one.
//
// The other four bodies have kernels of their own, since none of them is a
// chase of the tile (C46):
//   v1, v2  pp_sum_kernel: row (i * 1237) % n depends on no loaded value, so
//           the block gathers PP_CHUNK iterations' values at once into a
//           shared-memory ring of two chunks, a thread an iteration, while
//           thread 0 adds the previous chunk's values to acc in iteration
//           order (one barrier a chunk); acc is broadcast at the end. What
//           bounds it: the chain of 400,000 (v1: 800,000) dependent f32 adds,
//           the probe's own order, which no tree sum keeps bit for bit.
//   smem    pp_smem_kernel: the 8 stacks are pushed above the slot just
//           popped (or into the scrap slot once full), so each gang's stack
//           is its top in a register: a pop reads it, a push replaces it with
//           (v + i) & (n - 1). The pops never depend on a loaded value, so
//           there is no stack in shared memory and no barrier. Once a push
//           finds the stack full the state is a fixed point (from i = 62
//           with sp starting at 1) and every later iteration adds the same
//           row, loaded once. The 8 gangs add the same row (at the sum of
//           their pops), so the block sums PP_SMEM_ROWS gang rows of 128
//           columns and stores each to 8 / PP_SMEM_ROWS rows of out. What
//           bounds it: each column's chain of dependent adds.
//   full    pp_full_kernel: a warp a gang (pg_ablate's layout, C44), lanes
//           lane + 32 j (j < 4) a thread, PP_FULL_WARPS gangs a block. The
//           row minimum is the thread's minimum over its 4 lanes, then one
//           __reduce_min_sync of ordered int keys (no shared memory, no named
//           barrier). The chase never reads acc, so the next row's 9 values
//           are loaded before this iteration's acc arithmetic. What bounds
//           it: the chase (a row load an iteration) where the arithmetic
//           hides under it.
//
// Float semantics follow the plain version, built with -fmad=false (k_full
// and k_maskupd are a*b+c, left unfused): the f32 order of each sum is the
// probe's; float -> int truncates and saturates ((int), as gang.trunc_i32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_report.cuh"

#define PP_GANGS 8
#define PP_LANES 128
#define PP_BLOCK (PP_GANGS * PP_LANES)
#define PP_STACK 64
#define PP_STRIDE 1237
#define PP_FULL_MASK 0xffffffffu
#define PP_CHUNK 1024  // v1, v2: iterations a round, one a thread

// Gang rows pp_smem_kernel sums (1: the 128 columns once, stored to all 8
// rows; 8: each gang its own), and gangs (warps) a block of pp_full_kernel.
constexpr int PP_SMEM_ROWS = 1;
constexpr int PP_FULL_WARPS = 1;
static_assert(PP_GANGS % PP_SMEM_ROWS == 0 && PP_GANGS % PP_FULL_WARPS == 0, "whole gangs");

enum { P_SINGLE, P_STACK, P_SCRATCH, P_FULL, P_SMEM, P_COND, P_MASKUPD, P_V1, P_V2, P_V3, P_V4,
       P_COUNT };

__device__ __forceinline__ int pp_next(const float* row, int mask) {
  return ((int)__ldg(row + 5)) & mask;
}

template <int BODY>
__global__ void __launch_bounds__(PP_BLOCK)
pp_gang_kernel(const float* __restrict__ tab, const float* __restrict__ tab2,
               const int* __restrict__ seed, int n, int iters, float* __restrict__ out) {
  const int tid = threadIdx.x, g = tid >> 7, l = tid & 127;
  const int mask = n - 1;
  float acc;

  if (BODY == P_SINGLE || BODY == P_V3 || BODY == P_V4) {
    acc = 0.0f;
    int v = seed[0];
    for (int i = 0; i < iters; ++i) {
      const float* row = tab + (size_t)v * PP_LANES;
      acc = acc + __ldg(row + (BODY == P_V4 ? l : 0));
      if (BODY == P_SINGLE) acc = acc + __ldg(row + 64);
      v = pp_next(row, mask);
    }
  } else {  // a chase a gang: stack, scratch, cond, maskupd
    acc = BODY == P_MASKUPD ? 1.0f : 0.0f;
    int v = seed[g * PP_LANES];
    for (int i = 0; i < iters; ++i) {
      const float* row = (BODY == P_COND && !(v & 1) ? tab2 : tab) + (size_t)v * PP_LANES;
      if (BODY == P_MASKUPD) {
        acc = acc * __ldg(row) + __ldg(row + 1);
      } else {
        acc = acc + __ldg(row + l);
      }
      v = pp_next(row, mask);
    }
  }
  out[tid] = acc;
}

// acc + the 16 values in order.
__device__ __forceinline__ float pp_add16(float acc, float4 a, float4 b, float4 c, float4 d) {
  acc = acc + a.x; acc = acc + a.y; acc = acc + a.z; acc = acc + a.w;
  acc = acc + b.x; acc = acc + b.y; acc = acc + b.z; acc = acc + b.w;
  acc = acc + c.x; acc = acc + c.y; acc = acc + c.z; acc = acc + c.w;
  return acc + d.x + d.y + d.z + d.w;
}

// v1, v2. Step r gathers chunk r (iteration r * CHUNK + t on thread t, its
// row carried modulo n from step to step) into vals[r & 1] while thread 0
// adds chunk r - 1 from vals[(r - 1) & 1]; the barrier that ends step r
// publishes chunk r and frees chunk r - 1's buffer for step r + 1.
template <int BODY>
__global__ void __launch_bounds__(PP_BLOCK)
pp_sum_kernel(const float* __restrict__ tab, int n, int iters, float* __restrict__ out) {
  constexpr int K = BODY == P_V1 ? 2 : 1;  // values an iteration: row[0] (, row[64])
  constexpr int N = PP_CHUNK * K;         // values a full chunk
  static_assert(N % 32 == 0, "whole pairs of 16-value groups");
  __shared__ __align__(16) float vals[2][N + 16];  // 16 floats of slack: the last read ahead
  __shared__ float total;
  const int tid = threadIdx.x;
  const unsigned un = (unsigned)n;
  const unsigned step = (unsigned)((unsigned long long)PP_CHUNK * PP_STRIDE % un);
  unsigned node = (unsigned)((unsigned long long)tid * PP_STRIDE % un);
  const int rounds = (iters + PP_CHUNK - 1) / PP_CHUNK;
  float acc = 0.0f;  // thread 0's
  for (int r = 0; r <= rounds; ++r) {
    const bool have = r < rounds && r * PP_CHUNK + tid < iters;
    float x0 = 0.0f, x1 = 0.0f;
    if (have) {  // issued before thread 0's chain, stored after it
      const float* row = tab + (size_t)node * PP_LANES;
      x0 = __ldg(row);
      if (K == 2) x1 = __ldg(row + 64);
    }
    if (tid == 0 && r > 0) {
      const float* v = vals[(r - 1) & 1];
      const int m = min(PP_CHUNK, iters - (r - 1) * PP_CHUNK) * K;
      if (m == N) {  // a full chunk: 16 values added while the next 16 load
        const float4* v4 = reinterpret_cast<const float4*>(v);
        float4 a0 = v4[0], a1 = v4[1], a2 = v4[2], a3 = v4[3];
#pragma unroll 1
        for (int q = 4; q < N / 4; q += 8) {
          const float4 b0 = v4[q], b1 = v4[q + 1], b2 = v4[q + 2], b3 = v4[q + 3];
          acc = pp_add16(acc, a0, a1, a2, a3);
          a0 = v4[q + 4], a1 = v4[q + 5], a2 = v4[q + 6], a3 = v4[q + 7];
          acc = pp_add16(acc, b0, b1, b2, b3);
        }
      } else {
        for (int q = 0; q < m; ++q) acc = acc + v[q];
      }
    }
    if (have) {
      vals[r & 1][tid * K] = x0;
      if (K == 2) vals[r & 1][tid * K + 1] = x1;
    }
    node = node + step >= un ? node + step - un : node + step;  // node, step < n < 2^31
    __syncthreads();
  }
  if (tid == 0) total = acc;
  __syncthreads();
  out[tid] = total;
}

// smem: thread t sums column t % 128 for gang row t / 128; the pops are
// unsigned (only their low bits, & (n - 1), are ever used).
__global__ void __launch_bounds__(PP_SMEM_ROWS * PP_LANES)
pp_smem_kernel(const float* __restrict__ tab, const int* __restrict__ seed, int n, int iters,
               float* __restrict__ out) {
  const int tid = threadIdx.x, l = tid & 127;
  const unsigned mask = (unsigned)n - 1u;
  const float* col = tab + l;
  unsigned top[PP_GANGS];  // slot sp - 1 of each stack: what its next pop reads
#pragma unroll
  for (int g = 0; g < PP_GANGS; ++g) top[g] = (unsigned)seed[g * PP_LANES];
  int sp = 1, i = 0;
  float acc = 0.0f;
  unsigned vsum = 0;
  for (; i < iters; ++i) {
    const int spm = sp > 0 ? sp - 1 : 0;
    const bool ok = sp > 0 && spm + 1 < PP_STACK - 1;  // else the push goes to slot 63
    vsum = 0;
#pragma unroll
    for (int g = 0; g < PP_GANGS; ++g) vsum += top[g];
    acc = acc + __ldg(col + (size_t)(vsum & mask) * PP_LANES);
    if (ok) {
#pragma unroll
      for (int g = 0; g < PP_GANGS; ++g) top[g] = (top[g] + (unsigned)i) & mask;
    }
    const int nsp = spm + 1 + (ok ? 1 : 0);
    if (!ok && nsp == sp) {  // nothing moves again: every later pop is this one
      ++i;
      break;
    }
    sp = nsp;
  }
  if (i < iters) {
    const float x = __ldg(col + (size_t)(vsum & mask) * PP_LANES);
    for (; i < iters; ++i) acc = acc + x;
  }
  for (int g = tid >> 7; g < PP_GANGS; g += PP_SMEM_ROWS) out[g * PP_LANES + l] = acc;
}

// An int key whose signed order is the order of the floats that are not NaN
// (-0.0 as +0.0 after the + 0.0f), and its inverse; the caller keys a NaN
// as INT32_MIN, the least key, whose inverse is a NaN.
__device__ __forceinline__ int pp_key(float x) {
  const int b = __float_as_int(x + 0.0f);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float pp_unkey(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// full: warp w of block b is gang b * PP_FULL_WARPS + w; r[c] = row[6c] (c <
// 8) and r[8] = row[5], warp-uniform broadcasts.
__global__ void __launch_bounds__(PP_FULL_WARPS * 32)
pp_full_kernel(const float* __restrict__ tab, const int* __restrict__ seed, int n, int iters,
               float* __restrict__ out) {
  const int lane = threadIdx.x & 31, g = blockIdx.x * PP_FULL_WARPS + (threadIdx.x >> 5);
  const int mask = n - 1;
  float acc[4] = {0.5f, 0.5f, 0.5f, 0.5f};
  if (iters > 0) {
    float r[9];
    const float* row = tab + (size_t)seed[g * PP_LANES] * PP_LANES;
#pragma unroll
    for (int c = 0; c < 8; ++c) r[c] = __ldg(row + 6 * c);
    r[8] = __ldg(row + 5);
    for (int i = 0; i < iters; ++i) {
      // The next row first: the chase reads only the row.
      const float* nrow = tab + (size_t)(((int)r[8]) & mask) * PP_LANES;
      float nr[9];
#pragma unroll
      for (int c = 0; c < 8; ++c) nr[c] = __ldg(nrow + 6 * c);
      nr[8] = __ldg(nrow + 5);
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) s[j] = s[j] + r[c] * acc[j];
      }
      // The thread's minimum (a NaN among its lanes wins, as in torch.amin),
      // then the gang's.
      const bool nan = isnan(s[0]) || isnan(s[1]) || isnan(s[2]) || isnan(s[3]);
      const int k = nan ? INT32_MIN : pp_key(fminf(fminf(s[0], s[1]), fminf(s[2], s[3])));
      const float m = pp_unkey(__reduce_min_sync(PP_FULL_MASK, k));
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = (s[j] + m) * 1e-9f + acc[j];
#pragma unroll
      for (int c = 0; c < 9; ++c) r[c] = nr[c];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[g * PP_LANES + lane + 32 * j] = acc[j];
}

// tab, tab2 (n, 128) f32 with n a power of two; seed (8, 128) int32; out
// (1024,) f32. Returns the cudaError_t of the launch.
extern "C" int pp_gang(int body, const float* tab, const float* tab2, const int* seed, int n,
                       int iters, float* out, void* stream) {
  if (n <= 0 || (n & (n - 1)) || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PP_CASE(B)                                                              \
  case B:                                                                       \
    pp_gang_kernel<B><<<1, PP_BLOCK, 0, s>>>(tab, tab2, seed, n, iters, out); \
    break;
  switch (body) {
    PP_CASE(P_SINGLE)
    PP_CASE(P_STACK)
    PP_CASE(P_SCRATCH)
    PP_CASE(P_COND)
    PP_CASE(P_MASKUPD)
    PP_CASE(P_V3)
    PP_CASE(P_V4)
    case P_V1:
      pp_sum_kernel<P_V1><<<1, PP_BLOCK, 0, s>>>(tab, n, iters, out);
      break;
    case P_V2:
      pp_sum_kernel<P_V2><<<1, PP_BLOCK, 0, s>>>(tab, n, iters, out);
      break;
    case P_SMEM:
      pp_smem_kernel<<<1, PP_SMEM_ROWS * PP_LANES, 0, s>>>(tab, seed, n, iters, out);
      break;
    case P_FULL:
      pp_full_kernel<<<PP_GANGS / PP_FULL_WARPS, PP_FULL_WARPS * 32, 0, s>>>(tab, seed, n, iters,
                                                                             out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PP_CASE
  return (int)cudaGetLastError();
}

// The compiler's and the occupancy API's report of a body's kernel at its
// block size (kernel_report.cuh). Returns a cudaError_t.
extern "C" int pp_kernel_info(int body, int* out) {
  switch (body) {
    case P_V1: return kernel_report((const void*)pp_sum_kernel<P_V1>, PP_BLOCK, out);
    case P_V2: return kernel_report((const void*)pp_sum_kernel<P_V2>, PP_BLOCK, out);
    case P_SMEM: return kernel_report((const void*)pp_smem_kernel, PP_SMEM_ROWS * PP_LANES, out);
    case P_FULL: return kernel_report((const void*)pp_full_kernel, PP_FULL_WARPS * 32, out);
    case P_STACK: return kernel_report((const void*)pp_gang_kernel<P_STACK>, PP_BLOCK, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Layout constants, checked by ops/_native.load against probes/prims.py.
extern "C" int pp_layout(int which) {
  switch (which) {
    case 0: return PP_GANGS;
    case 1: return PP_LANES;
    case 2: return PP_STACK;
    case 3: return P_COUNT;
    case 4: return PP_STRIDE;
    case 5: return PP_CHUNK;
    default: return -1;
  }
}
