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
// pp_path_kernel<BODY> (single, stack, scratch, cond, maskupd, v3, v4): every
// body chases rows through next = int(row[5]) & (n - 1), a map of the n rows
// onto themselves, so a chase enters a cycle within n steps: after a tail of
// mu steps it repeats a cycle of lam rows, mu + lam <= n (on the probes' own
// table mu <= 1, lam = 1; on a chase table mu = 0, lam = n). A block
//   1. reads column 5 of every row in parallel into the next-row map in
//      shared memory (`cond`: row v's from `table` where v is odd, else from
//      `table2`), and a stamp for each row;
//   2. walks the chase once from its seed through the map on one thread,
//      PP_WALK steps at a time (a chain of dependent shared-memory reads and
//      nothing else), while its warp stamps each row with the step that
//      first reached it between two batches, until a row reached again
//      (mu its stamp, lam the step less it) or `iters` steps: at most n +
//      PP_WALK steps;
//   3. stages the values each iteration adds for the path's rows, in path
//      order, over the map: the cycle repeated to a run of at least PP_RUN
//      iterations, so the chain below reads it as long contiguous runs;
//   4. runs each output element's chain in the plain version's f32 order on
//      one thread, reading the staged values PP_UNROLL iterations ahead
//      (their addresses never depend on acc): the head of the path once,
//      then the cycle run after run, the position a counter.
// A chain's values: single row[0], row[64] (one chain, broadcast to the
// tile); v3 row[0] (the same); maskupd row[0], row[1] (a chain a gang,
// acc * a + b unfused); stack, scratch, cond row[l] for each column l of a
// gang, and v4 for each column of the one chase (broadcast over the gangs).
// The column bodies spread over blocks: a block takes one gang and
// pp_cols(n) columns (8 at n <= 4,096, 128 blocks for stack), its chains on
// lanes 0 .. pp_cols(n) - 1 of warp 0 (a column each, staged column-major
// with a stride that keeps the lanes and the staging writes on distinct
// banks). Every block walks its own gang's chase (no second launch). What
// bounds it: each chain's dependent f32 adds, the probe's order, plus the
// walk. The staged path needs n + PP_RUN values a chain, so n is capped at
// PP_PATH_MAX_ROWS (the launcher refuses more; ROADMAP C47).
//
// The other four bodies have kernels of their own (C46):
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
#define PP_PATH_THREADS 512       // a path body's block
#define PP_RUN 512                // least run of the staged cycle, iterations
#define PP_UNROLL 16              // staged values a chain loads ahead
#define PP_WALK 128               // steps of the walk between two checks
#define PP_PATH_MAX_ROWS 16384    // the most rows a path body takes

// Gang rows pp_smem_kernel sums (1: the 128 columns once, stored to all 8
// rows; 8: each gang its own), and gangs (warps) a block of pp_full_kernel.
constexpr int PP_SMEM_ROWS = 1;
constexpr int PP_FULL_WARPS = 1;
static_assert(PP_GANGS % PP_SMEM_ROWS == 0 && PP_GANGS % PP_FULL_WARPS == 0, "whole gangs");

enum { P_SINGLE, P_STACK, P_SCRATCH, P_FULL, P_SMEM, P_COND, P_MASKUPD, P_V1, P_V2, P_V3, P_V4,
       P_COUNT };

// The path bodies' shapes: chains on a gang's columns (a block takes
// pp_cols of them) or one chain a block; a chase a gang or one; two values
// an iteration (single, maskupd) or one.
__host__ __device__ constexpr bool pp_columns(int body) {
  return body == P_STACK || body == P_SCRATCH || body == P_COND || body == P_V4;
}
__host__ __device__ constexpr bool pp_per_gang(int body) {
  return body == P_STACK || body == P_SCRATCH || body == P_COND || body == P_MASKUPD;
}
__host__ __device__ constexpr bool pp_pair(int body) {
  return body == P_SINGLE || body == P_MASKUPD;
}
__host__ __device__ constexpr int pp_cols(int body, int n) {
  return !pp_columns(body) ? 1 : n <= 4096 ? 8 : n <= 8192 ? 4 : 2;
}
// A chain's stride in the staged array, in values: n + PP_RUN, and with
// several chains rounded up to 32 words plus 32 / cols, so that the chains'
// reads of one iteration and a warp's staging writes fall on distinct banks.
__host__ __device__ constexpr int pp_stride(int cols, int n) {
  return cols == 1 ? n + PP_RUN : (n + PP_RUN + 31) / 32 * 32 + 32 / cols;
}
// Dynamic shared bytes: the path (n + PP_WALK ints: the walk's last batch
// may run past it), then the map and the stamps (n ints each) for the walk,
// reused for the staged values after it.
static size_t pp_path_bytes(int body, int n) {
  const int cols = pp_cols(body, n);
  const size_t staged = (size_t)cols * pp_stride(cols, n) * (pp_pair(body) ? 8 : 4);
  const size_t map = (size_t)n * 8;
  return (size_t)(n + PP_WALK) * 4 + (staged > map ? staged : map);
}

// A staged value: row[col], or the pair (row[a], row[b]).
template <bool PAIR>
struct PPVal {
  using T = float;
  static __device__ __forceinline__ float load(const float* row, int col, int, int) {
    return __ldg(row + col);
  }
};
template <>
struct PPVal<true> {
  using T = float2;
  static __device__ __forceinline__ float2 load(const float* row, int, int a, int b) {
    return make_float2(__ldg(row + a), __ldg(row + b));
  }
};

// One iteration of a chain, in the plain version's f32 order.
template <int BODY>
__device__ __forceinline__ float pp_step(float acc, float x) {
  return acc + x;
}
template <int BODY>
__device__ __forceinline__ float pp_step(float acc, float2 x) {
  if (BODY == P_MASKUPD) return __fadd_rn(__fmul_rn(acc, x.x), x.y);
  return (acc + x.x) + x.y;
}

// acc through the staged values s[0 .. count) in order, the next PP_UNROLL
// loaded before the current PP_UNROLL are added.
template <int BODY, typename T>
__device__ __forceinline__ float pp_run(float acc, const T* s, int count) {
  int q = 0;
  if (count >= PP_UNROLL) {
    T a[PP_UNROLL];
#pragma unroll
    for (int u = 0; u < PP_UNROLL; ++u) a[u] = s[u];
#pragma unroll 1
    for (q = PP_UNROLL; q + PP_UNROLL <= count; q += PP_UNROLL) {
      T b[PP_UNROLL];
#pragma unroll
      for (int u = 0; u < PP_UNROLL; ++u) b[u] = s[q + u];
#pragma unroll
      for (int u = 0; u < PP_UNROLL; ++u) acc = pp_step<BODY>(acc, a[u]);
#pragma unroll
      for (int u = 0; u < PP_UNROLL; ++u) a[u] = b[u];
    }
#pragma unroll
    for (int u = 0; u < PP_UNROLL; ++u) acc = pp_step<BODY>(acc, a[u]);
  }
  for (; q < count; ++q) acc = pp_step<BODY>(acc, s[q]);
  return acc;
}

// Block (x, y) takes columns x * cols .. x * cols + cols - 1 of gang y
// (column bodies; one gang's whole row for maskupd; the tile for single and
// v3).
template <int BODY>
__global__ void __launch_bounds__(PP_PATH_THREADS)
pp_path_kernel(const float* __restrict__ tab, const float* __restrict__ tab2,
               const int* __restrict__ seed, int n, int iters, float* __restrict__ out) {
  using V = PPVal<pp_pair(BODY)>;
  using T = typename V::T;
  extern __shared__ __align__(16) unsigned char pp_smem[];
  __shared__ int s_len, s_mu, s_lam;
  __shared__ float s_acc;
  int* path = reinterpret_cast<int*>(pp_smem);
  int* nxt = reinterpret_cast<int*>(pp_smem + (size_t)(n + PP_WALK) * 4);
  int* first = nxt + n;
  T* staged = reinterpret_cast<T*>(nxt);
  const int tid = threadIdx.x, mask = n - 1;
  const int cols = pp_cols(BODY, n), stride = pp_stride(cols, n);
  const int lc = cols == 8 ? 3 : cols == 4 ? 2 : cols == 2 ? 1 : 0;
  const int g = pp_per_gang(BODY) ? blockIdx.y : 0, col0 = blockIdx.x * cols;

  // 1. The map, every row unstamped.
#pragma unroll 4
  for (int r = tid; r < n; r += PP_PATH_THREADS) {
    const float* t = BODY == P_COND && !(r & 1) ? tab2 : tab;
    nxt[r] = ((int)__ldg(t + (size_t)r * PP_LANES + 5)) & mask;
    first[r] = INT32_MAX;
  }
  __syncthreads();
  // 2. The walk, on warp 0: lane 0 runs PP_WALK steps of the chase through
  // the map (path[k] = the row iteration k reads; a chain of shared loads
  // and nothing else), then the warp stamps each row of the batch with the
  // first step that reached it and finds the batch's first step whose row
  // was stamped earlier: len = mu + lam, mu = that row's stamp. The walk
  // may run up to PP_WALK - 1 steps past len; they are never read. The
  // seed's low bits are torch's row for any seed in [-n, n).
  if (tid < 32) {
    int v = seed[g * PP_LANES] & mask, k0 = 0, len = -1;
    while (len < 0 && k0 < iters) {
      const int cnt = min(PP_WALK, iters - k0);
      if (tid == 0) {
#pragma unroll 8
        for (int q = 0; q < cnt; ++q) {
          path[k0 + q] = v;
          v = nxt[v];
        }
      }
      __syncwarp();
      for (int q = tid; q < cnt; q += 32) atomicMin(first + path[k0 + q], k0 + q);
      __syncwarp();
      int rep = INT32_MAX;
      for (int q = tid; q < cnt; q += 32)
        if (first[path[k0 + q]] < k0 + q) rep = min(rep, k0 + q);
      rep = __reduce_min_sync(PP_FULL_MASK, rep);
      if (rep != INT32_MAX) len = rep;
      k0 += cnt;
    }
    if (tid == 0) {
      s_len = len < 0 ? k0 : len;
      s_mu = len < 0 ? 0 : first[path[len]];
      s_lam = len < 0 ? 0 : len - first[path[len]];
    }
  }
  __syncthreads();
  // 3. Stage the path's values over the map: entry j is path row j, and
  // past the path the cycle's rows again, up to mu + lp (lp: lam, or the
  // least multiple of lam >= PP_RUN); iteration i >= mu + lp reads entry
  // mu + (i - mu) % lp.
  const int len = s_len, mu = s_mu, lam = s_lam;
  const int lp = lam == 0 ? 0 : lam >= PP_RUN ? lam : (PP_RUN + lam - 1) / lam * lam;
  const int staged_len = lam == 0 ? len : min(iters, mu + lp);
  const int pair_b = BODY == P_SINGLE ? 64 : 1;
#pragma unroll 4
  for (int e = tid; e < (staged_len << lc); e += PP_PATH_THREADS) {
    const int j = e >> lc, c = e & (cols - 1);
    const int row = path[j < len ? j : mu + (j - mu) % lam];
    const float* t = (BODY == P_COND && !(row & 1) ? tab2 : tab) + (size_t)row * PP_LANES;
    staged[(size_t)c * stride + j] = V::load(t, col0 + c, 0, pair_b);
  }
  __syncthreads();
  // 4. The chains: the staged run once, then its cycle run after run.
  if (tid < cols) {
    const T* s = staged + (size_t)tid * stride;
    float acc = pp_run<BODY>(BODY == P_MASKUPD ? 1.0f : 0.0f, s, staged_len);
    for (int left = iters - staged_len; left > 0; left -= lp)
      acc = pp_run<BODY>(acc, s + mu, min(lp, left));
    if (BODY == P_V4) {
#pragma unroll
      for (int r = 0; r < PP_GANGS; ++r) out[r * PP_LANES + col0 + tid] = acc;
    } else if (pp_columns(BODY)) {
      out[g * PP_LANES + col0 + tid] = acc;
    } else {
      s_acc = acc;
    }
  }
  if (!pp_columns(BODY)) {  // one chain: broadcast to the gang (maskupd) or the tile
    __syncthreads();
    const float acc = s_acc;
    const int base = BODY == P_MASKUPD ? g * PP_LANES : 0;
    const int count = BODY == P_MASKUPD ? PP_LANES : PP_BLOCK;
    for (int e = tid; e < count; e += PP_PATH_THREADS) out[base + e] = acc;
  }
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

template <int BODY>
static cudaError_t pp_path_launch(const float* tab, const float* tab2, const int* seed, int n,
                                  int iters, float* out, cudaStream_t s) {
  if (n > PP_PATH_MAX_ROWS) return cudaErrorInvalidValue;
  const size_t bytes = pp_path_bytes(BODY, n);
  cudaError_t err = cudaFuncSetAttribute(pp_path_kernel<BODY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(pp_columns(BODY) ? PP_LANES / pp_cols(BODY, n) : 1,
                  pp_per_gang(BODY) ? PP_GANGS : 1);
  pp_path_kernel<BODY><<<grid, PP_PATH_THREADS, bytes, s>>>(tab, tab2, seed, n, iters, out);
  return cudaGetLastError();
}

// A path body's report at the probes' 4,096 rows (its attribute set first).
template <int BODY>
static int pp_path_info(int* out) {
  const size_t bytes = pp_path_bytes(BODY, 4096);
  cudaError_t err = cudaFuncSetAttribute(pp_path_kernel<BODY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  return kernel_report((const void*)pp_path_kernel<BODY>, PP_PATH_THREADS, out, bytes);
}

// tab, tab2 (n, 128) f32 with n a power of two (at most PP_PATH_MAX_ROWS for
// the path bodies); seed (8, 128) int32; out (1024,) f32. Returns the
// cudaError_t of the launch.
extern "C" int pp_gang(int body, const float* tab, const float* tab2, const int* seed, int n,
                       int iters, float* out, void* stream) {
  if (n <= 0 || (n & (n - 1)) || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PP_CASE(B) \
  case B:          \
    return (int)pp_path_launch<B>(tab, tab2, seed, n, iters, out, s);
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
    case P_SINGLE: return pp_path_info<P_SINGLE>(out);
    case P_STACK: return pp_path_info<P_STACK>(out);
    case P_SCRATCH: return pp_path_info<P_SCRATCH>(out);
    case P_COND: return pp_path_info<P_COND>(out);
    case P_MASKUPD: return pp_path_info<P_MASKUPD>(out);
    case P_V3: return pp_path_info<P_V3>(out);
    case P_V4: return pp_path_info<P_V4>(out);
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
    case 6: return PP_PATH_MAX_ROWS;
    case 7: return PP_RUN;
    case 8: return PP_PATH_THREADS;
    case 9: return PP_WALK;
    default: return -1;
  }
}
