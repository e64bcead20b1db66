// Two-level binary-BVH traversal (closest hit with barycentrics, or any hit)
// on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas_traverse.py `_kernel`
// (`_trace_pallas`). The TPU kernel keeps its three (16, N) tables in SMEM
// and fetches a row per lane with a scalar select-scan over the live index
// range (Mosaic has no per-lane gather), which is why the JAX package gates
// it to tables of <= 600,000 bytes. Here a row is a direct load: the tables
// arrive transposed to 64-byte rows (ops/binary_traverse.make_tables), so a
// node is four float4 loads through the read-only cache, and any size runs.
// The per-lane order is the TPU kernel's, step for step
// (ops/binary_traverse.trace_plain is the same algorithm in PyTorch):
//
//   * the root (node 0) pops first, with no pre-test;
//   * a triangle leaf tests its count (<= 4) triangles in order, each taken
//     when nearer than the best hit so far;
//   * an interior node pushes the far child first, then the near one (the
//     smaller clamped entry t; the left child on a tie);
//   * an instance leaf moves the WORLD ray into object space (inverse
//     transform applied unnormalised) and pushes RESTORE, then the BLAS
//     root; a push past the 48-entry stack is dropped;
//   * any-hit stops at the first accepted hit.
//
// What bounds it on the card: latency. A ray visits about ten nodes, each a
// dependent row load then ~50 flops; small-scene tables (<= 600 KB under the
// gate) stay in L1 / L2. The design (PERF.md has the timings of each step):
//   1. One load round a node: the row's four float4 are issued together
//      (a leaf reads three of them for nothing, from the same 64 bytes).
//   2. The next item in a register: the near child, or the BLAS root after
//      an instance leaf, is taken at once instead of pushed and popped.
//      The TPU kernel's stack holds that item as its top entry, so the
//      drop rule is kept by counting the register as a stack slot: the
//      item is taken only where its push would have fit (sp < BT_STACK
//      after the far child or RESTORE was pushed), and popped otherwise.
//      Every push and pop happens as in the TPU kernel, and the hits are
//      the plain version's bit for bit (built with -fmad=false).
//   3. The world ray and its inverse kept in registers: RESTORE copies
//      them back instead of re-reading the ray and dividing again.
//   4. By role: the closest hit runs one thread a ray (R / BT_THREADS
//      blocks; the hardware refills an SM block by block). The any hit
//      runs persistent warps (the SMs times the blocks an SM holds, from
//      the occupancy API) that take 32 rays from a global counter (one
//      atomicAdd) once all their lanes are done, skipping dead rays (t_max
//      <= 0, or NaN: their miss is written at the fetch), so a shadow wave
//      whose rays are mostly dead runs in full warps. The wrapper's
//      counter is zeroed on the stream before such a launch.
// The stack is BT_STACK ints in local memory (L1). Persistent closest-hit
// warps (fetch under 12 lanes or once all are done), a shared-memory stack
// and the tables staged in shared memory ran slower or no faster on the
// H100. No pop-time cull: a box face shared by a triangle (the Cornell
// walls) can give that triangle a t one ulp below the box's entry t, so a
// cull could drop a hit that the TPU kernel takes.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "kernel_report.cuh"

#define BT_STACK 48
#define BT_LEAF 4
#define BT_RESTORE (-1)
#define BT_DIV_EPS 1e-12f
#define BT_RAY_EPS 1e-4f

struct BtV3 {
  float x, y, z;
};

__device__ __forceinline__ float bt_inv1(float c) {
  const float tiny = c >= 0.0f ? BT_DIV_EPS : -BT_DIV_EPS;
  return 1.0f / (fabsf(c) < BT_DIV_EPS ? tiny : c);
}

__device__ __forceinline__ BtV3 bt_inv3(BtV3 d) { return BtV3{bt_inv1(d.x), bt_inv1(d.y), bt_inv1(d.z)}; }

// Slab test of one child box (min at b[0..2], max at b[3..5]) -> clamped
// entry t; *hit as the TPU kernel decides it against the best t.
__device__ __forceinline__ float bt_slab(const float* b, BtV3 o, BtV3 inv, float best_t, bool* hit) {
  const float tx0 = (b[0] - o.x) * inv.x;
  const float ty0 = (b[1] - o.y) * inv.y;
  const float tz0 = (b[2] - o.z) * inv.z;
  const float tx1 = (b[3] - o.x) * inv.x;
  const float ty1 = (b[4] - o.y) * inv.y;
  const float tz1 = (b[5] - o.z) * inv.z;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  const float tn_c = fmaxf(tn, 0.0f);
  *hit = (tn <= tf) && (tf > 0.0f) && (tn_c < best_t);
  return tn_c;
}

constexpr int BT_THREADS = 128;   // 4 warps a block
constexpr int BT_MIN_BLOCKS = 8;  // 32 warps an SM: at most 64 registers a thread
// Persistent warps that fetch rays from a counter (1), or one thread a ray
// on a grid of R / BT_THREADS (0), by role.
constexpr int BT_PERSISTENT_CLOSEST = 0;
constexpr int BT_PERSISTENT_ANY = 1;
template <bool ANY>
constexpr bool BT_PERSISTENT = ANY ? BT_PERSISTENT_ANY : BT_PERSISTENT_CLOSEST;
constexpr unsigned BT_FETCH_MIN = 1;  // persistent: fetch once fewer lanes still traverse
constexpr int BT_NONE = INT_MIN;      // no next item: the lane's traversal ended
constexpr unsigned BT_FULL = 0xffffffffu;

template <bool ANY>
__global__ void __launch_bounds__(BT_THREADS, BT_MIN_BLOCKS)
bt_walk_kernel(const float4* __restrict__ nodes, const float4* __restrict__ insts,
               const float4* __restrict__ tris, int T, const float* __restrict__ ray_o,
               const float* __restrict__ ray_d, const float* __restrict__ t_max, int R,
               int* __restrict__ next_ray, float* __restrict__ t_out, int* __restrict__ tri_out,
               int* __restrict__ inst_out, float* __restrict__ u_out, float* __restrict__ v_out,
               uint8_t* __restrict__ occ_out) {
  int stack[BT_STACK];  // local memory (L1)
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;

  int ray = -1;       // the lane's ray, -1 when empty
  int cur = BT_NONE;  // the next item: a node, RESTORE, or none
  int sp = 0;         // entries on the stack (the next item not counted)
  BtV3 o = {0.0f, 0.0f, 0.0f}, d = o, inv = o;
  BtV3 wo = o, wd = o, winv = o;  // the world ray and its inverse
  int cur_inst = -1;
  float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1, best_inst = -1;

  auto pop = [&]() { cur = sp > 0 ? stack[--sp] : BT_NONE; };
  auto enter_world = [&]() {
    o = wo;
    d = wd;
    inv = winv;
    cur_inst = -1;
  };
  // Ray i, alive (t_max > 0), from the root.
  auto start = [&](int i, float m) {
    ray = i;
    wo = BtV3{__ldg(ray_o + 3 * i), __ldg(ray_o + 3 * i + 1), __ldg(ray_o + 3 * i + 2)};
    wd = BtV3{__ldg(ray_d + 3 * i), __ldg(ray_d + 3 * i + 1), __ldg(ray_d + 3 * i + 2)};
    winv = bt_inv3(wd);
    enter_world();
    best_t = m;
    best_tri = -1;
    best_inst = -1;
    best_u = 0.0f;
    best_v = 0.0f;
    cur = 0;  // the root
    sp = 0;
  };
  // A dead ray's miss (t_max <= 0 or NaN: the TPU kernel's walk finds none).
  auto miss = [&](int i) {
    if (ANY) {
      occ_out[i] = 0;
    } else {
      t_out[i] = INFINITY;
      tri_out[i] = -1;
      inst_out[i] = -1;
      u_out[i] = 0.0f;
      v_out[i] = 0.0f;
    }
  };
  auto retire = [&]() {
    if (ANY) {
      occ_out[ray] = best_tri >= 0 ? 1 : 0;
    } else {
      t_out[ray] = best_tri >= 0 ? best_t : INFINITY;
      tri_out[ray] = best_tri;
      inst_out[ray] = best_inst;
      u_out[ray] = best_u;
      v_out[ray] = best_v;
    }
    ray = -1;
  };
  // One item of the lane's walk: RESTORE, or a node row (one load round).
  auto visit = [&]() {
    if (cur == BT_RESTORE) {
      enter_world();
      pop();
      return;
    }
    const float4* row = nodes + 4 * (size_t)cur;
    const float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2), r3 = __ldg(row + 3);
    const int left = (int)r3.x;
    const int count = (int)r3.y;
    if (count > 0) {
      // ---- triangle leaf ----
      for (int j = 0; j < BT_LEAF && j < count; ++j) {
        const int ti = min(max(left + j, 0), T - 1);
        const float4* g = tris + 4 * (size_t)ti;
        const float4 g0 = __ldg(g), g1 = __ldg(g + 1), g2 = __ldg(g + 2);
        const float p0x = g0.x, p0y = g0.y, p0z = g0.z;
        const float e1x = g0.w, e1y = g1.x, e1z = g1.y;
        const float e2x = g1.z, e2y = g1.w, e2z = g2.x;
        const float hx = d.y * e2z - d.z * e2y;
        const float hy = d.z * e2x - d.x * e2z;
        const float hz = d.x * e2y - d.y * e2x;
        const float a = e1x * hx + e1y * hy + e1z * hz;
        const float f = 1.0f / (fabsf(a) < BT_DIV_EPS ? BT_DIV_EPS : a);
        const float sx = o.x - p0x, sy = o.y - p0y, sz = o.z - p0z;
        const float u = f * (sx * hx + sy * hy + sz * hz);
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = f * (d.x * qx + d.y * qy + d.z * qz);
        const float t = f * (e2x * qx + e2y * qy + e2z * qz);
        if (fabsf(a) >= BT_DIV_EPS && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
            t > BT_RAY_EPS && t < best_t) {
          best_t = t;
          best_tri = ti;
          best_inst = cur_inst;
          best_u = u;
          best_v = v;
        }
      }
      if (ANY && best_tri >= 0) {  // occluded: the traversal ends
        cur = BT_NONE;
        sp = 0;
      } else {
        pop();
      }
    } else if (count == 0) {
      // ---- interior: far child pushed, near child taken ----
      const float lb[6] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y};
      const float rb[6] = {r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
      bool hit_l, hit_r;
      const float t_l = bt_slab(lb, o, inv, best_t, &hit_l);
      const float t_r = bt_slab(rb, o, inv, best_t, &hit_r);
      const bool near_left = t_l <= t_r;
      const bool far_hit = near_left ? hit_r : hit_l;
      const bool near_hit = near_left ? hit_l : hit_r;
      if (far_hit && sp < BT_STACK) stack[sp++] = near_left ? left + 1 : left;
      if (near_hit && sp < BT_STACK)
        cur = near_left ? left : left + 1;
      else
        pop();
    } else if (count == -1) {
      // ---- instance leaf: world -> object space, RESTORE pushed ----
      const float4* m4 = insts + 4 * (size_t)left;
      const float4 m0 = __ldg(m4), m1 = __ldg(m4 + 1), m2 = __ldg(m4 + 2), m3 = __ldg(m4 + 3);
      o = BtV3{m0.x * wo.x + m0.y * wo.y + m0.z * wo.z + m0.w,
               m1.x * wo.x + m1.y * wo.y + m1.z * wo.z + m1.w,
               m2.x * wo.x + m2.y * wo.y + m2.z * wo.z + m2.w};
      d = BtV3{m0.x * wd.x + m0.y * wd.y + m0.z * wd.z, m1.x * wd.x + m1.y * wd.y + m1.z * wd.z,
               m2.x * wd.x + m2.y * wd.y + m2.z * wd.z};
      inv = bt_inv3(d);
      cur_inst = left;
      if (sp < BT_STACK) stack[sp++] = BT_RESTORE;
      if (sp < BT_STACK)
        cur = (int)m3.x;  // the BLAS root
      else
        pop();
    } else {
      pop();
    }
  };

  if constexpr (!BT_PERSISTENT<ANY>) {  // one thread a ray, the grid R / BT_THREADS
    const int i = blockIdx.x * BT_THREADS + threadIdx.x;
    if (i >= R) return;
    const float m = __ldg(t_max + i);
    if (!(m > 0.0f)) {
      miss(i);
      return;
    }
    start(i, m);
    while (cur != BT_NONE) visit();
    retire();
    return;
  }

  bool exhausted = false;
  while (true) {
    if (ray >= 0 && cur == BT_NONE) retire();
    // ---- fetch: rays for the empty lanes, one atomicAdd a round ----
    unsigned have = __ballot_sync(BT_FULL, ray >= 0);
    if (!exhausted && (unsigned)__popc(have) < BT_FETCH_MIN) {
      do {
        const unsigned empty = ~have;
        const int need = __popc(empty);
        int base = 0;
        if (lane == 0) base = atomicAdd(next_ray, need);
        base = __shfl_sync(BT_FULL, base, 0);
        if (ray < 0) {
          const int i = base + __popc(empty & below);
          if (i < R) {
            const float m = __ldg(t_max + i);
            if (m > 0.0f)
              start(i, m);
            else
              miss(i);  // no lane
          }
        }
        if (base + need >= R) exhausted = true;
        have = __ballot_sync(BT_FULL, ray >= 0);
      } while (!exhausted && have != BT_FULL);
    }
    if (have == 0) break;  // only once the counter has run out
    // ---- visits: one item a lane a step, until the warp should refill ----
    while (true) {
      const bool can = ray >= 0 && cur != BT_NONE;
      const unsigned stepping = (unsigned)__popc(__ballot_sync(BT_FULL, can));
      if (stepping == 0 || (!exhausted && stepping < BT_FETCH_MIN)) break;
      if (can) visit();
    }
  }
}

// Blocks of the kernel an SM holds and the card's SM count (occupancy API,
// asked once a process).
template <bool ANY>
static int bt_grid(int* per_sm, int* sms) {
  static int cached_per_sm = 0, cached_sms = 0;
  if (cached_per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached_per_sm, bt_walk_kernel<ANY>,
                                                          BT_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (cached_per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  *per_sm = cached_per_sm;
  *sms = cached_sms;
  return 0;
}

template <bool ANY>
static int bt_launch(cudaStream_t s, const float4* nodes, const float4* insts,
                     const float4* tris, int T, const float* ray_o, const float* ray_d,
                     const float* t_max, int R, int* next_ray, float* t_out, int* tri_out,
                     int* inst_out, float* u_out, float* v_out, uint8_t* occ_out) {
  int per_sm = 0, sms = 0;
  int err = bt_grid<ANY>(&per_sm, &sms);
  if (err != 0) return err;
  const int need = (R + BT_THREADS - 1) / BT_THREADS;
  int blocks = need;
  if constexpr (BT_PERSISTENT<ANY>) {
    if (blocks > per_sm * sms) blocks = per_sm * sms;
    err = (int)cudaMemsetAsync(next_ray, 0, sizeof(int), s);
    if (err != 0) return err;
  }
  bt_walk_kernel<ANY><<<blocks, BT_THREADS, 0, s>>>(nodes, insts, tris, T, ray_o, ray_d, t_max,
                                                    R, next_ray, t_out, tri_out, inst_out, u_out,
                                                    v_out, occ_out);
  return (int)cudaGetLastError();
}

// One launch over R rays; `next_ray` is the persistent warps' ray counter
// (one int32, zeroed here on the stream before a persistent launch). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int bt_trace(int any_hit, const float* nodes, const float* insts, const float* tris,
                        int T, const float* ray_o, const float* ray_d, const float* t_max, int R,
                        int* next_ray, float* t_out, int* tri_out, int* inst_out, float* u_out,
                        float* v_out, uint8_t* occ_out, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* n4 = (const float4*)nodes;
  const float4* i4 = (const float4*)insts;
  const float4* t4 = (const float4*)tris;
  if (any_hit)
    return bt_launch<true>(s, n4, i4, t4, T, ray_o, ray_d, t_max, R, next_ray, t_out, tri_out,
                           inst_out, u_out, v_out, occ_out);
  return bt_launch<false>(s, n4, i4, t4, T, ray_o, ray_d, t_max, R, next_ray, t_out, tri_out,
                          inst_out, u_out, v_out, occ_out);
}

extern "C" int bt_stack_depth() { return BT_STACK; }

// What the compiler and the occupancy API report for the kernel of a role
// (kernel_report). Returns a cudaError_t.
extern "C" int bt_kernel_info(int any_hit, int* out) {
  const void* k = any_hit ? (const void*)bt_walk_kernel<true> : (const void*)bt_walk_kernel<false>;
  return kernel_report(k, BT_THREADS, out);
}
