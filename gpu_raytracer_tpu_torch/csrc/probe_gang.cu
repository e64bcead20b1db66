// Gang-traversal probes for NVIDIA Hopper (sm_90a): the fixed-iteration gang
// traversal and its ablation variants, and the stage-by-stage iteration.
//
// Replaces two TPU probes of the JAX package (tools, not render paths):
//   tools/exp_gang_ablate.py `_kernel`  (pg_ablate<VARIANT>): a copy of
//       ops/pallas_gang.py `_gang_flat_kernel` run for a fixed number of
//       iterations, with ten ablation variants;
//   tools/exp_gang_micro.py  `_kernel`  (pg_micro<STAGE>): one gang iteration
//       built up stage by stage (loop, pop, load, slab, sort, push).
// over the unified table [nodes; leaf rows] of bvh/wide.py (see
// wide_common.cuh for the row layout).
//
// pg_ablate layout (redesigned for Hopper, ROADMAP C44): a 1024-ray TPU tile
// is one block of 8 warps, one warp a gang, each thread 4 of its gang's 128
// rays (ray tile*1024 + g*128 + lane + 32 j, j < 4): 256 threads and 79-80
// registers a thread, 3 tiles an SM. A gang's stack pointer, leaf-queue
// length and top of stack live in registers of its warp (the same value in
// every lane); its stack and leaf queue (zeroed: nopush and nopushst pop
// entries nobody pushed; the TPU kernel pops uninitialised scratch there),
// a row buffer, and each thread's rays' d and 1/d (kept out of registers)
// in shared memory, 33.5 KB a tile. A node phase:
//   - the popped node's row (48 bounds, 8 refs) was loaded into two
//     registers a lane, coalesced, right after the pushes that made it the
//     top of the stack (before the tile's vote), and is handed out through
//     the warp's row buffer;
//   - each thread slab-tests its 4 rays against each non-empty child (an
//     empty child's key is +inf whatever its box) and keeps the minimum over
//     its rays; then one __reduce_min_sync a child, all 8 in flight
//     together, gives the gang minimum on the float bits read as unsigned:
//     te >= 0 or +inf, with -0.0 (which orders above +inf as unsigned) made
//     +0.0 by adding 0.0f first;
//   - lane c < 8 keeps child c's key and ref; the 19 swaps run as six layers
//     of disjoint pairs ({01,23,45,67} {02,13,46,57} {12,56} {04,15,26,37}
//     {24,35} {12,34,56}; sorthalf: the first two and {12}), each one
//     shuffle exchange, swapping on a strict > so ties stay as the serial
//     network leaves them;
//   - the pushes are lane-parallel: a ballot of the node children and one of
//     the leaf children; lane c's slot is the pointer plus the popcount of
//     the children > c (the serial loop runs c = 7 .. 0), and it stores
//     where that slot is under the capacity: the serial loop's checks, since
//     the pointers only grow (nopush, nopushst and pushbase keep their own
//     semantics);
// then every lane reads the new top and issues its row's load. A triangle
// phase: the gang's warp copies its popped leaf row, coalesced, into its
// row buffer, and each thread tests its 4 rays against the row's triangles
// read by broadcast from there. The tile's node/triangle choice (and,
// under `converge`, whether any gang is busy) is one __syncthreads_count an
// iteration: lane 0 of each gang votes a trigger, lanes 1-9 vote busy, so
// the count is triggers + 9 x busy gangs. A lane with t_max <= 0 (padding)
// needs no flag: it enters no box (te >= 0 is not < t_max) and accepts no
// triangle (t > 1e-4 is not < t_max), as the plain version's dead mask says.

// pg_micro layout (redesigned for Hopper, ROADMAP C45): pg_ablate's warp a
// gang, stage by stage. Block gg (one warp) is gang gg % 8 of tile gg / 8; a
// thread holds rays gg * 128 + lane + 32 j (j < 4) and their acc. The gangs
// never vote together (the TPU tool has none), so a block need not be a
// tile: one gang a block spreads the probe's 512 gangs over every SM (a
// tile a block, 8 warps on 64 SMs, took 1.36x as long; PERF.md). A gang's
// stack is PG_MICRO_CAP + 1 ints of shared memory (the stack pointer never
// passes the cap), its pointer a warp-uniform register; the pop stage pops
// the warp's replica of gang 0's stack (nothing is pushed there, so it holds
// gang 0's root and any warp replays gang 0's pops). Each lane reads the
// popped row's child bounds by broadcast (__ldg float4); the gang minimum is
// __reduce_min_sync on the float bits after + 0.0f; lane c < 8 keeps child
// c's key and ref; the sort is pg_layer's six layers; the pushes are one
// ballot: child c goes to sp + the taken children > c, and past the cap the
// serial loop's last store to slot PG_MICRO_CAP (the lowest taken child) is
// the only one made. No named barrier, no serial pusher. What bounds it: a
// warp's own chain. The probe's 512 gangs are fewer than the card's 528
// warp schedulers, so no other warp hides a gang's row load or the latency
// of its slab arithmetic.
//
// What the variants price on this card (PERF.md): nosort/sorthalf the
// compare-swap layers; nopush/nopushst/pushbase the pushes' shared-memory
// stores (the TPU's vector-to-scalar extracts have no Hopper twin: here a
// key reaches its lane in a register, so the extract cost is absent); noload
// the dependent row fetch (all gangs read row 0, which stays in L1); nored
// the gang minimum (the key of the gang's ray 0, one shuffle; a thread then
// slab-tests its first ray only, since the other three go unused).
//
// What bounds it: the tile's lockstep. Each iteration ends in the tile's
// vote, so it lasts as long as its busiest gang's warp, and a warp now runs
// 4 rays' work: a node visit is 8 children x 4 rays x ~28 instructions (no
// fma under -fmad=false), a leaf's triangle ~62 a ray. On the merged
// bounce-1 wave only some gangs have a node or a leaf in a given phase; the
// others wait at the vote (tools/torch_gang_phase_cycles.py counts the
// cycles of each phase and of the wait, PERF.md). Exploratory builds that
// took the work off the gangs' warps (rays in shared memory, any warp on
// any gang's quarter, the gang minimum by shared atomics), held 4 tiles an
// SM (64 registers, spilling), tested two triangles at once or divided
// without the per-ray branch of the IEEE division were each slower on the
// card than this design. The first design (one 1024-thread block a tile,
// a serial pusher, two block barriers an iteration under converge, every
// lane re-reading the row) took 2.1x as long (PERF.md).

// Float semantics follow the plain versions (probes/gang.py), built with
// -fmad=false: the slab terms (b - o) * inv, fminf/fmaxf, the triangle test of
// wide_common.cuh; (int) casts truncate and saturate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_report.cuh"
#include "wide_common.cuh"

#define PG_GANGS 8
#define PG_LANES 128
#define PG_BLOCK (PG_GANGS * PG_LANES)
#define PG_QTRIG 8
#define PG_LEAFQ (PG_QTRIG + 7)  // LEAFQ_DEPTH
#define PG_STACK 160             // STACK_DEPTH
#define PG_SCRAP PG_STACK        // one trash slot at the end of each stack
#define PG_QSCRAP PG_LEAFQ
#define PG_IDLE (-2000000000)
#define PG_MICRO_CAP 8
#define PG_FULL_MASK 0xffffffffu
#define PG_TILE_THREADS (PG_GANGS * 32)  // pg_ablate: one warp a gang
#define PG_RAYS (PG_LANES / 32)          // rays a thread
#define PG_NODE_FLOATS 56                // a node row's bounds and refs
#define PG_BUSY_VOTES (PG_GANGS + 1)     // lanes 1..9 vote busy: count % 9 = triggers

// pg_ablate blocks an SM that ptxas must leave room for (register cap).
constexpr int PG_MIN_BLOCKS = 3;

// The compare-swap layers of the Batcher network (probes/gang.LAYERS): lane
// c < 8 exchanges with nibble c of a map (itself where it sits out).
#define PG_LAYER_1 0x67452301u  // 01 23 45 67
#define PG_LAYER_2 0x54761032u  // 02 13 46 57
#define PG_LAYER_3 0x75643120u  // 12 56
#define PG_LAYER_4 0x32107654u  // 04 15 26 37
#define PG_LAYER_5 0x76325410u  // 24 35
#define PG_LAYER_6 0x75634120u  // 12 34 56
#define PG_LAYER_H 0x76543120u  // 12: sorthalf's third layer

enum {
  V_FULL, V_NODE_ONLY, V_TRI_ONLY, V_NOSORT, V_NOPUSH, V_NOPUSHST, V_NOLOAD,
  V_NORED, V_PUSHBASE, V_SORTHALF, V_COUNT
};
enum { S_LOOP, S_POP, S_LOAD, S_SLAB, S_SORT, S_PUSH, S_COUNT };

// Slab test of one box (a, b, d: the child's 6 floats as three float2) for
// one ray: tn, tf.
__device__ __forceinline__ void pg_box(float2 a, float2 b, float2 d, float ox, float oy,
                                       float oz, float ix, float iy, float iz, float& tn,
                                       float& tf) {
  const float tx0 = (a.x - ox) * ix;  // bx0
  const float tx1 = (b.y - ox) * ix;  // bx1
  const float ty0 = (a.y - oy) * iy;  // by0
  const float ty1 = (d.x - oy) * iy;  // by1
  const float tz0 = (b.x - oz) * iz;  // bz0
  const float tz1 = (d.y - oz) * iz;  // bz1
  tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

// One compare-swap layer among lanes 0..7 (the others sit out): the lower
// lane of a pair keeps the smaller key, a tie stays.
__device__ __forceinline__ void pg_layer(unsigned map, int lane, float& key, int& ref) {
  const int partner = lane < 8 ? (int)((map >> (4 * lane)) & 0xFu) : lane;
  const float pk = __shfl_sync(PG_FULL_MASK, key, partner);
  const int pr = __shfl_sync(PG_FULL_MASK, ref, partner);
  if (lane < partner ? key > pk : pk > key) {
    key = pk;
    ref = pr;
  }
}

// wt_tri_hit (wide_common.cuh) on a triangle staged in shared memory: the
// same terms in the same order, the 9 floats read with plain loads.
__device__ __forceinline__ bool pg_tri_hit(const float* g, float ox, float oy, float oz,
                                           float dx, float dy, float dz, float limit,
                                           float& t) {
  const float p0x = g[0], p0y = g[1], p0z = g[2];
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / (fabsf(a) < WT_DIV_EPS ? WT_DIV_EPS : a);
  const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float w = f * (dx * qx + dy * qy + dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return (fabsf(a) >= WT_DIV_EPS) && (u >= 0.0f) && (u <= 1.0f) && (w >= 0.0f) &&
         (u + w <= 1.0f) && (t > WT_RAY_EPS) && (t < limit);
}

struct __align__(16) PgTileShared {
  float row[PG_GANGS][WT_ROW];  // each gang's popped row: a node's 56 floats or a leaf
  // Each thread's rays' 1/d (the slab tests) and d (the triangle tests),
  // [axis][ray][thread]: kept here, not in registers, for the tiles an SM holds.
  float inv[3][PG_RAYS][PG_TILE_THREADS];
  float dir[3][PG_RAYS][PG_TILE_THREADS];
  int stack[PG_GANGS][PG_STACK + 1];
  int leafq[PG_GANGS][PG_LEAFQ + 1];
};

template <int VARIANT>
__global__ void __launch_bounds__(PG_TILE_THREADS, PG_MIN_BLOCKS)
pg_ablate_kernel(const float* __restrict__ table, int N, int L,
                 const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                 const float* __restrict__ t_max, int k_iters, int converge,
                 float* __restrict__ t_out, int* __restrict__ tri_out,
                 int* __restrict__ iters_out) {
  __shared__ PgTileShared sh;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* rowbuf = sh.row[g];
  int* stack = sh.stack[g];
  int* leafq = sh.leafq[g];
  for (int k = lane; k < PG_STACK + 1; k += 32) stack[k] = 0;
  if (lane < PG_LEAFQ + 1) leafq[lane] = 0;

  const size_t r0 = (size_t)blockIdx.x * PG_BLOCK + g * PG_LANES + lane;
  float ox[PG_RAYS], oy[PG_RAYS], oz[PG_RAYS], best_t[PG_RAYS];
  int best_tri[PG_RAYS];
#pragma unroll
  for (int k = 0; k < PG_RAYS; ++k) {
    const size_t r = r0 + 32 * k;
    ox[k] = ray_o[3 * r + 0], oy[k] = ray_o[3 * r + 1], oz[k] = ray_o[3 * r + 2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float d = ray_d[3 * r + a];
      sh.dir[a][k][threadIdx.x] = d;
      sh.inv[a][k][threadIdx.x] = wt_inv1(d);
    }
    best_t[k] = t_max[r];
    best_tri[k] = -1;
  }

  int sp = 1, lq = 0;  // the root node, already in slot 0
  int top = 0;         // stack[sp - 1], or PG_IDLE where the stack is empty
  // The row of `top` (noload: row 0), loaded ahead: lane l holds floats l
  // and 32 + l (l < 24).
  const float* prow = table;
  float pre0 = __ldg(prow + lane);
  float pre1 = lane < PG_NODE_FLOATS - 32 ? __ldg(prow + 32 + lane) : 0.0f;

  int trig = 0;  // no gang holds a leaf yet
  bool busy = true;
  int it = 0;
  __syncthreads();
  while (it < k_iters) {
    if (converge && !busy) break;
    ++it;
    const bool tri_phase = VARIANT == V_TRI_ONLY ? true : VARIANT == V_NODE_ONLY ? false : trig > 0;

    if (tri_phase) {
      // ---- the gang pops one queued leaf row; each thread tests its rays ----
      const int qm = lq > 0 ? lq - 1 : 0;
      const int rid = lq > 0 ? leafq[qm] : -1;
      if (rid >= 0) {
        // The leaf row, coalesced, into the gang's row buffer: its triangles
        // are then read by broadcast from shared memory.
        const float* row = table + (size_t)(N + min(rid, L - 1)) * WT_ROW;
#pragma unroll
        for (int q = 0; q < WT_ROW / 32; ++q) rowbuf[32 * q + lane] = __ldg(row + 32 * q + lane);
        __syncwarp();
        float dx[PG_RAYS], dy[PG_RAYS], dz[PG_RAYS];
#pragma unroll
        for (int k = 0; k < PG_RAYS; ++k) {
          dx[k] = sh.dir[0][k][threadIdx.x];
          dy[k] = sh.dir[1][k][threadIdx.x];
          dz[k] = sh.dir[2][k][threadIdx.x];
        }
        // Slots j with j < kind (float compare, as the plain version's
        // mask; NaN or <= 0: none), as a trip count.
        const float kind = rowbuf[0];
        const int count = kind > 0.0f ? (int)ceilf(fminf(kind, (float)WT_LEAF_CAP)) : 0;
        for (int j = 0; j < count; ++j) {
          const int id = (int)rowbuf[1 + j];
#pragma unroll
          for (int k = 0; k < PG_RAYS; ++k) {
            float t;
            if (pg_tri_hit(rowbuf + 16 + 9 * j, ox[k], oy[k], oz[k], dx[k], dy[k], dz[k],
                           best_t[k], t)) {
              best_t[k] = t;
              best_tri[k] = id;
            }
          }
        }
      }
      lq = qm;
    } else {
      // ---- node phase: pop, slab-test 8 children, gang minimum, pushes ----
      const int v = top;
      const int s0 = sp > 0 ? sp - 1 : 0;
      rowbuf[lane] = pre0;
      if (lane < PG_NODE_FLOATS - 32) rowbuf[32 + lane] = pre1;
      __syncwarp();
      float key = INFINITY;  // lane c < 8: child c's key and ref
      int ref = -1;
      if (v >= 0) {
        float ix[PG_RAYS], iy[PG_RAYS], iz[PG_RAYS];
#pragma unroll
        for (int k = 0; k < PG_RAYS; ++k) {
          ix[k] = sh.inv[0][k][threadIdx.x];
          iy[k] = sh.inv[1][k][threadIdx.x];
          iz[k] = sh.inv[2][k][threadIdx.x];
        }
        // This thread's minimum over its rays of each child's entry distance
        // (nored: its ray 0's), +inf where none enters or the child is empty.
        float m[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          m[c] = INFINITY;
          if ((int)rowbuf[48 + c] == -1) continue;  // empty: +inf whatever its box
          const float2* q = reinterpret_cast<const float2*>(rowbuf + 6 * c);
          const float2 a = q[0], b = q[1], d = q[2];
#pragma unroll
          for (int k = 0; k < (VARIANT == V_NORED ? 1 : PG_RAYS); ++k) {
            float tn, tf;
            pg_box(a, b, d, ox[k], oy[k], oz[k], ix[k], iy[k], iz[k], tn, tf);
            const float te = fmaxf(tn, 0.0f);
            if ((tn <= tf) && (tf > 0.0f) && (te < best_t[k])) m[c] = fminf(m[c], te);
          }
        }
        // The gang minima, all 8 reductions in flight together; lane c keeps
        // child c's key and ref.
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float tmin =
              VARIANT == V_NORED  // the key of the gang's ray 0
                  ? __shfl_sync(PG_FULL_MASK, m[c], 0)
                  : __uint_as_float(__reduce_min_sync(PG_FULL_MASK,
                                                      __float_as_uint(m[c] + 0.0f)));  // -0 -> +0
          if (lane == c && tmin < INFINITY) {
            key = tmin;
            ref = (int)rowbuf[48 + c];
          }
        }
      }
      if (VARIANT != V_NOSORT) {
        pg_layer(PG_LAYER_1, lane, key, ref);
        pg_layer(PG_LAYER_2, lane, key, ref);
        if (VARIANT == V_SORTHALF) {
          pg_layer(PG_LAYER_H, lane, key, ref);
        } else {
          pg_layer(PG_LAYER_3, lane, key, ref);
          pg_layer(PG_LAYER_4, lane, key, ref);
          pg_layer(PG_LAYER_5, lane, key, ref);
          pg_layer(PG_LAYER_6, lane, key, ref);
        }
      }
      // Lanes >= 8 hold ref -1: they push nothing.
      const unsigned nodes = __ballot_sync(PG_FULL_MASK, ref >= 0);
      const unsigned leaves = __ballot_sync(PG_FULL_MASK, ref <= -2);
      if (VARIANT == V_NOPUSH) {
        sp = min(s0 + 2, PG_STACK - 1);
      } else if (VARIANT == V_PUSHBASE) {
        if (lane < 8) {
          if (s0 + lane < PG_SCRAP) stack[s0 + lane] = ref;
          if (lq + lane < PG_QSCRAP) leafq[lq + lane] = -ref - 2;
        }
        sp = min(s0 + __popc(nodes), PG_STACK - 1);
        lq = min(lq + __popc(leaves), PG_LEAFQ - 1);
      } else {
        const unsigned before = lane < 8 ? ~0u << (lane + 1) : 0u;  // c' > c push first
        const int sn = s0 + __popc(nodes & before), sl = lq + __popc(leaves & before);
        if (VARIANT != V_NOPUSHST) {
          if (ref >= 0 && sn < PG_STACK) stack[sn] = ref;
          if (ref <= -2 && sl < PG_LEAFQ) leafq[sl] = -ref - 2;
        }
        sp = min(s0 + __popc(nodes), PG_STACK);
        lq = min(lq + __popc(leaves), PG_LEAFQ);
      }
      __syncwarp();  // the pushes in before the new top is read
      top = sp > 0 ? stack[sp - 1] : PG_IDLE;
      prow = table + (size_t)(VARIANT == V_NOLOAD ? 0 : min(max(top, 0), N - 1)) * WT_ROW;
      pre0 = __ldg(prow + lane);
      pre1 = lane < PG_NODE_FLOATS - 32 ? __ldg(prow + 32 + lane) : 0.0f;
    }
    // Counts the gangs that trigger a triangle phase next (and, lanes 1-9,
    // the busy ones); orders this iteration's row-buffer reads before the
    // next one's stores.
    const bool trig_g = lq >= PG_QTRIG || (sp == 0 && lq > 0);
    const bool busy_g = sp > 0 || lq > 0;
    const int votes = __syncthreads_count(
        (lane == 0 && trig_g) || (converge && lane >= 1 && lane <= PG_BUSY_VOTES && busy_g));
    trig = votes % PG_BUSY_VOTES;
    busy = votes >= PG_BUSY_VOTES;
  }
#pragma unroll
  for (int k = 0; k < PG_RAYS; ++k) {
    const size_t r = r0 + 32 * k;
    t_out[r] = best_tri[k] >= 0 ? best_t[k] : INFINITY;
    tri_out[r] = best_tri[k];
  }
  if (threadIdx.x == 0) iters_out[blockIdx.x] = it;
}

// Gang g's root (its stack's slot 0) and its fallback node where its stack
// is empty, as exp_gang_micro.py sets them.
__device__ __forceinline__ int pg_micro_node(int it, int g, int N) {
  return (it * 31 + g * 7919) % N;
}

template <int STAGE>
__global__ void __launch_bounds__(32)
pg_micro_kernel(const float* __restrict__ table, int N, const float* __restrict__ rays,
                int n_iters, float* __restrict__ acc_out) {
  __shared__ int stack[PG_MICRO_CAP + 1];
  const int lane = threadIdx.x, gg = blockIdx.x;
  // The gang whose pops this warp makes: its own, or gang 0's under `pop`.
  const int g = STAGE == S_POP ? 0 : gg % PG_GANGS;
  if (lane <= PG_MICRO_CAP) stack[lane] = lane == 0 ? pg_micro_node(0, g, N) : 0;
  __syncwarp();
  float ox[PG_RAYS], oy[PG_RAYS], oz[PG_RAYS], ix[PG_RAYS], iy[PG_RAYS], iz[PG_RAYS];
  float acc[PG_RAYS];
#pragma unroll
  for (int k = 0; k < PG_RAYS; ++k) {
    ox[k] = rays[(size_t)gg * PG_LANES + lane + 32 * k];
    oy[k] = ox[k] * 1.01f, oz[k] = ox[k] * 0.99f;
    ix[k] = 1.0f / (ox[k] + 0.5f), iy[k] = 1.0f / (ox[k] + 0.6f), iz[k] = 1.0f / (ox[k] + 0.7f);
    acc[k] = 0.0f;
  }
  int sp = 1;  // warp-uniform
  for (int it = 0; it < n_iters; ++it) {
    float add;  // what every ray of the gang adds (all but `load`)
    if (STAGE == S_LOOP) {
      add = (float)pg_micro_node(it, 0, N);  // gang 0's fixed node
    } else {
      const int v = sp > 0 ? stack[sp - 1] : pg_micro_node(it, g, N);
      sp = sp > 0 ? sp - 1 : 0;
      const float* row = table + (size_t)min(max(v, 0), N - 1) * WT_ROW;
      if (STAGE == S_POP) {
        add = (float)v;
      } else if (STAGE == S_LOAD) {
#pragma unroll
        for (int k = 0; k < PG_RAYS; ++k) acc[k] += __ldg(row + lane + 32 * k);
        continue;
      } else {
        // This thread's minimum over its rays of each child's entry distance.
        float m[8];
        const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
        for (int p = 0; p < 4; ++p) {  // children 2p, 2p + 1: 12 floats
          const float4 q0 = __ldg(q + 3 * p), q1 = __ldg(q + 3 * p + 1), q2 = __ldg(q + 3 * p + 2);
          const float2 box[2][3] = {{make_float2(q0.x, q0.y), make_float2(q0.z, q0.w),
                                     make_float2(q1.x, q1.y)},
                                    {make_float2(q1.z, q1.w), make_float2(q2.x, q2.y),
                                     make_float2(q2.z, q2.w)}};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            m[2 * p + h] = INFINITY;
#pragma unroll
            for (int k = 0; k < PG_RAYS; ++k) {
              float tn, tf;
              pg_box(box[h][0], box[h][1], box[h][2], ox[k], oy[k], oz[k], ix[k], iy[k], iz[k],
                     tn, tf);
              if ((tn <= tf) && (tf > 0.0f)) m[2 * p + h] = fminf(m[2 * p + h], fmaxf(tn, 0.0f));
            }
          }
        }
        // Lane c < 8 keeps child c's key and ref (the gang minima, all 8
        // reductions in flight together).
        const int rr = lane < 8 ? (int)__ldg(row + 48 + lane) : -1;
        float key = INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float tmin =
              __uint_as_float(__reduce_min_sync(PG_FULL_MASK, __float_as_uint(m[c] + 0.0f)));
          if (lane == c) key = tmin;
        }
        const bool take = rr != -1 && key < INFINITY;
        key = take ? key : INFINITY;
        int ref = take ? rr : -1;
        if (STAGE >= S_SORT) {
          pg_layer(PG_LAYER_1, lane, key, ref);
          pg_layer(PG_LAYER_2, lane, key, ref);
          pg_layer(PG_LAYER_3, lane, key, ref);
          pg_layer(PG_LAYER_4, lane, key, ref);
          pg_layer(PG_LAYER_5, lane, key, ref);
          pg_layer(PG_LAYER_6, lane, key, ref);
        }
        if (STAGE == S_PUSH) {
          // The serial loop (c = 7 .. 0) stores child c at sp, then caps sp
          // at PG_MICRO_CAP (its sp < PG_STACK check always holds): child c's
          // slot is sp + the taken children > c, capped, so past the cap the
          // lowest taken child stores last.
          const unsigned taken = __ballot_sync(PG_FULL_MASK, ref != -1);  // lanes >= 8: -1
          const int slot = sp + __popc(taken & (lane < 8 ? ~0u << (lane + 1) : 0u));
          if (ref != -1 && (slot < PG_MICRO_CAP || lane == __ffs(taken) - 1))
            stack[min(slot, PG_MICRO_CAP)] = ref;
          sp = min(sp + __popc(taken), PG_MICRO_CAP);
          __syncwarp();  // the pushes in before the next pop reads the top
        }
        add = __shfl_sync(PG_FULL_MASK, key, 0);  // key[0]
      }
    }
#pragma unroll
    for (int k = 0; k < PG_RAYS; ++k) acc[k] += add;
  }
#pragma unroll
  for (int k = 0; k < PG_RAYS; ++k) acc_out[(size_t)gg * PG_LANES + lane + 32 * k] = acc[k];
}

// Layout constants, checked by ops/_native.load against probes/gang.py.
extern "C" int pg_layout(int which) {
  switch (which) {
    case 0: return PG_GANGS;
    case 1: return PG_LANES;
    case 2: return PG_STACK;
    case 3: return PG_LEAFQ;
    case 4: return PG_QTRIG;
    case 5: return WT_LEAF_CAP;
    case 6: return PG_IDLE;
    case 7: return V_COUNT;
    case 8: return S_COUNT;
    case 9: return PG_MICRO_CAP;
    case 10: return (int)PG_LAYER_1;
    case 11: return (int)PG_LAYER_2;
    case 12: return (int)PG_LAYER_3;
    case 13: return (int)PG_LAYER_4;
    case 14: return (int)PG_LAYER_5;
    case 15: return (int)PG_LAYER_6;
    case 16: return (int)PG_LAYER_H;
    case 17: return PG_TILE_THREADS;
    default: return -1;
  }
}

// The compiler's and the occupancy API's report of pg_ablate<variant>
// (kernel_report.cuh). Returns a cudaError_t.
extern "C" int pg_kernel_info(int variant, int* out) {
  const void* k = nullptr;
#define PG_INFO(V)                           \
  case V:                                    \
    k = (const void*)pg_ablate_kernel<V>;    \
    break;
  switch (variant) {
    PG_INFO(V_FULL)
    PG_INFO(V_NODE_ONLY)
    PG_INFO(V_TRI_ONLY)
    PG_INFO(V_NOSORT)
    PG_INFO(V_NOPUSH)
    PG_INFO(V_NOPUSHST)
    PG_INFO(V_NOLOAD)
    PG_INFO(V_NORED)
    PG_INFO(V_PUSHBASE)
    PG_INFO(V_SORTHALF)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PG_INFO
  return kernel_report(k, PG_TILE_THREADS, out);
}

// The compiler's and the occupancy API's report of pg_micro<stage>
// (kernel_report.cuh). Returns a cudaError_t.
extern "C" int pg_micro_info(int stage, int* out) {
  const void* k = nullptr;
  switch (stage) {
    case S_LOOP: k = (const void*)pg_micro_kernel<S_LOOP>; break;
    case S_POP: k = (const void*)pg_micro_kernel<S_POP>; break;
    case S_LOAD: k = (const void*)pg_micro_kernel<S_LOAD>; break;
    case S_SLAB: k = (const void*)pg_micro_kernel<S_SLAB>; break;
    case S_SORT: k = (const void*)pg_micro_kernel<S_SORT>; break;
    case S_PUSH: k = (const void*)pg_micro_kernel<S_PUSH>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return kernel_report(k, 32, out);
}

// One block of 8 warps per 1024-ray tile (G tiles; rays padded by the
// caller). Returns
// the cudaError_t of the launch (0 on success).
extern "C" int pg_ablate(int variant, const float* table, int N, int L, const float* ray_o,
                         const float* ray_d, const float* t_max, int G, int k_iters,
                         int converge, float* t_out, int* tri_out, int* iters_out,
                         void* stream) {
  if (G <= 0) return 0;
  if (N <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PG_CASE(V)                                                                     \
  case V:                                                                              \
    pg_ablate_kernel<V><<<G, PG_TILE_THREADS, 0, s>>>(table, N, L, ray_o, ray_d, t_max, \
                                                      k_iters, converge, t_out, tri_out, \
                                                      iters_out);                        \
    break;
  switch (variant) {
    PG_CASE(V_FULL)
    PG_CASE(V_NODE_ONLY)
    PG_CASE(V_TRI_ONLY)
    PG_CASE(V_NOSORT)
    PG_CASE(V_NOPUSH)
    PG_CASE(V_NOPUSHST)
    PG_CASE(V_NOLOAD)
    PG_CASE(V_NORED)
    PG_CASE(V_PUSHBASE)
    PG_CASE(V_SORTHALF)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PG_CASE
  return (int)cudaGetLastError();
}

// One 32-thread block a gang over T (8, 128) tiles of synthetic rays; the
// table 16-byte aligned.
extern "C" int pg_micro(int stage, const float* table, int N, const float* rays, int T,
                        int n_iters, float* acc_out, void* stream) {
  if (T <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PG_CASE(S)                                                                     \
  case S:                                                                              \
    pg_micro_kernel<S><<<T * PG_GANGS, 32, 0, s>>>(table, N, rays, n_iters, acc_out); \
    break;
  switch (stage) {
    PG_CASE(S_LOOP)
    PG_CASE(S_POP)
    PG_CASE(S_LOAD)
    PG_CASE(S_SLAB)
    PG_CASE(S_SORT)
    PG_CASE(S_PUSH)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PG_CASE
  return (int)cudaGetLastError();
}
