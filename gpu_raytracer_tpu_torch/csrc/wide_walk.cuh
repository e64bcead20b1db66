// The persistent-warp walk over wide-BVH tables for NVIDIA Hopper (sm_90a):
// one kernel template, wt_walk_kernel<MODE, LAYOUT, STATS>, shared by the
// primary, bounce and shadow waves of wide_traverse.cu (K1, K2 merged, K4
// two-level) and the two passes of stream_traverse.cu (K6 resident and page)
// over paged tables. Row layout and float semantics: wide_common.cuh.
//
// The walk (each step timed as it went in; PERF.md has the numbers):
//  1. Persistent warps that fetch rays. The grid is the SM count times the
//     blocks an SM holds (occupancy API), or fewer where the rays need fewer.
//     A warp takes the next rays for its empty lanes from a global counter,
//     one atomicAdd a fetch, when fewer than WP_FETCH_MIN of its lanes still
//     traverse (Aila and Laine's dynamic fetch; the resident pass: once all
//     are done, 32 rays in one fetch). A ray with nothing to do (dead: t_max
//     <= 0; page pass: no recorded portal, or occluded already) gets its
//     result written at the fetch and never takes a lane. The wrapper's
//     counter is zeroed on the stream before each launch; the kernel
//     allocates nothing.
//  2. The near child in registers: after the slab test and the stable sort
//     (wt_sort8, whose order the plain versions follow) the nearest hit
//     child is the next item; only the others are pushed, far to near. A
//     node without a hit child pops.
//  3. The stack: one per lane in local memory (L1), WT_STACK entries, each
//     the ref and key packed into 64 bits: one store, one load. (Its top 8
//     entries in a shared-memory ring did not pay.)
//  4. Registers: __launch_bounds__(WP_THREADS, WP_MIN_BLOCKS) for 32
//     resident warps an SM, the child boxes streamed as float4 triples
//     (two children each) into the slab test, the world ray re-read from
//     the ray arrays at an instance row or RESTORE rather than kept.
//  5. Postponed leaves (the TPU kernel's node / triangle phases, QTRIG, and
//     the reference's triangle postponing). A step of the node phase is one
//     interior node a lane; what follows it up to the next interior node is
//     taken in the same step (`advance`): RESTORE, instance rows (the
//     leading `inst_rows` leaf rows of two-level tables, known by their id,
//     transform the ray at once) and a leaf row, which is parked. A lane
//     holding a parked leaf waits at its next leaf row. The warp turns to
//     its leaves when WP_LEAF_MIN lanes hold one, or fewer than
//     WP_STEP_MIN lanes could take a node step. Two-level, a parked leaf
//     keeps the instance row of its space, so its lane goes on through
//     RESTORE and instance rows.
//  6. A cooperative leaf phase: the parked leaves' triangles are laid end
//     to end (a scan of their counts) and tested 32 at a time, one a lane,
//     against the owner's ray and best hit of the round (shuffled from the
//     owner); a segmented minimum of (t, slot) hands each owner what its
//     own loop over its slots in order, strict <, would keep. A lane's loop
//     over its own leaf ran a warp for the longest leaf, ~31% of its lanes
//     busy.
// Any hit ends a lane at its first hit; the lane then fetches again.
//
// MODE: WT_PRIMARY is the closest hit with barycentrics (K1; the trailing
// WtUv argument holds the u, v outputs), WT_CLOSEST the closest hit (K2,
// K4, K6), WT_ANY the occlusion test. The primary wave's u, v are those of
// the winning triangle, carried out of the leaf test: from the leaf phase
// by two shuffles from the lane that won the segmented minimum. The primary
// wave fetches as the bounce waves do (a warp keeping one 32-ray tile row
// until all its lanes were done ran 5-9% slower on the coherent wave); its
// two-level walk tests leaves inline, as the resident pass does (4.7%
// faster there), its merged walk parks them (inline ran 22% slower).
// PERF.md has the timings.
//
// LAYOUT selects the tables and what a pass adds to the walk:
//   WL_MERGED, WL_TWO_LEVEL  `nodes` and `rows` of bvh/wide.py (K1, K2, K4).
//   WL_RESIDENT  the resident rows of paged tables (bvh/stream.py), one
//       unified index space (`nodes` == `rows`): row v >= 0 a node, ref
//       <= -2 a leaf row -(ref+2), refs <= -(2 + WT_PORTAL_BASE) portals. A
//       portal child entered before the cull t is recorded, not pushed: it
//       gets the ray's next enumeration index (node visit order, then child
//       slot order), and if the index lies in the pass's window [skip, skip
//       + WT_K) its (portal id, entry t) goes to that slot of the ray's
//       list; past the window it only counts in ovf. The enumeration
//       depends on the best hit at each slab test, so leaves are tested
//       INLINE, in the lane's own order (no parking, no leaf phase): a
//       replay of the lane with the window advanced (the host's pass loop)
//       enumerates the same portals. Each list slot is written once: a
//       recorded one when its portal is enumerated, the rest (-1 / +inf up
//       to WT_K) when the lane retires, with the warp's other lanes.
//   WL_PAGE  the flat page array (G * page_rows rows of 128 f32), refs
//       local to their page: a node's children are made global by adding
//       its page's base (leaf refs subtract it). At the fetch a lane reads
//       its recorded portals, sorts them nearest first (a sorting network
//       in registers over (entry t, slot, global root row) keys: stable by
//       slot, as the plain version's torch.sort(stable=True)) and pushes
//       them far to near under the walk, so the pop-time cull against the
//       running best drops a far portal where a per-portal loop would stop
//       (portal subtrees are disjoint). The running best is read and
//       written in place (t_out, tri_out).
// The lists are slot-major, (WT_K, R): slot k of ray i at k * R + i, so a
// warp's lanes holding consecutive rays store and load one slot contiguously.
//
// Semantics against the plain versions: merged, two-level and page pass
// change only the order of a ray's visits, so the closest t is the minimum
// over the same triangle tests (bit-equal), any hit is equal, and tri / inst
// (and the primary wave's u, v, those of the triangle it names) may differ
// only at an exact tie in t. The resident pass visits in the plain version's
// order: every output bit-equal.
//
// Two-level invariants: RESTORE is pushed with the key -inf, so the pop-time
// cull never drops it (a dropped RESTORE would leave the ray in object space
// for the rest of the TLAS); the BLAS root keeps the instance's entry key.
// The transformed direction is not normalised: the affine inverse keeps the
// ray parameter, so t, the slab keys and best_t compare across spaces. The
// packer's stack bound counts RESTORE and the root (a bound on this kernel's
// depth too, which pushes one entry fewer a node) and is checked against
// WT_STACK before any launch (wide_traverse.make_tables); the page pass adds
// up to WT_K - 1 portals beneath its first subtree, which
// stream_traverse.make_stream_tables checks.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "kernel_report.cuh"
#include "wide_common.cuh"

#define WT_RESTORE (-1)           // stack entry: back to the world-space ray
#define WT_K 16                   // stream_traverse.K_PORTALS: a pass's window
#define WT_PORTAL_BASE (1 << 22)  // bvh/stream.PORTAL_BASE
#define WT_ROOT_BITS 28           // page pass: global root rows below 2^28

enum { WT_PRIMARY = 0, WT_CLOSEST = 1, WT_ANY = 2 };
enum { WL_MERGED = 0, WL_TWO_LEVEL = 1, WL_RESIDENT = 2, WL_PAGE = 3 };

constexpr int WP_THREADS = 128;   // 4 warps a block
constexpr int WP_MIN_BLOCKS = 8;  // 32 warps an SM: at most 64 registers a thread
constexpr unsigned WP_FETCH_MIN = 12;  // a warp fetches once fewer lanes still traverse
constexpr unsigned WP_LEAF_MIN = 12;   // leaf phase once this many lanes hold a parked leaf
constexpr unsigned WP_STEP_MIN = 4;    // ... or fewer lanes can take a node step
// The resident pass's walks are a few nodes long: a warp fetches 32 rays
// (one atomicAdd) only once all its lanes are done, and retires them
// together, so their list stores coalesce (PERF.md has the timings; the page
// pass fetches as the wide walk does).
constexpr unsigned WP_RESIDENT_FETCH_MIN = 1;
constexpr int WP_NONE = INT_MIN;  // no item, no parked leaf
constexpr unsigned WP_FULL = 0xffffffffu;

// Counters of the instrumented instantiation (STATS): per lane, the visits
// (interior nodes slab-tested, leaf rows tested, instance rows entered,
// triangles tested); per warp, the steps of the node phase, the leaf phases
// that tested a leaf, the fetches, and (resident pass) the rounds of inline
// leaf tests: in each node step, the most leaf rows a lane tested.
enum {
  WP_NODES, WP_LEAVES, WP_INSTANCES, WP_TRIANGLES,
  WP_NODE_STEPS, WP_LEAF_PHASES, WP_FETCHES, WP_LEAF_ROUNDS, WP_NUM_STATS
};

// What the paged passes (WtPaged) and the primary wave (WtUv) add to the
// walk's arguments: a trailing argument of their kernels alone (the `Extra`
// pack, empty for the closest and any roles on merged and two-level
// tables). Every paged-only and primary-only statement sits under `if
// constexpr`, so the closest and any kernels compile as they did before the
// paged passes and the primary wave joined the walk (the same registers
// and spills; an unused helper lambda had cost K2's any-hit kernel two
// registers).
struct WtPaged {
  int page_rows;           // page pass: rows a page
  const int* portal_page;  // page pass: (P,) page of each portal
  const int* portal_root;  // page pass: (P,) local root row in its page
  int skip;                // resident pass: the window's first index
  int* pid;                // (WT_K, R) portal ids, -1 past a ray's list
  float* pt;               // (WT_K, R) entry t, +inf past a ray's list
  int* ovf;                // resident pass: (R,) portals past the window
};
// What the primary wave adds: its u, v outputs, (R,) f32 each.
struct WtUv {
  float* u;
  float* v;
};
struct WtNone {};
__device__ __forceinline__ WtNone wt_paged_of() { return {}; }
__device__ __forceinline__ WtPaged wt_paged_of(const WtPaged& p) { return p; }
__device__ __forceinline__ WtNone wt_paged_of(const WtUv&) { return {}; }
__device__ __forceinline__ WtNone wt_uv_of() { return {}; }
__device__ __forceinline__ WtNone wt_uv_of(const WtPaged&) { return {}; }
__device__ __forceinline__ WtUv wt_uv_of(const WtUv& p) { return p; }

// Batcher's odd-even merge sort of n (a power of two) keys: comparator
// `index` of its network (-1, -1 past the last), and the network's size.
struct WtPair {
  int a, b;
};
__host__ __device__ constexpr WtPair wt_oem_pair(int n, int index) {
  int c = 0;
  for (int p = 1; p < n; p <<= 1)
    for (int k = p; k >= 1; k >>= 1)
      for (int j = k % p; j + k < n; j += 2 * k)
        for (int i = 0; i < k; ++i)
          if (i + j + k < n && (i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            if (c == index) return {i + j, i + j + k};
            ++c;
          }
  return {-1, -1};
}
__host__ __device__ constexpr int wt_oem_size(int n) {
  int c = 0;
  while (wt_oem_pair(n, c).a >= 0) ++c;
  return c;
}

// Ascending sort of the first N 64-bit keys of `e` in registers: the
// network's comparators one template instance each, every index a constant.
template <int N, int C = 0>
__device__ __forceinline__ void wt_sort_net(unsigned long long* e) {
  if constexpr (C < wt_oem_size(N)) {
    constexpr WtPair q = wt_oem_pair(N, C);
    const unsigned long long a = e[q.a], b = e[q.b];
    e[q.a] = a < b ? a : b;
    e[q.b] = a < b ? b : a;
    wt_sort_net<N, C + 1>(e);
  }
}

template <int MODE, int LAYOUT, bool STATS, typename... Extra>
__global__ void __launch_bounds__(WP_THREADS, WP_MIN_BLOCKS)
wt_walk_kernel(const float* __restrict__ nodes, const float* __restrict__ rows,
               int inst_rows, const float* __restrict__ ray_o,
               const float* __restrict__ ray_d, const float* __restrict__ t_max, int R,
               int* __restrict__ next_ray, float* __restrict__ t_out,
               int* __restrict__ tri_out, int* __restrict__ inst_out,
               uint8_t* __restrict__ occ_out, unsigned long long* __restrict__ stats,
               Extra... extra) {
  constexpr bool TWO_LEVEL = LAYOUT == WL_TWO_LEVEL;
  constexpr bool RECORD = LAYOUT == WL_RESIDENT;  // portals recorded, leaves inline
  constexpr bool SEEDED = LAYOUT == WL_PAGE;      // stack seeded with the portals
  constexpr bool PAGED = RECORD || SEEDED;        // t_out / tri_out, not occ_out
  constexpr bool PRIMARY = MODE == WT_PRIMARY;    // closest hit with u, v
  constexpr bool NEAREST = MODE != WT_ANY;        // the closest hit: cull by the best
  constexpr bool INLINE = RECORD || (PRIMARY && TWO_LEVEL);  // leaves tested at once
  constexpr unsigned FETCH_MIN = RECORD ? WP_RESIDENT_FETCH_MIN : WP_FETCH_MIN;
  const auto pg = wt_paged_of(extra...);  // WtNone but for the paged passes
  const auto uv = wt_uv_of(extra...);     // WtNone but for the primary wave
  unsigned long long stack[WT_STACK];  // ref << 32 | key bits
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;

  int ray = -1;  // the lane's ray, -1 when empty
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;
  float tm = 0.0f, best_t = 0.0f;
  int best_tri = -1;  // ANY: >= 0 once occluded
  int best_inst = -1;
  float best_u = 0.0f, best_v = 0.0f;  // primary: the best hit's barycentrics
  // Two-level: the instance row whose space the ray is in (-1: world), and
  // that of the parked leaf, which keeps its space while the lane goes on
  // through RESTORE and instance rows.
  int cur_row = -1, parked_row = -1;
  int cur = WP_NONE;  // the next node; or a leaf row waiting for the parked one
  float cur_t = 0.0f;
  int parked = WP_NONE;  // a parked leaf row
  int sp = 0;
  int cnt = 0, ovf = 0;  // resident pass: portals enumerated, past the window
  bool exhausted = false;
  unsigned long long lane_stats[4] = {0, 0, 0, 0};
  unsigned long long warp_stats[4] = {0, 0, 0, 0};
  unsigned inline_leaves = 0;  // STATS, inline leaves: leaf rows of this node step

  auto push = [&](int ref, float key) {
    if (sp < WT_STACK)  // make_tables rules out a full stack
      stack[sp++] = ((unsigned long long)(unsigned)ref << 32) | __float_as_uint(key);
  };
  // The next entry that may hold a closer hit into cur / cur_t, or WP_NONE.
  auto pop = [&]() {
    cur = WP_NONE;
    while (sp > 0) {
      const unsigned long long e = stack[--sp];
      const float key = __uint_as_float((unsigned)e);
      if (NEAREST && key >= best_t) continue;
      cur = (int)(e >> 32);
      cur_t = key;
      return;
    }
  };
  // The lane's ray in the space of instance row `inst_row` (-1: the world
  // ray), from the ray arrays.
  auto ray_in = [&](int inst_row, float& px, float& py, float& pz, float& qx, float& qy,
                    float& qz) {
    const float wox = __ldg(ray_o + 3 * ray), woy = __ldg(ray_o + 3 * ray + 1),
                woz = __ldg(ray_o + 3 * ray + 2);
    const float wdx = __ldg(ray_d + 3 * ray), wdy = __ldg(ray_d + 3 * ray + 1),
                wdz = __ldg(ray_d + 3 * ray + 2);
    if (inst_row < 0) {
      px = wox; py = woy; pz = woz;
      qx = wdx; qy = wdy; qz = wdz;
      return;
    }
    const float* m = rows + (size_t)inst_row * WT_ROW + 2;
    float k[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) k[c] = __ldg(m + c);
    px = k[0] * wox + k[1] * woy + k[2] * woz + k[3];
    py = k[4] * wox + k[5] * woy + k[6] * woz + k[7];
    pz = k[8] * wox + k[9] * woy + k[10] * woz + k[11];
    qx = k[0] * wdx + k[1] * wdy + k[2] * wdz;
    qy = k[4] * wdx + k[5] * wdy + k[6] * wdz;
    qz = k[8] * wdx + k[9] * wdy + k[10] * wdz;
  };
  auto enter = [&](int inst_row) {  // the current ray into that space
    cur_row = inst_row;
    ray_in(inst_row, ox, oy, oz, dx, dy, dz);
    ix = wt_inv1(dx); iy = wt_inv1(dy); iz = wt_inv1(dz);
  };
  // Up to the next interior node: RESTORE and instance rows (two-level: the
  // leading `inst_rows` leaf rows) are taken on the way, a leaf row is
  // parked (resident pass: tested at once); a second leaf row waits in cur
  // for the leaf phase.
  auto advance = [&]() {
    if (NEAREST && cur != WP_NONE && cur_t >= best_t) pop();  // a leaf phase ran
    while (cur != WP_NONE && cur < 0) {
      if (TWO_LEVEL && cur == WT_RESTORE) {  // leave the BLAS
        enter(-1);
        pop();
        continue;
      }
      const int row_id = -cur - 2;
      if (TWO_LEVEL && row_id < inst_rows) {
        // Instance row: the object-space ray, RESTORE pushed, the BLAS
        // root next with the instance's entry key.
        enter(row_id);
        push(WT_RESTORE, -INFINITY);  // never culled
        cur = (int)__ldg(rows + (size_t)row_id * WT_ROW + 14);
        if (STATS) ++lane_stats[WP_INSTANCES];
        continue;
      }
      if constexpr (INLINE) {
        // The lane's own leaf test, slots in order, strict < (the plain
        // version's fold), before its next slab test.
        const float* row = rows + (size_t)row_id * WT_ROW;
        const int count = (int)__ldg(row);
        if (STATS) {
          ++lane_stats[WP_LEAVES];
          lane_stats[WP_TRIANGLES] += count;
          ++inline_leaves;
        }
        for (int j = 0; j < WT_LEAF_CAP; ++j) {
          if (j >= count) break;
          float t, u, w;
          if (wt_tri_hit(row + 16 + 9 * j, ox, oy, oz, dx, dy, dz,
                         MODE == WT_ANY ? tm : best_t, t, u, w)) {
            if (MODE == WT_ANY) {  // occluded: the traversal ends
              best_t = 0.0f;
              best_tri = 0;
              cur = WP_NONE;
              sp = 0;
              return;
            }
            best_t = t;
            best_tri = (int)__ldg(row + 1 + j);
            if constexpr (PRIMARY) {
              if (TWO_LEVEL)
                best_inst = cur_row < 0 ? -1 : (int)__ldg(rows + (size_t)cur_row * WT_ROW + 1);
              best_u = u;
              best_v = w;
            }
          }
        }
        pop();
        continue;
      }
      if (parked != WP_NONE) return;
      parked = row_id;
      parked_row = cur_row;
      pop();
    }
  };

  while (true) {
    // ---- retire: a lane whose traversal ended writes its result ----
    if (ray >= 0 && cur == WP_NONE && parked == WP_NONE) {
      if constexpr (SEEDED) {  // the running best, in place (any hit: t 0, tri 0)
        if (MODE == WT_ANY) {
          if (best_tri >= 0) {
            t_out[ray] = 0.0f;
            tri_out[ray] = 0;
          }
        } else {
          t_out[ray] = best_t;
          tri_out[ray] = best_tri;
        }
      } else if (MODE == WT_ANY && !PAGED) {
        occ_out[ray] = best_tri >= 0 ? 1 : 0;
      } else {
        t_out[ray] = best_tri >= 0 ? best_t : INFINITY;
        tri_out[ray] = best_tri;
        if (TWO_LEVEL) inst_out[ray] = best_inst;
      }
      if constexpr (PRIMARY) {
        uv.u[ray] = best_u;
        uv.v[ray] = best_v;
      }
      if constexpr (RECORD) {  // the list's tail past the recorded slots
        pg.ovf[ray] = ovf;
        for (int k = max(cnt - pg.skip, 0); k < WT_K; ++k) {
          pg.pid[(size_t)k * R + ray] = -1;
          pg.pt[(size_t)k * R + ray] = INFINITY;
        }
      }
      ray = -1;
    }

    // ---- fetch: rays for the empty lanes, one atomicAdd a round ----
    unsigned have = __ballot_sync(WP_FULL, ray >= 0);
    if (!exhausted && have != WP_FULL && (unsigned)__popc(have) < FETCH_MIN) {
      do {
        const unsigned empty = ~have;
        const int need = __popc(empty);
        int base = 0;
        if (lane == 0) base = atomicAdd(next_ray, need);
        base = __shfl_sync(WP_FULL, base, 0);
        if (STATS) ++warp_stats[2];
        // Page pass: the fetched ray's recorded portals as sort keys
        // (entry t bits << 32 | slot << WT_ROOT_BITS | global root row),
        // ~0 past its list; n of them.
        unsigned long long e[SEEDED ? WT_K : 1];
        int n = 0;
        if constexpr (SEEDED) {
#pragma unroll
          for (int k = 0; k < WT_K; ++k) e[k] = ~0ull;
        }
        if (ray < 0) {
          const int i = base + __popc(empty & below);
          if (i < R) {
            if constexpr (SEEDED) {
              const int p0 = __ldg(pg.pid + i);
              const int held = tri_out[i];
              if (p0 >= 0 && !(MODE == WT_ANY && held >= 0)) {
                ray = i;
                enter(-1);
                tm = __ldg(t_max + i);
                best_t = t_out[i];
                best_tri = held;
                sp = 0;
                // The list fills from slot 0: four slots a round while the
                // last one read is filled.
                bool more = true;
#pragma unroll
                for (int k = 0; k < WT_K; ++k) {
                  if (k > 0 && (k & 3) == 0) more = more && e[k - 1] != ~0ull;
                  const int p = k == 0 ? p0 : more ? __ldg(pg.pid + (size_t)k * R + i) : -1;
                  if (p >= 0) {
                    const unsigned bits =
                        __float_as_uint(__ldg(pg.pt + (size_t)k * R + i)) & 0x7fffffffu;
                    const unsigned root = (unsigned)(__ldg(pg.portal_page + p) * pg.page_rows +
                                                     __ldg(pg.portal_root + p));
                    e[k] = ((unsigned long long)bits << 32) |
                           ((unsigned long long)k << WT_ROOT_BITS) | root;
                    ++n;
                  }
                }
              }
            } else {
              const float m = __ldg(t_max + i);
              if (m > 0.0f) {
                ray = i;
                enter(-1);
                tm = m;
                best_t = m;
                best_tri = -1;
                best_inst = -1;
                if constexpr (PRIMARY) {
                  best_u = 0.0f;
                  best_v = 0.0f;
                }
                cur = 0;  // the root
                cur_t = 0.0f;
                sp = 0;
                if constexpr (RECORD) {
                  cnt = 0;
                  ovf = 0;
                }
              } else if (MODE == WT_ANY && !PAGED) {  // a dead ray: its miss, no lane
                occ_out[i] = 0;
              } else {
                t_out[i] = INFINITY;
                tri_out[i] = -1;
                if (TWO_LEVEL) inst_out[i] = -1;
                if constexpr (PRIMARY) {
                  uv.u[i] = 0.0f;
                  uv.v[i] = 0.0f;
                }
                if constexpr (RECORD) {  // and an empty list
                  pg.ovf[i] = 0;
#pragma unroll
                  for (int k = 0; k < WT_K; ++k) {
                    pg.pid[(size_t)k * R + i] = -1;
                    pg.pt[(size_t)k * R + i] = INFINITY;
                  }
                }
              }
            }
          }
        }
        if constexpr (SEEDED) {
          // Nearest first: the sorting network the warp's longest new list
          // needs, then the portals pushed far to near, the nearest taken.
          const int most = __reduce_max_sync(WP_FULL, (unsigned)n);
          if (most > 8)
            wt_sort_net<16>(e);
          else if (most > 4)
            wt_sort_net<8>(e);
          else if (most > 1)
            wt_sort_net<4>(e);
          if (n > 0) {
            const float near = __uint_as_float((unsigned)(e[0] >> 32));
            if (NEAREST && near >= best_t) {
              ray = -1;  // every portal lies past the best hit: nothing to do
            } else {
#pragma unroll
              for (int k = WT_K - 1; k >= 1; --k)
                if (k < n)
                  push((int)(e[k] & ((1u << WT_ROOT_BITS) - 1u)),
                       __uint_as_float((unsigned)(e[k] >> 32)));
              cur = (int)(e[0] & ((1u << WT_ROOT_BITS) - 1u));
              cur_t = near;
            }
          }
        }
        if (base + need >= R) exhausted = true;
        have = __ballot_sync(WP_FULL, ray >= 0);
        // The resident pass takes one fetch a round: its dead rays leave
        // their lanes empty until the warp's next round.
      } while (!exhausted && (RECORD ? have == 0 : have != WP_FULL));
    }
    if (have == 0) break;  // only once the counter has run out

    // ---- node phase: one interior node a lane a step ----
    while (true) {
      if constexpr (STATS && INLINE) {
        warp_stats[3] += __reduce_max_sync(WP_FULL, inline_leaves);
        inline_leaves = 0;
      }
      // One reduction counts the lanes that can take a node step, hold a
      // parked leaf and still traverse (a byte each).
      const bool can = ray >= 0 && cur >= 0;
      const unsigned counts = __reduce_add_sync(
          WP_FULL, (can ? 1u : 0u) | (parked != WP_NONE ? 1u << 8 : 0u) |
                       (ray >= 0 && (cur != WP_NONE || parked != WP_NONE) ? 1u << 16 : 0u));
      const unsigned stepping = counts & 0xffu, holding = (counts >> 8) & 0xffu;
      if (stepping == 0 || holding >= WP_LEAF_MIN || (holding && stepping < WP_STEP_MIN)) break;
      if (!exhausted && (counts >> 16) < FETCH_MIN) break;
      if (STATS) ++warp_stats[0];
      if (!can) continue;
      // Slab test of the 8 children, two a float4 triple; refs at [48, 56).
      const float4* n4 = reinterpret_cast<const float4*>(nodes + (size_t)cur * WT_ROW);
      const float cull = MODE == WT_ANY ? tm : best_t;
      int ref[8];
      float key[8];
      {
        const float4 r0 = __ldg(n4 + 12), r1 = __ldg(n4 + 13);
        ref[0] = (int)r0.x; ref[1] = (int)r0.y; ref[2] = (int)r0.z; ref[3] = (int)r0.w;
        ref[4] = (int)r1.x; ref[5] = (int)r1.y; ref[6] = (int)r1.z; ref[7] = (int)r1.w;
      }
      if constexpr (SEEDED) {  // page-local refs -> rows of the flat page array
        const int page_base = cur - cur % pg.page_rows;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          ref[c] = ref[c] >= 0 ? ref[c] + page_base : ref[c] <= -2 ? ref[c] - page_base : ref[c];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 a = __ldg(n4 + 3 * p), b = __ldg(n4 + 3 * p + 1), c = __ldg(n4 + 3 * p + 2);
        key[2 * p] = wt_child_key(a.x, a.y, a.z, a.w, b.x, b.y, ref[2 * p], ox, oy, oz, ix, iy,
                                  iz, cull);
        key[2 * p + 1] = wt_child_key(b.z, b.w, c.x, c.y, c.z, c.w, ref[2 * p + 1], ox, oy, oz,
                                      ix, iy, iz, cull);
      }
      if constexpr (RECORD) {  // portal children: recorded in slot order, not pushed
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (key[c] < INFINITY && ref[c] <= -(2 + WT_PORTAL_BASE)) {
            const int k = cnt - pg.skip;
            if (k >= 0 && k < WT_K) {
              pg.pid[(size_t)k * R + ray] = -ref[c] - 2 - WT_PORTAL_BASE;
              pg.pt[(size_t)k * R + ray] = key[c];
            } else if (k >= WT_K) {
              ++ovf;
            }
            ++cnt;
            key[c] = INFINITY;
          }
        }
      }
      wt_sort8(key, ref);
      // The nearest child is the next item; the rest go far -> near.
#pragma unroll
      for (int c = 7; c >= 1; --c)
        if (key[c] < INFINITY) push(ref[c], key[c]);
      if (key[0] < INFINITY) {
        cur = ref[0];
        cur_t = key[0];
      } else {
        pop();
      }
      if (STATS) ++lane_stats[WP_NODES];
      advance();
    }

    // ---- leaf phase: every parked leaf, against the best hit of now ----
    // The warp's parked leaves' triangles are laid end to end (a scan of
    // the counts) and tested 32 at a time, one a lane; each owner takes the
    // least (t, slot) of its hits in a round (a segmented minimum), which is
    // what its own loop over the slots in order, strict <, would keep.
    if constexpr (!INLINE) {
      const bool holds = parked != WP_NONE;
      if (STATS && __ballot_sync(WP_FULL, holds) != 0) ++warp_stats[1];
      const float* my_row = rows + (size_t)(holds ? parked : 0) * WT_ROW;
      const int count = holds ? (int)__ldg(my_row) : 0;
      int end = count;  // inclusive scan of the counts
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(WP_FULL, end, off);
        if (lane >= off) end += x;
      }
      const int start = end - count;
      const int total = __shfl_sync(WP_FULL, end, 31);
      // The leaf's ray: the current one, or (two-level, the lane having
      // moved on) the ray in the leaf's own space.
      float lox = ox, loy = oy, loz = oz, ldx = dx, ldy = dy, ldz = dz;
      if (TWO_LEVEL && holds && parked_row != cur_row)
        ray_in(parked_row, lox, loy, loz, ldx, ldy, ldz);
      if (STATS && holds) {
        ++lane_stats[WP_LEAVES];
        lane_stats[WP_TRIANGLES] += count;
      }
      for (int base = 0; base < total; base += 32) {
        const int v = base + lane;
        int owner = 0;  // the first lane whose triangles end past v
#pragma unroll
        for (int step = 16; step >= 1; step >>= 1)
          if (__shfl_sync(WP_FULL, end, owner + step - 1) <= v) owner += step;
        const int j = v - __shfl_sync(WP_FULL, start, owner);
        const int leaf = __shfl_sync(WP_FULL, holds ? parked : 0, owner);
        const float px = __shfl_sync(WP_FULL, lox, owner), py = __shfl_sync(WP_FULL, loy, owner),
                    pz = __shfl_sync(WP_FULL, loz, owner), qx = __shfl_sync(WP_FULL, ldx, owner),
                    qy = __shfl_sync(WP_FULL, ldy, owner), qz = __shfl_sync(WP_FULL, ldz, owner);
        const float limit = __shfl_sync(WP_FULL, MODE == WT_ANY ? tm : best_t, owner);
        unsigned long long key = ~0ull;  // (t bits, slot) of a hit
        float u = 0.0f, w = 0.0f;
        if (v < total) {
          float t;
          if (wt_tri_hit(rows + (size_t)leaf * WT_ROW + 16 + 9 * j, px, py, pz, qx, qy, qz,
                         limit, t, u, w))
            key = ((unsigned long long)__float_as_uint(t) << 32) | (unsigned)j;
        }
        // Segmented minimum toward the first lane of each owner's run.
        const int mine = v < total ? owner : -1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned long long k2 = __shfl_down_sync(WP_FULL, key, off);
          const int o2 = __shfl_down_sync(WP_FULL, mine, off);
          if (lane + off < 32 && o2 == mine && k2 < key) key = k2;
        }
        // Each owner reads the head of its run in this round.
        const bool in_round = holds && start < base + 32 && end > base;
        const int head = in_round ? max(start, base) - base : 0;
        const unsigned long long got = __shfl_sync(WP_FULL, key, head);
        const bool won = in_round && got != ~0ull;
        const int slot = (int)(got & 0xffffffffu);
        if constexpr (PRIMARY) {
          // u, v from the lane that tested the winning slot in this round.
          const int src = won ? start + slot - base : lane;
          const float gu = __shfl_sync(WP_FULL, u, src), gv = __shfl_sync(WP_FULL, w, src);
          if (won) {
            best_u = gu;
            best_v = gv;
          }
        }
        if (won) {
          best_tri = (int)__ldg(my_row + 1 + slot);
          if (MODE == WT_ANY) {  // occluded: the traversal ends
            cur = WP_NONE;
            sp = 0;
          } else {
            best_t = __uint_as_float((unsigned)(got >> 32));
            if (TWO_LEVEL)
              best_inst = parked_row < 0 ? -1
                                         : (int)__ldg(rows + (size_t)parked_row * WT_ROW + 1);
          }
        }
      }
      parked = WP_NONE;
    }
    if (ray >= 0) advance();  // past a waiting leaf row, or a node culled by now
  }

  if (STATS) {
#pragma unroll
    for (int k = 0; k < 4; ++k) atomicAdd(stats + k, lane_stats[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) atomicAdd(stats + WP_NODE_STEPS + k, warp_stats[k]);
    }
  }
}

// The kernel of a walk (the paged passes' and the primary wave's with their
// trailing argument).
using WtWalkFn = void (*)(const float*, const float*, int, const float*, const float*,
                          const float*, int, int*, float*, int*, int*, uint8_t*,
                          unsigned long long*);
using WtPagedWalkFn = void (*)(const float*, const float*, int, const float*, const float*,
                               const float*, int, int*, float*, int*, int*, uint8_t*,
                               unsigned long long*, WtPaged);
using WtUvWalkFn = void (*)(const float*, const float*, int, const float*, const float*,
                            const float*, int, int*, float*, int*, int*, uint8_t*,
                            unsigned long long*, WtUv);
template <int MODE, int LAYOUT, bool STATS>
static auto wt_walk_entry() {
  if constexpr (LAYOUT >= WL_RESIDENT)
    return static_cast<WtPagedWalkFn>(&wt_walk_kernel<MODE, LAYOUT, STATS, WtPaged>);
  else if constexpr (MODE == WT_PRIMARY)
    return static_cast<WtUvWalkFn>(&wt_walk_kernel<MODE, LAYOUT, STATS, WtUv>);
  else
    return static_cast<WtWalkFn>(&wt_walk_kernel<MODE, LAYOUT, STATS>);
}

// Blocks of the walk's kernel an SM holds, and the card's SM count
// (occupancy API, asked once a process).
template <int MODE, int LAYOUT, bool STATS>
static int wt_walk_grid(int* per_sm, int* sms) {
  static int cached_per_sm = 0, cached_sms = 0;
  if (cached_per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &cached_per_sm, wt_walk_entry<MODE, LAYOUT, STATS>(), WP_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (cached_per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  *per_sm = cached_per_sm;
  *sms = cached_sms;
  return 0;
}

// One launch of the walk over R rays: the grid is the blocks the rays need,
// at most every SM full; the ray counter `next_ray` is zeroed on the stream
// first. `pg` reaches the paged passes' kernels, `uv` the primary wave's.
// Returns the cudaError_t of the launch (0 on success).
template <int MODE, int LAYOUT, bool STATS>
static int wt_walk_launch(cudaStream_t s, const float* nodes, const float* rows, int inst_rows,
                          const float* ray_o, const float* ray_d, const float* t_max, int R,
                          int* next_ray, float* t_out, int* tri_out, int* inst_out,
                          uint8_t* occ_out, unsigned long long* stats, const WtPaged& pg,
                          const WtUv& uv = {}) {
  int per_sm = 0, sms = 0;
  int err = wt_walk_grid<MODE, LAYOUT, STATS>(&per_sm, &sms);
  if (err != 0) return err;
  const int need = (R + WP_THREADS - 1) / WP_THREADS;
  const int blocks = need < per_sm * sms ? need : per_sm * sms;
  err = (int)cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (err != 0) return err;
  if constexpr (LAYOUT >= WL_RESIDENT)
    wt_walk_kernel<MODE, LAYOUT, STATS, WtPaged><<<blocks, WP_THREADS, 0, s>>>(
        nodes, rows, inst_rows, ray_o, ray_d, t_max, R, next_ray, t_out, tri_out, inst_out,
        occ_out, stats, pg);
  else if constexpr (MODE == WT_PRIMARY)
    wt_walk_kernel<MODE, LAYOUT, STATS, WtUv><<<blocks, WP_THREADS, 0, s>>>(
        nodes, rows, inst_rows, ray_o, ray_d, t_max, R, next_ray, t_out, tri_out, inst_out,
        occ_out, stats, uv);
  else
    wt_walk_kernel<MODE, LAYOUT, STATS><<<blocks, WP_THREADS, 0, s>>>(
        nodes, rows, inst_rows, ray_o, ray_d, t_max, R, next_ray, t_out, tri_out, inst_out,
        occ_out, stats);
  return (int)cudaGetLastError();
}
