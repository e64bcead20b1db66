// Wide (8-ary) BVH traversal for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package:
//   gpu_raytracer_tpu/ops/pallas_wide.py   `_kernel`            (primary wave,
//       closest hit with barycentrics; merged and two-level tables)
//       -> wt_walk_kernel<WT_PRIMARY, ...>
//   gpu_raytracer_tpu/ops/pallas_gang.py   `_gang_flat_kernel`  (merged tables:
//       bounce waves, closest hit; NEE shadow waves, any hit)
//   gpu_raytracer_tpu/ops/pallas_gang.py   `_gang_kernel`       (the same roles
//       on two-level tables)
//       -> wt_walk_kernel<WT_CLOSEST | WT_ANY, ...>
// all on the persistent-warp walk (below).
// over the tables of bvh/wide.py:
//   nodes (N, 128) f32: child c bounds at [c*6, c*6+6), child ref at [48+c]
//                       (>= 0 node id | -1 empty | <= -2 leaf row -(row+2))
//   rows  (L, 128) f32: [0] triangle count (<= LEAF_CAP), [1+j] prim code
//                       (merged) or leaf-order triangle id (two-level),
//                       [16+9j, 16+9j+9) p0 | e1 | e2;
//                       or, two-level only, an instance row: [0] = -1,
//                       [1] instance id, [2, 14) 3x4 inverse transform,
//                       [14] BLAS root node id.
// MERGED tables (pack_wide_merged) hold one world-space tree. TWO_LEVEL
// tables (pack_wide_scene) hold a TLAS over instance rows and per-mesh BLAS
// trees in object space: an instance row moves the ray into object space,
// pushes RESTORE (-1) and continues at the BLAS root; popping RESTORE brings
// the world ray back. The TPU split between a block-synchronous kernel (one
// stack per 1024-ray tile) and per-128-ray-gang kernels exists because the
// TPU's vector unit runs its lanes in lockstep; a GPU lane keeps its own
// stack and reads `nodes` and `rows` directly.
//
// What bounds it on the card: dependent, divergent 512-byte row fetches
// (latency, not bandwidth: a Sponza-class table of ~20 MB stays resident in
// the 50 MB L2; one dependent row load costs ~160 ns from L2, ~70 ns from
// L1) and warp divergence between rays that leave the loop at different
// times or sit in different phases (node vs leaf).
//
// wt_walk_kernel (the primary wave with u, v, the bounce and shadow waves:
// PRIMARY, CLOSEST and ANY): the persistent-warp walk of wide_walk.cuh (ray
// fetch, the near child in registers, postponed leaves tested by the whole
// warp), instantiated here for merged and two-level tables.
//
// Semantics against the plain version (ops/wide_traverse.trace_plain): only
// the order of a ray's visits changes, so the closest t is the minimum over
// the same triangle tests (bit-equal), any hit is equal, and tri / inst may
// differ only at an exact tie in t (u, v are the named triangle's).
//
// Two-level invariants: wide_walk.cuh.
//
// Float semantics follow the TPU kernels (wide_common.cuh, whose slab test,
// child sort and triangle test stream_traverse.cu shares); the instance
// transform sums m0*x + m1*y + m2*z + m3 left to right.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "wide_walk.cuh"

extern "C" int wt_stack_capacity(void) { return WT_STACK; }

extern "C" int wt_num_stats(void) { return WP_NUM_STATS; }

// mode: 0 primary (t, tri, u, v), 1 closest (t, tri), 2 any (occ); two_level
// adds inst (closest roles), and its leaf rows [0, inst_rows) are its
// instance rows. Every role runs wt_walk_kernel with the ray counter
// `next_ray` (one int32, zeroed here on the stream); with `stats`
// (WP_NUM_STATS uint64, zeroed by the caller) its instrumented
// instantiation adds its counters there. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int wt_trace(int mode, int two_level, const float* nodes, const float* rows,
                        int inst_rows, const float* ray_o, const float* ray_d, const float* t_max,
                        int R, int* next_ray, unsigned long long* stats, float* t_out,
                        int* tri_out, int* inst_out, float* u_out, float* v_out,
                        uint8_t* occ_out, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const WtPaged none = {};
  const WtUv uv = {u_out, v_out};
#define WT_ARGS s, nodes, rows, inst_rows, ray_o, ray_d, t_max, R, next_ray, t_out, tri_out, \
                inst_out, occ_out, stats, none, uv
  const int sel = mode * 4 + (two_level ? 2 : 0) + (stats ? 1 : 0);
  switch (mode >= WT_PRIMARY && mode <= WT_ANY ? sel : -1) {
    case 0: return wt_walk_launch<WT_PRIMARY, WL_MERGED, false>(WT_ARGS);
    case 1: return wt_walk_launch<WT_PRIMARY, WL_MERGED, true>(WT_ARGS);
    case 2: return wt_walk_launch<WT_PRIMARY, WL_TWO_LEVEL, false>(WT_ARGS);
    case 3: return wt_walk_launch<WT_PRIMARY, WL_TWO_LEVEL, true>(WT_ARGS);
    case 4: return wt_walk_launch<WT_CLOSEST, WL_MERGED, false>(WT_ARGS);
    case 5: return wt_walk_launch<WT_CLOSEST, WL_MERGED, true>(WT_ARGS);
    case 6: return wt_walk_launch<WT_CLOSEST, WL_TWO_LEVEL, false>(WT_ARGS);
    case 7: return wt_walk_launch<WT_CLOSEST, WL_TWO_LEVEL, true>(WT_ARGS);
    case 8: return wt_walk_launch<WT_ANY, WL_MERGED, false>(WT_ARGS);
    case 9: return wt_walk_launch<WT_ANY, WL_MERGED, true>(WT_ARGS);
    case 10: return wt_walk_launch<WT_ANY, WL_TWO_LEVEL, false>(WT_ARGS);
    case 11: return wt_walk_launch<WT_ANY, WL_TWO_LEVEL, true>(WT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WT_ARGS
}

// What the compiler and the occupancy API report for the kernel of a role
// (the uninstrumented one; kernel_report). Returns a cudaError_t.
extern "C" int wt_kernel_info(int mode, int two_level, int* out) {
  switch ((mode << 1) | (two_level ? 1 : 0)) {
    case 0: return kernel_report((const void*)wt_walk_entry<WT_PRIMARY, WL_MERGED, false>(), WP_THREADS, out);
    case 1: return kernel_report((const void*)wt_walk_entry<WT_PRIMARY, WL_TWO_LEVEL, false>(), WP_THREADS, out);
    case 2: return kernel_report((const void*)wt_walk_entry<WT_CLOSEST, WL_MERGED, false>(), WP_THREADS, out);
    case 3: return kernel_report((const void*)wt_walk_entry<WT_CLOSEST, WL_TWO_LEVEL, false>(), WP_THREADS, out);
    case 4: return kernel_report((const void*)wt_walk_entry<WT_ANY, WL_MERGED, false>(), WP_THREADS, out);
    case 5: return kernel_report((const void*)wt_walk_entry<WT_ANY, WL_TWO_LEVEL, false>(), WP_THREADS, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
