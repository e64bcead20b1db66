// Wide (8-ary) BVH traversal for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package:
//   gpu_raytracer_tpu/ops/pallas_wide.py   `_kernel`            (primary wave,
//       closest hit with barycentrics; merged and two-level tables)
//       -> wt_primary_kernel, one thread per ray
//   gpu_raytracer_tpu/ops/pallas_gang.py   `_gang_flat_kernel`  (merged tables:
//       bounce waves, closest hit; NEE shadow waves, any hit)
//   gpu_raytracer_tpu/ops/pallas_gang.py   `_gang_kernel`       (the same roles
//       on two-level tables)
//       -> wt_walk_kernel, persistent warps (below)
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
// times or sit in different phases (node vs leaf). The primary kernel keeps
// the simple design: one thread a ray, the stack in local memory.
//
// wt_walk_kernel (bounce and shadow waves, CLOSEST and ANY): the
// persistent-warp walk of wide_walk.cuh (ray fetch, the near child in
// registers, postponed leaves tested by the whole warp), instantiated here
// for merged and two-level tables.
//
// Semantics against the plain version (ops/wide_traverse.trace_plain): only
// the order of a ray's visits changes, so the closest t is the minimum over
// the same triangle tests (bit-equal), any hit is equal, and tri / inst may
// differ only at an exact tie in t.
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

// ---------------------------------------------------------------------------
// Primary wave (K1): one thread a ray, the stack in local memory.
// ---------------------------------------------------------------------------

template <bool TWO_LEVEL>
__global__ void __launch_bounds__(128)
wt_primary_kernel(const float* __restrict__ nodes, const float* __restrict__ rows,
                  const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                  const float* __restrict__ t_max, int R,
                  float* __restrict__ t_out, int* __restrict__ tri_out,
                  int* __restrict__ inst_out,
                  float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;

  const float wox = ray_o[3 * i + 0], woy = ray_o[3 * i + 1], woz = ray_o[3 * i + 2];
  const float wdx = ray_d[3 * i + 0], wdy = ray_d[3 * i + 1], wdz = ray_d[3 * i + 2];
  const float tm = t_max[i];
  // The current ray: the world ray, or an instance's object-space ray.
  float ox = wox, oy = woy, oz = woz;
  float dx = wdx, dy = wdy, dz = wdz;
  float ix = wt_inv1(dx), iy = wt_inv1(dy), iz = wt_inv1(dz);
  int cur_inst = -1;

  float best_t = tm;
  int best_tri = -1, best_inst = -1;
  float best_u = 0.0f, best_v = 0.0f;

  int st_ref[WT_STACK];
  float st_t[WT_STACK];
  int sp = 0;
  if (tm > 0.0f) {  // t_max <= 0 marks a dead lane (padding, masked rays)
    st_ref[0] = 0;
    st_t[0] = 0.0f;
    sp = 1;
  }

  while (sp > 0) {
    --sp;
    const int v = st_ref[sp];
    const float et = st_t[sp];
    if (et >= best_t) continue;  // cannot hold a closer hit

    if (v >= 0) {
      // ---- interior node: slab-test its 8 children, push far -> near ----
      float b[56];
      wt_load_node(nodes + (size_t)v * WT_ROW, b);
      float key[8];
      int ref[8];
      wt_child_keys(b, ox, oy, oz, ix, iy, iz, best_t, key, ref);
      wt_sort8(key, ref);
      wt_push_sorted<WT_STACK>(key, ref, st_ref, st_t, sp);
    } else if (TWO_LEVEL && v == WT_RESTORE) {
      // ---- RESTORE: leave the BLAS, back to the world-space ray ----
      ox = wox; oy = woy; oz = woz;
      dx = wdx; dy = wdy; dz = wdz;
      ix = wt_inv1(dx); iy = wt_inv1(dy); iz = wt_inv1(dz);
      cur_inst = -1;
    } else {
      const float* row = rows + (size_t)(-v - 2) * WT_ROW;
      const float kind = __ldg(row);
      if (TWO_LEVEL && kind < 0.0f) {
        // ---- instance row: object-space ray, push RESTORE + BLAS root ----
        float m[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) m[k] = __ldg(row + 2 + k);
        ox = m[0] * wox + m[1] * woy + m[2] * woz + m[3];
        oy = m[4] * wox + m[5] * woy + m[6] * woz + m[7];
        oz = m[8] * wox + m[9] * woy + m[10] * woz + m[11];
        dx = m[0] * wdx + m[1] * wdy + m[2] * wdz;
        dy = m[4] * wdx + m[5] * wdy + m[6] * wdz;
        dz = m[8] * wdx + m[9] * wdy + m[10] * wdz;
        ix = wt_inv1(dx); iy = wt_inv1(dy); iz = wt_inv1(dz);
        cur_inst = (int)__ldg(row + 1);
        if (sp < WT_STACK) {
          st_ref[sp] = WT_RESTORE;
          st_t[sp] = -INFINITY;  // never culled
          ++sp;
        }
        if (sp < WT_STACK) {
          st_ref[sp] = (int)__ldg(row + 14);
          st_t[sp] = et;
          ++sp;
        }
        continue;
      }
      // ---- leaf row: up to LEAF_CAP edge-form triangles ----
      const int count = (int)kind;
      for (int j = 0; j < WT_LEAF_CAP; ++j) {
        if (j >= count) break;
        float t, u, w;
        if (wt_tri_hit(row + 16 + 9 * j, ox, oy, oz, dx, dy, dz, best_t, t, u, w)) {
          best_t = t;
          best_tri = (int)__ldg(row + 1 + j);
          if (TWO_LEVEL) best_inst = cur_inst;
          best_u = u;
          best_v = w;
        }
      }
    }
  }

  t_out[i] = best_tri >= 0 ? best_t : INFINITY;
  tri_out[i] = best_tri;
  if (TWO_LEVEL) inst_out[i] = best_inst;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

template <bool TWO_LEVEL>
static int wt_primary_launch(cudaStream_t s, const float* nodes, const float* rows,
                             const float* ray_o, const float* ray_d, const float* t_max,
                             int R, float* t_out, int* tri_out, int* inst_out, float* u_out,
                             float* v_out) {
  const int threads = 128;
  wt_primary_kernel<TWO_LEVEL><<<(R + threads - 1) / threads, threads, 0, s>>>(
      nodes, rows, ray_o, ray_d, t_max, R, t_out, tri_out, inst_out, u_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int wt_stack_capacity(void) { return WT_STACK; }

extern "C" int wt_num_stats(void) { return WP_NUM_STATS; }

// mode: 0 primary (t, tri, u, v), 1 closest (t, tri), 2 any (occ); two_level
// adds inst (closest roles), and its leaf rows [0, inst_rows) are its
// instance rows. The closest and any roles run wt_walk_kernel with the ray
// counter `next_ray` (one int32, zeroed here on the stream); with `stats`
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
  if (mode == WT_PRIMARY) {
    return two_level ? wt_primary_launch<true>(s, nodes, rows, ray_o, ray_d, t_max, R, t_out,
                                               tri_out, inst_out, u_out, v_out)
                     : wt_primary_launch<false>(s, nodes, rows, ray_o, ray_d, t_max, R,
                                                t_out, tri_out, inst_out, u_out, v_out);
  }
  const WtPaged none = {};
#define WT_ARGS s, nodes, rows, inst_rows, ray_o, ray_d, t_max, R, next_ray, t_out, tri_out, \
                inst_out, occ_out, stats, none
  const int sel = (mode == WT_ANY ? 4 : 0) + (two_level ? 2 : 0) + (stats ? 1 : 0);
  switch (mode == WT_CLOSEST || mode == WT_ANY ? sel : -1) {
    case 0: return wt_walk_launch<WT_CLOSEST, WL_MERGED, false>(WT_ARGS);
    case 1: return wt_walk_launch<WT_CLOSEST, WL_MERGED, true>(WT_ARGS);
    case 2: return wt_walk_launch<WT_CLOSEST, WL_TWO_LEVEL, false>(WT_ARGS);
    case 3: return wt_walk_launch<WT_CLOSEST, WL_TWO_LEVEL, true>(WT_ARGS);
    case 4: return wt_walk_launch<WT_ANY, WL_MERGED, false>(WT_ARGS);
    case 5: return wt_walk_launch<WT_ANY, WL_MERGED, true>(WT_ARGS);
    case 6: return wt_walk_launch<WT_ANY, WL_TWO_LEVEL, false>(WT_ARGS);
    case 7: return wt_walk_launch<WT_ANY, WL_TWO_LEVEL, true>(WT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WT_ARGS
}

// What the compiler and the occupancy API report for the kernel of a role
// (the uninstrumented one; wt_info_of). Returns a cudaError_t.
extern "C" int wt_kernel_info(int mode, int two_level, int* out) {
  switch ((mode << 1) | (two_level ? 1 : 0)) {
    case 0: return wt_info_of(wt_primary_kernel<false>, 128, out);
    case 1: return wt_info_of(wt_primary_kernel<true>, 128, out);
    case 2: return wt_info_of(wt_walk_entry<WT_CLOSEST, WL_MERGED, false>(), WP_THREADS, out);
    case 3: return wt_info_of(wt_walk_entry<WT_CLOSEST, WL_TWO_LEVEL, false>(), WP_THREADS, out);
    case 4: return wt_info_of(wt_walk_entry<WT_ANY, WL_MERGED, false>(), WP_THREADS, out);
    case 5: return wt_info_of(wt_walk_entry<WT_ANY, WL_TWO_LEVEL, false>(), WP_THREADS, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
