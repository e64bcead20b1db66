// Traversal of paged wide-BVH tables for NVIDIA Hopper (sm_90a): the two
// passes of the streamed-tables path as instantiations of the persistent-warp
// walk of wide_walk.cuh.
//
// Replaces the two TPU kernels of the JAX package's streamed-tables path:
//   gpu_raytracer_tpu/ops/pallas_stream.py  `_resident_kernel`
//       -> wt_walk_kernel<MODE, WL_RESIDENT>  (st_resident)
//   gpu_raytracer_tpu/ops/pallas_stream.py  `_page_kernel`
//       -> wt_walk_kernel<MODE, WL_PAGE>      (st_page)
// over the tables of bvh/stream.py: a resident table (Rr, 128) f32 and pages
// (G, page_rows, 128) f32, each a unified local index space (row v >= 0 a
// wide node, ref <= -2 a leaf row -(ref+2), -1 empty); resident refs
// <= -(2 + PORTAL_BASE) are portals to the subtree rooted at row
// portal_root[pid] of page portal_page[pid].
//
// The resident pass walks the resident rows and records each ray's portals
// in its enumeration order (node visit order, then child slot order), the
// window [skip, skip + K) of them into slot-major (K, R) lists, the rest
// counted in ovf; it also writes the best resident hit (any hit: t 0 and tri
// 0 where occluded). Its leaves are tested inline, in the lane's own order,
// so the enumeration is a function of the ray alone and the host
// (ops/stream_traverse.py), which reruns the pass for the lanes whose list
// overflowed with the window advanced by K, loses no portal.
//
// The page pass seeds each lane's stack with its recorded portals, sorted
// nearest first, as global rows of the flat page array, and walks them as
// one traversal with postponed leaves and the warp's cooperative leaf phase,
// folding hits into the running best it reads and writes.
//
// What the TPU needed and Hopper does not (ROADMAP C18): gangs of 128 rays
// sharing a stack, popularity-sorted page rounds with M_SUB portals a gang,
// the 2 MiB page copy into VMEM and the 512-tile watchdog launch split. A
// lane here reads any page row from device memory through the 50 MB L2.
//
// What bounds it on the card: dependent divergent 512-byte row loads
// (latency), from a page array of hundreds of MB that does not stay in L2:
// more useful lanes in flight is the lever.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wide_walk.cuh"

// Layout constants, checked against the Python side at load
// (ops/_native.load).
extern "C" int st_window(void) { return WT_K; }
extern "C" int st_stack_capacity(void) { return WT_STACK; }
extern "C" int st_portal_base(void) { return WT_PORTAL_BASE; }
extern "C" int st_root_bits(void) { return WT_ROOT_BITS; }

// Resident pass over R rays: t_out, tri_out, ovf_out (R,), pid_out,
// pt_out (K, R) slot-major. `next_ray` is the walk's ray counter (one int32,
// zeroed here on the stream); with `stats` (WP_NUM_STATS uint64, zeroed by
// the caller) the instrumented instantiation adds its counters there.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int st_resident(int any_hit, const float* resident, const float* ray_o,
                           const float* ray_d, const float* t_max, int R, int skip,
                           int* next_ray, unsigned long long* stats, float* t_out,
                           int* tri_out, int* pid_out, float* pt_out, int* ovf_out,
                           void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  WtPaged pg = {};
  pg.skip = skip;
  pg.pid = pid_out;
  pg.pt = pt_out;
  pg.ovf = ovf_out;
#define ST_ARGS s, resident, resident, 0, ray_o, ray_d, t_max, R, next_ray, t_out, tri_out, \
                nullptr, nullptr, stats, pg
  switch ((any_hit ? 2 : 0) + (stats ? 1 : 0)) {
    case 0: return wt_walk_launch<WT_CLOSEST, WL_RESIDENT, false>(ST_ARGS);
    case 1: return wt_walk_launch<WT_CLOSEST, WL_RESIDENT, true>(ST_ARGS);
    case 2: return wt_walk_launch<WT_ANY, WL_RESIDENT, false>(ST_ARGS);
    default: return wt_walk_launch<WT_ANY, WL_RESIDENT, true>(ST_ARGS);
  }
#undef ST_ARGS
}

// Page pass over the recorded portals (pid, pt (K, R) slot-major); best_t /
// best_tri (R,) are read and written in place. Counter and stats as
// st_resident. Returns the cudaError_t of the launch (0 on success).
extern "C" int st_page(int any_hit, const float* pages, int page_rows,
                       const int* portal_page, const int* portal_root, const float* ray_o,
                       const float* ray_d, const float* t_max, int R, const int* pid,
                       const float* pt, int* next_ray, unsigned long long* stats,
                       float* best_t, int* best_tri, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  WtPaged pg = {};
  pg.page_rows = page_rows;
  pg.portal_page = portal_page;
  pg.portal_root = portal_root;
  pg.pid = const_cast<int*>(pid);  // read only in the page pass
  pg.pt = const_cast<float*>(pt);
#define ST_ARGS s, pages, pages, 0, ray_o, ray_d, t_max, R, next_ray, best_t, best_tri, \
                nullptr, nullptr, stats, pg
  switch ((any_hit ? 2 : 0) + (stats ? 1 : 0)) {
    case 0: return wt_walk_launch<WT_CLOSEST, WL_PAGE, false>(ST_ARGS);
    case 1: return wt_walk_launch<WT_CLOSEST, WL_PAGE, true>(ST_ARGS);
    case 2: return wt_walk_launch<WT_ANY, WL_PAGE, false>(ST_ARGS);
    default: return wt_walk_launch<WT_ANY, WL_PAGE, true>(ST_ARGS);
  }
#undef ST_ARGS
}

// What the compiler and the occupancy API report for a pass's kernel (the
// uninstrumented one; page 0 resident, 1 page): kernel_report's six numbers.
extern "C" int st_kernel_info(int page, int any_hit, int* out) {
  switch ((page ? 2 : 0) + (any_hit ? 1 : 0)) {
    case 0: return kernel_report((const void*)wt_walk_entry<WT_CLOSEST, WL_RESIDENT, false>(), WP_THREADS, out);
    case 1: return kernel_report((const void*)wt_walk_entry<WT_ANY, WL_RESIDENT, false>(), WP_THREADS, out);
    case 2: return kernel_report((const void*)wt_walk_entry<WT_CLOSEST, WL_PAGE, false>(), WP_THREADS, out);
    default: return kernel_report((const void*)wt_walk_entry<WT_ANY, WL_PAGE, false>(), WP_THREADS, out);
  }
}
