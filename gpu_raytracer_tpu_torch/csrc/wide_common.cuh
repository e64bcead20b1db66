// Device helpers of the persistent-warp walk (wide_walk.cuh) that the
// wide-BVH traversal kernels share: wide_traverse.cu (merged and two-level
// tables) and stream_traverse.cu (paged tables). The row layout is bvh/wide.py's: a node row holds 8 child boxes at [c*6, c*6+6)
// and child refs at [48+c]; a leaf row holds a triangle count at [0], ids at
// [1+j] and edge-form triangles at [16+9j, 16+9j+9).
//
// Float semantics follow the TPU kernels: 1/d is clamped at |d| < 1e-12, the
// Moller-Trumbore test requires |a| >= 1e-12, t > 1e-4 and t < limit
// (strict). The plain PyTorch versions (ops/wide_traverse.py child_keys,
// push_children, leaf_hits) compute the same terms in the same order; the
// kernels build with -fmad=false so no product is contracted into an fma.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define WT_LEAF_CAP 12
#define WT_ROW 128
#define WT_DIV_EPS 1e-12f
#define WT_RAY_EPS 1e-4f

// Traversal stack entries of one thread (wide_traverse.STACK_CAPACITY; both
// kernels export it and ops/_native.load checks it).
#ifndef WT_STACK
#define WT_STACK 160
#endif

__device__ __forceinline__ float wt_inv1(float c) {
  float tiny = c >= 0.0f ? WT_DIV_EPS : -WT_DIV_EPS;
  return 1.0f / (fabsf(c) < WT_DIV_EPS ? tiny : c);
}

// Slab test of ONE child with bounds lo (lx, ly, lz), hi (hx, hy, hz) and
// ref r: the entry distance max(tn, 0) of a non-empty child that the ray
// hits (tn <= tf, tf > 0) and enters before `cull`, +inf otherwise. A caller
// streams a node row's boxes into it (two children per three float4 loads).
__device__ __forceinline__ float wt_child_key(float lx, float ly, float lz, float hx,
                                              float hy, float hz, int r, float ox, float oy,
                                              float oz, float ix, float iy, float iz,
                                              float cull) {
  const float tx0 = (lx - ox) * ix;
  const float ty0 = (ly - oy) * iy;
  const float tz0 = (lz - oz) * iz;
  const float tx1 = (hx - ox) * ix;
  const float ty1 = (hy - oy) * iy;
  const float tz1 = (hz - oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  const float te = fmaxf(tn, 0.0f);
  const bool take = (r != -1) && (tn <= tf) && (tf > 0.0f) && (te < cull);
  return take ? te : INFINITY;
}

// Ascending by key. Odd-even transposition sort with a strict compare is
// STABLE (equal keys keep slot order), so the plain version's
// torch.sort(stable=True) visits children in exactly this order. (The TPU
// kernels sort block- or gang-shared keys with a Batcher network; per-ray
// keys make their order moot here.)
__device__ __forceinline__ void wt_sort8(float key[8], int ref[8]) {
#pragma unroll
  for (int pass = 0; pass < 8; ++pass) {
#pragma unroll
    for (int a = pass & 1; a + 1 < 8; a += 2) {
      if (key[a] > key[a + 1]) {
        const float tk = key[a];
        key[a] = key[a + 1];
        key[a + 1] = tk;
        const int tr = ref[a];
        ref[a] = ref[a + 1];
        ref[a + 1] = tr;
      }
    }
  }
}

// Edge-form Moller-Trumbore test of the triangle at `g` (p0 | e1 | e2);
// returns whether it is hit before `limit` and writes t, u, w.
__device__ __forceinline__ bool wt_tri_hit(const float* g, float ox, float oy, float oz,
                                           float dx, float dy, float dz, float limit,
                                           float& t, float& u, float& w) {
  const float p0x = __ldg(g + 0), p0y = __ldg(g + 1), p0z = __ldg(g + 2);
  const float e1x = __ldg(g + 3), e1y = __ldg(g + 4), e1z = __ldg(g + 5);
  const float e2x = __ldg(g + 6), e2y = __ldg(g + 7), e2z = __ldg(g + 8);
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / (fabsf(a) < WT_DIV_EPS ? WT_DIV_EPS : a);
  const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
  u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  w = f * (dx * qx + dy * qy + dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return (fabsf(a) >= WT_DIV_EPS) && (u >= 0.0f) && (u <= 1.0f) && (w >= 0.0f) &&
         (u + w <= 1.0f) && (t > WT_RAY_EPS) && (t < limit);
}
