// Whole-bounce fused shade with its in-kernel sampler, for small scenes, on
// NVIDIA Hopper (sm_90a), one thread per lane.
//
// Replaces the TPU kernel gpu_raytracer_tpu/ops/pallas_shade.py `_kernel`
// (`shade_diffuse_pallas`) with its in-kernel sampler `_draw2_kernel`. From
// the traversal's hits (t, tri, inst, u, v) it does a whole bounce: sky on a
// miss, the emissive hit with MIS (weight 1 at bounce 0), russian roulette
// (off at bounce 0), hit interpolation from the object-space tables, the
// two-sided Duff shading frame, the albedo fold, the light pick (count of
// CDF entries below the draw), NEE with the 4-BSDF eval (shade_common.cuh,
// shared with K3), the shadow-ray setup and the BSDF sample.
//
// The sampler: each draw site's PMJ pair is one scalar per wave (params),
// rotated by the block's blue-noise row (a 1024-lane block is one 32x32
// screen tile; its first pixel names the noise tile) and wrapped to [0, 1);
// past 4096 samples a uint32 hash whose top 24 bits are scaled by 2^-24.
//
// Tables (ops/fused_shade.py make_tables, built once with the scene's
// tables): the kernel reads rows, 16-byte aligned, with 128-bit loads,
//   tri_rows   (T, 32): p0 | e1 | e2 (object space) | pad, n0 | n1 | n2 | pad
//   inst_rows  (I, 80): forward transform, material id | pad, inverse
//              transform | pad, the material's (16,) row, its (32,) curves
//   light_rows (L, 16): p0, e1, e2 in world space (the light instance's
//              transform applied at build time), emission | pad
// the light CDF (lgt_tbl row 0, L floats) and the noise rows (16 NT, 1024).
//
// What bounds it on the card: the latency of one lane's bounce. A lane
// reads ~60 bytes and writes ~100 of its own (its tables stay in L1 and
// L2), so bytes bound a 512² wave at 0.0123 ms; but a lane's bounce is a
// chain of dependent table reads and a long run of dependent arithmetic,
// at 128 registers, so 16 warps an SM run the wave in rounds. The
// design shortens the chain and keeps the registers: a lane's inputs load
// in one round; its instance row carries its material and curves, so one
// more round of 128-bit loads brings the instance, material and triangle,
// and the light row (its triangle in world space, its emission) comes in
// the round after the CDF; the Kulla-Conty curves load only on dielectric
// and conductor lanes, into registers by value selects (`FsLane`: no
// local-memory copy of the lane). A dead lane rides the bounce masked, as
// in the parent kernel: a path of its own for warps of dead lanes did not
// pay on the route's waves (PERF.md §6). The arithmetic and its order are
// the parent kernel's (-fmad=false, fmaf Horner steps): its outputs are
// bit-equal on every lane the parity bar reads. The 32-byte stack frame is
// sample_disk's sinf / cosf argument-reduction slow path, never taken here.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "kernel_report.cuh"
#include "shade_common.cuh"

#define FS_BLOCK 1024
#define FS_NUM_PARAMS 48
#define FS_INV_24 (1.0f / 16777216.0f)
// Row widths in float4s (ops/fused_shade.py TRI_ROW, INST_ROW, LIGHT_ROW).
#define FS_TRI_ROW4 8
#define FS_INST_ROW4 20
#define FS_LIGHT_ROW4 4

// Threads a block (tools/torch_time_traverse.py can set it as a NAME=VALUE
// tree): 128, 4 blocks an SM at 128 registers; 64 ran 8% slower on the
// mixed-BSDF wave, 256 2.5% slower on the bounce-1 wave (PERF.md §6).
constexpr int FS_THREADS = 128;

// Field order is the Python wrapper's IN_FIELDS / OUT_FIELDS order.
struct FsIn {
  const float* t;
  const int* tri;
  const int* inst;
  const float* u;
  const float* v;
  const float* ray_o;       // (R, 3)
  const float* ray_d;       // (R, 3)
  const float* throughput;  // (R, 3)
  const uint8_t* alive;
  const uint8_t* prev_allow_nee;
  const float* last_pdf;
  const int64_t* pixel_index;
};

struct FsOut {
  float* radiance_add;  // (R, 3)
  float* ray_o;         // (R, 3)
  float* ray_d;         // (R, 3)
  float* throughput;    // (R, 3)
  uint8_t* alive;
  uint8_t* prev_allow_nee;
  float* last_pdf;
  float* shadow_o;      // (R, 3)
  float* shadow_d;      // (R, 3)
  float* shadow_tmax;
  float* illumination;  // (R, 3)
};

struct FsTables {
  const float4* tri_rows;
  const float4* inst_rows;
  const float4* light_rows;
  const float* cdf;
  const float* noise_x;
  const float* noise_y;
  int L;
};

struct FsParams {
  float p[FS_NUM_PARAMS];
};

// Lane's material constants with the Kulla-Conty curves as registers: the
// dielectric curve of the side the ray enters from, the other side's and
// the conductor's, picked from the material's 32 curve values by value
// selects (shade_common.cuh's BSDF functions read them through e_same,
// e_other, e_cond).
struct FsLane {
  bool is_diffuse, is_plastic, is_diel, is_cond, entering, can_nee;
  V3 al;
  float alpha, eta_d, ratio_d, E_avg_same, E_avg_inv, E_avg_c;
  V3 eta3, k3, fms;
  float ks[8], ko[8], kd[8];
  __device__ __forceinline__ float e_same(float x) const { return clip01(poly8(ks, x)); }
  __device__ __forceinline__ float e_other(float x) const { return clip01(poly8(ko, x)); }
  __device__ __forceinline__ float e_cond(float x) const { return clip01(poly8(kd, x)); }
};

__device__ __forceinline__ uint32_t fs_pcg(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t fs_hash_with(uint32_t seed, uint32_t h) {
  seed = (seed ^ 61u) ^ h;
  seed = seed + (seed << 3);
  seed = seed ^ (seed >> 4);
  return seed * 0x27D4EB2Du;
}

// One draw site's pair (pallas_shade._draw2_kernel); the lane's pixel id is
// read only where the site falls back to the hash.
__device__ __forceinline__ void fs_draw2(const FsParams& P, const FsTables& tb, const int64_t* pixel_index,
                                         int i, int tile, int lane, int site, uint32_t dim, uint32_t bounce_u,
                                         uint32_t s_idx, float* a, float* b) {
  const int base = 16 + 4 * site;
  if (P.p[base + 3] > 0.0f) {
    const int row = (int)P.p[base + 2] * 16 + tile;
    float u = P.p[base] + __ldg(tb.noise_x + (size_t)row * FS_BLOCK + lane);
    float v = P.p[base + 1] + __ldg(tb.noise_y + (size_t)row * FS_BLOCK + lane);
    *a = u >= 1.0f ? u - 1.0f : u;
    *b = v >= 1.0f ? v - 1.0f : v;
    return;
  }
  const uint32_t pix = (uint32_t)pixel_index[i];
  const uint32_t h = fs_pcg((pix * 7u + dim) * 128u + bounce_u);
  *a = (float)(int)(fs_hash_with(s_idx, h) >> 8) * FS_INV_24;
  *b = (float)(int)(fs_hash_with(s_idx + 0xDEADBEEFu, h) >> 8) * FS_INV_24;
}

__device__ __forceinline__ V3 fs_affine_pt(const float* m, V3 p) {
  return V3{m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3], m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
            m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]};
}
__device__ __forceinline__ V3 fs_inv_transpose_dir(const float* m, V3 n) {
  return norm3(V3{m[0] * n.x + m[4] * n.y + m[8] * n.z, m[1] * n.x + m[5] * n.y + m[9] * n.z,
                  m[2] * n.x + m[6] * n.y + m[10] * n.z});
}
// `count` float4s of a row into out[0 : 4 count].
__device__ __forceinline__ void fs_row(const float4* row, int count, float* out) {
#pragma unroll
  for (int c = 0; c < count; ++c) {
    const float4 q = __ldg(row + c);
    out[4 * c] = q.x;
    out[4 * c + 1] = q.y;
    out[4 * c + 2] = q.z;
    out[4 * c + 3] = q.w;
  }
}

// One thread a lane: its inputs in one round of loads, the whole bounce
// (the parent kernel's body, term by term; a dead lane rides it masked, as
// in the plain version), then its outputs.
__global__ void __launch_bounds__(FS_THREADS)
fs_shade_kernel(FsIn in, FsOut out, FsTables tb, FsParams P, int width, int enable_nee, int enable_mis,
                int enable_rr, int R) {
  const int i = blockIdx.x * FS_THREADS + threadIdx.x;
  if (i >= R) return;
  const float bounce = P.p[0];
  const float num_bounces = P.p[1];
  const float total_weight = P.p[5];

  const float t = in.t[i];
  const int tri = in.tri[i];
  const int inst = in.inst[i];
  const float hu = in.u[i], hv = in.v[i];
  const V3 o = ld3(in.ray_o, i), d = ld3(in.ray_d, i);
  V3 tp = ld3(in.throughput, i);
  bool active = in.alive[i] != 0;
  const bool prev_nee = in.prev_allow_nee[i] != 0;
  const float last_pdf = in.last_pdf[i];

  // ---- in-kernel sampler draws ----
  const int first = (int)in.pixel_index[(i / FS_BLOCK) * FS_BLOCK];
  const int tile = ((first / width) / 32 % 4) * 4 + (first % width) / 32 % 4;
  const int lane = i % FS_BLOCK;
  const uint32_t bounce_u = (uint32_t)(int)bounce;
  const uint32_t s_idx = (uint32_t)(int)P.p[6];
  float r5, r0, r1, r2, f0, f1, r3, r4, unused;
  fs_draw2(P, tb, in.pixel_index, i, tile, lane, 0, 2u, bounce_u, s_idx, &r5, &unused);  // RUSSIAN_ROULETTE
  fs_draw2(P, tb, in.pixel_index, i, tile, lane, 1, 3u, bounce_u, s_idx, &r0, &unused);  // NEE_LIGHT
  fs_draw2(P, tb, in.pixel_index, i, tile, lane, 2, 4u, bounce_u, s_idx, &r1, &r2);      // NEE_TRIANGLE
  fs_draw2(P, tb, in.pixel_index, i, tile, lane, 3, 5u, bounce_u, s_idx, &f0, &f1);      // BSDF_0
  fs_draw2(P, tb, in.pixel_index, i, tile, lane, 4, 6u, bounce_u, s_idx, &r3, &r4);      // BSDF_1

  // ---- sky on miss (constant sky) ----
  V3 rad = v3(0.0f, 0.0f, 0.0f);
  const bool missed = active && tri < 0;
  if (missed) rad = V3{tp.x * P.p[2], tp.y * P.p[3], tp.z * P.p[4]};
  active = active && !missed;

  const int ti = tri > 0 ? tri : 0;
  const int ii = inst > 0 ? inst : 0;

  // ---- instance transforms (material id at fwd[12]) + material; the triangle ----
  float fwd[16], inv[12], mv[16], g[12], nr[12];
  const float4* irow = tb.inst_rows + (size_t)ii * FS_INST_ROW4;
  fs_row(irow, 4, fwd);
  fs_row(irow + 4, 3, inv);
  fs_row(irow + 8, 4, mv);
  const float4* trow = tb.tri_rows + (size_t)ti * FS_TRI_ROW4;
  fs_row(trow, 3, g);
  fs_row(trow + 4, 3, nr);
  const int mtype = (int)mv[0];
  const V3 em = v3(mv[1], mv[2], mv[3]);
  FsLane m;
  m.al = v3(mv[4], mv[5], mv[6]);
  const float rough = mv[7];
  const float ior = fmaxf(mv[8], 1.0001f);
  m.is_diffuse = mtype == SG_MAT_DIFFUSE;
  m.is_plastic = mtype == SG_MAT_PLASTIC;
  m.is_diel = mtype == SG_MAT_DIELECTRIC;
  m.is_cond = mtype == SG_MAT_CONDUCTOR;
  // The curves only where a lobe reads them.
  float kc[32];
  if (m.is_diel || m.is_cond) {
    fs_row(irow + 12, 8, kc);
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) kc[k] = 0.0f;
  }

  // ---- hit geometry ----
  const V3 po = v3(g[0] + hu * g[3] + hv * g[6], g[1] + hu * g[4] + hv * g[7], g[2] + hu * g[5] + hv * g[8]);
  const V3 p = fs_affine_pt(fwd, po);
  const V3 cg = v3(g[4] * g[8] - g[5] * g[7], g[5] * g[6] - g[3] * g[8], g[3] * g[7] - g[4] * g[6]);
  V3 gn = fs_inv_transpose_dir(inv, cg);

  // ---- emissive hit with MIS ----
  const bool is_light = active && mtype == SG_MAT_LIGHT;
  const float lum = 0.2126f * em.x + 0.7152f * em.y + 0.0722f * em.z;
  const float cos_l = fabsf(dot3(d, gn));
  const float lpdf_here = lum * t * t / fmaxf(cos_l * total_weight, 1e-20f);
  const bool lpdf_ok = isfinite(lpdf_here) && lpdf_here > 0.0f;
  float mis_w = 1.0f;
  if (enable_nee && bounce != 0.0f && prev_nee) {
    if (enable_mis) {
      const float w = last_pdf * last_pdf / fmaxf(last_pdf * last_pdf + lpdf_here * lpdf_here, 1e-20f);
      mis_w = lpdf_ok ? w : 0.0f;
    } else {
      mis_w = 0.0f;
    }
  }
  if (is_light) {
    rad.x += tp.x * em.x * mis_w;
    rad.y += tp.y * em.y * mis_w;
    rad.z += tp.z * em.z * mis_w;
  }
  active = active && !is_light;

  // ---- bounce cap + russian roulette (off at bounce 0) ----
  active = active && (bounce < num_bounces - 1.0f);
  if (enable_rr && bounce > 0.0f) {
    const float survival = clip01(fmaxf(tp.x, fmaxf(tp.y, tp.z)));
    active = active && !(r5 > survival);
    const float inv_s = 1.0f / fmaxf(survival, 1e-8f);
    tp = V3{tp.x * inv_s, tp.y * inv_s, tp.z * inv_s};
  }

  // ---- shading frame ----
  const float w0 = 1.0f - hu - hv;
  V3 sn = fs_inv_transpose_dir(inv, v3(w0 * nr[0] + hu * nr[3] + hv * nr[6], w0 * nr[1] + hu * nr[4] + hv * nr[7],
                                       w0 * nr[2] + hu * nr[5] + hv * nr[8]));
  const bool entering = dot3(d, gn) < 0.0f;
  const float flip = entering ? 1.0f : -1.0f;
  gn = v3(gn.x * flip, gn.y * flip, gn.z * flip);
  sn = v3(sn.x * flip, sn.y * flip, sn.z * flip);
  const float sgn = sn.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sgn + sn.z);
  const float b = sn.x * sn.y * a;
  const V3 T = v3(1.0f + sgn * sn.x * sn.x * a, sgn * b, -sgn * sn.x);
  const V3 B = v3(b, sgn + sn.y * sn.y * a, -sn.y);
  const V3 wi = v3(-dot3(d, T), -dot3(d, B), -dot3(d, sn));
  active = active && (wi.z > 0.0f);

  m.entering = entering;
  m.alpha = fmaxf(rough * rough, 1e-4f);
  m.eta_d = entering ? 1.0f / ior : ior;
  m.eta3 = v3(mv[9], mv[10], mv[11]);
  m.k3 = v3(mv[12], mv[13], mv[14]);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    m.ks[k] = entering ? kc[k] : kc[8 + k];
    m.ko[k] = entering ? kc[8 + k] : kc[k];
    m.kd[k] = kc[16 + k];
  }
  m.ratio_d = entering ? kc[26] : kc[27];
  m.E_avg_same = entering ? kc[24] : kc[25];
  m.E_avg_inv = entering ? kc[25] : kc[24];
  m.E_avg_c = kc[31];
  m.fms = v3(kc[28], kc[29], kc[30]);
  m.can_nee = !((mtype == SG_MAT_DIELECTRIC || mtype == SG_MAT_CONDUCTOR) && rough < SG_ROUGH_CUTOFF);

  // Diffuse folds albedo into throughput at the hit.
  if (active && m.is_diffuse) tp = V3{tp.x * m.al.x, tp.y * m.al.y, tp.z * m.al.z};

  // ---- NEE shadow-ray setup ----
  float stmax = 0.0f;
  V3 so = v3(0.0f, 0.0f, 0.0f);
  V3 sd = v3(1.0f, 0.0f, 0.0f);
  V3 il = v3(0.0f, 0.0f, 0.0f);
  if (enable_nee) {
    int k = 0;
    for (int j = 0; j < tb.L - 1; ++j) k += (r0 > __ldg(tb.cdf + j)) ? 1 : 0;
    const bool flip2 = r2 > r1;
    const float lu = flip2 ? 0.5f * r1 : r1 - 0.5f * r2;
    const float lv = flip2 ? r2 - 0.5f * r1 : 0.5f * r2;
    float l[12];
    fs_row(tb.light_rows + (size_t)k * FS_LIGHT_ROW4, 3, l);
    const V3 lp0 = v3(l[0], l[1], l[2]);
    const V3 le1 = v3(l[3], l[4], l[5]);
    const V3 le2 = v3(l[6], l[7], l[8]);
    const V3 lem = v3(l[9], l[10], l[11]);
    V3 lp = v3(lp0.x + lu * le1.x + lv * le2.x, lp0.y + lu * le1.y + lv * le2.y, lp0.z + lu * le1.z + lv * le2.z);
    const V3 lgn = norm3(v3(le1.y * le2.z - le1.z * le2.y, le1.z * le2.x - le1.x * le2.z,
                            le1.x * le2.y - le1.y * le2.x));
    so = offset3(p, v3(lp.x - p.x, lp.y - p.y, lp.z - p.z), gn);
    lp = offset3(lp, v3(so.x - lp.x, so.y - lp.y, so.z - lp.z), lgn);
    const V3 tl = v3(lp.x - so.x, lp.y - so.y, lp.z - so.z);
    const float dist = sqrtf(fmaxf(tl.x * tl.x + tl.y * tl.y + tl.z * tl.z, 0.0f));
    const float inv_d = 1.0f / fmaxf(dist, 1e-20f);
    sd = v3(tl.x * inv_d, tl.y * inv_d, tl.z * inv_d);
    const float cos_light = fabsf(dot3(sd, lgn));
    const V3 lo = v3(dot3(sd, T), dot3(sd, B), dot3(sd, sn));
    V3 ev;
    float ev_pdf;
    bool ev_ok;
    nee_eval_of(m, wi, lo, &ev, &ev_pdf, &ev_ok);
    const float llum = 0.2126f * lem.x + 0.7152f * lem.y + 0.0722f * lem.z;
    const float light_pdf = llum * dist * dist / fmaxf(cos_light * total_weight, 1e-20f);
    const bool lp_ok = isfinite(light_pdf) && light_pdf > 1e-20f;
    const float w_nee =
        enable_mis ? light_pdf * light_pdf / fmaxf(light_pdf * light_pdf + ev_pdf * ev_pdf, 1e-20f) : 1.0f;
    const float scale = w_nee / fmaxf(light_pdf, 1e-20f);
    il = v3(tp.x * ev.x * lem.x * scale, tp.y * ev.y * lem.y * scale, tp.z * ev.z * lem.z * scale);
    const bool want = active && m.can_nee && ev_ok && lp_ok && cos_light > 1e-6f;
    stmax = want ? dist - 2.0f * SG_EPS : 0.0f;
  }

  // ---- BSDF sample -> continuation ray ----
  V3 os, mul;
  float pdf;
  bool valid;
  bsdf_sample_of(m, wi, f0, f1, r3, r4, &os, &pdf, &mul, &valid);
  active = active && valid;
  if (active) tp = V3{tp.x * mul.x, tp.y * mul.y, tp.z * mul.z};
  const V3 nd = norm3(v3(os.x * T.x + os.y * B.x + os.z * sn.x, os.x * T.y + os.y * B.y + os.z * sn.y,
                         os.x * T.z + os.y * B.z + os.z * sn.z));
  const V3 no = offset3(p, nd, gn);

  st3(out.radiance_add, i, rad);
  st3(out.ray_o, i, active ? no : o);
  st3(out.ray_d, i, active ? nd : d);
  st3(out.throughput, i, tp);
  st3(out.shadow_o, i, so);
  st3(out.shadow_d, i, sd);
  st3(out.illumination, i, il);
  out.alive[i] = active ? 1 : 0;
  out.prev_allow_nee[i] = (enable_nee && m.can_nee) ? 1 : 0;
  out.last_pdf[i] = pdf;
  out.shadow_tmax[i] = stmax;
}

// in_ptrs / out_ptrs / tab_ptrs: the FsIn / FsOut / FsTables pointer
// fields in order (the rows 16-byte aligned); L: the lights; params: the 48
// floats. Returns the cudaError_t of the launch (0 on success).
extern "C" int fs_shade(const void* const* in_ptrs, void* const* out_ptrs, const void* const* tab_ptrs, int L,
                        const float* params, int width, int enable_nee, int enable_mis, int enable_rr, int R,
                        void* stream) {
  if (R <= 0) return 0;
  FsIn in;
  FsOut out;
  FsTables tb;
  memcpy(&in, in_ptrs, sizeof(FsIn));
  memcpy(&out, out_ptrs, sizeof(FsOut));
  memcpy(&tb, tab_ptrs, offsetof(FsTables, L));
  tb.L = L;
  FsParams P;
  memcpy(P.p, params, sizeof(P.p));
  const int blocks = (R + FS_THREADS - 1) / FS_THREADS;
  fs_shade_kernel<<<blocks, FS_THREADS, 0, (cudaStream_t)stream>>>(in, out, tb, P, width, enable_nee, enable_mis,
                                                                  enable_rr, R);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy API report for the kernel
// (kernel_report). Returns a cudaError_t.
extern "C" int fs_kernel_info(int* out) { return kernel_report((const void*)fs_shade_kernel, FS_THREADS, out); }

// The pointer fields of FsIn (0), FsOut (1) and FsTables (2), for the
// wrapper's IN_FIELDS, OUT_FIELDS and TAB_FIELDS.
extern "C" int fs_num_fields(int which) {
  return which == 0   ? (int)(sizeof(FsIn) / sizeof(void*))
         : which == 1 ? (int)(sizeof(FsOut) / sizeof(void*))
                      : (int)(offsetof(FsTables, L) / sizeof(void*));
}

// The row widths in floats (ops/fused_shade.py checks TRI_ROW, INST_ROW,
// LIGHT_ROW against them).
extern "C" int fs_row_floats(int which) {
  return 4 * (which == 0 ? FS_TRI_ROW4 : which == 1 ? FS_INST_ROW4 : FS_LIGHT_ROW4);
}
