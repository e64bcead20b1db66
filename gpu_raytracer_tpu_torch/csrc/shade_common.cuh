// Per-lane shading helpers shared by the two fused shade kernels,
// csrc/shade_gather.cu (K3, gathered lanes) and csrc/fused_shade.cu (K7,
// whole bounce): the vector and microfacet functions, the per-lane material
// constants (`Lane`, JAX pallas_shade.make_lane_materials), the NEE eval of
// the four BSDFs (`nee_eval_of`, nee_eval_dispatch) and the BSDF sample
// (`bsdf_sample_of`, bsdf_sample_dispatch). Kulla-Conty curves are
// per-material degree-7 polynomials evaluated with fmaf (the sources build
// with -fmad=false, so every other a*b+c rounds twice, as in PyTorch).
//
// The BSDF functions take any lane type with Lane's fields and its three
// curve members (e_same, e_other, e_cond): K3 passes `Lane` (the curves as
// 32 floats), K7 its own `FsLane` (the curves as value-selected registers,
// loaded only on dielectric and conductor lanes). A curve is evaluated
// inside the lobe that reads it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SG_EPS 1e-4f
#define SG_PI 3.14159265358979323846f
#define SG_MAT_LIGHT 0
#define SG_MAT_DIFFUSE 1
#define SG_MAT_PLASTIC 2
#define SG_MAT_DIELECTRIC 3
#define SG_MAT_CONDUCTOR 4
#define SG_ROUGH_CUTOFF 0.05f
#define SG_PLASTIC_IOR 1.5f
#define SG_PLASTIC_ETA (1.0f / SG_PLASTIC_IOR)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 sel3(bool m, V3 a, V3 b) {
  return V3{m ? a.x : b.x, m ? a.y : b.y, m ? a.z : b.z};
}
__device__ __forceinline__ float sqrt_s(float x) { return sqrtf(fmaxf(x, 0.0f)); }
__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ bool pdf_ok(float p) { return isfinite(p) && p > 1e-8f; }

__device__ __forceinline__ V3 norm3(V3 a) {  // pallas_shade._norm3
  const float inv = rsqrtf(fmaxf(a.x * a.x + a.y * a.y + a.z * a.z, 1e-20f));
  return V3{a.x * inv, a.y * inv, a.z * inv};
}
__device__ __forceinline__ V3 norm3t(V3 a) {  // pallas_shade._norm3t
  const float inv = rsqrtf(fmaxf(a.x * a.x + a.y * a.y + a.z * a.z, 1e-16f));
  return V3{a.x * inv, a.y * inv, a.z * inv};
}
__device__ __forceinline__ V3 offset3(V3 p, V3 d, V3 n) {  // Ray.h:16-18
  const float s = dot3(d, n) >= 0.0f ? SG_EPS : -SG_EPS;
  return V3{p.x + s * n.x, p.y + s * n.y, p.z + s * n.z};
}
__device__ __forceinline__ void sample_disk(float u1, float u2, float* x, float* y) {
  const float a = 2.0f * u1 - 1.0f;
  const float b = 2.0f * u2 - 1.0f;
  const bool use_a = fabsf(a) > fabsf(b);
  const float r = use_a ? a : b;
  const float safe = r == 0.0f ? 1.0f : r;
  const float phi = use_a ? (SG_PI / 4.0f) * (b / safe)
                          : (SG_PI / 2.0f) - (SG_PI / 4.0f) * (a / safe);
  *x = r * cosf(phi);
  *y = r * sinf(phi);
}
// Horner with explicit fused multiply-adds: the degree-7 Kulla-Conty fits
// cancel large coefficients, and -fmad=false would otherwise round each step
// twice (the plain version rounds like an FMA too).
__device__ __forceinline__ float poly8(const float* c, float x) {
  float acc = c[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) acc = fmaf(acc, x, c[k]);
  return acc;
}
__device__ __forceinline__ float fres_diel(float cos_i, float eta) {
  const float s2 = eta * eta * (1.0f - cos_i * cos_i);
  const float cos_o = sqrt_s(1.0f - s2);
  const float pp = (eta * cos_i - cos_o) / fmaxf(eta * cos_i + cos_o, 1e-8f);
  const float ss = (cos_i - eta * cos_o) / fmaxf(cos_i + eta * cos_o, 1e-8f);
  return s2 >= 1.0f ? 1.0f : 0.5f * (pp * pp + ss * ss);
}
__device__ __forceinline__ float fres_cond1(float c, float e, float k) {
  const float c2 = c * c;
  const float s2 = 1.0f - c2;
  const float inner = e * e - k * k - s2;
  const float a2b2 = sqrt_s(inner * inner + 4.0f * k * k * e * e);
  const float a = sqrt_s(0.5f * (a2b2 + inner));
  const float ts = (a2b2 + c2 - 2.0f * a * c) / fmaxf(a2b2 + c2 + 2.0f * a * c, 1e-8f);
  const float tp = ((a2b2 * c2 + s2 * s2 - 2.0f * a * c * s2) /
                    fmaxf(a2b2 * c2 + s2 * s2 + 2.0f * a * c * s2, 1e-8f)) * ts;
  return 0.5f * (tp + ts);
}
__device__ __forceinline__ float ggx_D(V3 m, float alpha) {
  const bool valid = m.z >= 1e-6f;
  const float zs = valid ? m.z : 1.0f;
  const float sx = -m.x / (zs * alpha);
  const float sy = -m.y / (zs * alpha);
  const float sl = 1.0f + sx * sx + sy * sy;
  const float cos4 = zs * zs * zs * zs;
  return valid ? 1.0f / (sl * sl * SG_PI * alpha * alpha * cos4) : 0.0f;
}
__device__ __forceinline__ float ggx_lambda(V3 v, float alpha) {
  const float z2 = fmaxf(v.z * v.z, 1e-8f);
  const float t = (alpha * alpha) * (v.x * v.x + v.y * v.y) / z2;
  return 0.5f * (sqrtf(1.0f + t) - 1.0f);
}
__device__ __forceinline__ float ggx_G1(V3 v, float alpha) {
  return 1.0f / (1.0f + ggx_lambda(v, alpha));
}
__device__ __forceinline__ float ggx_G2(V3 o, V3 i, V3 m, float alpha) {
  const bool i_back = dot3(i, m) * i.z <= 0.0f;
  const bool o_back = dot3(o, m) * o.z <= 0.0f;
  const float g = 1.0f / (1.0f + ggx_lambda(o, alpha) + ggx_lambda(i, alpha));
  return (i_back || o_back) ? 0.0f : g;
}
__device__ __forceinline__ V3 halfway(V3 i, V3 o) {
  return norm3t(V3{i.x + o.x, i.y + o.y, i.z + o.z});
}
__device__ __forceinline__ V3 vndf_sample(V3 i, float alpha, float u1, float u2) {
  const V3 v = norm3t(V3{alpha * i.x, alpha * i.y, i.z});
  const float len2 = v.x * v.x + v.y * v.y;
  const float il = rsqrtf(fmaxf(len2, 1e-8f));
  const bool use = len2 > 1e-8f;
  const float a1x = use ? -v.y * il : 1.0f;
  const float a1y = use ? v.x * il : 0.0f;
  const float a2x = -v.z * a1y;
  const float a2y = v.z * a1x;
  const float a2z = v.x * a1y - v.y * a1x;
  float t1x, t1y;
  sample_disk(u1, u2, &t1x, &t1y);
  const float h = 0.5f + 0.5f * v.z;
  const float t2 = (1.0f - h) * sqrt_s(1.0f - t1x * t1x) + h * t1y;
  const float t3 = sqrt_s(1.0f - t1x * t1x - t2 * t2);
  const float nx = t1x * a1x + t2 * a2x + t3 * v.x;
  const float ny = t1x * a1y + t2 * a2y + t3 * v.y;
  const float nz = t2 * a2z + t3 * v.z;
  return norm3t(V3{alpha * nx, alpha * ny, fmaxf(nz, 0.0f)});
}
__device__ __forceinline__ V3 reflect3(V3 i, V3 m) {
  const float d = 2.0f * dot3(i, m);
  return V3{d * m.x - i.x, d * m.y - i.y, d * m.z - i.z};
}
__device__ __forceinline__ V3 refract3(V3 i, V3 m, float eta) {
  const float cos_t = dot3(i, m);
  const float k = 1.0f - eta * eta * (1.0f - cos_t * cos_t);
  const float a = eta * cos_t - sqrt_s(k);
  return V3{a * m.x - eta * i.x, a * m.y - eta * i.y, a * m.z - eta * i.z};
}
__device__ __forceinline__ float ms_lobe(float E_i, float E_o, float E_avg) {
  return (1.0f - E_i) * (1.0f - E_o) / fmaxf(1e-4f, SG_PI * (1.0f - E_avg));
}

struct Lane {  // pallas_shade.make_lane_materials
  bool is_diffuse, is_plastic, is_diel, is_cond, entering, can_nee;
  V3 al;
  float alpha, eta_d, ratio_d, E_avg_same, E_avg_inv, E_avg_c;
  V3 eta3, k3, fms;
  float kc[32];
  // Dielectric E(cos) on the side the ray enters from (kc[0:8] entering,
  // else kc[8:16]), on the other side, and the conductor's (kc[16:24]).
  __device__ __forceinline__ float e_same(float x) const {
    return clip01(poly8(entering ? kc : kc + 8, x));
  }
  __device__ __forceinline__ float e_other(float x) const {
    return clip01(poly8(!entering ? kc : kc + 8, x));
  }
  __device__ __forceinline__ float e_cond(float x) const { return clip01(poly8(kc + 16, x)); }
};

template <class M>
__device__ __forceinline__ void plastic_at(const M& m, V3 i, V3 o, V3 h, V3* val, float* pdf) {
  const float internal = 1.0f - (1.0f - (SG_PLASTIC_IOR - 1.0f) / (4.08567f + 1.00071f * SG_PLASTIC_IOR)) *
                                    SG_PLASTIC_ETA * SG_PLASTIC_ETA;
  const float i_dot_m = fabsf(dot3(i, h));
  const float F = fres_diel(i_dot_m, SG_PLASTIC_ETA);
  const float D = ggx_D(h, m.alpha);
  const float G1 = ggx_G1(i, m.alpha);
  const float G2 = ggx_G2(o, i, h, m.alpha);
  const float z_i = fmaxf(i.z, 1e-6f);
  const float spec = F * G2 * D / (4.0f * z_i);
  const float F_i = fres_diel(i.z, SG_PLASTIC_ETA);
  const float F_o = fres_diel(o.z, SG_PLASTIC_ETA);
  const float base = SG_PLASTIC_ETA * SG_PLASTIC_ETA * (1.0f - F_i) * (1.0f - F_o) * o.z * (1.0f / SG_PI);
  val->x = spec + base * m.al.x / (1.0f - m.al.x * internal);
  val->y = spec + base * m.al.y / (1.0f - m.al.y * internal);
  val->z = spec + base * m.al.z / (1.0f - m.al.z * internal);
  const float pdf_spec = G1 * D / (4.0f * z_i);
  const float pdf_dif = fmaxf(o.z, 0.0f) * (1.0f / SG_PI);
  *pdf = pdf_dif + F_i * (pdf_spec - pdf_dif);
}

template <class M>
__device__ __forceinline__ void dielectric_at(const M& m, V3 i, V3 o, V3 h, bool reflected, float E_i,
                                              float E_o_r, float E_o_t, float* val, float* pdf) {
  const float eta = m.eta_d;
  const float i_dot_m = fabsf(dot3(i, h));
  const float o_dot_m = fabsf(dot3(o, h));
  const float F = fres_diel(i_dot_m, eta);
  const float D = ggx_D(h, m.alpha);
  const float G1 = ggx_G1(i, m.alpha);
  const float G2 = ggx_G2(o, i, h, m.alpha);
  const float z_i = fmaxf(i.z, 1e-6f);
  const float abs_oz = fabsf(o.z);
  const float single_r = F * G2 * D / (4.0f * z_i);
  const float pdf_single_r = F * G1 * D / (4.0f * z_i);
  const float multi_r = (1.0f - m.ratio_d) * abs_oz * ms_lobe(E_i, E_o_r, m.E_avg_same);
  const float pdf_multi_r = (1.0f - m.ratio_d) * abs_oz * (1.0f / SG_PI);
  const float dd = eta * i_dot_m + o_dot_m;
  const float denom = dd * dd;
  const float single_t = (1.0f - F) * G2 * D * i_dot_m * o_dot_m / (z_i * fmaxf(denom, 1e-12f) * eta * eta);
  const float pdf_single_t = (1.0f - F) * G1 * D * i_dot_m * o_dot_m / (z_i * fmaxf(denom, 1e-12f));
  const float multi_t = m.ratio_d * abs_oz * ms_lobe(E_i, E_o_t, m.E_avg_inv);
  const float pdf_multi_t = m.ratio_d * abs_oz * (1.0f / SG_PI);
  *val = reflected ? single_r + multi_r : single_t + multi_t;
  const float ps = reflected ? pdf_single_r : pdf_single_t;
  const float pm = reflected ? pdf_multi_r : pdf_multi_t;
  *pdf = pm + E_i * (ps - pm);
}

template <class M>
__device__ __forceinline__ void conductor_at(const M& m, V3 i, V3 o, V3 h, float E_i, float E_o, V3* val,
                                             float* pdf, float* o_dot_m) {
  const float odm = dot3(o, h);
  const float D = ggx_D(h, m.alpha);
  const float G1 = ggx_G1(i, m.alpha);
  const float G2 = ggx_G2(o, i, h, m.alpha);
  const float z_i = fmaxf(i.z, 1e-6f);
  const float s = G2 * D / (4.0f * z_i);
  const float z_o = fmaxf(o.z, 0.0f);
  const float ms = ms_lobe(E_i, E_o, m.E_avg_c) * z_o;
  val->x = fres_cond1(odm, m.eta3.x, m.k3.x) * s + m.fms.x * ms;
  val->y = fres_cond1(odm, m.eta3.y, m.k3.y) * s + m.fms.y * ms;
  val->z = fres_cond1(odm, m.eta3.z, m.k3.z) * s + m.fms.z * ms;
  const float pdf_single = G1 * D / (4.0f * z_i);
  const float pdf_multi = z_o * (1.0f / SG_PI);
  *pdf = pdf_multi + E_i * (pdf_single - pdf_multi);
  *o_dot_m = odm;
}

template <class M>
__device__ __forceinline__ void nee_eval_of(const M& m, V3 wi, V3 lo, V3* ev, float* ev_pdf, bool* ev_ok) {
  // diffuse
  const float val_dif = fmaxf(lo.z, 0.0f) * (1.0f / SG_PI);
  V3 e = v3(val_dif, val_dif, val_dif);
  float p = val_dif;
  bool ok = lo.z > 0.0f;
  // plastic
  const V3 h = halfway(wi, lo);
  if (m.is_plastic) {
    V3 pv;
    float pp;
    plastic_at(m, wi, lo, h, &pv, &pp);
    e = pv;
    p = pp;
    ok = lo.z > 0.0f && pdf_ok(pp);
  }
  // dielectric
  if (m.is_diel) {
    const bool refl = lo.z >= 0.0f;
    const V3 tm = norm3t(V3{m.eta_d * wi.x + lo.x, m.eta_d * wi.y + lo.y, m.eta_d * wi.z + lo.z});
    V3 dm = sel3(refl, h, tm);
    const float fl = dm.z >= 0.0f ? 1.0f : -1.0f;
    dm = V3{dm.x * fl, dm.y * fl, dm.z * fl};
    const float E_i_d = m.e_same(wi.z);
    const float E_o_r = m.e_same(fabsf(lo.z));
    const float E_o_t = m.e_other(fabsf(lo.z));
    float dv, dp;
    dielectric_at(m, wi, lo, dm, refl, E_i_d, E_o_r, E_o_t, &dv, &dp);
    e = v3(dv, dv, dv);
    p = dp;
    ok = pdf_ok(dp);
  }
  // conductor
  if (m.is_cond) {
    const float E_i_c = m.e_cond(wi.z);
    const float E_o_c = m.e_cond(fabsf(lo.z));
    V3 cv;
    float cp, odm;
    conductor_at(m, wi, lo, h, E_i_c, E_o_c, &cv, &cp, &odm);
    e = cv;
    p = cp;
    ok = lo.z > 0.0f && odm > 0.0f && pdf_ok(cp);
  }
  *ev = e;
  *ev_pdf = p;
  *ev_ok = ok;
}

template <class M>
__device__ __forceinline__ void bsdf_sample_of(const M& m, V3 wi, float f0, float f1, float r3, float r4, V3* out,
                                               float* pdf_out, V3* mul_out, bool* valid_out) {
  // diffuse: cosine hemisphere
  float sx, sy;
  sample_disk(r3, r4, &sx, &sy);
  const float sz = sqrtf(fmaxf(0.0f, 1.0f - sx * sx - sy * sy));
  const V3 s = v3(sx, sy, sz);
  const float pdf_dif = fmaxf(sz, 1e-8f) * (1.0f / SG_PI);
  V3 o = s;
  float pdf = pdf_dif;
  V3 mul = v3(1.0f, 1.0f, 1.0f);
  bool valid = pdf_ok(pdf_dif);

  if (m.is_plastic || m.is_diel || m.is_cond) {
    // one VNDF microfacet shared by the specular lobes (same draws)
    const V3 vm = vndf_sample(wi, m.alpha, r3, r4);
    if (m.is_plastic) {
      const float F_i_p = fres_diel(wi.z, SG_PLASTIC_ETA);
      const bool pick = f0 < F_i_p;
      const V3 po = sel3(pick, reflect3(wi, vm), s);
      const V3 pm = sel3(pick, vm, halfway(wi, s));
      V3 pv;
      float pp;
      plastic_at(m, wi, po, pm, &pv, &pp);
      const bool p_ok = pm.z >= 0.0f && po.z > 0.0f && pdf_ok(pp);
      const float inv_pp = 1.0f / fmaxf(pp, 1e-8f);
      o = po;
      pdf = pp;
      mul = v3(pv.x * inv_pp, pv.y * inv_pp, pv.z * inv_pp);
      valid = p_ok;
    }
    if (m.is_diel) {
      const float F_s = fres_diel(fabsf(dot3(wi, vm)), m.eta_d);
      const bool refl_s = f1 < F_s;
      const V3 s1 = sel3(refl_s, reflect3(wi, vm), refract3(wi, vm, m.eta_d));
      // multi branch: cosine lobe, hemisphere by ratio
      const bool refl_m = f1 > m.ratio_d;
      const float moz = sz * (refl_m ? 1.0f : -1.0f);
      const V3 mo = v3(sx, sy, moz);
      const V3 mh = halfway(wi, mo);
      const V3 tt = norm3t(V3{m.eta_d * wi.x + sx, m.eta_d * wi.y + sy, m.eta_d * wi.z + moz});
      const V3 mm = sel3(refl_m, mh, tt);
      const float E_i_d = m.e_same(wi.z);
      const bool single = f0 < E_i_d;
      const V3 go = sel3(single, s1, mo);
      V3 gm = sel3(single, vm, mm);
      const float fl = gm.z >= 0.0f ? 1.0f : -1.0f;
      gm = V3{gm.x * fl, gm.y * fl, gm.z * fl};
      const bool refl = single ? refl_s : refl_m;
      const float E_o_rs = m.e_same(fabsf(go.z));
      const float E_o_ts = m.e_other(fabsf(go.z));
      float dv, dp;
      dielectric_at(m, wi, go, gm, refl, E_i_d, E_o_rs, E_o_ts, &dv, &dp);
      const bool hemi_ok = refl == (go.z >= 0.0f);
      const float d_mul = dv / fmaxf(dp, 1e-8f);
      o = go;
      pdf = dp;
      mul = v3(d_mul, d_mul, d_mul);
      valid = hemi_ok && pdf_ok(dp);
    }
    if (m.is_cond) {
      const float E_i_c = m.e_cond(wi.z);
      const bool single_c = f0 < E_i_c;
      const V3 co = sel3(single_c, reflect3(wi, vm), s);
      const V3 cm = sel3(single_c, vm, halfway(wi, s));
      const float E_o_cs = m.e_cond(fabsf(co.z));
      V3 cv;
      float cp, odm;
      conductor_at(m, wi, co, cm, E_i_c, E_o_cs, &cv, &cp, &odm);
      const float inv_cp = 1.0f / fmaxf(cp, 1e-8f);
      o = co;
      pdf = cp;
      mul = v3(cv.x * inv_cp, cv.y * inv_cp, cv.z * inv_cp);
      valid = odm > 0.0f && co.z >= 0.0f && pdf_ok(cp);
    }
  }
  *out = o;
  *pdf_out = pdf;
  *mul_out = mul;
  *valid_out = valid;
}

// K3's calls, compiled as functions of their own as before the templates.
static __device__ void nee_eval(const Lane& m, V3 wi, V3 lo, V3* ev, float* ev_pdf, bool* ev_ok) {
  nee_eval_of(m, wi, lo, ev, ev_pdf, ev_ok);
}
static __device__ void bsdf_sample(const Lane& m, V3 wi, float f0, float f1, float r3, float r4, V3* out,
                                   float* pdf_out, V3* mul_out, bool* valid_out) {
  bsdf_sample_of(m, wi, f0, f1, r3, r4, out, pdf_out, mul_out, valid_out);
}

__device__ __forceinline__ V3 ld3(const float* p, int i) { return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]}; }
__device__ __forceinline__ void st3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
