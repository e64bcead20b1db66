// SVGF spatial stencils on NVIDIA Hopper (sm_90a), one thread a pixel.
//
// Replaces the TPU kernels of gpu_raytracer_tpu/ops/pallas_svgf.py:
//   sv_variance  <- `_variance_kernel` (the 7x7 bilateral moment estimate)
//   sv_atrous    <- `_atrous_kernel`   (one 3x3 a-trous pass, hole spacing
//                                       `step`)
// both launched there through `_run_stencil`.
//
// Layout (packed by ops/svgf_stencil.py), float32, channel-major, unpadded:
//   guide (5, H, W): normal xyz | depth (sky sanitised to 1e30) | dz
//   dyn   (8, H, W): direct rgb | indirect rgb | var_d | var_i
//   out   (8, H, W): the same channels as dyn, normalised.
// A tap at (y + oy, x + ox) reads the pixel at the clamped index, which is
// exactly the TPU kernel's edge padding (`_pad_cmajor`): any step and any
// width work, with no halo limit and no VMEM width gate.
//
// The arithmetic follows the TPU kernel (and the plain PyTorch versions in
// ops/svgf_stencil.py) term by term: tap order, the `_pow_static` repeated
// squaring for an integer sigma_n, the luminance denominators, the
// normalisations. The library is built with -fmad=false, so products and
// sums round as the plain versions' do; only expf/logf may differ by an ulp.
//
// What bounds it on the card: a 1080p launch moves 21 planes of 2,073,600
// floats (13 read, 8 written: 174 MB, 0.052 ms at 3.35 TB/s); the variance
// pass does ~2,500 flops per pixel (49 taps with three exponentials each),
// the a-trous pass ~450: both are bound by instruction issue (their accurate
// expf and IEEE divisions), not by bytes. The variance pass stages a tile
// and its halo in shared memory, computing each pixel's luminances once;
// the a-trous pass, six launches a frame, reads global memory directly,
// with no clamps and 32-bit offsets in the image's interior (below).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "kernel_report.cuh"

#define SV_LUM_R 0.2126f
#define SV_LUM_G 0.7152f
#define SV_LUM_B 0.0722f

__device__ __forceinline__ float sv_lum(float r, float g, float b) {
  return SV_LUM_R * r + SV_LUM_G * g + SV_LUM_B * b;
}

// x**p: repeated squaring for an integer exponent 0 < ip <= 64 (pallas_svgf
// `_pow_static`), exp/log otherwise (ip == 0).
__device__ __forceinline__ float sv_pow(float x, float p, int ip) {
  if (ip > 0) {
    float acc = 0.0f, base = x;
    bool have = false;
    for (int e = ip; e; e >>= 1) {
      if (e & 1) {
        acc = have ? acc * base : base;
        have = true;
      }
      base = base * base;
    }
    return acc;
  }
  return expf(p * logf(fmaxf(x, 1e-20f)));
}

__device__ __forceinline__ size_t sv_tap(int y, int x, int oy, int ox, int H, int W) {
  const int yy = min(max(y + oy, 0), H - 1);
  const int xx = min(max(x + ox, 0), W - 1);
  return (size_t)yy * W + xx;
}

// ---- the variance pass: a shared-memory window, one thread a pixel ----
//
// A block stages its SV_VAR_TILE_X x SV_VAR_TILE_Y output tile and a
// SV_VAR_R-pixel halo (38 x 22 pixels) in shared memory: per pixel the
// normal, depth, the six colour channels and the direct and indirect
// luminance, as three float4. Each window pixel is loaded at its clamped
// index (the TPU kernel's edge padding, done once a pixel) and its two
// luminances are computed once, with the same sv_lum (the same bits under
// -fmad=false), instead of once by each of the 49 pixels whose footprint
// holds it. The 7x7 loop is unrolled, its taps read the window at 32-bit
// offsets with no clamp, and each tap's distance is a constant. The
// exponent of the normal term is a template parameter: SV_POW_STATIC for
// the default sigma_n = 16 (four products), SV_POW_RUNTIME for any other
// sigma_n (sv_pow: repeated squaring, or exp/log for a non-integer).
// Accumulation order, expf and the IEEE divisions are the parent kernel's
// (ROADMAP C6), so the output is bit-equal to the per-tap global-load
// kernel it replaces; the pass is bound by those instructions.
constexpr int SV_VAR_TILE_X = 32;
constexpr int SV_VAR_TILE_Y = 16;
constexpr int SV_VAR_R = 3;  // the 7x7 footprint's reach
constexpr int SV_VAR_WX = SV_VAR_TILE_X + 2 * SV_VAR_R;
constexpr int SV_VAR_WY = SV_VAR_TILE_Y + 2 * SV_VAR_R;
constexpr int SV_VAR_WIN = SV_VAR_WX * SV_VAR_WY;
constexpr int SV_VAR_THREADS = SV_VAR_TILE_X * SV_VAR_TILE_Y;
constexpr int SV_POW_STATIC = 16;  // ops/svgf_stencil.VARIANCE_STATIC_POW
constexpr int SV_POW_RUNTIME = 0;

// x**p as sv_pow, with a positive exponent IP known at compile time: the
// same products in the same order.
template <int IP>
__device__ __forceinline__ float sv_pow_t(float x, float p, int ip) {
  if constexpr (IP > 0) {
    float acc = 0.0f, base = x;
    bool have = false;
#pragma unroll
    for (int e = IP; e; e >>= 1) {
      if (e & 1) {
        acc = have ? acc * base : base;
        have = true;
      }
      base = base * base;
    }
    return acc;
  } else {
    return sv_pow(x, p, ip);
  }
}

template <int IP>
__global__ void __launch_bounds__(SV_VAR_THREADS)
sv_variance_kernel(const float* __restrict__ g, const float* __restrict__ d,
                   float* __restrict__ out, int H, int W, float sigma_z, float sigma_n, int ip,
                   float den) {
  // Window pixel k: geo (normal xyz, depth), col (direct rgb, indirect r),
  // lum (indirect g b, direct luminance, indirect luminance).
  __shared__ float4 s_geo[SV_VAR_WIN], s_col[SV_VAR_WIN], s_lum[SV_VAR_WIN];
  const int tid = threadIdx.y * SV_VAR_TILE_X + threadIdx.x;
  const int x0 = blockIdx.x * SV_VAR_TILE_X, y0 = blockIdx.y * SV_VAR_TILE_Y;
  const size_t plane = (size_t)H * W;
  for (int k = tid; k < SV_VAR_WIN; k += SV_VAR_THREADS) {
    const int wy = k / SV_VAR_WX, wx = k - wy * SV_VAR_WX;
    const size_t q = sv_tap(y0 - SV_VAR_R, x0 - SV_VAR_R, wy, wx, H, W);
    const float c0 = __ldg(d + q), c1 = __ldg(d + plane + q), c2 = __ldg(d + 2 * plane + q);
    const float c3 = __ldg(d + 3 * plane + q), c4 = __ldg(d + 4 * plane + q),
                c5 = __ldg(d + 5 * plane + q);
    s_geo[k] = make_float4(__ldg(g + q), __ldg(g + plane + q), __ldg(g + 2 * plane + q),
                           __ldg(g + 3 * plane + q));
    s_col[k] = make_float4(c0, c1, c2, c3);
    s_lum[k] = make_float4(c4, c5, sv_lum(c0, c1, c2), sv_lum(c3, c4, c5));
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t p = (size_t)y * W + x;
  const int cw = (threadIdx.y + SV_VAR_R) * SV_VAR_WX + threadIdx.x + SV_VAR_R;
  const float4 cg = s_geo[cw], cl = s_lum[cw];
  const float c_dz = __ldg(g + 4 * plane + p);

  float sum_w_d = 0.0f, sum_w_i = 0.0f;
  float m_d1 = 0.0f, m_d2 = 0.0f, m_i1 = 0.0f, m_i2 = 0.0f;
  float cd0 = 0.0f, cd1 = 0.0f, cd2 = 0.0f, ci0 = 0.0f, ci1 = 0.0f, ci2 = 0.0f;
#pragma unroll
  for (int dy = -SV_VAR_R; dy <= SV_VAR_R; ++dy) {
#pragma unroll
    for (int dx = -SV_VAR_R; dx <= SV_VAR_R; ++dx) {
      const int q = cw + dy * SV_VAR_WX + dx;
      const float4 a = s_geo[q], b = s_col[q], c = s_lum[q];
      // Edge-stopping weights (pallas_svgf `_weights`): normal, depth and
      // luminance terms.
      const float ndot = cg.x * a.x + cg.y * a.y + cg.z * a.z;
      const float w_n = sv_pow_t<IP>(fmaxf(ndot, 0.0f), sigma_n, ip);
      const float dist = sqrtf((float)(dy * dy + dx * dx));
      const float w_z = expf(-fabsf(cg.w - a.w) / (sigma_z * fmaxf(c_dz * dist, 1e-8f)));
      const float l_dq = c.z, l_iq = c.w;
      const float w_l_d = expf(-fabsf(cl.z - l_dq) / den);
      const float w_l_i = expf(-fabsf(cl.w - l_iq) / den);
      const float base = w_n * w_z;
      const float w_d = base * w_l_d, w_i = base * w_l_i;
      sum_w_d = sum_w_d + w_d;
      sum_w_i = sum_w_i + w_i;
      m_d1 = m_d1 + w_d * l_dq;
      m_d2 = m_d2 + w_d * l_dq * l_dq;
      m_i1 = m_i1 + w_i * l_iq;
      m_i2 = m_i2 + w_i * l_iq * l_iq;
      cd0 = cd0 + w_d * b.x;
      ci0 = ci0 + w_i * b.w;
      cd1 = cd1 + w_d * b.y;
      ci1 = ci1 + w_i * c.x;
      cd2 = cd2 + w_d * b.z;
      ci2 = ci2 + w_i * c.y;
    }
  }
  const float inv_d = 1.0f / fmaxf(sum_w_d, 1e-8f);
  const float inv_i = 1.0f / fmaxf(sum_w_i, 1e-8f);
  const float mu_d1 = m_d1 * inv_d;
  const float mu_i1 = m_i1 * inv_i;
  out[p] = cd0 * inv_d;
  out[plane + p] = cd1 * inv_d;
  out[2 * plane + p] = cd2 * inv_d;
  out[3 * plane + p] = ci0 * inv_i;
  out[4 * plane + p] = ci1 * inv_i;
  out[5 * plane + p] = ci2 * inv_i;
  out[6 * plane + p] = fmaxf(m_d2 * inv_d - mu_d1 * mu_d1, 0.0f);
  out[7 * plane + p] = fmaxf(m_i2 * inv_i - mu_i1 * mu_i1, 0.0f);
}

__constant__ float SV_GAUSS_3[3][3] = {{1.0f / 16, 2.0f / 16, 1.0f / 16},
                                       {2.0f / 16, 4.0f / 16, 2.0f / 16},
                                       {1.0f / 16, 2.0f / 16, 1.0f / 16}};

// ---- the a-trous pass: a clamp-free interior, each tap's planes read once ----
//
// One thread a pixel (groups of 2 and 4 pixels with vector loads, and a
// shared-memory window for steps 1 and 2, ran slower on the H100: PERF.md).
// The per-pixel arithmetic is sv_atrous_body's, shared by two loaders:
//   SvInLoad     the interior (the pixel and its taps at +-step and +-1
//      inside the image, H * W below 2^31): 32-bit offsets, no min/max.
//   SvClampLoad  the border pixels: each tap at the clamped index (the TPU
//      kernel's edge padding).
// Each tap's 12 planes are read once: the luminances feed both the weights
// and, with the colours, the sums. The tap distance is a constant of the
// tap's direction, worked out once (bit-identical to the per-tap sqrtf).
// Planes are named by k: 0-4 the guide's, 5-12 dyn's.
constexpr int SV_BLOCK_X = 32;
constexpr int SV_BLOCK_Y = 4;

// The planes of the two images.
struct SvPlanes {
  const float* __restrict__ g;
  const float* __restrict__ d;
  size_t plane;
  __device__ __forceinline__ const float* operator()(int k) const {
    return k < 5 ? g + k * plane : d + (k - 5) * plane;
  }
};

struct SvInLoad {
  SvPlanes pl;
  int p;  // y * W + x
  int W;
  __device__ __forceinline__ float operator()(int k, int oy, int ox) const {
    return __ldg(pl(k) + (p + oy * W + ox));
  }
};

struct SvClampLoad {
  SvPlanes pl;
  int y, x, H, W;
  __device__ __forceinline__ float operator()(int k, int oy, int ox) const {
    return __ldg(pl(k) + (size_t)min(max(y + oy, 0), H - 1) * W + min(max(x + ox, 0), W - 1));
  }
};

// One pixel's a-trous pass (pallas_svgf `_atrous_kernel`, term by term):
// the 3x3 gaussian pre-blur of the variance, the 8 taps in the plain
// version's order, the normalisation. `o` takes the 8 output channels.
template <class Load>
__device__ __forceinline__ void sv_atrous_body(const Load& ld, int step, float sigma_z,
                                               float sigma_n, int ip, float sigma_l,
                                               float o[8]) {
  const float n0 = ld(0, 0, 0), n1 = ld(1, 0, 0), n2 = ld(2, 0, 0), z = ld(3, 0, 0),
              dz = ld(4, 0, 0);
#pragma unroll
  for (int c = 0; c < 8; ++c) o[c] = ld(5 + c, 0, 0);
  const float l_d = sv_lum(o[0], o[1], o[2]);
  const float l_i = sv_lum(o[3], o[4], o[5]);

  // 3x3 gaussian pre-blur of the variance, for the weights only.
  float vd_b = 0.0f, vi_b = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float w = SV_GAUSS_3[dy + 1][dx + 1];
      vd_b = vd_b + w * ld(11, dy, dx);
      vi_b = vi_b + w * ld(12, dy, dx);
    }
  }
  const float den_d = sigma_l * sqrtf(fmaxf(vd_b, 0.0f)) + 1e-8f;
  const float den_i = sigma_l * sqrtf(fmaxf(vi_b, 0.0f)) + 1e-8f;

  const float dist_axis = sqrtf((float)(step * step));
  const float dist_diag = sqrtf((float)(step * step + step * step));
  float sum_w_d = 1.0f, sum_w_i = 1.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int oy = dy * step, ox = dx * step;
      const float dist = dy != 0 && dx != 0 ? dist_diag : dist_axis;
      float q[12];  // normal xyz, depth, then the 8 dyn channels
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = ld(c, oy, ox);
#pragma unroll
      for (int c = 0; c < 8; ++c) q[4 + c] = ld(5 + c, oy, ox);
      const float ndot = n0 * q[0] + n1 * q[1] + n2 * q[2];
      const float w_n = sv_pow(fmaxf(ndot, 0.0f), sigma_n, ip);
      const float w_z = expf(-fabsf(z - q[3]) / (sigma_z * fmaxf(dz * dist, 1e-8f)));
      const float l_dq = sv_lum(q[4], q[5], q[6]);
      const float l_iq = sv_lum(q[7], q[8], q[9]);
      const float w_l_d = expf(-fabsf(l_d - l_dq) / den_d);
      const float w_l_i = expf(-fabsf(l_i - l_iq) / den_i);
      const float base = w_n * w_z;
      const float w_d = base * w_l_d, w_i = base * w_l_i;
      o[0] = o[0] + w_d * q[4];
      o[3] = o[3] + w_i * q[7];
      o[1] = o[1] + w_d * q[5];
      o[4] = o[4] + w_i * q[8];
      o[2] = o[2] + w_d * q[6];
      o[5] = o[5] + w_i * q[9];
      o[6] = o[6] + (w_d * w_d) * q[10];
      o[7] = o[7] + (w_i * w_i) * q[11];
      sum_w_d = sum_w_d + w_d;
      sum_w_i = sum_w_i + w_i;
    }
  }
  const float inv_d = 1.0f / sum_w_d;
  const float inv_i = 1.0f / sum_w_i;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = o[c] * inv_d;
    o[3 + c] = o[3 + c] * inv_i;
  }
  o[6] = o[6] / fmaxf(sum_w_d * sum_w_d, 1e-8f);
  o[7] = o[7] / fmaxf(sum_w_i * sum_w_i, 1e-8f);
}

__global__ void __launch_bounds__(SV_BLOCK_X * SV_BLOCK_Y)
sv_atrous_kernel(const float* __restrict__ g, const float* __restrict__ d,
                 float* __restrict__ out, int H, int W, int step, float sigma_z, float sigma_n,
                 int ip, float sigma_l) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const SvPlanes pl{g, d, (size_t)H * W};
  const size_t p = (size_t)y * W + x;
  float o[8];
  // Taps at +-step and +-1 (step >= 1 covers the pre-blur's); int offsets
  // while H * W < 2^31.
  if (y >= step && y + step < H && x >= step && x + step < W && step >= 1 &&
      pl.plane < (1ull << 31))
    sv_atrous_body(SvInLoad{pl, (int)p, W}, step, sigma_z, sigma_n, ip, sigma_l, o);
  else
    sv_atrous_body(SvClampLoad{pl, y, x, H, W}, step, sigma_z, sigma_n, ip, sigma_l, o);
#pragma unroll
  for (int c = 0; c < 8; ++c) out[c * pl.plane + p] = o[c];
}

static dim3 sv_grid(int H, int W, dim3 block) {
  return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
}

// Each returns the cudaError_t of its launch (0 on success).
extern "C" int sv_variance(const float* guide, const float* dyn, float* out, int H, int W,
                           float sigma_z, float sigma_n, int int_pow, float den,
                           void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(SV_VAR_TILE_X, SV_VAR_TILE_Y);
  const dim3 grid = sv_grid(H, W, block);
  if (int_pow == SV_POW_STATIC)
    sv_variance_kernel<SV_POW_STATIC><<<grid, block, 0, (cudaStream_t)stream>>>(
        guide, dyn, out, H, W, sigma_z, sigma_n, int_pow, den);
  else
    sv_variance_kernel<SV_POW_RUNTIME><<<grid, block, 0, (cudaStream_t)stream>>>(
        guide, dyn, out, H, W, sigma_z, sigma_n, int_pow, den);
  return (int)cudaGetLastError();
}

// The exponent of sv_variance_kernel's static instance.
extern "C" int sv_variance_static_pow() { return SV_POW_STATIC; }

extern "C" int sv_atrous(const float* guide, const float* dyn, float* out, int H, int W,
                         int step, float sigma_z, float sigma_n, int int_pow, float sigma_l,
                         void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(SV_BLOCK_X, SV_BLOCK_Y);
  sv_atrous_kernel<<<sv_grid(H, W, block), block, 0, (cudaStream_t)stream>>>(
      guide, dyn, out, H, W, step, sigma_z, sigma_n, int_pow, sigma_l);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy API report for a kernel
// (kernel_report): 0 the variance kernel's static instance (sigma_n = 16),
// 1 the a-trous kernel, 2 the variance kernel's run-time instance. Returns
// a cudaError_t.
extern "C" int sv_kernel_info(int kernel, int* out) {
  const void* k = kernel == 0   ? (const void*)sv_variance_kernel<SV_POW_STATIC>
                  : kernel == 1 ? (const void*)sv_atrous_kernel
                                : (const void*)sv_variance_kernel<SV_POW_RUNTIME>;
  return kernel_report(k, kernel == 1 ? SV_BLOCK_X * SV_BLOCK_Y : SV_VAR_THREADS, out);
}
