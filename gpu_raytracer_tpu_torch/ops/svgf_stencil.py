"""SVGF spatial stages: the 7x7 variance estimate and the a-trous iterations.

Counterpart of the JAX package's `ops/pallas_svgf.py` (`svgf_spatial_pallas`,
TPU kernels `_variance_kernel` and `_atrous_kernel`). On CUDA tensors
`svgf_variance` and `svgf_atrous` launch the hand-written kernels in
`csrc/svgf_stencil.cu` (one thread a pixel; the variance kernel from a
shared-memory window of its tile and halo, in two instances by the normal
term's exponent; the a-trous kernel without clamps in the image's interior)
and raise if they cannot; on CPU tensors
they run `variance_plain` and `atrous_plain`, the same arithmetic as tensor
ops, in the TPU kernels' tap sign (`img[y + oy]`), tap order and
normalisations.

Images are float32, channel-major and unpadded:

  guide (5, H, W)  normal xyz | depth (sky sanitised to 1e30) | dz
  dyn   (8, H, W)  direct rgb | indirect rgb | var_d | var_i

and both stages return an (8, H, W) image in the dyn layout, so the a-trous
iterations chain without repacking. A tap outside the frame reads the
clamped edge pixel, as the TPU kernels' edge padding does. The TPU's gates
(`supports_width`, a VMEM budget, and the `2^(iterations-1) <= 32` halo
guard) do not apply: any width and any step work.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gpu_raytracer_tpu_torch.ops import _native

LUM = (0.2126, 0.7152, 0.0722)
GAUSS_3 = ((1.0 / 16, 2.0 / 16, 1.0 / 16),
           (2.0 / 16, 4.0 / 16, 2.0 / 16),
           (1.0 / 16, 2.0 / 16, 1.0 / 16))
GUIDE_CHANNELS, DYN_CHANNELS = 5, 8
ROLES = ("svgf_variance", "svgf_atrous")
# The variance kernel's instance for sigma_n = 16 (the default) has the
# exponent as a constant (csrc SV_POW_STATIC); any other sigma_n runs the
# instance that takes it at run time.
VARIANCE_STATIC_POW = 16
VARIANCE_INSTANCES = ("static", "runtime")

# Launch counts: a kernel's count rises only where the kernel is launched; a
# plain version's only where the plain version runs. `variance_instances`
# counts the variance launches by instance.
launches = {r: 0 for r in ROLES}
plain_calls = {r: 0 for r in ROLES}
variance_instances = {k: 0 for k in VARIANCE_INSTANCES}
# What `kernel_info` returns (csrc/svgf_stencil.cu sv_kernel_info), and the
# kernels it reports, in sv_kernel_info's order.
INFO = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm", "sms")
INFO_KERNELS = ("svgf_variance", "svgf_atrous", "svgf_variance_runtime")


def pack_guide(normal, depth, dz) -> torch.Tensor:
    """(H, W, 3) normal + (H, W) depth and dz -> (5, H, W)."""
    return torch.cat([normal.permute(2, 0, 1), depth[None], dz[None]]).contiguous()


def pack_dyn(direct, indirect, var_d, var_i) -> torch.Tensor:
    """(H, W, 3) x 2 + (H, W) x 2 -> (8, H, W)."""
    return torch.cat([direct.permute(2, 0, 1), indirect.permute(2, 0, 1),
                      var_d[None], var_i[None]]).contiguous()


def unpack(dyn):
    """(8, H, W) -> (direct (H, W, 3), indirect (H, W, 3), var_d, var_i)."""
    return (dyn[0:3].permute(1, 2, 0), dyn[3:6].permute(1, 2, 0), dyn[6], dyn[7])


def int_power(p: float) -> int:
    """The exponent as an int when `_pow_static` squares repeatedly, else 0."""
    ip = int(p)
    return ip if float(ip) == float(p) and 0 < ip <= 64 else 0


def _pow(x, p: float):
    """x**p as pallas_svgf `_pow_static`: repeated squaring for a small
    integer exponent, exp/log otherwise."""
    ip = int_power(p)
    if not ip:
        return torch.exp(p * torch.log(x.clamp(min=1e-20)))
    acc, base = None, x
    while ip:
        if ip & 1:
            acc = base if acc is None else acc * base
        base = base * base
        ip >>= 1
    return acc


def _lum(a, b, c):
    return LUM[0] * a + LUM[1] * b + LUM[2] * c


class _Taps:
    """Views of `img` (C, H, W) shifted by (oy, ox): tap(c, oy, ox)[y, x] =
    img[c, clamp(y + oy), clamp(x + ox)], from one edge-replicated copy."""

    def __init__(self, img, reach: int):
        self.H, self.W = img.shape[1], img.shape[2]
        self.r = reach
        self.p = F.pad(img, (reach,) * 4, mode="replicate")

    def __call__(self, c, oy, ox):
        r = self.r
        return self.p[c, r + oy:r + oy + self.H, r + ox:r + ox + self.W]


def _weights(g, d, oy, ox, n_c, z_c, dz_c, l_dc, l_ic, den_d, den_i,
             sigma_z, sigma_n):
    """Edge-stopping weights of tap (oy, ox) (pallas_svgf `_weights`)."""
    ndot = n_c[0] * g(0, oy, ox) + n_c[1] * g(1, oy, ox) + n_c[2] * g(2, oy, ox)
    w_n = _pow(ndot.clamp(min=0.0), sigma_n)
    dist = float((oy * oy + ox * ox) ** 0.5)
    w_z = torch.exp(-(z_c - g(3, oy, ox)).abs()
                    / (sigma_z * (dz_c * dist).clamp(min=1e-8)))
    l_dq = _lum(d(0, oy, ox), d(1, oy, ox), d(2, oy, ox))
    l_iq = _lum(d(3, oy, ox), d(4, oy, ox), d(5, oy, ox))
    w_l_d = torch.exp(-(l_dc - l_dq).abs() / den_d)
    w_l_i = torch.exp(-(l_ic - l_iq).abs() / den_i)
    base = w_n * w_z
    return base * w_l_d, base * w_l_i


def variance_plain(guide, dyn, sigma_z: float = 4.0, sigma_n: float = 16.0,
                   sigma_l: float = 10.0) -> torch.Tensor:
    """Plain PyTorch version of the 7x7 variance stage (TPU:
    `_variance_kernel`): filtered colour and the luminance-moment variance,
    with the constant luminance denominator sigma_l."""
    plain_calls["svgf_variance"] += 1
    g, d = _Taps(guide, 3), _Taps(dyn, 3)
    n_c, z_c, dz_c = (guide[0], guide[1], guide[2]), guide[3], guide[4]
    l_dc = _lum(dyn[0], dyn[1], dyn[2])
    l_ic = _lum(dyn[3], dyn[4], dyn[5])
    den = sigma_l * 1.0 + 1e-8
    zero = torch.zeros_like(l_dc)
    sum_w_d = sum_w_i = m_d1 = m_d2 = m_i1 = m_i2 = zero
    col_d, col_i = [zero] * 3, [zero] * 3
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            w_d, w_i = _weights(g, d, dy, dx, n_c, z_c, dz_c, l_dc, l_ic, den,
                                den, sigma_z, sigma_n)
            l_dq = _lum(d(0, dy, dx), d(1, dy, dx), d(2, dy, dx))
            l_iq = _lum(d(3, dy, dx), d(4, dy, dx), d(5, dy, dx))
            sum_w_d = sum_w_d + w_d
            sum_w_i = sum_w_i + w_i
            m_d1 = m_d1 + w_d * l_dq
            m_d2 = m_d2 + w_d * l_dq * l_dq
            m_i1 = m_i1 + w_i * l_iq
            m_i2 = m_i2 + w_i * l_iq * l_iq
            for c in range(3):
                col_d[c] = col_d[c] + w_d * d(c, dy, dx)
                col_i[c] = col_i[c] + w_i * d(3 + c, dy, dx)
    inv_d = 1.0 / sum_w_d.clamp(min=1e-8)
    inv_i = 1.0 / sum_w_i.clamp(min=1e-8)
    mu_d1 = m_d1 * inv_d
    mu_i1 = m_i1 * inv_i
    return torch.stack([*(x * inv_d for x in col_d), *(x * inv_i for x in col_i),
                        (m_d2 * inv_d - mu_d1 * mu_d1).clamp(min=0.0),
                        (m_i2 * inv_i - mu_i1 * mu_i1).clamp(min=0.0)])


def atrous_plain(guide, dyn, step: int, sigma_z: float = 4.0,
                 sigma_n: float = 16.0, sigma_l: float = 10.0) -> torch.Tensor:
    """Plain PyTorch version of one a-trous pass (TPU: `_atrous_kernel`):
    3x3 taps with hole spacing `step`, weights from the 3x3 gaussian
    pre-blurred variance, colour filtered by w and variance by w^2."""
    plain_calls["svgf_atrous"] += 1
    g, d = _Taps(guide, max(step, 1)), _Taps(dyn, max(step, 1))
    n_c, z_c, dz_c = (guide[0], guide[1], guide[2]), guide[3], guide[4]
    vd_b = vi_b = torch.zeros_like(dyn[6])
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            w = GAUSS_3[dy + 1][dx + 1]
            vd_b = vd_b + w * d(6, dy, dx)
            vi_b = vi_b + w * d(7, dy, dx)
    l_dc = _lum(dyn[0], dyn[1], dyn[2])
    l_ic = _lum(dyn[3], dyn[4], dyn[5])
    den_d = sigma_l * torch.sqrt(vd_b.clamp(min=0.0)) + 1e-8
    den_i = sigma_l * torch.sqrt(vi_b.clamp(min=0.0)) + 1e-8

    sum_w_d = torch.ones_like(l_dc)
    sum_w_i = torch.ones_like(l_ic)
    out_d = [dyn[c] for c in range(3)]
    out_i = [dyn[3 + c] for c in range(3)]
    out_vd, out_vi = dyn[6], dyn[7]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            oy, ox = dy * step, dx * step
            w_d, w_i = _weights(g, d, oy, ox, n_c, z_c, dz_c, l_dc, l_ic,
                                den_d, den_i, sigma_z, sigma_n)
            for c in range(3):
                out_d[c] = out_d[c] + w_d * d(c, oy, ox)
                out_i[c] = out_i[c] + w_i * d(3 + c, oy, ox)
            out_vd = out_vd + (w_d * w_d) * d(6, oy, ox)
            out_vi = out_vi + (w_i * w_i) * d(7, oy, ox)
            sum_w_d = sum_w_d + w_d
            sum_w_i = sum_w_i + w_i
    inv_d = 1.0 / sum_w_d
    inv_i = 1.0 / sum_w_i
    return torch.stack([*(x * inv_d for x in out_d), *(x * inv_i for x in out_i),
                        out_vd / (sum_w_d * sum_w_d).clamp(min=1e-8),
                        out_vi / (sum_w_i * sum_w_i).clamp(min=1e-8)])


# ---------------------------------------------------------------------------
# Dispatch: CUDA kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def _check(guide, dyn) -> None:
    H, W = guide.shape[1:] if guide.dim() == 3 else (-1, -1)
    if guide.shape != (GUIDE_CHANNELS, H, W) or dyn.shape != (DYN_CHANNELS, H, W):
        raise ValueError(f"guide must be (5, H, W) and dyn (8, H, W), got "
                         f"{tuple(guide.shape)} and {tuple(dyn.shape)}")
    if guide.dtype != torch.float32 or dyn.dtype != torch.float32:
        raise ValueError("SVGF stencil images must be float32")
    if guide.device != dyn.device:
        raise ValueError("guide and dyn must share one device")


def _launch(role: str, guide, dyn, step, sigma_z, sigma_n, sigma_l):
    lib = _native.load()
    guide, dyn = guide.contiguous(), dyn.contiguous()
    H, W = guide.shape[1], guide.shape[2]
    out = torch.empty_like(dyn)
    ptr = [ctypes.c_void_p(x.data_ptr()) for x in (guide, dyn, out)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(guide.device).cuda_stream)
    ip = int_power(sigma_n)
    if role == "svgf_variance":
        err = lib.sv_variance(*ptr, H, W, sigma_z, sigma_n, ip, sigma_l * 1.0 + 1e-8,
                              stream)
    else:
        err = lib.sv_atrous(*ptr, H, W, int(step), sigma_z, sigma_n, ip, sigma_l,
                            stream)
    _native.check(err, role)
    launches[role] += 1
    if role == "svgf_variance":
        variance_instances[variance_instance(sigma_n)] += 1
    return out


def variance_instance(sigma_n: float) -> str:
    """The variance kernel's instance that runs for `sigma_n`."""
    return "static" if int_power(sigma_n) == VARIANCE_STATIC_POW else "runtime"


def kernel_info(kernel: str) -> dict:
    """What the compiler and the occupancy API report for a kernel on the
    card (one of INFO_KERNELS; INFO: registers, stack frame and static
    shared bytes, the threads of a block, the blocks an SM holds, the
    SMs)."""
    lib = _native.load()
    out = (ctypes.c_int * len(INFO))()
    _native.check(lib.sv_kernel_info(INFO_KERNELS.index(kernel), out),
                  f"svgf_stencil.kernel_info({kernel})")
    return dict(zip(INFO, list(out)))


def svgf_variance(guide, dyn, sigma_z: float = 4.0, sigma_n: float = 16.0,
                  sigma_l: float = 10.0) -> torch.Tensor:
    """The 7x7 variance stage (TPU: `_variance_kernel`) -> (8, H, W)."""
    _check(guide, dyn)
    if guide.device.type == "cuda":
        return _launch("svgf_variance", guide, dyn, 1, sigma_z, sigma_n, sigma_l)
    if guide.device.type == "cpu":
        return variance_plain(guide, dyn, sigma_z, sigma_n, sigma_l)
    raise RuntimeError(f"no SVGF stencil kernel for device {guide.device}")


def svgf_atrous(guide, dyn, step: int, sigma_z: float = 4.0,
                sigma_n: float = 16.0, sigma_l: float = 10.0) -> torch.Tensor:
    """One a-trous pass with hole spacing `step` (TPU: `_atrous_kernel`)
    -> (8, H, W)."""
    _check(guide, dyn)
    if guide.device.type == "cuda":
        return _launch("svgf_atrous", guide, dyn, step, sigma_z, sigma_n, sigma_l)
    if guide.device.type == "cpu":
        return atrous_plain(guide, dyn, step, sigma_z, sigma_n, sigma_l)
    raise RuntimeError(f"no SVGF stencil kernel for device {guide.device}")


def svgf_spatial(frame: dict, integrated: dict, iterations: int = 6,
                 feedback_iteration: int = 1, sigma_z: float = 4.0,
                 sigma_n: float = 16.0, sigma_l: float = 10.0,
                 spatial_variance: bool = True, kernels=None):
    """The spatial SVGF stages (JAX: svgf_spatial_pallas): the 7x7 variance
    estimate, taken where the history is shorter than 4 frames, then
    `iterations` a-trous passes with step 2^i. `frame` holds normal, depth
    and dz; `integrated` direct, indirect, var_direct, var_indirect and
    length. `kernels` names the functions of the two roles (attributes
    `svgf_variance`, `svgf_atrous`; default: the dispatching ones).
    Returns (direct, indirect, (fb_direct, fb_indirect)), the feedback being
    iteration `feedback_iteration`'s output."""
    variance = kernels.svgf_variance if kernels is not None else svgf_variance
    atrous = kernels.svgf_atrous if kernels is not None else svgf_atrous
    guide = pack_guide(frame["normal"], frame["depth"], frame["dz"])
    dyn = pack_dyn(integrated["direct"], integrated["indirect"],
                   integrated["var_direct"], integrated["var_indirect"])
    if spatial_variance:
        sp = variance(guide, dyn, sigma_z, sigma_n, sigma_l)
        dyn = torch.where((integrated["length"] < 4.0)[None], sp, dyn)
    feedback = dyn
    for i in range(iterations):
        dyn = atrous(guide, dyn, 1 << i, sigma_z, sigma_n, sigma_l)
        if i == feedback_iteration:
            feedback = dyn
    direct, indirect, _, _ = unpack(dyn)
    fb_direct, fb_indirect, _, _ = unpack(feedback)
    return direct, indirect, (fb_direct, fb_indirect)
