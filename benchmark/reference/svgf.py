"""The plain reference of the denoise stage: SVGF (temporal reprojection,
the 7x7 variance estimate, the a-trous passes, the re-modulation) and TAA,
in plain PyTorch, for the denoised cells.

A frozen copy of the port's plain versions, which its tests hold to the
JAX package: `gpu_raytracer_tpu_torch/ops/svgf.py` (`shift` :55-60,
`_median` :63-68, `window_mask` :71-90, `floor_index` :93-96,
`project_to_screen` :99-110, `reproject` :113-176, `finalize` :179-182,
`svgf_step` :185-214), `ops/svgf_stencil.py` (`pack_guide`, `pack_dyn`,
`unpack`, `int_power`, `_pow`, `_lum`, `_Taps`, `_weights`,
`variance_plain`, `atrous_plain`: :59-214; `svgf_spatial` :289-316),
`ops/taa.py` (:28-100) and `integrators/pathtracer.py` (`Pathtracer.denoise`
:1122-1138; the view-projection of `scene/camera.py` :71-81 and
`_perspective` :102-112), with the launch counters and the kernel
dispatch left out. It runs in the dtype of its inputs. Imports nothing of
the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

LUM = (0.2126, 0.7152, 0.0722)
GAUSS_3 = ((1.0 / 16, 2.0 / 16, 1.0 / 16),
           (2.0 / 16, 4.0 / 16, 2.0 / 16),
           (1.0 / 16, 2.0 / 16, 1.0 / 16))
REPROJECT_WIN = 2
REPROJECT_MAX_SHIFT = 64
TAA_ALPHA = 0.1
GAMMA_CLAMP = 1.25
NEAR, FAR = 0.1, 300.0


class History(NamedTuple):
    direct: torch.Tensor
    indirect: torch.Tensor
    moments: torch.Tensor
    length: torch.Tensor
    normal: torch.Tensor
    depth: torch.Tensor
    instance: torch.Tensor


def luminance(rgb):
    return LUM[0] * rgb[..., 0] + LUM[1] * rgb[..., 1] + LUM[2] * rgb[..., 2]


def view_projection(camera: dict, position, width: int, height: int) -> np.ndarray:
    """Column-vector view-projection of a camera at `position` (the port's
    Camera.update with its perspective matrix; fov across the width)."""
    tan_half = np.tan(0.5 * camera["fov"])
    aspect = (0.5 * height) / (0.5 * width)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 1.0 / tan_half
    proj[1, 1] = 1.0 / (tan_half * aspect)
    proj[2, 2] = -(FAR + NEAR) / (FAR - NEAR)
    proj[2, 3] = -2.0 * FAR * NEAR / (FAR - NEAR)
    proj[3, 2] = -1.0
    x, y, z, w = (float(v) for v in camera["rotation"])
    x, y, z = -x, -y, -z
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = np.array(
        [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]], np.float32)
    trans = np.eye(4, dtype=np.float32)
    trans[:3, 3] = -np.asarray(position, np.float32)
    return proj @ rot @ trans


def shift(img, dy: int, dx: int):
    H, W = img.shape[0], img.shape[1]
    ys = (torch.arange(H, device=img.device) - dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=img.device) - dx).clamp(0, W - 1)
    return img[ys][:, xs]


def _median(x):
    s = x.flatten().sort().values
    n = s.numel()
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def window_mask(x0, y0, win: int = REPROJECT_WIN):
    H, W = x0.shape
    cols = torch.arange(W, device=x0.device)[None, :]
    rows = torch.arange(H, device=x0.device)[:, None]
    dx = x0 - cols
    dy = y0 - rows
    P = REPROJECT_MAX_SHIFT
    gx = torch.round(_median(dx[::8, ::8].float())).clamp(-P, P).to(x0.dtype)
    gy = torch.round(_median(dy[::8, ::8].float())).clamp(-P, P).to(x0.dtype)
    rx = dx - gx
    ry = dy - gy
    return ((rx.abs() <= win) & (ry.abs() <= win)
            & (cols + rx >= 0) & (cols + rx < W)
            & (rows + ry >= 0) & (rows + ry < H)
            & (x0 >= 0) & (x0 < W) & (y0 >= 0) & (y0 < H))


def floor_index(p):
    return torch.floor(p.float()).clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int32)


def project_to_screen(points, vp, width: int, height: int):
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    clip_x = vp[0, 0] * x + vp[0, 1] * y + vp[0, 2] * z + vp[0, 3]
    clip_y = vp[1, 0] * x + vp[1, 1] * y + vp[1, 2] * z + vp[1, 3]
    clip_w = vp[3, 0] * x + vp[3, 1] * y + vp[3, 2] * z + vp[3, 3]
    w = torch.where(clip_w.abs() < 1e-8, 1e-8, clip_w)
    sx = (clip_x / w * 0.5 + 0.5) * width
    sy = (clip_y / w * 0.5 + 0.5) * height
    return torch.stack([sx, sy], dim=-1)


def reproject(frame: dict, history: History, screen_prev, alpha: float, alpha_moments: float):
    H, W = frame["depth"].shape
    direct, indirect = frame["direct"], frame["indirect"]
    l_d, l_i = luminance(direct), luminance(indirect)
    mu = torch.stack([l_d, l_d * l_d, l_i, l_i * l_i], dim=-1)
    px = screen_prev[..., 0] - 0.5
    py = screen_prev[..., 1] - 0.5
    x0, y0 = floor_index(px), floor_index(py)
    fx, fy = px - x0, py - y0
    in_window = window_mask(x0.clamp(0, W - 2), y0.clamp(0, H - 2))
    hist = torch.cat([history.direct, history.indirect, history.moments,
                      history.length[..., None], history.normal,
                      history.depth[..., None],
                      history.instance[..., None].to(history.direct.dtype)], dim=-1)
    inst_cur = frame["instance"].to(hist.dtype)
    z_cur = frame["depth"]

    def tap(xi, yi, wgt):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & in_window
        f = hist[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        z_prev = f[..., 14]
        z_prev = torch.where(torch.isfinite(z_prev), z_prev, 1e30)
        consistent = (((f[..., 11:14] * frame["normal"]).sum(-1) > 0.95)
                      & ((z_prev - z_cur).abs() < 2.0 * (z_cur * 0.02).clamp(min=1e-2))
                      & (f[..., 15] == inst_cur))
        w = torch.where(ok & consistent, wgt, 0.0)
        return (w, w[..., None] * f[..., 0:3], w[..., None] * f[..., 3:6],
                w[..., None] * f[..., 6:10], w * f[..., 10])

    taps = [tap(x0, y0, (1 - fx) * (1 - fy)), tap(x0 + 1, y0, fx * (1 - fy)),
            tap(x0, y0 + 1, (1 - fx) * fy), tap(x0 + 1, y0 + 1, fx * fy)]
    w_sum, prev_direct, prev_indirect, prev_moments, prev_length = (
        sum(t[k] for t in taps) for k in range(5))
    valid = w_sum > 1e-4
    inv_w = 1.0 / w_sum.clamp(min=1e-4)
    prev_direct = prev_direct * inv_w[..., None]
    prev_indirect = prev_indirect * inv_w[..., None]
    prev_moments = prev_moments * inv_w[..., None]
    prev_length = prev_length * inv_w
    length = torch.where(valid, prev_length + 1.0, 1.0)
    a_c = torch.clamp(1.0 / length, min=alpha)[..., None]
    a_m = torch.clamp(1.0 / length, min=alpha_moments)[..., None]
    v = valid[..., None]
    int_direct = torch.where(v, prev_direct + a_c * (direct - prev_direct), direct)
    int_indirect = torch.where(v, prev_indirect + a_c * (indirect - prev_indirect), indirect)
    int_moments = torch.where(v, prev_moments + a_m * (mu - prev_moments), mu)
    m = int_moments
    return {"direct": int_direct, "indirect": int_indirect, "moments": int_moments,
            "length": length,
            "var_direct": (m[..., 1] - m[..., 0] * m[..., 0]).clamp(min=0.0),
            "var_indirect": (m[..., 3] - m[..., 2] * m[..., 2]).clamp(min=0.0)}


def int_power(p: float) -> int:
    ip = int(p)
    return ip if float(ip) == float(p) and 0 < ip <= 64 else 0


def _pow(x, p: float):
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
    def __init__(self, img, reach: int):
        self.H, self.W = img.shape[1], img.shape[2]
        self.r = reach
        self.p = F.pad(img, (reach,) * 4, mode="replicate")

    def __call__(self, c, oy, ox):
        r = self.r
        return self.p[c, r + oy:r + oy + self.H, r + ox:r + ox + self.W]


def _weights(g, d, oy, ox, n_c, z_c, dz_c, l_dc, l_ic, den_d, den_i, sigma_z, sigma_n):
    ndot = n_c[0] * g(0, oy, ox) + n_c[1] * g(1, oy, ox) + n_c[2] * g(2, oy, ox)
    w_n = _pow(ndot.clamp(min=0.0), sigma_n)
    dist = float((oy * oy + ox * ox) ** 0.5)
    w_z = torch.exp(-(z_c - g(3, oy, ox)).abs() / (sigma_z * (dz_c * dist).clamp(min=1e-8)))
    l_dq = _lum(d(0, oy, ox), d(1, oy, ox), d(2, oy, ox))
    l_iq = _lum(d(3, oy, ox), d(4, oy, ox), d(5, oy, ox))
    w_l_d = torch.exp(-(l_dc - l_dq).abs() / den_d)
    w_l_i = torch.exp(-(l_ic - l_iq).abs() / den_i)
    base = w_n * w_z
    return base * w_l_d, base * w_l_i


def variance(guide, dyn, sigma_z, sigma_n, sigma_l):
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
            w_d, w_i = _weights(g, d, dy, dx, n_c, z_c, dz_c, l_dc, l_ic, den, den,
                                sigma_z, sigma_n)
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


def atrous(guide, dyn, step: int, sigma_z, sigma_n, sigma_l):
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
            w_d, w_i = _weights(g, d, oy, ox, n_c, z_c, dz_c, l_dc, l_ic, den_d, den_i,
                                sigma_z, sigma_n)
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


def spatial(frame, integrated, settings):
    guide = torch.cat([frame["normal"].permute(2, 0, 1), frame["depth"][None],
                       frame["dz"][None]]).contiguous()
    dyn = torch.cat([integrated["direct"].permute(2, 0, 1),
                     integrated["indirect"].permute(2, 0, 1),
                     integrated["var_direct"][None], integrated["var_indirect"][None]]).contiguous()
    sz, sn, sl = settings["sigma_z"], settings["sigma_n"], settings["sigma_l"]
    if settings["spatial_variance"]:
        sp = variance(guide, dyn, sz, sn, sl)
        dyn = torch.where((integrated["length"] < 4.0)[None], sp, dyn)
    feedback = dyn
    for i in range(settings["atrous_iterations"]):
        dyn = atrous(guide, dyn, 1 << i, sz, sn, sl)
        if i == 1:
            feedback = dyn
    return (dyn[0:3].permute(1, 2, 0), dyn[3:6].permute(1, 2, 0),
            (feedback[0:3].permute(1, 2, 0), feedback[3:6].permute(1, 2, 0)))


def svgf_step(frame: dict, history: History, vp_prev, settings: dict):
    H, W = frame["depth"].shape
    screen_prev = project_to_screen(frame["position_prev"], vp_prev, W, H)
    frame = dict(frame)
    depth = torch.where(torch.isfinite(frame["depth"]), frame["depth"], 1e30)
    frame["depth"] = depth
    dz_x = (shift(depth, 0, 1) - depth).abs()
    dz_y = (shift(depth, 1, 0) - depth).abs()
    frame["dz"] = torch.maximum(dz_x, dz_y).clamp(1e-4, 1e20)
    integrated = reproject(frame, history, screen_prev, settings["alpha_colour"],
                           settings["alpha_moments"])
    direct, indirect, (fb_d, fb_i) = spatial(frame, integrated, settings)
    combined = direct + indirect
    colour = combined * frame["albedo"] if settings["modulate_albedo"] else combined
    new = History(direct=fb_d.contiguous(), indirect=fb_i.contiguous(),
                  moments=integrated["moments"], length=integrated["length"],
                  normal=frame["normal"], depth=depth, instance=frame["instance"])
    return colour, new


def rgb_to_ycocg(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack([0.25 * r + 0.5 * g + 0.25 * b, 0.5 * r - 0.5 * b,
                        -0.25 * r + 0.5 * g - 0.25 * b], dim=-1)


def ycocg_to_rgb(c):
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([y + co - cg, y + cg, y - co - cg], dim=-1)


def _mitchell(x, b: float = 1.0 / 3.0, c: float = 1.0 / 3.0):
    ax = x.abs()
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (12 - 9 * b - 6 * c) * ax3 + (-18 + 12 * b + 6 * c) * ax2 + (6 - 2 * b)
    outer = ((-b - 6 * c) * ax3 + (6 * b + 30 * c) * ax2
             + (-12 * b - 48 * c) * ax + (8 * b + 24 * c))
    return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, 0.0)) / 6.0


def resample_mitchell(img, screen_pos):
    H, W = img.shape[0], img.shape[1]
    px = screen_pos[..., 0] - 0.5
    py = screen_pos[..., 1] - 0.5
    x0, y0 = floor_index(px), floor_index(py)
    in_window = window_mask((x0 - 1).clamp(0, W - 4), (y0 - 1).clamp(0, H - 4))
    colour = torch.zeros_like(img)
    weight = torch.zeros_like(px)
    for j in range(-1, 3):
        for i in range(-1, 3):
            xi, yi = x0 + i, y0 + j
            w = _mitchell(px - xi) * _mitchell(py - yi)
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & in_window
            w = torch.where(ok, w, 0.0)
            val = img[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
            colour = colour + w[..., None] * val
            weight = weight + w
    return colour / weight.clamp(min=1e-5)[..., None], weight > 1e-5


def taa_step(current, prev_frame, screen_prev):
    history, history_ok = resample_mitchell(prev_frame, screen_prev)
    mean = m2 = torch.zeros_like(current)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            q = rgb_to_ycocg(shift(current, dy, dx))
            mean = mean + q
            m2 = m2 + q * q
    mean = mean / 9.0
    sigma = torch.sqrt((m2 / 9.0 - mean * mean).clamp(min=0.0))
    clamped = torch.clamp(rgb_to_ycocg(history), mean - GAMMA_CLAMP * sigma,
                          mean + GAMMA_CLAMP * sigma)
    blended = TAA_ALPHA * current + (1.0 - TAA_ALPHA) * ycocg_to_rgb(clamped)
    return torch.where(history_ok[..., None], blended, current)


def to_taa_space(rgb):
    return torch.sqrt(rgb / (1.0 + luminance(rgb)[..., None]))


def from_taa_space(rgb):
    sq = rgb * rgb
    return sq / (1.0 - luminance(sq)[..., None]).clamp(min=1e-4)


def denoise(frame: dict, history: History, taa_prev, vp_prev, first: bool, settings: dict):
    """One frame's SVGF + TAA -> (colour, new history, new TAA frame);
    `first`: the frame after a reset, whose TAA history is itself."""
    colour, history = svgf_step(frame, history, vp_prev, settings)
    if not settings["taa"]:
        return colour, history, taa_prev
    taa_in = to_taa_space(colour.clamp(min=0.0))
    prev = taa_in if first else taa_prev
    screen_prev = project_to_screen(frame["position_prev"], vp_prev, frame["depth"].shape[1],
                                    frame["depth"].shape[0])
    taa = taa_step(taa_in, prev, screen_prev)
    return from_taa_space(taa), history, taa


def settings_of(gpu_config: dict) -> dict:
    """The filter's settings from the cell's render settings (the port's
    GPUConfig defaults where the traffic leaves one out)."""
    g = gpu_config
    return {"alpha_colour": g.get("svgf_alpha_colour", 0.1),
            "alpha_moments": g.get("svgf_alpha_moments", 0.1),
            "sigma_z": g.get("svgf_sigma_z", 4.0), "sigma_n": g.get("svgf_sigma_n", 16.0),
            "sigma_l": g.get("svgf_sigma_l", 10.0),
            "atrous_iterations": g.get("svgf_atrous_iterations", 6),
            "spatial_variance": g.get("enable_spatial_variance", True),
            "modulate_albedo": g.get("modulate_albedo", True),
            "taa": g.get("enable_taa", True)}

