"""Whole-bounce fused shade for small scenes, with its in-kernel sampler.

Counterpart of the JAX package's `ops/pallas_shade.py` (`shade_diffuse_pallas`,
TPU kernel `_kernel` with `_draw2_kernel`). One call shades one bounce of a
wave straight from the traversal's hits (t, tri, inst, u, v): sky on a miss,
the emissive hit with MIS (weight 1 at bounce 0), russian roulette (off at
bounce 0), hit interpolation from the object-space triangle and instance
tables, the two-sided shading frame, the light pick by CDF count with the
light's geometry transformed here, NEE with the 4-BSDF eval (Kulla-Conty from
per-material curves), the shadow-ray setup and the BSDF sample. It draws its
own random numbers: a PMJ pair per draw site that is one scalar per wave
(`params`), the per-pixel blue-noise rotation read as one 1024-lane noise row
per block of 1024 lanes (the block's 32x32 screen tile, `pmj.pack_noise_rows`),
and a uint32 hash past 4096 samples.

On a CUDA tensor `fused_shade` launches the hand-written kernel in
`csrc/fused_shade.cu` (one thread per lane; its table rows read with
128-bit loads) and raises if it cannot; on a
CPU tensor it runs `fused_shade_plain`, which follows the TPU kernel term by
term. Table values are read by lane index where the TPU kernel select-scans
them; the scan returns the same value on every lane whose result is used.

Tables (ops/buffers.py `_pack_pallas_shade`, (16, .) f32 column-major, the
JAX layout, which the plain version reads):
  tri_geo (16, T): [0:9] p0 | e1 | e2 (object space)
  tri_nrm (16, T): [0:9] n0 | n1 | n2 (object space)
  inst_a  (16, I): [0:12] forward transform rows, [12] material id
  inst_b  (16, I): [0:12] inverse transform rows
  mat_tbl (16, M), kc_tbl (32, M): as the K3 shade kernel's
  lgt_tbl (16, L): [0] cdf, [1] light triangle, [2] light instance
`make_tables` builds the kernel's rows from them once, with the scene's
tables (`FusedTables`: a triangle's row, an instance's row with its
material and curves joined on, a light's row in world space).
params (48,) f32 (`make_params`): [0] bounce, [1] num_bounces, [2:5] sky
rgb (scale folded), [5] total light weight, [6] sample index; per draw site
s (RR, NEE_LIGHT, NEE_TRIANGLE, BSDF_0, BSDF_1): [16+4s .. 16+4s+4) =
(pmj x, pmj y, noise texture, in-table flag).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gpu_raytracer_tpu_torch.config import (
    BLUE_NOISE_NUM_TEXTURES,
    PMJ_NUM_SAMPLES_PER_SEQUENCE,
    PMJ_NUM_SEQUENCES,
)
from gpu_raytracer_tpu_torch.ops import _native
from gpu_raytracer_tpu_torch.ops import shade_gather as sg
from gpu_raytracer_tpu_torch.ops.pmj import _hash_with
from gpu_raytracer_tpu_torch.ops.rng import M32, SampleDimension, mul32, pcg_hash

BLOCK = 1024  # lanes per noise row: one 32x32 screen tile
NUM_PARAMS = 48
# The JAX package's SMEM budget (pallas_shade MAX_SHADE_TABLE_BYTES), kept as
# the route's gate.
MAX_SHADE_TABLE_BYTES = 600_000
# The draw sites, in params order.
SITES = (SampleDimension.RUSSIAN_ROULETTE, SampleDimension.NEE_LIGHT,
         SampleDimension.NEE_TRIANGLE, SampleDimension.BSDF_0,
         SampleDimension.BSDF_1)
INV_24 = float(np.float32(1.0 / (1 << 24)))

# Field order of FsIn / FsOut in csrc/fused_shade.cu.
IN_FIELDS = ("t", "tri", "inst", "u", "v", "ray_o", "ray_d", "throughput",
             "alive", "prev_allow_nee", "last_pdf", "pixel_index")
OUT_FIELDS = ("radiance_add", "ray_o", "ray_d", "throughput", "alive",
              "prev_allow_nee", "last_pdf", "shadow_o", "shadow_d",
              "shadow_tmax", "illumination")
# Pointer fields of FsTables, in order: the kernel's rows, the light CDF
# (lgt_tbl row 0) and the sampler's two noise planes.
TAB_FIELDS = ("tri_rows", "inst_rows", "light_rows", "cdf", "noise_x_rows",
              "noise_y_rows")
_VEC3 = {"ray_o", "ray_d", "throughput", "radiance_add", "shadow_o",
         "shadow_d", "illumination"}
_BOOL = {"alive", "prev_allow_nee"}
_INT = {"tri", "inst", "pixel_index"}

launches = {"fused_shade": 0}
plain_calls = {"fused_shade": 0}
# What `kernel_info` returns (csrc/fused_shade.cu fs_kernel_info).
INFO = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm", "sms")


class FusedTables(NamedTuple):
    """The fused shade's tables in two layouts (`make_tables`): the JAX
    package's column-major (16, n) tables, which the plain version reads,
    and the kernel's rows, 16-byte aligned and read with 128-bit loads."""
    tri_geo: torch.Tensor     # (16, T)
    tri_nrm: torch.Tensor     # (16, T)
    inst_a: torch.Tensor      # (16, I)
    inst_b: torch.Tensor      # (16, I)
    mat_tbl: torch.Tensor     # (16, M)
    kc_tbl: torch.Tensor      # (32, M)
    lgt_tbl: torch.Tensor     # (16, L)
    tri_rows: torch.Tensor    # (T, 32): tri_geo | tri_nrm
    inst_rows: torch.Tensor   # (I, 80): inst_a | inst_b | its material | its curves
    light_rows: torch.Tensor  # (L, 16): p0, e1, e2 in world space, emission


TRI_ROW, INST_ROW, LIGHT_ROW = 32, 80, 16


def make_tables(cols) -> FusedTables:
    """The seven (16 | 32, n) f32 tables of `_pack_pallas_shade` (the JAX
    layout) -> FusedTables on their device. The kernel's rows are built here
    once, on the host: a triangle's geometry and normals in one 128-byte
    row; an instance's forward and inverse transforms with its material's
    row and Kulla-Conty curves joined on, so one dependent load round gives
    a hit all of them; a light's triangle in world space (its instance's
    forward transform applied in float32, term by term in the kernel's
    order, so the values are bit-equal to the transform the plain version
    and the JAX kernel do per lane) and its emission."""
    if len(cols) != 7:
        raise ValueError(f"want the 7 fused shade tables, got {len(cols)}")
    cols = tuple(torch.as_tensor(x) for x in cols)
    dev = cols[0].device
    h = [x.detach().to("cpu", torch.float32).numpy() for x in cols]
    tri_geo, tri_nrm, inst_a, inst_b, mat_tbl, kc_tbl, lgt_tbl = h
    rows_of = {"tri_geo": 16, "tri_nrm": 16, "inst_a": 16, "inst_b": 16,
               "mat_tbl": 16, "kc_tbl": 32, "lgt_tbl": 16}
    for (name, rows), x in zip(rows_of.items(), h):
        if x.ndim != 2 or x.shape[0] != rows or x.shape[1] < 1:
            raise ValueError(f"{name} must be ({rows}, n >= 1), got {x.shape}")
    mat_id = inst_a[12].astype(np.int64)
    inst_rows = np.concatenate([inst_a, inst_b, mat_tbl[:, mat_id], kc_tbl[:, mat_id]]).T
    lt = lgt_tbl[1].astype(np.int64)
    f = inst_a[:12, lgt_tbl[2].astype(np.int64)]
    g = tri_geo[:9, lt]

    def pt(x, y, z):  # fs_affine_pt
        return [f[0] * x + f[1] * y + f[2] * z + f[3],
                f[4] * x + f[5] * y + f[6] * z + f[7],
                f[8] * x + f[9] * y + f[10] * z + f[11]]

    def dr(x, y, z):  # fs_affine_dir
        return [f[0] * x + f[1] * y + f[2] * z,
                f[4] * x + f[5] * y + f[6] * z,
                f[8] * x + f[9] * y + f[10] * z]

    lmat = inst_a[12, lgt_tbl[2].astype(np.int64)].astype(np.int64)
    light_rows = np.zeros((lgt_tbl.shape[1], LIGHT_ROW), np.float32)
    light_rows[:, 0:12] = np.stack(pt(*g[0:3]) + dr(*g[3:6]) + dr(*g[6:9])
                                   + list(mat_tbl[1:4, lmat])).T

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)

    return FusedTables(*cols, t(np.concatenate([tri_geo, tri_nrm]).T), t(inst_rows),
                       t(light_rows))


def plain_tables(tables) -> tuple:
    """The seven JAX-layout tables of `tables` (FusedTables or the 7-tuple)."""
    return tuple(tables[:7])


def supports_shade(mat_types, num_tris: int, num_instances: int,
                   num_lights: int, has_textures: bool, has_media: bool,
                   sky_shape) -> bool:
    """The fused shade route's gate (JAX pallas_shade.supports_shade)."""
    types = set(int(t) for t in np.asarray(mat_types))
    if not types.issubset({sg.MAT_LIGHT, sg.MAT_DIFFUSE, sg.MAT_PLASTIC,
                           sg.MAT_DIELECTRIC, sg.MAT_CONDUCTOR}):
        return False
    if has_textures or has_media:
        return False
    if tuple(sky_shape[:2]) != (1, 1):
        return False
    total = 2 * num_tris + 2 * num_instances + num_lights + 16
    return 64 * total <= MAX_SHADE_TABLE_BYTES


def make_params(seq_x, seq_y, bounce: int, num_bounces: int, sky_rgb,
                total_weight: float, sample_index: int) -> np.ndarray:
    """The (48,) f32 params of one bounce (JAX fast_bounce_body): `seq_x`,
    `seq_y` are the flat PMJ sequence tables (host arrays), `sky_rgb` the
    constant sky times its scale."""
    p = np.zeros(NUM_PARAMS, np.float32)
    p[0] = bounce
    p[1] = num_bounces
    p[2:5] = sky_rgb
    p[5] = total_weight
    p[6] = sample_index
    s = int(sample_index) & M32
    for site, dim in enumerate(SITES):
        dim_total = (int(dim) + int(SampleDimension.NUM_BOUNCE) * int(bounce)) & M32
        flat = ((dim_total % PMJ_NUM_SEQUENCES) * PMJ_NUM_SAMPLES_PER_SEQUENCE
                + min(s, PMJ_NUM_SAMPLES_PER_SEQUENCE - 1))
        b = 16 + 4 * site
        p[b] = seq_x[flat]
        p[b + 1] = seq_y[flat]
        p[b + 2] = dim_total % BLUE_NOISE_NUM_TEXTURES
        p[b + 3] = float(s < PMJ_NUM_SAMPLES_PER_SEQUENCE)
    return p


def block_tiles(pixel_index: torch.Tensor, width: int) -> torch.Tensor:
    """(R,) noise-tile row (0..15) of each lane's 1024-lane block, from the
    block's first pixel: every block of the route's waves lies inside one
    32x32 screen tile, which maps to one of the noise texture's 4x4 tiles."""
    R = pixel_index.shape[0]
    first = pixel_index[::BLOCK].long()
    tile = ((first // width) // 32 % 4) * 4 + (first % width) // 32 % 4
    return tile.repeat_interleave(BLOCK)[:R]


def _draw2(sampler, params, tile, lane, pix_u, site: int, bounce_u: int,
           s_idx_u: int):
    """One draw site's pair per lane (JAX _draw2_kernel): the PMJ scalar plus
    the block's noise row, wrapped to [0, 1); past the table, the hash
    fallback's top 24 bits times 2^-24 (uint32 held in int64)."""
    dim = int(SITES[site])
    base = 16 + 4 * site
    sx, sy = params[base], params[base + 1]
    row = int(params[base + 2]) * 16 + tile
    u = sx + sampler["noise_x_rows"][row, lane]
    u = torch.where(u >= 1.0, u - 1.0, u)
    v = sy + sampler["noise_y_rows"][row, lane]
    v = torch.where(v >= 1.0, v - 1.0, v)
    if params[base + 3] > 0.0:
        return u, v
    h = pcg_hash((mul32((mul32(pix_u, 7) + dim) & M32, 128) + bounce_u) & M32)
    fx = (_hash_with(s_idx_u, h) >> 8).to(torch.float32) * INV_24
    fy = (_hash_with((s_idx_u + 0xDEADBEEF) & M32, h) >> 8).to(torch.float32) * INV_24
    return fx, fy


def _affine_pt(m, x, y, z):
    return (m[0] * x + m[1] * y + m[2] * z + m[3],
            m[4] * x + m[5] * y + m[6] * z + m[7],
            m[8] * x + m[9] * y + m[10] * z + m[11])


def _affine_dir(m, x, y, z):
    return (m[0] * x + m[1] * y + m[2] * z,
            m[4] * x + m[5] * y + m[6] * z,
            m[8] * x + m[9] * y + m[10] * z)


def _inv_transpose_dir(m, x, y, z):
    """n'_j = sum_i inv[i, j] * n_i, normalised."""
    return sg._norm3((m[0] * x + m[4] * y + m[8] * z,
                      m[1] * x + m[5] * y + m[9] * z,
                      m[2] * x + m[6] * y + m[10] * z))


def fused_shade_plain(tables, sampler, params, hit, ray_o, ray_d, throughput,
                      alive, prev_allow_nee, last_pdf, pixel_index, width: int,
                      enable_nee: bool = True, enable_mis: bool = True,
                      enable_rr: bool = True) -> dict:
    """Plain PyTorch version of the fused shade kernel (any device)."""
    plain_calls["fused_shade"] += 1
    tri_geo, tri_nrm, inst_a, inst_b, mat_tbl, kc_tbl, lgt_tbl = plain_tables(tables)
    params = np.asarray(params, np.float32)
    P = [float(x) for x in params]
    bounce, num_bounces = np.float32(P[0]), np.float32(P[1])
    sky = P[2:5]
    total_weight = P[5]
    L = lgt_tbl.shape[1]
    R = hit.t.shape[0]
    dev = hit.t.device

    t = hit.t.float()
    tri = hit.tri.long()
    inst = hit.inst.long()
    hu, hv = hit.u.float(), hit.v.float()
    d = (ray_d[:, 0], ray_d[:, 1], ray_d[:, 2])
    o = (ray_o[:, 0], ray_o[:, 1], ray_o[:, 2])
    tp = (throughput[:, 0], throughput[:, 1], throughput[:, 2])
    active = alive.bool()
    prev_nee = prev_allow_nee.bool()
    zero = torch.zeros_like(t)

    # ---- in-kernel sampler draws ----
    pix_u = pixel_index.to(torch.int64) & M32
    bounce_u = int(P[0]) & M32
    s_idx_u = int(P[6]) & M32
    tile = block_tiles(pixel_index, width)
    lane = torch.arange(R, device=dev) % BLOCK

    def draw(site):
        return _draw2(sampler, P, tile, lane, pix_u, site, bounce_u, s_idx_u)

    r5, _ = draw(0)
    r0, _ = draw(1)
    r1, r2 = draw(2)
    f0, f1 = draw(3)
    r3, r4 = draw(4)

    # ---- sky on miss (constant sky) ----
    missed = active & (tri < 0)
    rad = tuple(torch.where(missed, a * s, zero) for a, s in zip(tp, sky))
    active = active & ~missed

    ti = tri.clamp(min=0)
    ii = inst.clamp(min=0)

    # ---- material + instance transforms ----
    ia = inst_a[:13].index_select(1, ii)
    fwd = list(ia[:12])
    mat_id = ia[12].long()
    inv = list(inst_b[:12].index_select(1, ii))
    mv = mat_tbl[:15].index_select(1, mat_id)
    mtype = mv[0].long()
    em = (mv[1], mv[2], mv[3])
    al = (mv[4], mv[5], mv[6])
    rough = mv[7]
    ior = mv[8].clamp(min=1.0001)
    kc = list(kc_tbl.index_select(1, mat_id))

    # ---- hit geometry ----
    g = tri_geo[:9].index_select(1, ti)
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = g
    pox = p0x + hu * e1x + hv * e2x
    poy = p0y + hu * e1y + hv * e2y
    poz = p0z + hu * e1z + hv * e2z
    p = _affine_pt(fwd, pox, poy, poz)
    cgx = e1y * e2z - e1z * e2y
    cgy = e1z * e2x - e1x * e2z
    cgz = e1x * e2y - e1y * e2x
    gn = _inv_transpose_dir(inv, cgx, cgy, cgz)

    # ---- emissive hit with MIS ----
    is_light = active & (mtype == sg.MAT_LIGHT)
    lum = 0.2126 * em[0] + 0.7152 * em[1] + 0.0722 * em[2]
    cos_l = sg._dot(d, gn).abs()
    lpdf_here = lum * t * t / (cos_l * total_weight).clamp(min=1e-20)
    pdf_ok = torch.isfinite(lpdf_here) & (lpdf_here > 0)
    if enable_nee:
        full = ~prev_nee
        if enable_mis:
            w = (last_pdf * last_pdf
                 / (last_pdf * last_pdf + lpdf_here * lpdf_here).clamp(min=1e-20))
            mis_w = torch.where(full, 1.0, torch.where(pdf_ok, w, zero))
        else:
            mis_w = torch.where(full, 1.0, zero)
        if bounce == 0:
            mis_w = torch.ones_like(t)
    else:
        mis_w = torch.ones_like(t)
    rad = tuple(r + torch.where(is_light, a * e * mis_w, zero)
                for r, a, e in zip(rad, tp, em))
    active = active & ~is_light

    # ---- bounce cap + russian roulette (off at bounce 0) ----
    active = active & bool(bounce < num_bounces - np.float32(1.0))
    if enable_rr:
        survival = sg._clip01(torch.maximum(tp[0], torch.maximum(tp[1], tp[2])))
        if bounce > 0:
            active = active & ~(r5 > survival)
            inv_s = 1.0 / survival.clamp(min=1e-8)
            tp = tuple(a * inv_s for a in tp)

    # ---- shading frame ----
    nr = tri_nrm[:9].index_select(1, ti)
    w0 = 1.0 - hu - hv
    sn = _inv_transpose_dir(inv, w0 * nr[0] + hu * nr[3] + hv * nr[6],
                            w0 * nr[1] + hu * nr[4] + hv * nr[7],
                            w0 * nr[2] + hu * nr[5] + hv * nr[8])
    entering = sg._dot(d, gn) < 0.0
    flip = torch.where(entering, 1.0, -1.0)
    gn = tuple(x * flip for x in gn)
    sn = tuple(x * flip for x in sn)
    sgn = torch.where(sn[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sgn + sn[2])
    b = sn[0] * sn[1] * a
    T = (1.0 + sgn * sn[0] * sn[0] * a, sgn * b, -sgn * sn[0])
    B = (b, sgn + sn[1] * sn[1] * a, -sn[1])
    wi = (-sg._dot(d, T), -sg._dot(d, B), -sg._dot(d, sn))
    active = active & (wi[2] > 0.0)

    m = sg.make_lane_materials(mtype, al, rough, ior, (mv[9], mv[10], mv[11]),
                               (mv[12], mv[13], mv[14]), kc, entering)
    fold = active & (mtype == sg.MAT_DIFFUSE)
    tp = tuple(torch.where(fold, x * y, x) for x, y in zip(tp, al))

    # ---- NEE shadow-ray setup (light geometry transformed here) ----
    stmax = zero
    so = (zero, zero, zero)
    sd = (torch.ones_like(t), zero, zero)
    il = (zero, zero, zero)
    if enable_nee:
        k = (r0[:, None] > lgt_tbl[0, :L - 1][None, :]).sum(dim=1)
        lk = lgt_tbl[1:3].index_select(1, k)
        lt, li = lk[0].long(), lk[1].long()
        flip2 = r2 > r1
        lu = torch.where(flip2, 0.5 * r1, r1 - 0.5 * r2)
        lv = torch.where(flip2, r2 - 0.5 * r1, 0.5 * r2)
        lg = tri_geo[:9].index_select(1, lt)
        lf = inst_a[:13].index_select(1, li)
        lfwd = list(lf[:12])
        lmat = lf[12].long()
        le1 = _affine_dir(lfwd, lg[3], lg[4], lg[5])
        le2 = _affine_dir(lfwd, lg[6], lg[7], lg[8])
        lp0 = _affine_pt(lfwd, lg[0], lg[1], lg[2])
        lp = tuple(x + lu * y + lv * z for x, y, z in zip(lp0, le1, le2))
        lgn = sg._norm3((le1[1] * le2[2] - le1[2] * le2[1],
                         le1[2] * le2[0] - le1[0] * le2[2],
                         le1[0] * le2[1] - le1[1] * le2[0]))
        lem = tuple(mat_tbl[1:4].index_select(1, lmat))
        so = sg._offset(p, tuple(x - y for x, y in zip(lp, p)), gn)
        lp = sg._offset(lp, tuple(x - y for x, y in zip(so, lp)), lgn)
        tl = tuple(x - y for x, y in zip(lp, so))
        dist = torch.sqrt((tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2]).clamp(min=0.0))
        inv_d = 1.0 / dist.clamp(min=1e-20)
        sd = tuple(x * inv_d for x in tl)
        cos_light = sg._dot(sd, lgn).abs()
        lo = (sg._dot(sd, T), sg._dot(sd, B), sg._dot(sd, sn))
        ev, ev_pdf, ev_ok = sg.nee_eval_dispatch(m, wi, lo)
        llum = 0.2126 * lem[0] + 0.7152 * lem[1] + 0.0722 * lem[2]
        light_pdf = llum * dist * dist / (cos_light * total_weight).clamp(min=1e-20)
        lp_ok = torch.isfinite(light_pdf) & (light_pdf > 1e-20)
        if enable_mis:
            w_nee = (light_pdf * light_pdf
                     / (light_pdf * light_pdf + ev_pdf * ev_pdf).clamp(min=1e-20))
        else:
            w_nee = torch.ones_like(t)
        scale = w_nee / light_pdf.clamp(min=1e-20)
        il = tuple(x * e * l * scale for x, e, l in zip(tp, ev, lem))
        want = active & m["can_nee"] & ev_ok & lp_ok & (cos_light > 1e-6)
        stmax = torch.where(want, dist - 2.0 * sg.EPS, zero)

    # ---- BSDF sample -> continuation ray ----
    os_, pdf, mul, valid = sg.bsdf_sample_dispatch(m, wi, f0, f1, r3, r4)
    active = active & valid
    tp = tuple(torch.where(active, x * y, x) for x, y in zip(tp, mul))
    nd = sg._norm3((os_[0] * T[0] + os_[1] * B[0] + os_[2] * sn[0],
                    os_[0] * T[1] + os_[1] * B[1] + os_[2] * sn[1],
                    os_[0] * T[2] + os_[1] * B[2] + os_[2] * sn[2]))
    no = sg._offset(p, nd, gn)

    def v3(x):
        return torch.stack(x, dim=-1)

    return {
        "radiance_add": v3(rad),
        "ray_o": v3(tuple(torch.where(active, a, b) for a, b in zip(no, o))),
        "ray_d": v3(tuple(torch.where(active, a, b) for a, b in zip(nd, d))),
        "throughput": v3(tp),
        "alive": active,
        "prev_allow_nee": (m["can_nee"] if enable_nee
                           else torch.zeros_like(active)),
        "last_pdf": pdf,
        "shadow_o": v3(so),
        "shadow_d": v3(sd),
        "shadow_tmax": stmax,
        "illumination": v3(il),
    }


# ---------------------------------------------------------------------------
# Dispatch: CUDA kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def _launch(tables, sampler, params, hit, ray_o, ray_d, throughput, alive,
            prev_allow_nee, last_pdf, pixel_index, width, enable_nee,
            enable_mis, enable_rr):
    if not isinstance(tables, FusedTables):
        raise TypeError("pass tables built by make_tables()")
    lib = _native.load()
    R = hit.t.shape[0]
    dev = hit.t.device
    lanes = {"t": hit.t, "tri": hit.tri, "inst": hit.inst, "u": hit.u,
             "v": hit.v, "ray_o": ray_o, "ray_d": ray_d,
             "throughput": throughput, "alive": alive,
             "prev_allow_nee": prev_allow_nee, "last_pdf": last_pdf,
             "pixel_index": pixel_index}
    ins = {}
    for name in IN_FIELDS:
        x = lanes[name]
        shape = (R, 3) if name in _VEC3 else (R,)
        if tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"lane {name}: {tuple(x.shape)} on {x.device}, "
                             f"want {shape} on {dev}")
        want = (torch.bool if name in _BOOL else torch.int64 if name == "pixel_index"
                else torch.int32 if name in _INT else torch.float32)
        ins[name] = x.to(want).contiguous()
    # TAB_FIELDS' order; the kernel reads the rows with 16-byte loads.
    tabs = [tables.tri_rows, tables.inst_rows, tables.light_rows,
            tables.lgt_tbl[0].contiguous(), sampler["noise_x_rows"].contiguous(),
            sampler["noise_y_rows"].contiguous()]
    for x in tabs:
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError("fused shade tables must be float32 on the lanes' device")
        if x.data_ptr() % 16:
            raise ValueError("fused shade table rows must be 16-byte aligned")
    outs = {}
    for name in OUT_FIELDS:
        dtype = torch.bool if name in _BOOL else torch.float32
        outs[name] = torch.empty((R, 3) if name in _VEC3 else (R,), dtype=dtype,
                                 device=dev)
    in_ptrs = (ctypes.c_void_p * len(IN_FIELDS))(*[ins[n].data_ptr() for n in IN_FIELDS])
    out_ptrs = (ctypes.c_void_p * len(OUT_FIELDS))(
        *[outs[n].data_ptr() for n in OUT_FIELDS])
    tab_ptrs = (ctypes.c_void_p * len(tabs))(*[x.data_ptr() for x in tabs])
    p = (ctypes.c_float * NUM_PARAMS)(*np.asarray(params, np.float32).tolist())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fs_shade(in_ptrs, out_ptrs, tab_ptrs, tables.lgt_tbl.shape[1], p, int(width),
                       int(enable_nee), int(enable_mis), int(enable_rr), R,
                       ctypes.c_void_p(stream))
    _native.check(err, "fused_shade")
    launches["fused_shade"] += 1
    return outs


def kernel_info() -> dict:
    """What the compiler and the occupancy API report for the kernel on the
    card (INFO: registers, stack frame and static shared bytes, the threads
    of a block, the blocks an SM holds, the SMs)."""
    lib = _native.load()
    out = (ctypes.c_int * len(INFO))()
    _native.check(lib.fs_kernel_info(out), "fused_shade.kernel_info")
    return dict(zip(INFO, list(out)))


def moved_bytes(args, out: dict) -> int:
    """The least bytes one call on `args` (fused_shade's positional
    arguments) must move: the tables once, the noise rows this wave
    addresses (one row per draw site on the PMJ table and noise tile of a
    block, in both planes), each lane's inputs once (a lane that comes in
    dead needs only its instance, alive flag, throughput and ray), the
    blocks' first pixel ids (every lane's where a site falls back to the
    hash), and `out` (the outputs) written once."""
    tables, sampler, params, hit, ray_o, ray_d, throughput, alive, pnee, lpdf, pix, width = args
    params = np.asarray(params, np.float32)
    tiles = torch.unique(block_tiles(pix, width)).tolist()
    in_table = [s for s in range(len(SITES)) if params[16 + 4 * s + 3] > 0]
    rows = {int(params[16 + 4 * s + 2]) * 16 + tile for s in in_table for tile in tiles}
    R = int(hit.t.shape[0])
    live = int(alive.sum())
    # t, u, v, tri f32/i32; prev_allow_nee 1; last_pdf 4: live lanes only.
    live_bytes = live * (4 * 4 + 1 + 4)
    every_bytes = R * (4 + 1 + 3 * 12)  # inst, alive, throughput, ray_o, ray_d
    pix_bytes = pix.element_size() * (R if len(in_table) < len(SITES)
                                      else (R + BLOCK - 1) // BLOCK)
    tab = sum(x.numel() * x.element_size() for x in plain_tables(tables))
    outs = sum(x.numel() * x.element_size() for x in out.values())
    row_bytes = 2 * len(rows) * sampler["noise_x_rows"][0].numel() * 4
    return tab + row_bytes + live_bytes + every_bytes + pix_bytes + outs


def fused_shade(tables, sampler, params, hit, ray_o, ray_d, throughput, alive,
                prev_allow_nee, last_pdf, pixel_index, width: int,
                enable_nee: bool = True, enable_mis: bool = True,
                enable_rr: bool = True) -> dict:
    """Fused shade of one bounce (JAX: shade_diffuse_pallas). `pixel_index`
    must come in 32x32 tile order with every 1024-lane block inside one
    screen tile (film sides multiples of 32, wave offsets multiples of
    1024). Returns the next wave state (ray_o / ray_d already selected
    against the old rays) and the radiance and illumination adds."""
    args = (tables, sampler, params, hit, ray_o, ray_d, throughput, alive,
            prev_allow_nee, last_pdf, pixel_index, width, enable_nee,
            enable_mis, enable_rr)
    dev = hit.t.device
    if dev.type == "cuda":
        return _launch(*args)
    if dev.type == "cpu":
        return fused_shade_plain(*args)
    raise RuntimeError(f"no fused shade kernel for device {dev}")
