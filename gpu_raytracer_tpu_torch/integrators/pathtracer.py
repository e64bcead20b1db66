"""Wavefront path tracer (JAX: gpu_raytracer_tpu/integrators/pathtracer.py
`render_wave`, `_denoised_frame` and the `Pathtracer` host class).

`render_wave(route=...)` takes one of four routes, as the JAX package does
with its flags:

  wide          (JAX use_wide + use_gather_shade) the steps below;
  stream        (JAX use_stream + use_gather_shade) the same steps with every
                closest-hit wave, the primary one included, on the paged
                tables (`kernels.stream_closest`, no coherence sort, hits
                decoded through `stream_prim`, u, v re-derived from the hit
                point, lanes whose portal list was truncated poisoned with
                NaN) and shadow waves on `kernels.stream_any`;
  binary        (JAX use_pallas) the same steps with every wave on the
                binary two-level tables (`kernels.binary_closest` with u, v
                for the primary and bounce waves, no coherence sort;
                `kernels.binary_any` for shadow waves);
  binary_shade  (JAX use_pallas + use_pallas_shade) every bounce, bounce 0
                included, is one binary closest-hit wave, one fused shade
                call that draws its own samples (`kernels.fused_shade`) and
                one binary any-hit wave.

One wide-route `render_wave` call renders one sample for one wave of pixels:

  1. camera rays (under SVGF a frame-constant Halton jitter);
  2. primary closest hit (`kernels.primary`, wide traversal with u, v),
     over merged or two-level tables (the layout is marked on the tables);
  3. bounce 0 on plain tensor ops: sky, emissive MIS, the anisotropic
     ray-cone texture tap, the four BSDFs (ops/bsdf.py, Kulla-Conty from
     `buffers["luts"]`), NEE with an any-hit shadow wave (`kernels.any`),
     and with `with_aovs` the G-buffer and SVGF albedo demodulation;
  4. bounces >= 1 until every lane is dead: coherence sort + closest hit
     (`kernels.closest`), the sky sample and the sampler draws, then one
     shade call from the hits (`kernels.shade`: the hit rows, u, v
     re-derived from t, the hit interpolation, the isotropic nearest-mip
     texture tap, the sky and emission adds and the rest of the bounce) and
     the NEE any-hit; on the last bounce the shade adds the sky and
     emission only, with no draws and no shadow wave;
  5. NaN/Inf pixels become magenta.

Late-bounce compaction (JAX render_wave `compact_tiers`, the reference's
material-queue compaction, Pathtracer.cu:426-462): on every route but
"binary_shade", when the live lanes at the top of a bounce >= 1 fit one of
the narrow widths of `compact_caps(R, compact_tiers)` below the wave's
current width, the smallest such width is taken: the live lanes are packed
in lane order (`compact_lanes`) and this and every later bounce run on the
narrow wave, so a lane that dies is never traced again. A smaller tier's
width packs again. Only radiance (and `direct` under AOVs) goes back to
full width, by the composed map from slots to the wave's lanes: after the
loop, and at each later packing for the lanes it leaves behind. Each lane
computes exactly what it would at full width. `Pathtracer` passes
`default_compact_tiers` of its wave.

Scenes with homogeneous media (`has_media`) carry each lane's medium id
(-1 outside every medium; every lane starts outside). After each closest-hit
wave of a bounce >= 1, the last included, and before the sky, lanes inside
a medium take the medium step (`medium_step`: a spectral-MIS distance
sample from the BSDF_0 draws, the Henyey-Greenstein direction from the
BSDF_1 draws, the scatter, pass-through and absorb-only throughputs; JAX
render_wave :390-439). A lane that scatters leaves `alive` before the shade
call, rides it dead (the call still applies russian roulette's 1 / survival
to its throughput), and rejoins after it with the scattered ray unless the
same roulette draw kills it. The shade call hands the medium over on a
dielectric transmission (K3's SG_MEDIA instances); at bounce 0 the plain
body does it from the material row. At bounce 0 every lane is outside every
medium, so the JAX package's medium step there changes nothing and the port
leaves it out. Every route's closest hit returns t = +inf on a miss, as the
JAX routes do, which the medium step reads.

`Pathtracer.render_frame_denoised` traces one such sample with AOVs for
every pixel and filters it with SVGF (`kernels.svgf_variance`,
`kernels.svgf_atrous`) and TAA.

`kernels` names the function run in each role. The default dispatches by
device: the hand-written CUDA kernels for CUDA tensors, their plain PyTorch
versions for CPU tensors. Passing `PLAIN` runs the plain versions on any
device (used to compare the two on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gpu_raytracer_tpu_torch.config import CPUConfig, GPUConfig, Invalidation
from gpu_raytracer_tpu_torch.scene.scene import Scene
from gpu_raytracer_tpu_torch.scene.types import MaterialType
from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
from gpu_raytracer_tpu_torch.ops import bsdf as bsdf_lib
from gpu_raytracer_tpu_torch.ops import fused_shade as fs
from gpu_raytracer_tpu_torch.ops import rng
from gpu_raytracer_tpu_torch.ops import shade_gather as sg
from gpu_raytracer_tpu_torch.ops import stream_traverse as st
from gpu_raytracer_tpu_torch.ops import svgf as svgf_ops
from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv
from gpu_raytracer_tpu_torch.ops import taa as taa_ops
from gpu_raytracer_tpu_torch.ops import textures as tx
from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
from gpu_raytracer_tpu_torch.ops.buffers import build_scene_tables, refresh_tlas
from gpu_raytracer_tpu_torch.ops.camera_rays import (
    camera_tensors,
    generate_primary_rays,
    halton_jitter,
    tile_order,
)
from gpu_raytracer_tpu_torch.ops.ray_sort import trace_sorted
from gpu_raytracer_tpu_torch.ops.sampling import (
    local_to_world,
    luminance,
    normalize,
    orthonormal_basis,
    power_heuristic,
    sample_henyey_greenstein,
    sample_triangle_barycentric,
    searchsorted_cdf,
    world_to_local,
)
from gpu_raytracer_tpu_torch.ops.sky_ops import sample_sky
from gpu_raytracer_tpu_torch.ops.vec import (
    affine_dir_rows,
    affine_point_rows,
    fetch_rows,
)

EPSILON = 1e-4  # ray-origin offset (Common.h:75)
# The profiler range of the compaction's packing and write-backs.
COMPACT_RANGE = "render_wave.compact"


class KernelSet(NamedTuple):
    """The function that runs each kernel role. The three wide traversal
    roles serve merged tables (TPU: pallas_wide._kernel,
    pallas_gang._gang_flat_kernel) and two-level tables (TPU:
    pallas_wide._kernel, pallas_gang._gang_kernel)."""
    primary: Callable   # closest hit + u, v
    closest: Callable   # closest hit
    any: Callable       # occlusion
    shade: Callable     # shade from the hits (TPU: pallas_shade_gather._kernel)
    svgf_variance: Callable  # 7x7 variance   (TPU: pallas_svgf._variance_kernel)
    svgf_atrous: Callable    # a-trous pass   (TPU: pallas_svgf._atrous_kernel)
    binary_closest: Callable  # closest + u, v (TPU: pallas_traverse._kernel)
    binary_any: Callable      # occlusion      (TPU: pallas_traverse._kernel)
    fused_shade: Callable     # whole bounce   (TPU: pallas_shade._kernel)
    stream_closest: Callable  # paged tables   (TPU: pallas_stream._resident_kernel,
    stream_any: Callable      #                 _page_kernel)


TRAVERSAL_ROLES = ("primary", "closest", "any")
# The roles render_wave runs on each route; denoised frames add DENOISE_ROLES.
ROUTE_ROLES = {
    "wide": TRAVERSAL_ROLES + ("shade",),
    "stream": ("stream_closest", "stream_any", "shade"),
    "binary": ("binary_closest", "binary_any", "shade"),
    "binary_shade": ("binary_closest", "binary_any", "fused_shade"),
}
DENOISE_ROLES = ("svgf_variance", "svgf_atrous")
# The AOVs a denoised frame filters (JAX _denoised_frame).
FRAME_AOVS = ("direct", "indirect", "albedo", "normal", "depth", "instance",
              "position_prev")

DISPATCH = KernelSet(wt.trace_primary, wt.trace_closest, wt.trace_any,
                     sg.shade_hits, sv.svgf_variance, sv.svgf_atrous,
                     bt.trace_closest, bt.trace_any, fs.fused_shade,
                     st.trace_closest, st.trace_any)
PLAIN = KernelSet(wt.trace_primary_plain, wt.trace_closest_plain,
                  wt.trace_any_plain, sg.shade_hits_plain, sv.variance_plain,
                  sv.atrous_plain, bt.trace_closest_plain, bt.trace_any_plain,
                  fs.fused_shade_plain, st.trace_closest_plain,
                  st.trace_any_plain)

KERNEL_SOURCES = {
    "primary": "gpu_raytracer_tpu_torch/csrc/wide_traverse.cu",
    "closest": "gpu_raytracer_tpu_torch/csrc/wide_traverse.cu",
    "any": "gpu_raytracer_tpu_torch/csrc/wide_traverse.cu",
    "shade": "gpu_raytracer_tpu_torch/csrc/shade_gather.cu",
    "svgf_variance": "gpu_raytracer_tpu_torch/csrc/svgf_stencil.cu",
    "svgf_atrous": "gpu_raytracer_tpu_torch/csrc/svgf_stencil.cu",
    "binary_closest": "gpu_raytracer_tpu_torch/csrc/binary_traverse.cu",
    "binary_any": "gpu_raytracer_tpu_torch/csrc/binary_traverse.cu",
    "fused_shade": "gpu_raytracer_tpu_torch/csrc/fused_shade.cu",
    "stream_closest": "gpu_raytracer_tpu_torch/csrc/stream_traverse.cu",
    "stream_any": "gpu_raytracer_tpu_torch/csrc/stream_traverse.cu",
}


def kernel_paths(kernels: KernelSet, device, two_level: bool = False,
                 route: str = "wide") -> dict:
    """Which kernel or plain version runs each role of `route` (and the
    denoise roles) on `device`; wide traversal roles on two-level tables are
    named with "_tl"."""
    dev = torch.device(device)
    out = {}
    for role in ROUTE_ROLES[route] + DENOISE_ROLES:
        fn = getattr(kernels, role)
        name = role + ("_tl" if two_level and role in TRAVERSAL_ROLES else "")
        if fn is getattr(DISPATCH, role):
            out[name] = ("cuda:" + KERNEL_SOURCES[role] if dev.type == "cuda"
                         else "plain:" + fn.__module__ + "." + fn.__name__)
        else:
            out[name] = "plain:" + fn.__module__ + "." + fn.__name__
    return out


def hit_surface(hit, prim_map):
    """(leaf-order triangle id, instance id) of a hit, -1 on a miss: from
    the prim map on merged tables, from the kernel on two-level tables (JAX
    pathtracer._decode_wide_hit)."""
    if prim_map is None:
        return hit.tri, hit.inst
    return wt.decode_prim(prim_map, hit.tri)


def _offset_origin(point, direction, geometric_normal):
    """Ray.h:16-18."""
    sign = torch.where((direction * geometric_normal).sum(-1, keepdim=True) >= 0,
                       1.0, -1.0)
    return point + sign * EPSILON * geometric_normal


def _aniso_texture_tap(textures, tex_id, srow, irow, uv, cone_width, ray_d, geom_n):
    """The bounce-0 tap (JAX render_wave, aniso_tex): the ray cone's ellipse
    axes on the surface (RayCone.h:5-35), a1 along the projected direction
    and a2 across it, each scaled so its extent across the ray equals the
    cone width, taken to uv gradients through the barycentrics."""
    nd = (geom_n * ray_d).sum(-1, keepdim=True)
    a1 = ray_d - nd * geom_n
    p1 = a1 - (ray_d * a1).sum(-1, keepdim=True) * ray_d
    a1 = a1 * (cone_width / torch.linalg.vector_norm(p1, dim=-1).clamp(min=1e-4))[:, None]
    a2 = torch.linalg.cross(geom_n, a1, dim=-1)
    p2 = a2 - (ray_d * a2).sum(-1, keepdim=True) * ray_d
    a2 = a2 * (cone_width / torch.linalg.vector_norm(p2, dim=-1).clamp(min=1e-4))[:, None]
    e1w, e2w, uv_e1, uv_e2 = sg.tex_edges(srow, irow)
    ng = torch.linalg.cross(e1w, e2w, dim=-1)
    denom = (ng * ng).sum(-1).clamp(min=1e-20)

    def to_uv(a):
        al = (torch.linalg.cross(a, e2w, dim=-1) * ng).sum(-1) / denom
        be = (torch.linalg.cross(e1w, a, dim=-1) * ng).sum(-1) / denom
        return al[:, None] * uv_e1 + be[:, None] * uv_e2

    return tx.sample_aniso_grad(textures, tex_id, uv[:, 0], uv[:, 1], to_uv(a1), to_uv(a2))


def render_wave(buffers: dict, camera: dict, pixel_index: torch.Tensor,
                sample_index: int, config: GPUConfig, width: int, seed: int = 0,
                has_lights: bool = True, with_stats: bool = False,
                valid_mask: Optional[torch.Tensor] = None,
                mat_types: Optional[tuple] = None,
                kernels: KernelSet = DISPATCH, with_aovs: bool = False,
                route: str = "wide", has_media: Optional[bool] = None,
                compact_tiers: tuple = (), bounce_log: Optional[list] = None):
    """Trace one sample for one wave of pixels -> (R, 3) radiance, or with
    `with_aovs` a dict of (R, ...) AOVs (radiance, direct, indirect, albedo,
    normal, position, position_prev, depth, instance); and the traced-ray
    count when `with_stats`. `route` is one of ROUTE_ROLES (see the module
    docstring); "binary_shade" needs 32x32 tile-ordered pixel ids in
    1024-lane blocks, no AOVs and no media; "stream" needs paged tables.
    Textures (`buffers["has_textures"]`) are sampled with ray-cone lods when
    `config.enable_mipmapping` is on, as in the JAX package: an anisotropic
    tap at bounce 0, an isotropic nearest-mip tap in the shade kernel
    after. `has_media` (default `buffers["has_media"]`) runs the medium
    step and hands media over (module docstring). `compact_tiers` narrows
    the bounces >= 1 to the live lanes (module docstring; not on
    "binary_shade"); `bounce_log`, a list, gets (bounce, live lanes, wave
    width) for each bounce >= 1 traced."""
    if mat_types is None:
        mat_types = buffers["mat_types"]
    if has_media is None:
        has_media = bool(buffers["has_media"])
    sample_index = int(sample_index)
    R = pixel_index.shape[0]
    dev = pixel_index.device
    f32 = torch.float32
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    nee_possible = config.enable_nee and has_lights
    if route not in ROUTE_ROLES:
        raise ValueError(f"route {route!r}: want one of {sorted(ROUTE_ROLES)}")
    use_binary = route in ("binary", "binary_shade")
    if route == "binary_shade" and (with_aovs or has_media):
        raise ValueError("the fused-shade route computes no AOVs and takes no media")
    if use_binary and buffers["binary"] is None:
        raise ValueError(f"route {route!r} needs binary tables (buffers['binary'])")
    if route == "stream" and buffers["stream"] is None:
        raise ValueError("route 'stream' needs paged tables (buffers['stream'])")
    # SVGF demodulation: the primary albedo stays out of the path and is
    # multiplied back after filtering; it still weighs russian roulette
    # (rr_albedo, Pathtracer.cu:199-218).
    demodulate = with_aovs and config.enable_svgf and config.modulate_albedo
    inst_rows, mat_rows = buffers["inst_rows"], buffers["mat_rows"]
    luts, textures = buffers["luts"], buffers["textures"]
    use_textures = bool(buffers["has_textures"]) and config.enable_mipmapping
    # Ray cones for the texture lod (RayCone.h): the angle is the camera's
    # per-pixel spread, the width grows by angle * t a segment.
    cone_angle = camera["pixel_spread_angle"]
    cone_width = torch.zeros(R, dtype=f32, device=dev)
    # Stream route: lanes of the latest closest-hit wave whose portal list
    # outran the pass cap (their hit may be truncated).
    truncated = None
    shade_rows = buffers["shade_rows"]
    total_weight = buffers["total_weight"]
    if use_binary:
        binary = buffers["binary"]

        def trace_closest(o, d, tm):
            return kernels.binary_closest(binary, o, d, tm)
        trace_primary = trace_closest

        def trace_any(o, d, tm):
            return kernels.binary_any(binary, o, d, tm)

        def surface_ids(hit):
            return hit.tri, hit.inst
    elif route == "stream":
        stream = buffers["stream"]
        p_inst, p_tri = buffers["stream_prim"]

        def trace_closest(o, d, tm):
            nonlocal truncated
            hit, truncated = kernels.stream_closest(stream, o, d, tm)
            return hit
        trace_primary = trace_closest

        def trace_any(o, d, tm):
            return kernels.stream_any(stream, o, d, tm)

        def surface_ids(hit):
            ok = hit.tri >= 0
            code = hit.tri.clamp(min=0).long()
            return (torch.where(ok, p_tri[code], -1),
                    torch.where(ok, p_inst[code], -1))
    else:
        wide = buffers["wide"]
        prim_map = buffers["prim_map"]

        def trace_primary(o, d, tm):
            return kernels.primary(wide, o, d, tm)

        def trace_closest(o, d, tm):
            return trace_sorted(lambda o, d, tm: kernels.closest(wide, o, d, tm),
                                o, d, tm, buffers["root_min"], buffers["root_max"])

        def trace_any(o, d, tm):
            return kernels.any(wide, o, d, tm)

        def surface_ids(hit):
            return hit_surface(hit, prim_map)

    draw2 = rng.make_draw2(buffers["sampler"], width, seed, config.sampler)
    ray_o, ray_d = generate_primary_rays(
        camera, pixel_index, width, sample_index, config.reconstruction_filter,
        seed, jitter_override=(halton_jitter(sample_index, dev)
                               if config.enable_svgf else None), draw2=draw2)
    radiance = torch.zeros((R, 3), dtype=f32, device=dev)
    throughput = torch.ones((R, 3), dtype=f32, device=dev)
    alive = (torch.ones(R, dtype=torch.bool, device=dev) if valid_mask is None
             else valid_mask.to(dev).bool())
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    # AOVs. `direct`: light reaching the camera through <= 1 scattering
    # event: sky, emission and NEE at bounce 0, the shade kernel's
    # radiance_add at bounce 1.
    direct = torch.zeros((R, 3), dtype=f32, device=dev) if with_aovs else None
    aovs = {}
    # The lane's homogeneous medium (-1: none); the camera is outside every one.
    medium_id = torch.full((R,), -1, dtype=torch.int32, device=dev) if has_media else None

    if route == "binary_shade":
        radiance, rays_traced = _fused_bounces(
            buffers, kernels, trace_closest, trace_any, pixel_index,
            sample_index, config, width, nee_possible, ray_o, ray_d, radiance,
            throughput, alive, rays_traced, bounce_log)
        return _finish(radiance, direct, aovs, with_aovs, with_stats, rays_traced)

    def tmax_of(live):
        return torch.where(live, inf, zero)

    def poison_truncated(radiance, live):
        """A truncated hit is never rendered as geometry: its lane turns NaN,
        counted as a magenta pixel (JAX pathtracer.py:343-353)."""
        if truncated is None:
            return radiance
        return torch.where((live & truncated)[:, None], float("nan"), radiance)

    # ---------------- bounce 0 (plain tensor body) ----------------
    rays_traced = rays_traced + alive.sum()
    hit = trace_primary(ray_o, ray_d, tmax_of(alive))
    radiance = poison_truncated(radiance, alive)
    tri, inst = surface_ids(hit)
    missed = alive & (tri < 0)
    sky_radiance = sample_sky(buffers["sky"], buffers["sky_scale"], ray_d)
    sky_add = torch.where(missed[:, None], throughput * sky_radiance, zero)
    radiance = radiance + sky_add
    alive = alive & ~missed
    if with_aovs:
        direct = direct + sky_add
        # Depth and instance for every surface hit, emitters included: a lamp
        # pixel with inf depth would poison the SVGF edge weights.
        aovs["depth"] = torch.where(alive, hit.t, inf)
        aovs["instance"] = torch.where(alive, inst, -1).to(torch.int32)

    irow = fetch_rows(inst_rows, inst.clamp(min=0))
    srow = fetch_rows(shade_rows, tri.clamp(min=0))
    mrow = fetch_rows(mat_rows, irow[:, 24].long())
    mat_type = mrow[:, 0].long()
    emission = mrow[:, 1:4]

    # ---- emissive hit (bounce 0: prev_allow_nee is False, so mis_w = 1) ----
    is_light = alive & (mat_type == int(MaterialType.LIGHT))
    light_add = torch.where(is_light[:, None], throughput * emission, zero)
    radiance = radiance + light_add
    if with_aovs:
        direct = direct + light_add
    alive = alive & ~is_light
    alive = alive & (0 < config.num_bounces - 1)

    if route == "stream":
        u, v = sg.rederive_uv(srow, irow, ray_o, ray_d, hit.t, tri >= 0)
    else:
        u, v = hit.u, hit.v
    point, geom_n, shading_n, p_obj, uv = sg.interpolate_hit(srow, irow, u, v)
    entering = (ray_d * geom_n).sum(-1) < 0.0
    flip = torch.where(entering, 1.0, -1.0)[:, None]
    geom_n = geom_n * flip
    shading_n = shading_n * flip
    tangent, bitangent = orthonormal_basis(shading_n)
    omega_i = world_to_local(-ray_d, tangent, bitangent, shading_n)
    alive = alive & (omega_i[:, 2] > 0.0)

    mat = {"type": mat_type, "roughness": mrow[:, 7], "ior": mrow[:, 8],
           "eta": mrow[:, 9:12], "k": mrow[:, 12:15]}
    albedo = mrow[:, 4:7]
    if use_textures:
        cone_width = cone_width + cone_angle * torch.where(alive, hit.t, zero)
        tex_id = mrow[:, 15].to(torch.int32)
        tex_rgb = _aniso_texture_tap(textures, tex_id, srow, irow, uv, cone_width, ray_d,
                                     geom_n)
        albedo = torch.where((tex_id >= 0)[:, None], albedo * tex_rgb, albedo)
    is_diffuse = mat_type == int(MaterialType.DIFFUSE)
    fold = alive & is_diffuse
    rr_albedo = None
    if demodulate:
        rr_albedo = torch.where(fold[:, None], albedo, 1.0)
        fold = torch.zeros_like(fold)
    throughput = torch.where(fold[:, None], throughput * albedo, throughput)
    can_nee = bsdf_lib.allow_nee(mat_type, mat["roughness"], mat_types)
    if with_aovs:
        # Primary-hit G-buffer (svgf_set_gbuffers, SVGF.h:61-81).
        diffuse_like = alive & (is_diffuse | (mat_type == int(MaterialType.PLASTIC)))
        aovs["albedo"] = torch.where(diffuse_like[:, None], albedo, 1.0)
        aovs["normal"] = torch.where(alive[:, None], shading_n, zero)
        aovs["position"] = torch.where(alive[:, None], point, zero)
        point_prev = affine_point_rows(
            fetch_rows(buffers["inst_prev_rows"], inst.clamp(min=0)), p_obj)
        aovs["position_prev"] = torch.where(alive[:, None], point_prev, zero)

    if nee_possible:
        u_pick, _ = draw2(rng.SampleDimension.NEE_LIGHT, pixel_index, 0, sample_index)
        u_b1, u_b2 = draw2(rng.SampleDimension.NEE_TRIANGLE, pixel_index, 0,
                           sample_index)
        k = searchsorted_cdf(buffers["light_cdf"], u_pick)
        lt = buffers["light_tri"][k]
        li = buffers["light_inst"][k]
        lu, lv = sample_triangle_barycentric(u_b1, u_b2)
        lrow = fetch_rows(shade_rows, lt)
        lirow = fetch_rows(inst_rows, li)
        le1 = affine_dir_rows(lirow[:, 0:12], lrow[:, 3:6])
        le2 = affine_dir_rows(lirow[:, 0:12], lrow[:, 6:9])
        lp0 = affine_point_rows(lirow[:, 0:12], lrow[:, 0:3])
        light_point = lp0 + lu[:, None] * le1 + lv[:, None] * le2
        light_gn = normalize(torch.linalg.cross(le1, le2, dim=-1))
        light_emission = fetch_rows(mat_rows, lirow[:, 24].long())[:, 1:4]

        shadow_o = _offset_origin(point, light_point - point, geom_n)
        light_point = _offset_origin(light_point, shadow_o - light_point, light_gn)
        to_light = light_point - shadow_o
        dist = torch.linalg.vector_norm(to_light, dim=-1)
        to_light = to_light / dist.clamp(min=1e-20)[:, None]
        cos_light = (to_light * light_gn).sum(-1).abs()
        omega_o_nee = world_to_local(to_light, tangent, bitangent, shading_n)
        nee_eval = bsdf_lib.bsdf_eval(luts, mat, omega_i, omega_o_nee, albedo,
                                      entering, mat_types)
        light_pdf = (luminance(light_emission) * dist * dist
                     / (cos_light * total_weight).clamp(min=1e-20))
        pdf_ok = torch.isfinite(light_pdf) & (light_pdf > 1e-20)
        mis_w = (power_heuristic(light_pdf, nee_eval.pdf) if config.enable_mis
                 else torch.ones_like(light_pdf))
        illumination = (throughput * nee_eval.value * light_emission
                        * (mis_w / light_pdf.clamp(min=1e-20))[:, None])
        want = alive & can_nee & nee_eval.valid & pdf_ok & (cos_light > 1e-6)
        rays_traced = rays_traced + want.sum()
        shadow_tmax = torch.where(want, dist - 2 * EPSILON, zero)
        occluded = trace_any(shadow_o, to_light, shadow_tmax)
        nee_add = torch.where((want & ~occluded)[:, None], illumination, zero)
        radiance = radiance + nee_add
        if with_aovs:
            direct = direct + nee_add

    u_f0, u_f1 = draw2(rng.SampleDimension.BSDF_0, pixel_index, 0, sample_index)
    u_b0, u_b1 = draw2(rng.SampleDimension.BSDF_1, pixel_index, 0, sample_index)
    sample = bsdf_lib.bsdf_sample(luts, mat, omega_i, albedo, entering, u_f0, u_f1,
                                  u_b0, u_b1, mat_types)
    alive = alive & sample.valid
    throughput = torch.where(alive[:, None], throughput * sample.throughput_mul,
                             throughput)
    new_dir = normalize(local_to_world(sample.omega_o, tangent, bitangent, shading_n))
    ray_o = torch.where(alive[:, None], _offset_origin(point, new_dir, geom_n), ray_o)
    ray_d = torch.where(alive[:, None], new_dir, ray_d)
    last_pdf = sample.pdf
    prev_allow_nee = can_nee & bool(config.enable_nee)
    if has_media:  # dielectric transmissions hand the medium over (BSDF.h)
        medium_id = torch.where(alive & sample.is_transmission,
                                torch.where(entering, mrow[:, 16].to(torch.int32), -1),
                                medium_id)

    # ---------------- bounces >= 1 (shade from the hits) ----------------
    # The shade kernel reads each lane's hit rows itself: glue only traces,
    # samples the sky and draws the lane's numbers (none on the last bounce,
    # whose shade adds the sky and emission only and traces nothing after,
    # unless the scene has media: the medium step draws there too).
    shade_tables = buffers["shade_gather"]
    params = (config.num_bounces, total_weight, float(cone_angle) if use_textures else 0.0)
    caps = compact_caps(R, compact_tiers)
    # Once compacted: the wave's lane of each slot, and the full-width
    # radiance (and direct) that the narrow wave's are written back into.
    lane_ids = full = None
    live_prev = R
    bounce = 1
    while bounce < config.num_bounces:
        live = int(alive.sum())
        if live == 0:
            break
        cap = next((c for c in caps if live <= c < alive.shape[0]), None)
        if cap is not None:
            carry = {"ray_o": ray_o, "ray_d": ray_d, "radiance": radiance,
                     "throughput": throughput, "last_pdf": last_pdf, "alive": alive,
                     "prev_allow_nee": prev_allow_nee, "pixel_index": pixel_index}
            for name, x in (("cone_width", cone_width if use_textures else None),
                            ("rr_albedo", rr_albedo), ("medium_id", medium_id),
                            ("direct", direct)):
                if x is not None:
                    carry[name] = x
            if full is None:
                full = (radiance, direct)
            else:  # the narrow wave's lanes, live or not, as they stand
                _write_back(full, lane_ids, live_prev, radiance, direct)
            with torch.profiler.record_function(COMPACT_RANGE):
                slots, carry = compact_lanes(carry, live, cap)
            lane_ids = slots if lane_ids is None else lane_ids[slots]
            live_prev = live
            ray_o, ray_d, radiance = carry["ray_o"], carry["ray_d"], carry["radiance"]
            throughput, last_pdf, alive = carry["throughput"], carry["last_pdf"], carry["alive"]
            prev_allow_nee, pixel_index = carry["prev_allow_nee"], carry["pixel_index"]
            cone_width = carry.get("cone_width", cone_width)
            rr_albedo = carry.get("rr_albedo")
            medium_id = carry.get("medium_id")
            direct = carry.get("direct")
        if bounce_log is not None:
            bounce_log.append((bounce, live, alive.shape[0]))
        rays_traced = rays_traced + alive.sum()
        hit = trace_closest(ray_o, ray_d, tmax_of(alive))
        radiance = poison_truncated(radiance, alive)
        tri, inst = surface_ids(hit)
        last = bounce == config.num_bounces - 1
        dims = rng.SampleDimension
        if has_media:
            # The medium step's draws are the shade's f0, f1, r3, r4 (the
            # same dimensions and bounce), drawn once.
            u_f = draw2(dims.BSDF_0, pixel_index, bounce, sample_index)
            u_c = draw2(dims.BSDF_1, pixel_index, bounce, sample_index)
            throughput, alive, scatters, scatter_o, scatter_d = medium_step(
                buffers["mediums"], medium_id, alive, throughput, ray_o, ray_d, hit.t,
                u_f, u_c)
        lanes = {"t": hit.t, "tri": tri, "inst": inst, "ray_o": ray_o, "ray_d": ray_d,
                 "throughput": throughput, "alive": alive,
                 "prev_allow_nee": prev_allow_nee, "last_pdf": last_pdf,
                 "sky": sample_sky(buffers["sky"], buffers["sky_scale"], ray_d)}
        if use_binary:  # the binary kernel returns u, v (0 on a miss)
            lanes["u"], lanes["v"] = hit.u, hit.v
        if use_textures:
            lanes["cone_width"] = cone_width
        if demodulate:
            lanes["rr_albedo"] = rr_albedo
        if not last:
            lanes["r5"], _ = draw2(dims.RUSSIAN_ROULETTE, pixel_index, bounce, sample_index)
            lanes["r0"], _ = draw2(dims.NEE_LIGHT, pixel_index, bounce, sample_index)
            lanes["r1"], lanes["r2"] = draw2(dims.NEE_TRIANGLE, pixel_index, bounce,
                                             sample_index)
            if has_media:
                (lanes["f0"], lanes["f1"]), (lanes["r3"], lanes["r4"]) = u_f, u_c
                lanes["medium_id"] = medium_id
            else:
                lanes["f0"], lanes["f1"] = draw2(dims.BSDF_0, pixel_index, bounce,
                                                 sample_index)
                lanes["r3"], lanes["r4"] = draw2(dims.BSDF_1, pixel_index, bounce,
                                                 sample_index)
        out = kernels.shade(shade_tables, (bounce,) + params, lanes,
                            enable_nee=nee_possible, enable_mis=config.enable_mis,
                            enable_rr=config.enable_russian_roulette, demod=demodulate,
                            textured=use_textures, last=last)
        radiance = radiance + out["radiance_add"]
        if with_aovs and bounce == 1:  # sky and emission after one scattering
            direct = direct + out["radiance_add"]
        alive = out["alive"]
        if last:
            break
        if nee_possible:
            want = out["shadow_tmax"] > 0.0
            rays_traced = rays_traced + want.sum()
            occluded = trace_any(out["shadow_o"], out["shadow_d"],
                                 out["shadow_tmax"])
            radiance = radiance + torch.where((want & ~occluded)[:, None],
                                              out["illumination"], zero)
        ray_o, ray_d = out["ray_o"], out["ray_d"]
        throughput = out["throughput"]
        prev_allow_nee = out["prev_allow_nee"]
        last_pdf = out["last_pdf"]
        if use_textures:
            cone_width = out["cone_width"]
        if has_media:
            # Scattered lanes rejoin (JAX render_wave :617-641): the shade's
            # russian roulette scaled their throughput; the same draw, on the
            # same pre-shade throughput, kills them here.
            if config.enable_russian_roulette:
                basis = lanes["throughput"] * rr_albedo if demodulate else lanes["throughput"]
                survival = basis.amax(dim=-1).clamp(0.0, 1.0)
                scatters = scatters & (lanes["r5"] <= survival)
            medium_id = out["medium_id"]
            ray_o = torch.where(scatters[:, None], scatter_o, ray_o)
            ray_d = torch.where(scatters[:, None], scatter_d, ray_d)
            alive = alive | scatters
            prev_allow_nee = prev_allow_nee & ~scatters
            last_pdf = torch.where(scatters, 1.0, last_pdf)
        bounce += 1

    if full is not None:
        radiance, direct = _write_back(full, lane_ids, live_prev, radiance, direct)
    return _finish(radiance, direct, aovs, with_aovs, with_stats, rays_traced)


def default_compact_tiers(R: int, config: GPUConfig) -> tuple:
    """The compaction tiers `Pathtracer` passes render_wave for a wave of
    `R` rays (JAX default_compact_tiers, a gate sized on the TPU and kept as
    routing, ROADMAP C42): none below 2^18 rays or at <= 3 bounces, else
    one tier of 1/16."""
    if R < (1 << 18) or config.num_bounces <= 3:
        return ()
    return (16,)


def compact_caps(R: int, tiers) -> tuple:
    """The narrow wave widths of `tiers` for a wave of `R` lanes, ascending
    (JAX render_wave `_tiered_body`): a tier `div` gives
    ceil((R // div) / 1024) * 1024 lanes; tiers under 2, or of fewer than
    1024 lanes, none."""
    return tuple(sorted({-(-(R // d) // 1024) * 1024 for d in {int(t) for t in tiers}
                         if d >= 2 and R // d >= 1024}))


def compact_lanes(carry: dict, live: int, cap: int):
    """Pack the `live` lanes of `carry["alive"]` into `cap` slots, in lane
    order (a cumsum gives each its slot; one scatter of the lane ids), with
    one gather of the float lanes stacked and one of the integer lanes.
    Padding slots hold lane 0's values and are dead. Returns (the lane of
    each slot, the packed carry: every (W, ...) tensor of `carry` at (cap,
    ...))."""
    alive = carry["alive"]
    dev = alive.device
    W = alive.shape[0]
    slot = torch.where(alive, torch.cumsum(alive, 0) - 1, cap)
    lanes = torch.zeros(cap + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, torch.arange(W, device=dev))[:cap]
    floats = [k for k, x in carry.items() if x.is_floating_point()]
    ints = [k for k in carry if k not in floats]
    cols = [carry[k].reshape(W, -1) for k in floats]
    packed_f = torch.cat(cols, 1).index_select(0, lanes)
    packed_i = torch.stack([carry[k].long() for k in ints], 1).index_select(0, lanes)
    out, at = {}, 0
    for k, c in zip(floats, cols):
        out[k] = packed_f[:, at:at + c.shape[1]].reshape((cap,) + carry[k].shape[1:]).contiguous()
        at += c.shape[1]
    for j, k in enumerate(ints):
        out[k] = packed_i[:, j].to(carry[k].dtype)
    out["alive"] = out["alive"] & (torch.arange(cap, device=dev) < live)
    return lanes, out


def _write_back(full, lane_ids, live: int, radiance, direct):
    """Write the first `live` slots of a narrow wave's radiance (and
    direct) into the full-width tensors of `full` at their lanes; the slots
    after them are padding. Returns the full-width tensors."""
    with torch.profiler.record_function(COMPACT_RANGE):
        lanes = lane_ids[:live]
        full[0].index_copy_(0, lanes, radiance[:live])
        if direct is not None:
            full[1].index_copy_(0, lanes, direct[:live])
    return full


def medium_step(mediums: dict, medium_id, alive, throughput, ray_o, ray_d, t,
                u_dist, u_phase):
    """The homogeneous-medium interaction of one segment (JAX render_wave
    :390-439; reference Pathtracer.cu:252-325): for live lanes inside a
    medium, a distance sampled on a channel picked by throughput (Wrenninge's
    spectral MIS, `u_dist` = the BSDF_0 pair), against the hit distance `t`
    (+inf on a miss). A lane that samples short of the hit scatters: its
    throughput takes sigma_s T / pdf and it leaves `alive`, to continue from
    `ray_o + dist * ray_d` (no offset) along a Henyey-Greenstein direction
    (`u_phase` = the BSDF_1 pair); a lane that reaches the hit takes T / pdf;
    in a medium that cannot scatter, exp(-sigma_a t). Returns (throughput,
    alive, scatters, scatter origin, scatter direction)."""
    in_medium = alive & (medium_id >= 0)
    mid = medium_id.clamp(min=0).long()
    sig_a = mediums["sigma_a"][mid]
    sig_s = mediums["sigma_s"][mid]
    sigma_t = sig_a + sig_s
    can_scatter = sig_s.sum(-1) > 0.0
    u_s1, u_s2 = u_dist
    thr_sum = throughput.sum(-1).clamp(min=1e-20)
    wavelength_pdf = throughput / thr_sum[:, None]
    pick = u_s1 * thr_sum
    sigma_used = torch.where(pick < throughput[:, 0], sigma_t[:, 0],
                             torch.where(pick < throughput[:, 0] + throughput[:, 1],
                                         sigma_t[:, 1], sigma_t[:, 2]))
    dist = -torch.log((1.0 - u_s2).clamp(min=1e-10)) / sigma_used.clamp(min=1e-10)
    transmittance = torch.exp(-sigma_t * torch.minimum(dist, t)[:, None])
    scatters = in_medium & can_scatter & (dist < t)
    passthrough = in_medium & can_scatter & ~scatters
    absorb_only = in_medium & ~can_scatter
    pdf_sc = (wavelength_pdf * sigma_t * transmittance).sum(-1).clamp(min=1e-20)
    pdf_pass = (wavelength_pdf * transmittance).sum(-1).clamp(min=1e-20)
    thr_scatter = throughput * sig_s * transmittance / pdf_sc[:, None]
    thr_pass = throughput * transmittance / pdf_pass[:, None]
    thr_absorb = throughput * torch.exp(-sig_a * t.clamp(max=1e20)[:, None])
    throughput = torch.where(scatters[:, None], thr_scatter,
                             torch.where(passthrough[:, None], thr_pass,
                                         torch.where(absorb_only[:, None], thr_absorb,
                                                     throughput)))
    scatter_d = sample_henyey_greenstein(-ray_d, mediums["g"][mid], *u_phase)
    scatter_o = ray_o + dist[:, None] * ray_d
    return throughput, alive & ~scatters, scatters, scatter_o, scatter_d


def _fused_bounces(buffers, kernels, trace_closest, trace_any, pixel_index,
                   sample_index, config, width, nee_possible, ray_o, ray_d,
                   radiance, throughput, alive, rays_traced, bounce_log=None):
    """The fused-shade route's bounce loop (JAX fast_bounce_body): each
    bounce, bounce 0 included, is a closest-hit wave, one fused shade call
    and the NEE shadow wave, until every lane is dead; every wave at full
    width, as in the JAX package. Returns (radiance, rays traced)."""
    R = pixel_index.shape[0]
    dev = pixel_index.device
    prev_allow_nee = torch.zeros(R, dtype=torch.bool, device=dev)
    last_pdf = torch.ones(R, dtype=torch.float32, device=dev)
    seq_x, seq_y = buffers["seq_host"]
    zero = torch.zeros((), device=dev)
    bounce = 0
    while bounce < config.num_bounces:
        live = int(alive.sum())
        if live == 0:
            break
        if bounce_log is not None and bounce > 0:
            bounce_log.append((bounce, live, R))
        rays_traced = rays_traced + alive.sum()
        hit = trace_closest(ray_o, ray_d,
                            torch.where(alive, float("inf"), zero))
        params = fs.make_params(seq_x, seq_y, bounce, config.num_bounces,
                                buffers["sky_rgb"], buffers["total_weight"],
                                sample_index)
        out = kernels.fused_shade(
            buffers["fused_shade"], buffers["sampler"], params, hit, ray_o,
            ray_d, throughput, alive, prev_allow_nee, last_pdf, pixel_index,
            width, enable_nee=nee_possible, enable_mis=config.enable_mis,
            enable_rr=config.enable_russian_roulette)
        radiance = radiance + out["radiance_add"]
        if nee_possible:
            want = out["shadow_tmax"] > 0.0
            rays_traced = rays_traced + want.sum()
            occluded = trace_any(out["shadow_o"], out["shadow_d"], out["shadow_tmax"])
            radiance = radiance + torch.where((want & ~occluded)[:, None],
                                              out["illumination"], zero)
        ray_o, ray_d = out["ray_o"], out["ray_d"]
        throughput, alive = out["throughput"], out["alive"]
        prev_allow_nee, last_pdf = out["prev_allow_nee"], out["last_pdf"]
        bounce += 1
    return radiance, rays_traced


def _finish(radiance, direct, aovs, with_aovs, with_stats, rays_traced):
    """NaN/Inf poisoning -> magenta (Pathtracer.cu:790-793), and the
    render_wave result."""
    dev = radiance.device
    zero = torch.zeros((), device=dev)
    bad = ~torch.isfinite(radiance).all(dim=-1)
    magenta = torch.tensor([1.0, 0.0, 1.0], dtype=torch.float32, device=dev)
    radiance = torch.where(bad[:, None], magenta, radiance)
    result = radiance
    if with_aovs:
        result = {"radiance": radiance,
                  "direct": torch.where(bad[:, None], zero, direct),
                  "indirect": torch.where(bad[:, None], magenta,
                                          (radiance - direct).clamp(min=0.0)),
                  **aovs}
    if with_stats:
        return result, rays_traced
    return result


class Pathtracer:
    """Host orchestrator: device tables, waves, accumulation, and the SVGF +
    TAA history of the denoised path (JAX: integrators/pathtracer.Pathtracer).

    Scene edits go through `invalidated` and `update` / `update_async`.
    `inst_prev_rows`, which the denoised path's motion vectors read, holds
    the instance transforms of the previously rendered frame: on the first
    frame after `init_device` the current ones, after a transform refresh
    those current before it (the reference's rule: Integrator::update calls
    Mesh::update every frame, so a static mesh has prev == current; the
    JAX package keeps the scene's `transform_prev`, ROADMAP C5)."""

    def __init__(self, scene: Scene, cpu_config: Optional[CPUConfig] = None,
                 gpu_config: Optional[GPUConfig] = None, device="cuda",
                 kernels: KernelSet = DISPATCH):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                               "False; pass device='cpu' to run the plain "
                               "versions on the CPU")
        self.scene = scene
        self.cpu_config = cpu_config or scene.config
        gpu = gpu_config or GPUConfig()
        if scene.integrator_max_depth:
            gpu = dataclasses.replace(gpu, num_bounces=scene.integrator_max_depth)
        self.gpu_config = gpu
        self.kernels = kernels
        self.invalidated = Invalidation()
        self.width = scene.film_width
        self.height = scene.film_height
        self.buffers: Optional[dict] = None
        self.accumulator: Optional[torch.Tensor] = None
        self.sample_index = 0
        self.rays_traced = 0
        self.magenta_pixels = 0
        self._tile_order = None
        # Each wave's (bounce, live lanes, width) of its bounces >= 1 in the
        # last trace (`compaction`).
        self.bounce_widths: list = []
        # Denoised path: filter history, previous TAA frame and the previous
        # frame's view-projection, carried from frame to frame.
        self.svgf_history: Optional[svgf_ops.SVGFHistory] = None
        self._taa_prev = None
        self._vp_prev = None
        # What refresh_tlas re-packs from; a refresh running on the loader
        # pool (update_async); the instance rows of the last rendered frame;
        # the rows inst_prev_rows was last taken from, with what it became.
        self._host = self._geo = None
        self._pending = None
        self._shown_rows = self._prev = None

    def init_device(self) -> None:
        """Build and upload the scene tables."""
        self.buffers, self._host, self._geo = build_scene_tables(
            self.scene, self.device, self.cpu_config.sah_cost_node,
            self.cpu_config.sah_cost_leaf, self.cpu_config.bvh_force_rebuild)
        self._shown_rows = None
        self.reset_accumulation()
        self.invalidated.clear()

    def reset_accumulation(self) -> None:
        self.sample_index = 0
        self.rays_traced = 0
        self.magenta_pixels = 0
        self.accumulator = torch.zeros((self.width * self.height, 3),
                                       dtype=torch.float32, device=self.device)

    def share_tables(self, other: "Pathtracer") -> None:
        """Take the tables of `other` (a Pathtracer of the same scene), with
        what refresh_tlas re-packs them from, as init_device would build
        them (the accumulation reset, nothing invalidated); a later refresh
        replaces this Pathtracer's tables only."""
        other._join_pending()
        self.buffers, self._host, self._geo = other.buffers, other._host, other._geo
        self._shown_rows = None
        self.reset_accumulation()
        self.invalidated.clear()

    def update(self, delta: float = 0.0) -> None:
        """Re-upload what `invalidated` names (JAX Pathtracer.update,
        reference Integrator::update, Integrator.cpp:432-528): a material,
        medium or sky edit, or no tables yet, rebuilds every table and
        resets; a transform edit re-derives the tables built from transforms
        (`refresh_tlas`; the scene's instances are updated first only under
        `enable_scene_update`) and resets unless SVGF is on, whose history
        carries over the move; a camera or gpu_config edit resets."""
        self._join_pending()
        inv = self.invalidated
        if self.buffers is None or inv.materials or inv.mediums or inv.sky:
            self.scene.update(delta)
            self.init_device()
        elif inv.scene:
            if self.cpu_config.enable_scene_update:
                self.scene.update(delta)
            self.buffers, self._host = refresh_tlas(self.buffers, self.scene,
                                                    self._host, self._geo)
            if not self.gpu_config.enable_svgf:
                self.reset_accumulation()
            inv.clear()
        elif inv.camera or inv.gpu_config:
            self.reset_accumulation()
            inv.clear()

    def update_async(self, delta: float = 0.0) -> None:
        """`update`, with a transform edit's refresh run on the loader pool
        (JAX update_async; reference: uploads on a non-blocking stream,
        Integrator.cpp:212,278); the next render, denoised frame or AOV
        export joins it first. Only host work can overlap: every render ends
        in a host sync, and the refresh's pageable copies queue on the
        stream behind the launches before them. Other edits update at once."""
        inv = self.invalidated
        if (self.buffers is not None and inv.scene
                and not (inv.materials or inv.mediums or inv.sky)):
            from gpu_raytracer_tpu_torch.utils.pool import submit

            self._join_pending()
            if self.cpu_config.enable_scene_update:
                self.scene.update(delta)
            self._pending = submit(refresh_tlas, self.buffers, self.scene, self._host,
                                   self._geo)
            if not self.gpu_config.enable_svgf:
                self.reset_accumulation()
            inv.clear()
        else:
            self.update(delta)

    def _join_pending(self) -> None:
        fut, self._pending = self._pending, None
        if fut is not None:
            self.buffers, self._host = fut.result()

    def _ready(self) -> None:
        """Join a pending refresh; build the tables if there are none."""
        self._join_pending()
        if self.buffers is None:
            self.init_device()

    def _take_prev_rows(self) -> None:
        """Set `inst_prev_rows` to the transforms of the last rendered frame
        (the current ones when none was rendered since init_device), in a
        new dict, so that a dict another Pathtracer shares stays as it is."""
        shown = self.buffers["inst_rows"] if self._shown_rows is None else self._shown_rows
        prev = self.buffers["inst_prev_rows"]
        if self._prev is None or self._prev[0] is not shown or self._prev[1] is not prev:
            prev = shown[:, :12].contiguous()
            self.buffers = {**self.buffers, "inst_prev_rows": prev}
            self._prev = (shown, prev)

    @property
    def mat_types(self) -> tuple:
        return tuple(sorted({int(m.type) for m in self.scene.materials}))

    @property
    def has_media(self) -> bool:
        """Whether the scene holds a homogeneous medium (render_wave's
        medium step and hand-over run only then)."""
        return len(self.scene.mediums) > 0

    @property
    def use_pallas(self) -> bool:
        """Every wave on the binary tables (JAX Pathtracer.use_pallas): on
        the card when the scene is under the binary kernel's gate (or packed
        binary by `--bvh sah|sbvh`); on the CPU only when there are no wide
        tables, as the JAX package keeps its XLA route off the TPU."""
        if self.buffers is None or self.buffers["binary"] is None:
            return False
        return self.device.type == "cuda" or self.buffers["wide"] is None

    @property
    def use_pallas_shade(self) -> bool:
        """The fused-shade route (JAX Pathtracer.use_pallas_shade): on the
        card, with the fused shade tables, film sides that are multiples of
        32 (each 1024-lane block one 32x32 screen tile, for the in-kernel
        noise rows), the PMJ sampler and at most 12 bounces (every sampler
        dimension inside the 64 PMJ sequences)."""
        return (self.use_pallas and self.device.type == "cuda"
                and self.buffers["fused_shade"] is not None
                and self.width % 32 == 0 and self.height % 32 == 0
                and self.gpu_config.sampler == "pmj"
                and self.gpu_config.num_bounces <= 12)

    def route(self, denoised: bool = False) -> str:
        """The render_wave route of a batch sample, or of a denoised frame
        (JAX _denoised_frame passes use_pallas, never use_pallas_shade):
        "stream" on any device whenever the tables are paged."""
        if self.buffers is not None and self.buffers["stream"] is not None:
            return "stream"
        if not self.use_pallas:
            return "wide"
        return "binary_shade" if self.use_pallas_shade and not denoised else "binary"

    @property
    def paths(self) -> dict:
        """Which kernel or plain version runs each role of the route this
        Pathtracer takes (denoised frames when its config enables SVGF)."""
        route = self.route(self.gpu_config.enable_svgf)
        wide = None if self.buffers is None else self.buffers["wide"]
        two_level = route == "wide" and wide is not None and wide.two_level
        return kernel_paths(self.kernels, self.device, two_level, route)

    @property
    def compaction(self) -> dict:
        """The late-bounce compaction in force (render_wave
        `compact_tiers`): the tiers and their narrow widths ("caps") on
        the route of a batch sample (of a denoised frame when the config
        enables SVGF) at this Pathtracer's wave size, and (bounce, live
        lanes, width) of each bounce >= 1 of the first wave of the last
        sample, frame or AOV export rendered ("bounces"), and how many of
        its waves ran a bounce narrower than the wave ("waves_narrowed")."""
        route = self.route(self.gpu_config.enable_svgf)
        tiers = self._tiers(route)
        return {"tiers": tiers, "caps": compact_caps(self._wave_size(), tiers),
                "bounces": list(self.bounce_widths[0]) if self.bounce_widths else [],
                "waves_narrowed": sum(any(w < self._wave_size() for _, _, w in log)
                                      for log in self.bounce_widths)}

    def _tiers(self, route: str) -> tuple:
        """The compaction tiers of `route` at this Pathtracer's wave (none
        on the fused-shade route, as in the JAX package)."""
        if route == "binary_shade":
            return ()
        return default_compact_tiers(self._wave_size(), self.gpu_config)

    def _wave_size(self) -> int:
        """batch_size pixels, at most the film's (a multiple of 1024 on the
        fused-shade route)."""
        wave = min(self.cpu_config.batch_size, self.width * self.height)
        if self.use_pallas_shade:
            wave = max(wave // fs.BLOCK * fs.BLOCK, fs.BLOCK)
        return wave

    def _waves(self):
        """(pixel ids, valid mask, valid count) of each wave of one sample:
        `_wave_size()` pixels in tile order, the tail wave clamped and
        masked."""
        dev = self.device
        num_pixels = self.width * self.height
        wave = self._wave_size()
        if self._tile_order is None or self._tile_order.shape[0] != num_pixels:
            self._tile_order = torch.as_tensor(
                tile_order(self.width, self.height).astype(np.int64), device=dev)
        for offset in range(0, num_pixels, wave):
            pos_raw = offset + torch.arange(wave, device=dev)
            idx = self._tile_order[pos_raw.clamp(max=num_pixels - 1)]
            yield idx, pos_raw < num_pixels, min(wave, num_pixels - offset)

    def _trace(self, with_aovs: bool, sample_index: Optional[int] = None,
               names: tuple = FRAME_AOVS):
        """One sample (`sample_index`, default the next) for every pixel ->
        ({name: (H*W, ...) image}, rays, NaN samples): radiance, or with
        `with_aovs` the AOVs `names`."""
        dev = self.device
        num_pixels = self.width * self.height
        camera = camera_tensors(self.scene.camera.params(), dev)
        images = {}
        rays = torch.zeros((), dtype=torch.int64, device=dev)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        magenta = torch.tensor([1.0, 0.0, 1.0], device=dev)
        route = self.route(denoised=with_aovs)
        tiers = self._tiers(route)
        sample = self.sample_index if sample_index is None else sample_index
        self._take_prev_rows()
        self.bounce_widths = []
        for idx, mask, count in self._waves():
            self.bounce_widths.append([])
            out, n = render_wave(
                self.buffers, camera, idx, sample, self.gpu_config,
                self.width, self.cpu_config.seed, self.scene.has_lights,
                with_stats=True, valid_mask=mask, mat_types=self.mat_types,
                kernels=self.kernels, with_aovs=with_aovs, route=route,
                has_media=self.has_media, compact_tiers=tiers,
                bounce_log=self.bounce_widths[-1])
            out = out if with_aovs else {"radiance": out}
            for k in names if with_aovs else ("radiance",):
                v = out[k]
                if k not in images:
                    images[k] = torch.zeros((num_pixels,) + v.shape[1:],
                                            dtype=v.dtype, device=dev)
                images[k][idx[:count]] = v[:count]
            rays = rays + n
            bad = bad + (out["radiance"][:count] == magenta).all(dim=-1).sum()
        self._shown_rows = self.buffers["inst_rows"]
        return images, rays, bad

    def render(self) -> None:
        """Render one sample for every pixel and fold it into the online
        average (kernel_accumulate, Pathtracer.cu:775-796)."""
        self._ready()
        images, rays, bad = self._trace(with_aovs=False)
        self.accumulator = self.accumulator + (images["radiance"] - self.accumulator) / (
            self.sample_index + 1)
        self.sample_index += 1
        self.rays_traced += int(rays)
        self.magenta_pixels += int(bad)  # NaN/Inf samples (render_wave)

    def render_samples(self, n: int) -> np.ndarray:
        for _ in range(n):
            self.render()
        return self.framebuffer()

    def _view_projection(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.scene.camera.view_projection,
                                          np.float32), device=self.device)

    def trace_aovs(self):
        """One 1-spp sample with AOVs for every pixel -> ({name: (H, W, ...)
        image}, rays, NaN samples): the trace half of a denoised frame."""
        images, rays, bad = self._trace(with_aovs=True)
        H, W = self.height, self.width
        return {k: v.reshape((H, W) + v.shape[1:]) for k, v in images.items()}, rays, bad

    def denoise(self, frame: dict) -> torch.Tensor:
        """SVGF, then TAA when enabled, on one frame of AOV images (JAX
        _denoised_frame after the trace); advances the filter history."""
        config = self.gpu_config
        colour, self.svgf_history = svgf_ops.svgf_step(
            frame, self.svgf_history, self._vp_prev, config, kernels=self.kernels)
        if not config.enable_taa:
            return colour
        taa_in = taa_ops.to_taa_space(colour.clamp(min=0.0))
        prev = taa_in if self.sample_index == 0 else self._taa_prev
        # position_prev is the hit's previous-frame position: project it with
        # the previous view-projection (SVGF.h:61-81).
        screen_prev = svgf_ops.project_to_screen(frame["position_prev"],
                                                 self._vp_prev, self.width,
                                                 self.height)
        self._taa_prev = taa_ops.taa_step(taa_in, prev, screen_prev)
        return taa_ops.from_taa_space(self._taa_prev)

    def render_frame_denoised(self) -> torch.Tensor:
        """One 1-spp frame through SVGF (+ TAA), the interactive mode (JAX
        render_frame_denoised): trace with AOVs in waves, scatter the AOVs
        into images, filter. Returns the (H, W, 3) frame on the device, which
        is also the framebuffer."""
        self._ready()
        H, W = self.height, self.width
        if self.svgf_history is None:
            self.svgf_history = svgf_ops.init_history(H, W, self.device)
            self._taa_prev = torch.zeros((H, W, 3), device=self.device)
            self._vp_prev = self._view_projection()
        frame, rays, bad = self.trace_aovs()
        colour = self.denoise(frame)
        self.sample_index += 1
        self._vp_prev = self._view_projection()
        self.accumulator = colour.reshape(-1, 3)
        self.rays_traced += int(rays)
        self.magenta_pixels += int(bad)
        return colour

    def framebuffer(self) -> np.ndarray:
        """(H, W, 3) float32 HDR frame."""
        return self.accumulator.cpu().numpy().reshape(self.height, self.width, 3)

    def export_aovs(self, output_filename: str, samples: int = 4) -> dict:
        """Write the albedo, normal and position AOVs, each the mean of
        samples 0 .. `samples` - 1, as EXRs beside the main output
        (`<base>_albedo.exr`, ...; JAX Pathtracer.export_aovs, reference
        capture_screen, Main.cpp:226-250). Returns {name: path}."""
        import os

        from gpu_raytracer_tpu_torch.utils.exr import write_exr

        self._ready()
        names = ("albedo", "normal", "position")
        acc = dict.fromkeys(names, 0.0)
        for s in range(samples):
            images, _, _ = self._trace(with_aovs=True, sample_index=s, names=names)
            for k in names:
                acc[k] = acc[k] + images[k]
        base = os.path.splitext(output_filename)[0]
        written = {}
        for k, v in acc.items():
            img = (v / samples).cpu().numpy().reshape(self.height, self.width, 3)
            path = f"{base}_{k}.exr"
            write_exr(path, np.flipud(img))
            written[k] = path
        return written
