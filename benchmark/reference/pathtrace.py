"""The plain reference of the diffuse scenes: an unbiased path tracer in
plain PyTorch over the benchmark's own tree (`bvh`), written from the
light-transport contract the port implements for diffuse and emissive
materials (the port's `render_wave`; the reference renderer's
Pathtracer.cu:122-773), not from its code:

  * a path has `num_bounces` segments; an emissive hit adds its emission
    (two-sided) and ends the path; the last segment adds emission only;
  * at each diffuse vertex, next-event estimation picks a light triangle in
    proportion to area x luminance and a uniform point on it, weighted by
    the power heuristic against the cosine-weighted BSDF sample, and an
    emissive hit after a diffuse vertex takes the complementary weight;
  * the shading normal is the barycentric blend of the vertex normals,
    both normals turned to face the incoming ray by the geometric normal;
    a path whose incoming direction lies below the shading normal ends;
  * ray origins move 1e-4 along the geometric normal to the side the ray
    leaves by; shadow rays stop 2e-4 short of the light;
  * camera rays: a pinhole through pixel (x + jx, y + jy), the jitter of
    the Gaussian reconstruction filter (0.5 + 0.5 N(0, 1) a coordinate)
    or a given frame-constant one.

Russian roulette and the port's low-discrepancy sampler change the
variance of an estimate, not its mean, and are left out; the random
numbers are PyTorch's Philox stream from a `torch.Generator`. Everything
runs in `dtype` (float32 as the configurations state; the control runs
it in bfloat16). Imports neither JAX nor anything of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import bvh

EPSILON = 1e-4
LUM = (0.2126, 0.7152, 0.0722)


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-20)


def _offset(point, direction, normal):
    sign = torch.where(_dot(direction, normal) >= 0, 1.0, -1.0)[:, None].to(point.dtype)
    return point + sign * EPSILON * normal


def _onb(n):
    s = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t1 = torch.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], 1)
    t2 = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], 1)
    return t1, t2


class RefScene:
    """The world triangles of `scene.world_triangles`, the tree over them
    and the light table, on `device`, in `dtype`."""

    def __init__(self, tris: dict, device, dtype=torch.float32):
        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), device=device).to(dt)

        self.dtype, self.device = dtype, device
        v0, v1, v2 = (t(tris[k], torch.float32) for k in ("v0", "v1", "v2"))
        self.tree = bvh.build(v0, v1, v2, dtype)
        self.v0, self.e1, self.e2 = v0.to(dtype), (v1 - v0).to(dtype), (v2 - v0).to(dtype)
        self.n = [t(tris[k]) for k in ("n0", "n1", "n2")]
        self.gn = _normalize(torch.linalg.cross(v1 - v0, v2 - v0)).to(dtype)
        mat = t(tris["mat"], torch.int64)
        self.kind = t(tris["kind"], torch.int64)[mat]
        self.albedo = t(tris["albedo"])[mat]
        self.emission = t(tris["emission"])[mat]
        self.inst = t(tris["inst"], torch.int32)
        lights = torch.nonzero(self.kind == 2).flatten()
        area = 0.5 * torch.linalg.vector_norm(torch.linalg.cross(v1 - v0, v2 - v0), dim=-1)
        em = t(tris["emission"], torch.float32)[mat]
        lum = LUM[0] * em[:, 0] + LUM[1] * em[:, 1] + LUM[2] * em[:, 2]
        weight = (lum * area)[lights]
        self.lights = lights
        self.total_weight = float(weight.sum())
        self.light_cdf = torch.cumsum(weight / weight.sum(), 0) if lights.numel() else None
        self.lum = lum.to(dtype)


def camera_rays(basis: dict, px, py, dtype):
    """Pinhole rays through film positions (px, py) (pixel + jitter)."""
    dev = px.device

    def t(k):
        return torch.as_tensor(basis[k], device=dev, dtype=torch.float64)

    d = (t("blc")[None] + px.double()[:, None] * t("xa")[None]
         + py.double()[:, None] * t("ya")[None])
    d = _normalize(d.to(dtype))
    o = t("position").to(dtype).expand(px.shape[0], 3).contiguous()
    return o, d


def gaussian_jitter(n: int, gen, device):
    """(jx, jy) of the Gaussian reconstruction filter: 0.5 + 0.5 N(0, 1)."""
    g = torch.randn((2, n), generator=gen, device=device)
    return 0.5 + 0.5 * g[0], 0.5 + 0.5 * g[1]


def radiance(rs: RefScene, o, d, num_bounces: int, gen, aovs: bool = False):
    """(R, 3) float32 path radiance of rays (o, d) and the primary hit
    distance (R,) (+inf on a miss). With `aovs`, instead a dict of the
    denoiser's images: the radiance demodulated by the primary diffuse
    albedo ("radiance"), its part through at most one scattering ("direct":
    emission and NEE at the primary hit, emission at the next), the albedo
    (1 off diffuse surfaces), shading normal, position, depth and instance
    of the primary hit."""
    dev, dt = o.device, rs.dtype
    R = o.shape[0]
    o, d = o.clone(), d.clone()
    if aovs:
        G = {"direct": torch.zeros((R, 3), dtype=dt, device=dev),
             "albedo": torch.ones((R, 3), dtype=dt, device=dev),
             "normal": torch.zeros((R, 3), dtype=dt, device=dev),
             "position": torch.zeros((R, 3), dtype=dt, device=dev),
             "instance": torch.full((R,), -1, dtype=torch.int32, device=dev)}
    L = torch.zeros((R, 3), dtype=dt, device=dev)
    tp = torch.ones((R, 3), dtype=dt, device=dev)
    prev_pdf = torch.zeros(R, dtype=dt, device=dev)
    depth = torch.full((R,), float("inf"), device=dev)
    idx = torch.arange(R, device=dev)
    inf = torch.full((R,), float("inf"), dtype=dt, device=dev)

    def rand(n, k):
        return torch.rand((k, n), generator=gen, device=dev).to(dt)

    for b in range(num_bounces):
        if not idx.numel():
            break
        oo, dd = o[idx], d[idx]
        t, tri, u, v = bvh.trace(rs.tree, oo, dd, inf[: idx.numel()])
        if b == 0:
            depth[idx] = t.float()
        hit = tri >= 0
        idx, oo, dd, t, tri, u, v = (x[hit] for x in (idx, oo, dd, t, tri, u, v))
        kind = rs.kind[tri]
        light = kind == 2
        if bool(light.any()):
            li, lt = idx[light], tri[light]
            em = rs.emission[lt]
            w = torch.ones(li.numel(), dtype=dt, device=dev)
            if b > 0 and rs.total_weight > 0:
                cos_l = _dot(dd[light], rs.gn[lt]).abs()
                lpdf = rs.lum[lt] * t[light] ** 2 / (cos_l * rs.total_weight).clamp(min=1e-20)
                pb = prev_pdf[li]
                w = torch.where(torch.isfinite(lpdf) & (lpdf > 0),
                                pb * pb / (pb * pb + lpdf * lpdf).clamp(min=1e-20), 0.0)
            L[li] += tp[li] * em * w[:, None]
            if aovs and b <= 1:
                G["direct"][li] += tp[li] * em * w[:, None]
        if b == num_bounces - 1:
            break
        keep = ~light
        idx, oo, dd, t, tri, u, v = (x[keep] for x in (idx, oo, dd, t, tri, u, v))
        if not idx.numel():
            break
        p = oo + t[:, None] * dd
        gn = rs.gn[tri]
        flip = torch.where(_dot(dd, gn) < 0, 1.0, -1.0)[:, None].to(dt)
        w0 = (1.0 - u - v)[:, None]
        sn = _normalize(w0 * rs.n[0][tri] + u[:, None] * rs.n[1][tri]
                        + v[:, None] * rs.n[2][tri]) * flip
        gn = gn * flip
        up = _dot(-dd, sn) > 0
        idx, p, dd, tri, sn, gn = (x[up] for x in (idx, p, dd, tri, sn, gn))
        n = idx.numel()
        if not n:
            break
        albedo = rs.albedo[tri]
        if aovs and b == 0:  # the primary albedo stays out of the path
            G["albedo"][idx], G["normal"][idx], G["position"][idx] = albedo, sn, p
            G["instance"][idx] = rs.inst[tri]
            albedo = torch.ones_like(albedo)
        r = rand(n, 5)
        if rs.light_cdf is not None:
            k = torch.searchsorted(rs.light_cdf, r[0].float().contiguous()).clamp(
                max=rs.lights.numel() - 1)
            lt = rs.lights[k]
            su = torch.sqrt(r[1])
            lp = rs.v0[lt] + (1.0 - su)[:, None] * rs.e1[lt] + (r[2] * su)[:, None] * rs.e2[lt]
            lgn = rs.gn[lt]
            so = _offset(p, lp - p, gn)
            lp = _offset(lp, so - lp, lgn)
            to = lp - so
            dist = torch.linalg.vector_norm(to, dim=-1)
            wl = to / dist.clamp(min=1e-20)[:, None]
            cos_l = _dot(wl, lgn).abs()
            cos_o = _dot(wl, sn)
            lpdf = rs.lum[lt] * dist * dist / (cos_l * rs.total_weight).clamp(min=1e-20)
            bpdf = cos_o.clamp(min=0.0) / math.pi
            mis = lpdf * lpdf / (lpdf * lpdf + bpdf * bpdf).clamp(min=1e-20)
            want = (cos_o > 0) & (cos_l > 1e-6) & torch.isfinite(lpdf) & (lpdf > 1e-20)
            wi = torch.nonzero(want).flatten()
            if wi.numel():
                occ = bvh.trace(rs.tree, so[wi], wl[wi], dist[wi] - 2 * EPSILON, any_hit=True)
                ok = wi[~occ]
                contrib = (tp[idx[ok]] * albedo[ok] * (cos_o[ok] / math.pi)[:, None]
                           * rs.emission[lt[ok]] * (mis[ok] / lpdf[ok])[:, None])
                L[idx[ok]] += contrib
                if aovs and b == 0:
                    G["direct"][idx[ok]] += contrib
        r1, phi = r[3], 2.0 * math.pi * r[4]
        rr = torch.sqrt(r1)
        z = torch.sqrt((1.0 - r1).clamp(min=0.0))
        t1, t2 = _onb(sn)
        nd = _normalize((rr * torch.cos(phi))[:, None] * t1 + (rr * torch.sin(phi))[:, None] * t2
                        + z[:, None] * sn)
        ok = z > 0
        idx, p, nd, gn, albedo, z = (x[ok] for x in (idx, p, nd, gn, albedo, z))
        tp[idx] = tp[idx] * albedo
        prev_pdf[idx] = z / math.pi
        o[idx] = _offset(p, nd, gn)
        d[idx] = nd
    if aovs:
        return dict({k: v.float() if v.is_floating_point() else v for k, v in G.items()},
                    radiance=L.float(), depth=depth)
    return L.float(), depth
