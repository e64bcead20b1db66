"""How `correct` is decided: what the timed path produced, held to the
plain reference (`benchmark/reference/`) once the window has closed.

Batch cells (the accumulated image of every sample of the window):

  block_z   the largest |z| over image blocks and colour channels between
            the image's block mean and the reference's estimate of it
            (`paths_per_block` paths a block, a uniform pixel of the block
            and the filter's jitter each), in standard errors of the
            difference (the reference's path variance over its paths and
            over the image's pixels x samples);
  pixel_err the median over `pixels` pixels drawn from the seed of the
            relative gap |a - r| / max(r, f) between a pixel's luminance a
            and the reference's estimate r of it (`paths_per_pixel`
            paths), f a twentieth of the image's mean luminance: the
            per-pixel check that block means cannot make (a fault that
            leaves the blocks' means as they were, such as lanes left out
            and the rest scaled up);
  nonfinite non-finite image values plus the program's NaN samples.

Denoised cells (two more frames run through the same entry once the
window has closed, untimed, with copies kept of their inputs and state):

  gbuffer_miss the share of pixels whose primary depth differs from the
            reference's primary hit through the same pixel, jitter and
            camera pose by more than 1e-3 of it;
  block_z   as above, on the frame's 1-spp radiance (the trace half's
            demodulated direct + indirect times the albedo image), with
            the frame's constant jitter;
  denoise_err the largest |a - b| / (1 + |b|) between a frame the program
            returned and the reference's SVGF + TAA of the program's own
            AOV images, run from the program's state before the first of
            the two frames through both (the filter's inputs are the
            program's: gbuffer_miss and block_z judge them);
  nonfinite non-finite values in the frames and their AOV images, plus
            the program's NaN samples.

A number passes at or under its limit (the traffic file's `limits`).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import pathtrace as ref
from benchmark.reference import svgf as ref_svgf

TAA_HALTON = ((0.3, 0.2), (0.7, 0.8), (0.2, 0.7), (0.8, 0.3))  # Camera.h:26-29


def _blocks(W: int, H: int, bx: int, by: int):
    xs = [(i * W) // bx for i in range(bx + 1)]
    ys = [(j * H) // by for j in range(by + 1)]
    return [(xs[i], xs[i + 1], ys[j], ys[j + 1]) for j in range(by) for i in range(bx)]


class Estimates:
    """Per-group mean and per-path variance of reference path radiance
    (float64 sums over float32 paths); groups are blocks or pixels."""

    def __init__(self, groups: int, device):
        z = lambda: torch.zeros((groups, 4), dtype=torch.float64, device=device)  # noqa: E731
        self.s, self.q = z(), z()
        self.n = torch.zeros(groups, dtype=torch.float64, device=device)

    def add(self, group, L):
        x = torch.cat([L.double(), ref_svgf.luminance(L).double()[:, None]], 1)
        self.s.index_add_(0, group, x)
        self.q.index_add_(0, group, x * x)
        self.n.index_add_(0, group, torch.ones_like(group, dtype=torch.float64))

    def mean_var(self):
        n = self.n[:, None]
        mean = self.s / n
        var = (self.q / n - mean * mean).clamp(min=0.0) * n / (n - 1).clamp(min=1.0)
        return mean, var


def _z(diff, se):
    return torch.where(se > 0, diff.abs() / se.clamp(min=1e-300),
                       torch.where(diff.abs() > 0, math.inf, 0.0))


def reference_paths(rs, basis, W, H, bounces, gen, groups_px, jitter, chunk, n_groups):
    """Trace the reference paths of (group, pixel x, pixel y) rows in chunks
    -> Estimates. `jitter` None draws the Gaussian filter's, else (jx, jy)."""
    group, px, py = groups_px
    est = Estimates(n_groups, px.device)
    for s in range(0, px.numel(), chunk):
        x, y = px[s:s + chunk].double(), py[s:s + chunk].double()
        if jitter is None:
            jx, jy = ref.gaussian_jitter(x.numel(), gen, x.device)
        else:
            jx, jy = jitter
        o, d = ref.camera_rays(basis, x + jx, y + jy, rs.dtype)
        L, _ = ref.radiance(rs, o, d, bounces, gen)
        est.add(group[s:s + chunk], L)
    return est


def block_requests(W, H, grid, per_block, gen, device):
    rows = []
    for b, (x0, x1, y0, y1) in enumerate(_blocks(W, H, *grid)):
        u = torch.rand((2, per_block), generator=gen, device=device, dtype=torch.float64)
        rows.append((torch.full((per_block,), b, dtype=torch.int64, device=device),
                     (x0 + (u[0] * (x1 - x0)).floor()).clamp(max=x1 - 1),
                     (y0 + (u[1] * (y1 - y0)).floor()).clamp(max=y1 - 1)))
    return tuple(torch.cat(c) for c in zip(*rows))


def block_z(image, est_mean, est_var, per_block, grid, samples: int) -> float:
    """Largest |z| of the image's block means (H, W, 3) against the
    reference's, over blocks and channels."""
    H, W = image.shape[:2]
    zs = []
    for b, (x0, x1, y0, y1) in enumerate(_blocks(W, H, *grid)):
        blk = image[y0:y1, x0:x1].double()
        npx = blk.shape[0] * blk.shape[1]
        prog = blk.reshape(-1, 3).mean(0)
        var = est_var[b, :3]
        se = torch.sqrt(var / per_block + var / (npx * samples))
        zs.append(_z(prog - est_mean[b, :3], se))
    return float(torch.stack(zs).max())


def check_batch(image, samples: int, bad_samples: int, rs, basis, bounces: int,
                params: dict, seed: int) -> dict:
    """The batch cells' numbers. `image` (H, W, 3) float32 after `samples`
    samples, `bad_samples` the program's NaN sample count."""
    dev = rs.device
    H, W = image.shape[:2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    grid, K = tuple(params["blocks"]), int(params["paths_per_block"])
    P, M = int(params["pixels"]), int(params["paths_per_pixel"])
    chunk = int(params["chunk"])
    req = block_requests(W, H, grid, K, gen, dev)
    est = reference_paths(rs, basis, W, H, bounces, gen, req, None, chunk, grid[0] * grid[1])
    mean, var = est.mean_var()
    numbers = {"block_z": block_z(image, mean, var, K, grid, samples)}
    pix = torch.randint(0, W * H, (P,), generator=gen, device=dev)
    group = torch.arange(P, device=dev).repeat_interleave(M)
    rows = (group, (pix % W).double().repeat_interleave(M),
            (pix // W).double().repeat_interleave(M))
    est = reference_paths(rs, basis, W, H, bounces, gen, rows, None, chunk, P)
    mean, var = est.mean_var()
    flat = image.reshape(-1, 3).double()
    lum = ref_svgf.luminance(flat[pix])
    floor = (ref_svgf.luminance(flat).mean() / 20.0).clamp(min=1e-6)
    numbers["pixel_err"] = float(((lum - mean[:, 3]).abs()
                                  / torch.maximum(mean[:, 3], floor)).median())
    numbers["nonfinite"] = int((~torch.isfinite(image)).sum()) + int(bad_samples)
    return numbers


def _f32(x):
    return x.float() if x.is_floating_point() else x


def _primary_depth(rs, basis, W, H, jitter, chunk):
    dev = rs.device
    out = torch.empty(W * H, device=dev)
    for s in range(0, W * H, chunk):
        p = torch.arange(s, min(s + chunk, W * H), device=dev)
        o, d = ref.camera_rays(basis, (p % W).double() + jitter[0], (p // W).double() + jitter[1],
                               rs.dtype)
        t, _, _, _ = ref.bvh.trace(rs.tree, o, d, torch.full((p.numel(),), float("inf"),
                                                             dtype=rs.dtype, device=dev))
        out[s:s + p.numel()] = t.float()
    return out.view(H, W)


def check_denoised(frames: list, bad_samples: int, rs, basis, vp, bounces: int,
                   settings: dict, params: dict, seed: int) -> dict:
    """The denoised cells' numbers over `frames`, the loop's records of
    two consecutive frames; `basis` is the camera frame, `vp` its
    view-projection (the camera is held still)."""
    dev = rs.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    grid, K, chunk = tuple(params["blocks"]), int(params["paths_per_block"]), int(params["chunk"])
    numbers = {"gbuffer_miss": 0.0, "block_z": 0.0, "denoise_err": 0.0,
               "nonfinite": int(bad_samples)}
    first = frames[0]
    history, taa_prev = first["history"], first["taa_prev"]
    for rec in frames:
        aovs = rec["aovs"]
        H, W = aovs["depth"].shape
        jitter = TAA_HALTON[rec["sample_index"] & 3]
        depth = _primary_depth(rs, basis, W, H, jitter, chunk)
        prog = aovs["depth"].float()
        both_inf = ~torch.isfinite(prog) & ~torch.isfinite(depth)
        close = (prog - depth).abs() <= 1e-3 * depth.abs() + 1e-4
        miss = ~(both_inf | close)
        numbers["gbuffer_miss"] = max(numbers["gbuffer_miss"], float(miss.float().mean()))
        radiance = aovs["albedo"] * (aovs["direct"] + aovs["indirect"])
        req = block_requests(W, H, grid, K, gen, dev)
        jt = (torch.tensor(jitter[0], dtype=torch.float64, device=dev),
              torch.tensor(jitter[1], dtype=torch.float64, device=dev))
        est = reference_paths(rs, basis, W, H, bounces, gen, req, jt, chunk, grid[0] * grid[1])
        mean, var = est.mean_var()
        numbers["block_z"] = max(numbers["block_z"], block_z(radiance, mean, var, K, grid, 1))
        colour, history, taa_prev = ref_svgf.denoise(
            {k: _f32(v) for k, v in aovs.items()}, ref_svgf.History(*map(_f32, history)),
            _f32(taa_prev), torch.as_tensor(vp, device=dev), rec["sample_index"] == 0, settings)
        err = (rec["colour"].float() - colour).abs() / (1.0 + colour.abs())
        numbers["denoise_err"] = max(numbers["denoise_err"], float(err.max()))
        for k, x in [("colour", rec["colour"])] + list(aovs.items()):
            if x.is_floating_point():  # depth is +inf on a miss
                bad = torch.isnan(x) if k == "depth" else ~torch.isfinite(x)
                numbers["nonfinite"] += int(bad.sum())
    return numbers


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit fails."""
    rows = [(k, numbers[k], limits.get(k)) for k in sorted(numbers)]
    ok = all(lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows

