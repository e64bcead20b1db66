#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths (batch render on merged, two-level,
small-scene binary and paged tables, SVGF + TAA denoised frames) once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is nonzero):
  1. device: `nvidia-smi` name and power limit; no CUDA -> exit 1, no result.
  2. build: compile gpu_raytracer_tpu_torch/csrc/*.cu with nvcc (timed),
     while the scenes below are built; the ptxas report (registers, spills,
     stack frame) and the occupancy API's blocks an SM of each wide, paged
     and binary traversal kernel, of the SVGF kernels (the variance
     kernel's two instances) and of the fused shade.
  scene: the procedural 1920x1080 configuration (cube room, area light,
     three subdivision-6 icospheres, 245,774 triangles, merged tables) and
     the instanced one (441 instances of one subdivision-4 icosphere, room,
     light: 443 instances, 2,257,934 triangles from 5,134, two-level
     tables) and the small one (the Cornell stand-in at 512x512, 36
     triangles, binary tables under both small-scene gates) and the streamed
     one (the room with ONE subdivision-8 icosphere instanced three times:
     3,932,174 triangles, past every wide budget, so paged tables, route
     "stream", nothing patched); tables built (timed), their sizes and the
     gates printed; for the streamed scene also the merged wide tables of
     the same world tree (~316 MB), the yardstick of phase 3st.
  3. per-kernel parity: every kernel against its plain PyTorch version on
     one full 777,600-ray wave captured from the main path (the merged roles
     and shade on the procedural scene, the two-level roles on the instanced
     scene), compared on the whole wave (and the shade, besides, on every
     BSDF over a 65,536-lane head with synthetic materials; the closest
     roles by parity.compare_closest's tie-aware bar); both timed, and the
     least time the card could take (bound) counted from the wave's
     inputs; beside each traversal role, the warp utilisation of a
     one-thread-a-ray schedule (from the plain version's per-ray visits)
     and the persistent-warp kernel's own (its instrumented launch's
     counters).
  3sv. the SVGF kernels: the guide and dyn images of the fifth 1080p denoised
     frame of the merged scene (history of 4 frames, so both sides of the
     length < 4 select occur); the variance kernel and each a-trous step
     against its plain version at full frame (rtol = atol = 2e-4), timed as
     phase 3 times kernels, with bounds; the variance kernel's run-time
     instance (sigma_n 8 and 12.5; the path's 16 runs the static one) on
     the same frame against its plain version; and the shade kernel with
     demod on a captured full wave of the denoised path.
  3sm. the small-scene kernels: binary closest hit (bounce 1), binary any
     hit (its shadow wave) and the fused shade (bounce 1; and every BSDF on
     synthetic mixed-material tables, timed too; bounce 4 of the same
     sample, most lanes dead; bounce 1 with every lane dead) against their
     plain versions on a captured full 262,144-ray wave of the 512x512
     slice, timed, with bounds;
     and K8 closest and any on hand-made tables 80 nodes deep
     (parity.deep_binary_tables), where the 48-entry stack drops pushes.
  3st. the paged-table kernels: resident and page passes, closest and any,
     against their plain versions on captured full 777,600-ray waves of the
     streamed scene (the primary wave, the bounce-1 wave and its shadow
     wave; the resident pass bit-equal, the page pass's closest hit by the
     tie-aware bar, any hit exact), timed, with bounds (the page pass's
     bytes: the distinct page rows its plain version loads) and the warp
     utilisation of a one-thread-a-ray schedule (plain visits) beside the
     walk's (its instrumented launch); the passes a wave took and the
     portals a lane enumerated; and the whole paged trace of each wave
     against the plain trace (the same bars) and against the merged wide
     kernels (K1 primary, K2 closest and any) over the merged tables of the
     same tree, both timed (K1 held there to the plain primary by the
     primary bar, u, v included). The scene line gives the page pass's stack: the
     deepest page walk plus the K - 1 portals seeded beneath it.
  3pr. the probe kernels (the Hopper counterparts of the JAX package's TPU
     probes tools/exp_gang_ablate.py, exp_gang_micro.py, exp_gather.py and
     exp_gather2.py) on the merged scene's tables and its captured full
     777,600-ray bounce-1 wave: every ablation variant of pg_ablate at 256
     fixed iterations and every stage of pg_micro at 512 (64 tiles) against
     its plain version (tri equal, t bit-equal; acc bit-equal; the plain
     ablation on the first 64 tiles but for `full`), timed; the gang
     traversal run to its end against K2 on the same wave and on the primary
     wave (equal hits, ties aside), both timed; pf_lane and pf_window in
     every mode at the probes' sizes (seeded numpy; 1 tile and 760 tiles)
     against their plain versions, exactly, timed beside one `index_select`
     of the same values; and the glue's `fetch_rows(shade_rows, hit_tri)` on
     the wave as pf_lane rows against `index_select` (the library time of
     pf_lane; int64 `index_select` and `shade_rows[idx]` timed beside). Then
     the single-block probes (tools/exp_blocksync.py, exp_scalar_read.py,
     exp_vmem2.py, exp_gang_prims*.py, exp_dma*.py) at their own sizes,
     inputs from seeded numpy, each against its plain version (bit-equal;
     copies exact) and timed: pb_pop on the own and the 1e29-scaled table;
     pr_read, every body (the roll read in place and staged in shared
     memory) beside one `index_select`; the shared-memory ceiling, which
     must equal cudaDevAttrMaxSharedMemoryPerBlockOptin with 16 bytes more
     refused; pp_gang, 11 bodies at the probes' iteration counts on the own
     and a chase table, `full` also on the own table times 1e4 (parity
     at 256 iterations); pd_copy, 20 bodies with
     cp.async and the TMA bulk copy (the whole-table ones on a 2-block
     cluster), the 16 KB-window ones also at 132 blocks. No probe is on a
     render path: their launches in the slices below are 0.
  4. the merged slice: 1920x1080, 3 bounces, NEE+MIS+RR, a warm-up sample
     and 4 timed spp through Pathtracer(device="cuda"); every kernel of the
     path must launch and no plain version may run.
  4tl. the two-level slice: the instanced scene at 1920x1080, 4 bounces,
     NEE+MIS+RR, the same way.
  4sv. the denoised slice: the merged scene at 1920x1080, 3 bounces, SVGF +
     TAA, a warm-up frame and 8 timed frames with the history carried; in
     the last 4 the camera moves sideways ~3 px a frame. ms/frame split into
     trace and SVGF + TAA; every kernel of the path (shade with demod
     included) must launch and no plain version may run.
  4sm. the small-scene slice, route (a): the Cornell stand-in at 512x512,
     6 bounces, NEE+MIS+RR (bench.py's cornell512 probe), a warm-up sample
     and 4 timed spp; the binary kernels and the fused shade must launch, no
     wide kernel, no K3 and no plain version may run.
  4sm1080. route (b): the same scene at 1920x1080 (not a multiple of 32),
     3 bounces; the binary kernels and K3 launch, the fused shade does not.
  4st. the streamed slice: 1920x1080, 3 bounces, on the paged kernels and K3
     only (no wide or binary kernel, no plain version, no magenta pixel).
  5. image parity: 256x256, 8 spp, kernels vs plain versions on the card,
     on the four scenes (5, 5tl, 5sm, 5st); 5sv: 4 denoised 256x256 frames,
     kernels vs plain.
  6. CLI: `python -m gpu_raytracer_tpu_torch` on a Mitsuba XML (a small
     scene), plain and with `--svgf on`, the two runs at once; the `[paths]`
     line must name the binary kernel, with the fused shade in the plain
     run and K3 under `--svgf on`.
Each line carries the seconds since the start. The line before the last is
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SUB = 65_536            # lanes of the synthetic mixed-material shade check
FULL_W, FULL_H = 1920, 1080
SPP = 4
BOUNCES = 3
BOUNCES_TL = 4          # the JAX package's instancing probe (bench.py)
SMALL = 512             # the JAX package's small-scene probe (bench.py:665-671)
BOUNCES_SM = 6
SPHERE_SUBDIV = 6
STREAM_SUBDIV = 8       # 1,310,720 triangles a sphere, instanced three times
SVGF_FRAMES = 8         # timed denoised frames, after one warm-up
SVGF_MOVING = 4         # of which the last ones pan the camera
PAN_PX = 3.0            # image shift per moving frame, beyond the +-2 px window

WT_SRC = "gpu_raytracer_tpu_torch/csrc/wide_traverse.cu"
SV_SRC = "gpu_raytracer_tpu_torch/csrc/svgf_stencil.cu"
BT_SRC = "gpu_raytracer_tpu_torch/csrc/binary_traverse.cu"
ST_SRC = "gpu_raytracer_tpu_torch/csrc/stream_traverse.cu"
PG_SRC = "gpu_raytracer_tpu_torch/csrc/probe_gang.cu"
PF_SRC = "gpu_raytracer_tpu_torch/csrc/probe_fetch.cu"
PB_SRC = "gpu_raytracer_tpu_torch/csrc/probe_block.cu"
PR_SRC = "gpu_raytracer_tpu_torch/csrc/probe_read.cu"
PP_SRC = "gpu_raytracer_tpu_torch/csrc/probe_prims.cu"
PD_SRC = "gpu_raytracer_tpu_torch/csrc/probe_dma.cu"
ST_RESIDENT = "gpu_raytracer_tpu/ops/pallas_stream.py:235"
ST_PAGE = "gpu_raytracer_tpu/ops/pallas_stream.py:310"
KERNELS = {  # name -> (kernel name, source, TPU kernel it replaces)
    "primary": ("wide_traverse.primary", WT_SRC, "gpu_raytracer_tpu/ops/pallas_wide.py:80"),
    "closest": ("wide_traverse.closest", WT_SRC, "gpu_raytracer_tpu/ops/pallas_gang.py:350"),
    "any": ("wide_traverse.any", WT_SRC, "gpu_raytracer_tpu/ops/pallas_gang.py:350"),
    "shade": ("shade_gather", "gpu_raytracer_tpu_torch/csrc/shade_gather.cu",
              "gpu_raytracer_tpu/ops/pallas_shade_gather.py:95"),
    "primary_tl": ("wide_traverse.primary_tl", WT_SRC,
                   "gpu_raytracer_tpu/ops/pallas_wide.py:80"),
    "closest_tl": ("wide_traverse.closest_tl", WT_SRC,
                   "gpu_raytracer_tpu/ops/pallas_gang.py:90"),
    "any_tl": ("wide_traverse.any_tl", WT_SRC, "gpu_raytracer_tpu/ops/pallas_gang.py:90"),
    "svgf_variance": ("svgf_stencil.variance", SV_SRC,
                      "gpu_raytracer_tpu/ops/pallas_svgf.py:208"),
    "svgf_atrous": ("svgf_stencil.atrous", SV_SRC,
                    "gpu_raytracer_tpu/ops/pallas_svgf.py:140"),
    "binary_closest": ("binary_traverse.closest", BT_SRC,
                       "gpu_raytracer_tpu/ops/pallas_traverse.py:89"),
    "binary_any": ("binary_traverse.any", BT_SRC,
                   "gpu_raytracer_tpu/ops/pallas_traverse.py:89"),
    "fused_shade": ("fused_shade", "gpu_raytracer_tpu_torch/csrc/fused_shade.cu",
                    "gpu_raytracer_tpu/ops/pallas_shade.py:659"),
    "resident_closest": ("stream_traverse.resident_closest", ST_SRC, ST_RESIDENT),
    "resident_any": ("stream_traverse.resident_any", ST_SRC, ST_RESIDENT),
    "page_closest": ("stream_traverse.page_closest", ST_SRC, ST_PAGE),
    "page_any": ("stream_traverse.page_any", ST_SRC, ST_PAGE),
    "pg_ablate": ("probe_gang.pg_ablate", PG_SRC, "tools/exp_gang_ablate.py:56"),
    "pg_micro": ("probe_gang.pg_micro", PG_SRC, "tools/exp_gang_micro.py:34"),
    "pf_lane": ("probe_fetch.pf_lane", PF_SRC, "tools/exp_gather.py:52"),
    "pf_window": ("probe_fetch.pf_window", PF_SRC, "tools/exp_gather.py:100"),
    "pb_pop": ("probe_block.pb_pop", PB_SRC, "tools/exp_blocksync.py:110"),
    "pr_read": ("probe_read.pr_read", PR_SRC, "tools/exp_scalar_read.py:38"),
    "pp_gang": ("probe_prims.pp_gang", PP_SRC, "tools/exp_gang_prims.py:82"),
    "pd_copy": ("probe_dma.pd_copy", PD_SRC, "tools/exp_dma.py:58"),
}
PROBE_TILES = 760       # the wave's 777,600 rays in 1024-lane tiles
# Kernels of the wide route (and K3), which the fused-shade route must not run.
WIDE_NAMES = ("primary", "closest", "any", "primary_tl", "closest_tl", "any_tl")
STREAM_NAMES = ("resident_closest", "resident_any", "page_closest", "page_any")


T_START = time.perf_counter()


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] ({time.perf_counter() - T_START:.1f} s) {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, repeats: int) -> list:
    """Device ms per call (`probes.device_ms`: CUDA events behind a device
    spin, after one warm-up call)."""
    from gpu_raytracer_tpu_torch.probes import device_ms

    return device_ms(fn, reps, repeats)


def time_pair(kernel_fn, plain_fn) -> tuple:
    """(kernel ms, plain ms, text): medians of 7 x 10 kernel calls and of 3
    single plain calls, with the spread of the repeats."""
    ks = sorted(cuda_ms(kernel_fn, 10, 7))
    ps = sorted(cuda_ms(plain_fn, 1, 3))
    text = (f"kernel {ks[len(ks) // 2]:.4f} ms (7 x 10 calls: {ks[0]:.4f}-"
            f"{ks[-1]:.4f}), plain {ps[1]:.2f} ms (3 calls: {ps[0]:.2f}-{ps[-1]:.2f})")
    return ks[len(ks) // 2], ps[1], text


def count_dicts() -> tuple:
    """(launch counts, plain-call counts) of every kernel wrapper."""
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    from gpu_raytracer_tpu_torch.probes import block, dma, fetch, gang, prims, read

    mods = (wt, sg, sv, bt, fs, st, gang, fetch, block, read, prims, dma)
    return (tuple(m.launches for m in mods), tuple(m.plain_calls for m in mods))


def counts():
    launched, plain = count_dicts()
    return ({k: v for d in launched for k, v in d.items()},
            {k: v for d in plain for k, v in d.items()})


def nbytes(*xs) -> int:
    """Bytes of the tensors in `xs` (dicts and tuples walked; None skipped)."""
    import torch

    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif torch.is_tensor(x):
            total += x.numel() * x.element_size()
    return total


def bound(num_bytes: int, ops: int) -> tuple:
    """(bound ms, "bytes" | "operations"): the larger of the bytes over the
    H100's memory rate and the operations over its fp32 rate."""
    from gpu_raytracer_tpu_torch import probes

    return probes.bound(num_bytes, ops)


def pointwise_ops(fn) -> int:
    """Elements produced by pointwise PyTorch operations while `fn` runs:
    the plain shade's and stencils' operation count."""
    from gpu_raytracer_tpu_torch.probes import pointwise_ops as count

    return count(fn)


def reset_counts() -> None:
    for group in count_dicts():
        for d in group:
            for k in d:
                d[k] = 0


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_kernels(pt, results: dict, with_shade: bool) -> None:
    """Phase 3 on the tables of `pt`: the traversal roles (named with "_tl"
    on two-level tables) and, with `with_shade`, the shade kernel."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    wave = pt.cpu_config.batch_size
    got = parity.capture_wave(pt, wave)

    def head(x, n):
        return x[:n] if torch.is_tensor(x) and x.dim() >= 1 else x

    for role, tri_match in (("primary", parity.TRI_MATCH_COHERENT),
                            ("closest", parity.TRI_MATCH_INCOHERENT),
                            ("any", None)):
        (tables, o, d, tm), _ = got[role]
        name = wt.name_of(wt.ROLES.index(role), tables)
        ka = getattr(DISPATCH, role)(tables, o, d, tm)
        pa = getattr(PLAIN, role)(tables, o, d, tm)
        torch.cuda.synchronize()
        err = (parity.compare_any(ka, pa) if role == "any"
               else parity.compare_closest(ka, pa, tri_match, role == "primary",
                                           (tables, o, d)))
        ms, plain_ms, text = time_pair(
            lambda: getattr(DISPATCH, role)(tables, o, d, tm),
            lambda: getattr(PLAIN, role)(tables, o, d, tm))
        # Work of the full wave: the last timed plain call's visits; bytes:
        # tables and rays read once, outputs written once.
        work = dict(wt.last_work)
        util = wt.warp_utilisation(wt.last_pops)
        ops = (work["nodes"] * wt.OPS_PER_NODE + work["triangles"] * wt.OPS_PER_TRIANGLE
               + work["instances"] * wt.OPS_PER_INSTANCE)
        out = getattr(DISPATCH, role)(tables, o, d, tm)
        b_ms, b_by = bound(nbytes(tables.nodes, tables.rows, o, d, tm, out), ops)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        # The persistent-warp kernel's instrumented launch (not timed).
        _, stats = wt.trace_stats(wt.ROLES.index(role), tables, o, d, tm)
        warps = (f"one-thread-a-ray warp utilisation {util:.4f} (plain visits); kernel "
                 f"warp utilisation {wt.kernel_utilisation(stats):.4f}, its counters {stats}")
        say("3", f"{KERNELS[name][0]}: parity ok on the {o.shape[0]}-ray wave (max |dt| "
                 f"{err:.3g}); {text}; {warps}; work {work}, {ops} ops; bound "
                 f"{b_ms:.4f} ms ({b_by})")
    if not with_shade:
        return

    (tables, params, lanes), kw = got["shade"]
    err = parity.compare_shade(DISPATCH.shade(tables, params, lanes, **kw),
                               PLAIN.shade(tables, params, lanes, **kw))
    # Every BSDF branch, on synthetic mixed-material tables over the wave's
    # first SUB lanes.
    sub_lanes = {k: head(v, SUB) for k, v in lanes.items()}
    mixed, M = parity.synthetic_mixed_tables(pt.device)
    gen = torch.Generator(device=pt.device).manual_seed(11)
    mixed_lanes = dict(sub_lanes)
    mixed_lanes["mat_id"] = torch.randint(-1, M, (SUB,), generator=gen,
                                          device=pt.device, dtype=torch.int32)
    mixed_lanes["alive"] = sub_lanes["alive"] | (torch.rand(SUB, generator=gen,
                                                            device=pt.device) < 0.9)
    err = max(err, parity.compare_shade(
        DISPATCH.shade(mixed, (1, 4, 3.0), mixed_lanes),
        PLAIN.shade(mixed, (1, 4, 3.0), mixed_lanes)))
    ms, plain_ms, text = time_pair(
        lambda: DISPATCH.shade(tables, params, lanes, **kw),
        lambda: PLAIN.shade(tables, params, lanes, **kw))
    ops = pointwise_ops(lambda: PLAIN.shade(tables, params, lanes, **kw))
    out = DISPATCH.shade(tables, params, lanes, **kw)
    b_ms, b_by = bound(nbytes(tables, lanes, out), ops)
    results["shade"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    say("3", f"shade_gather: parity ok on the {lanes['t'].shape[0]} bounce-1 lanes and "
             f"on all 4 BSDFs over {SUB} lanes (max abs err {err:.3g}); {text}; "
             f"{ops} pointwise ops of the plain version; bound {b_ms:.4f} ms ({b_by})")


def phase_small_kernels(pt, results: dict) -> None:
    """Phase 3sm on the small scene's full 512x512 wave (route (a)): the
    binary closest hit on bounce 1, the binary any hit on its shadow wave,
    and the fused shade on bounce 1 (and on synthetic mixed-material tables,
    every BSDF; on bounce 4; on bounce 1 with every lane dead), each against
    its plain version, timed, with bounds."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs

    got = parity.capture_wave(pt, pt.width * pt.height, route="binary_shade", every=True)
    for role in ("binary_closest", "binary_any"):
        (tables, o, d, tm), _ = got[role][1]
        kernel, plain = getattr(DISPATCH, role), getattr(PLAIN, role)
        ka, pa = kernel(tables, o, d, tm), plain(tables, o, d, tm)
        torch.cuda.synchronize()
        err = (parity.compare_any(ka, pa) if role == "binary_any"
               else parity.compare_binary(ka, pa))
        ms, plain_ms, text = time_pair(lambda: kernel(tables, o, d, tm),
                                       lambda: plain(tables, o, d, tm))
        work = dict(bt.last_work)  # the last timed plain call's visits
        ops = (work["nodes"] * bt.OPS_PER_NODE + work["triangles"] * bt.OPS_PER_TRI
               + work["instances"] * bt.OPS_PER_INST)
        b_ms, b_by = bound(nbytes(tables, o, d, tm, kernel(tables, o, d, tm)), ops)
        results[role] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        hits = int((ka.tri >= 0).sum()) if role == "binary_closest" else int(ka.sum())
        say("3sm", f"{KERNELS[role][0]}: parity ok on {o.shape[0]} rays of the "
                   f"bounce-1 {'wave' if role == 'binary_closest' else 'shadow wave'} "
                   f"({hits} {'hits' if role == 'binary_closest' else 'occluded'}, max "
                   f"|dt| {err:.3g}); {text}; work {work}, {ops} ops; bound {b_ms:.4f} ms "
                   f"({b_by})")

    # The drop rule at the stack's real depth: a chain deeper than 48.
    tables = bt.make_tables(*(torch.as_tensor(x, device=pt.device)
                              for x in parity.deep_binary_tables()))
    o, d, tm = (torch.as_tensor(x, device=pt.device) for x in parity.deep_binary_rays(65_536))
    err = parity.compare_binary(DISPATCH.binary_closest(tables, o, d, tm),
                                PLAIN.binary_closest(tables, o, d, tm))
    parity.compare_any(DISPATCH.binary_any(tables, o, d, tm), PLAIN.binary_any(tables, o, d, tm))
    depth = int((tables.nodes[:, 13] == 0).sum())
    say("3sm", f"binary_traverse closest and any: parity ok on {o.shape[0]} rays over a chain "
               f"{depth} interior nodes deep (pushes past the 48-entry stack dropped; max "
               f"|dt| {err:.3g})")

    calls = got["fused_shade"]
    if len(calls) < 5:
        raise RuntimeError(f"the small cell's sample ended after {len(calls)} bounces")
    args, kw = calls[1]
    err = parity.compare_shade(DISPATCH.fused_shade(*args, **kw),
                               PLAIN.fused_shade(*args, **kw))
    # Every BSDF: the mixed tables' materials on the scene's instances.
    mixed = parity.mixed_fused_args(args)
    err = max(err, parity.compare_shade(DISPATCH.fused_shade(*mixed, **kw),
                                        PLAIN.fused_shade(*mixed, **kw)))
    # Bounce 4 of the same sample (most lanes dead), and bounce 1 with every
    # lane dead; the lanes whose masks differ from the plain version's are
    # counted (compare_shade allows 0.1%).
    late, late_kw = calls[4]
    dead = list(args)
    dead[7] = torch.zeros_like(dead[7])
    report = []
    for name, (a, k) in (("bounce 4", (late, late_kw)), ("all dead", (tuple(dead), kw))):
        ka, pa = DISPATCH.fused_shade(*a, **k), PLAIN.fused_shade(*a, **k)
        err = max(err, parity.compare_shade(ka, pa))
        differ = ((ka["alive"] != pa["alive"]) | (ka["prev_allow_nee"] != pa["prev_allow_nee"])
                  | ((ka["shadow_tmax"] > 0) != (pa["shadow_tmax"] > 0)))
        report.append(f"{name} ({int(a[7].sum())} live, masks differ on "
                      f"{int(differ.sum())} lanes)")
    if (bool(ka["alive"].any()) or bool((ka["shadow_tmax"] != 0).any())
            or not torch.equal(ka["ray_o"], dead[4]) or not torch.equal(ka["ray_d"], dead[5])
            or bool((ka["radiance_add"] != 0).any())):
        raise AssertionError("fused_shade: the all-dead wave left a lane alive, traced a "
                             "shadow ray, added radiance or moved a ray")
    mixed_ms = sorted(cuda_ms(lambda: DISPATCH.fused_shade(*mixed, **kw), 10, 7))[3]
    ms, plain_ms, text = time_pair(lambda: DISPATCH.fused_shade(*args, **kw),
                                   lambda: PLAIN.fused_shade(*args, **kw))
    ops = pointwise_ops(lambda: PLAIN.fused_shade(*args, **kw))
    out = DISPATCH.fused_shade(*args, **kw)
    b_ms, b_by = bound(fs.moved_bytes(args, out), ops)
    results["fused_shade"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    hit, alive = args[3], args[7]
    say("3sm", f"fused_shade: parity ok on {hit.t.shape[0]} bounce-1 lanes "
               f"({int(alive.sum())} live), on all 4 BSDFs, on {' and '.join(report)} "
               f"(max abs err {err:.3g}); "
               f"{text}; the mixed-BSDF wave {mixed_ms:.4f} ms; {ops} pointwise ops of "
               f"the plain version; bound {b_ms:.4f} ms ({b_by}: "
               f"{fs.moved_bytes(args, out)} bytes)")


def phase_stream_kernels(pt, merged, results: dict) -> None:
    """Phase 3st on the streamed scene's paged tables: each pass kernel
    (resident, page; closest, any) against its plain version on three
    captured full waves (primary, bounce 1, the bounce-1 shadow wave), timed,
    with bounds; then the whole paged
    trace of each wave against the merged wide kernels on `merged`, the
    merged wide tables of the same tree. The kernels line takes the bounce-1
    waves' numbers."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    got = parity.capture_wave(pt, pt.cpu_config.batch_size, route="stream", every=True)
    waves = (("primary", False, got["stream_closest"][0][0]),
             ("bounce-1", False, got["stream_closest"][1][0]),
             ("bounce-1 shadow", True, got["stream_any"][1][0]))
    errs = {n: 0.0 for n in STREAM_NAMES}
    for label, any_hit, (tables, o, d, tm) in waves:
        mode = "any" if any_hit else "closest"
        res_k = st.resident_kernel(any_hit, tables, o, d, tm)
        errs["resident_" + mode] = max(errs["resident_" + mode], parity.compare_stream_pass(
            res_k, st.resident_plain(any_hit, tables, o, d, tm),
            ("t", "tri", "pid", "pt", "ovf")))
        # The page pass after pass 0's fold (a first pass finds best = t_max):
        # any hit exact, closest hit by the tie-aware bar.
        t1, tri1, pid, pt_, ovf = res_k
        page_in = (pid, pt_, torch.where(tri1 >= 0, t1, tm), tri1)
        page_k = st.page_kernel(any_hit, tables, o, d, tm, *page_in)
        page_p = st.page_plain(any_hit, tables, o, d, tm, *page_in)
        errs["page_" + mode] = max(errs["page_" + mode], (
            parity.compare_stream_pass(page_k, page_p, ("t", "tri")) if any_hit
            else parity.compare_stream_closest(page_k, page_p, (tables, o, d))))
        page_ties = int((page_k[1] != page_p[1]).sum())
        torch.cuda.synchronize()
        live = tm > 0
        portals = ((pid >= 0).sum(dim=1) + ovf)[live].float()
        named = torch.unique(tables.portal_page[pid[pid >= 0].long()])
        for kind, kernel, plain, args in (
                ("resident", st.resident_kernel, st.resident_plain, (o, d, tm)),
                ("page", st.page_kernel, st.page_plain, (o, d, tm, *page_in))):
            name = f"{kind}_{mode}"
            ms, plain_ms, text = time_pair(lambda: kernel(any_hit, tables, *args),
                                           lambda: plain(any_hit, tables, *args))
            work = dict(st.last_work[name])  # the last timed plain call's visits
            ops = work["nodes"] * wt.OPS_PER_NODE + work["triangles"] * wt.OPS_PER_TRIANGLE
            out = kernel(any_hit, tables, *args)
            # Bytes: the distinct table rows the plain version loads, read
            # once. The resident pass reads every ray and writes whole lists;
            # the page pass reads the walked portals' page and root, the list
            # entries up to each lane's first empty slot, the rays of the
            # lanes with a pending portal, and the running best in and out.
            if kind == "resident":
                need = work["rows"] * 512 + nbytes(args, out)
            else:
                need = (work["rows"] * 512 + 8 * work["portals"] + 4 * work["entries"]
                        + 28 * work["lanes"] + nbytes(page_in[2:], out))
            b_ms, b_by = bound(need, ops)
            if label.startswith("bounce-1"):
                results[name] = {"max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            # Warp utilisation: a one-thread-a-ray schedule's (the plain
            # version's per-ray visits), the walk's (its instrumented launch).
            util_old = wt.warp_utilisation(st.last_pops[name])
            _, stats = st.pass_stats(kind, any_hit, tables, *args)
            ties = f"; ids differ at {page_ties} exact ties" if kind == "page" and not any_hit \
                else ""
            say("3st", f"{KERNELS[name][0]} on the {label} wave: parity ok on "
                       f"{o.shape[0]} rays{ties}; {text}; work {work}, {ops} ops; {need} bytes; "
                       f"bound {b_ms:.4f} ms ({b_by}); warp utilisation one thread a ray "
                       f"{util_old:.4f}, walk {wt.kernel_utilisation(stats):.4f}, its "
                       f"counters {stats}")
        # The whole paged trace against the merged wide kernels (K1 on the
        # primary wave, K2 on the others) over the same tree's merged tables.
        role = "any" if any_hit else ("primary" if label == "primary" else "closest")
        fn6 = DISPATCH.stream_any if any_hit else DISPATCH.stream_closest
        out6 = fn6(tables, o, d, tm)
        passes = st.last_trace["passes"]
        out12 = getattr(DISPATCH, role)(merged, o, d, tm)
        if role == "primary":  # K1 on this tree by the primary bar (u, v too)
            parity.compare_closest(out12, PLAIN.primary(merged, o, d, tm),
                                   parity.TRI_MATCH_COHERENT, True, (merged, o, d))
        # The whole paged trace against the plain one (closest hit by the
        # tie-aware bar, any hit exact), then against the merged kernels.
        if any_hit:
            parity.compare_any(out6, PLAIN.stream_any(tables, o, d, tm))
        else:
            (hit_p, residual_p) = PLAIN.stream_closest(tables, o, d, tm)
            if not torch.equal(out6[1], residual_p):
                raise AssertionError("residual lanes differ from the plain trace's")
            parity.compare_stream_closest(out6[0], hit_p, (tables, o, d))
        if any_hit:
            parity.compare_any(out6, out12)
            match = 1.0
        else:
            (hit6, residual), hit12 = out6, out12
            if bool(residual.any()):
                raise AssertionError(f"{int(residual.sum())} truncated lanes")
            if not torch.equal(hit6.tri >= 0, hit12.tri >= 0):
                raise AssertionError(f"hit masks differ from {role} on "
                                     f"{int(((hit6.tri >= 0) != (hit12.tri >= 0)).sum())} rays")
            both = hit6.tri >= 0
            match = (hit6.tri == hit12.tri)[both].float().mean().item()
            if match <= parity.TRI_MATCH_COHERENT:
                raise AssertionError(f"tri match with {role} {match}")
        ms6 = sorted(cuda_ms(lambda: fn6(tables, o, d, tm), 3, 3))[1]
        ms12 = sorted(cuda_ms(lambda: getattr(DISPATCH, role)(merged, o, d, tm), 10, 7))[3]
        say("3st", f"{label} wave ({int(live.sum())} live rays): {passes} passes; portals "
                   f"a lane enumerated: max {int(portals.max())}, mean "
                   f"{float(portals.mean()):.2f}; {named.numel()} of "
                   f"{tables.pages.shape[0]} pages named; paged trace {ms6:.4f} ms "
                   f"(resident + page launches and the host's pass loop) vs merged "
                   f"{KERNELS[role][0]} {ms12:.4f} ms on {nbytes(merged.nodes, merged.rows)} "
                   f"bytes of merged tables; hit masks equal, tri equal on {match:.5f}")
    for name, err in errs.items():
        results[name]["max_abs_err"] = err


def _probe_text(row: dict) -> str:
    return ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in row.items() if k not in ("probe", "device"))


def phase_probes(pt, results: dict) -> None:
    """Phase 3pr on the merged scene's tables and its bounce-1 wave: the gang
    probes (ablation variants, the run to the end against K2, the micro
    stages) and the fetch probes (every case at 1 and PROBE_TILES tiles, the
    glue's row gather), each kernel against its plain version, timed, with
    bounds. The kernels line takes `full` (pg_ablate), `push` (pg_micro), the
    glue's row gather (pf_lane, with `index_select` as its library call) and
    exp_gather.py B f32 at 512 rows on PROBE_TILES tiles (pf_window)."""
    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH
    from gpu_raytracer_tpu_torch.probes import fetch, gang

    def timer(fn):
        return cuda_ms(fn, 10, 7)

    got = probes.bounce1(pt)
    gt, wave = got["gt"], got["wave"]
    rows = gang.ablation(gt, wave, gang.K_ITERS, timer=timer)
    for r in rows:
        say("3pr", f"pg_ablate<{r['variant']}>: parity ok (tri, t bit-equal on "
                   f"{r['parity_tiles']} tiles); {_probe_text(r)}")
    full = rows[0]
    b_ms, b_by = bound(full["bytes"], full["ops"])
    results["pg_ablate"] = {"max_abs_err": 0.0, "ms": full["ms"], "plain_ms": full["plain_ms"],
                            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    say("3pr", f"pg_ablate<full> bound {b_ms:.4f} ms ({b_by}): {full['bytes']} bytes, "
               f"{full['ops']} ops")
    for label, rays in (("bounce-1", wave), ("primary", got["primary"])):
        k2 = gang.converged_vs_closest(gt, got["tables"], rays, DISPATCH.closest, timer=timer)
        say("3pr", f"gang traversal to the end vs K2 (wide_traverse.closest) on the {label} "
                   f"wave: hits equal; {_probe_text(k2)}")

    table, rays = gang.micro_inputs(gt, wave)
    for r in gang.micro_stages(table, rays, gang.N_ITERS, timer=timer):
        say("3pr", f"pg_micro<{r['variant']}>: parity ok (acc bit-equal); {_probe_text(r)}")
    m_ms, m_by = bound(*gang.micro_bytes_ops("push", table, rays.shape[0], gang.N_ITERS))
    results["pg_micro"] = {"max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
                           "bound_ms": m_ms, "bound_by": m_by, "library_ms": None}

    for tiles in (1, PROBE_TILES):
        for r in fetch.probe_fetches("cuda", fetch.ITERS, tiles, timer=timer):
            r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"])
            say("3pr", f"{r['kernel']}<{r['mode']}> {r['probe']}, {r['indices']} indices, "
                       f"{tiles} tile(s): parity ok (exact); {_probe_text(r)}")
            if (tiles == PROBE_TILES and r["probe"] == "exp_gather.py:100 B f32"
                    and r["indices"] == "coherent"):
                results["pf_window"] = {"max_abs_err": 0.0, "ms": r["ms"],
                                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                                        "bound_by": r["bound_by"], "library_ms": None}
    g = fetch.glue_fetch(got["shade_rows"], got["hit_tri"], timer=timer)
    g["bound_ms"], g["bound_by"] = bound(g["bytes"], g["ops"])
    results["pf_lane"] = {"max_abs_err": 0.0, "ms": g["ms"], "plain_ms": g["plain_ms"],
                          "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                          "library_ms": g["library_ms"]}
    say("3pr", f"pf_lane<rows> {g['probe']} on the bounce-1 wave: equal to index_select; "
               f"{_probe_text(g)}")
    phase_probes_small(results)


def _kernel_row(r: dict, library_ms=None) -> dict:
    b_ms, b_by = bound(r["bytes"], r["ops"])
    r["bound_ms"], r["bound_by"] = b_ms, b_by
    return {"max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def phase_probes_small(results: dict) -> None:
    """Phase 3pr, the single-block probes (the Hopper counterparts of
    tools/exp_blocksync.py, exp_scalar_read.py, exp_vmem2.py,
    exp_gang_prims.py, exp_gang_prims2.py and exp_dma*.py) at the probes'
    own sizes, inputs from seeded numpy, each launch against its plain
    version (bit-equal; copies exact) and timed: the pop loop on the own and
    the scaled table; every scalar-read body (the roll in both spaces) beside
    one `index_select` of its values; the shared-memory ceiling against the
    device attribute; every gang-primitive body at the probes' iteration
    counts on the own and the chase tables, `full` on the table times 1e4
    (parity at 256 iterations); every
    copy body with both mechanisms at one block, and the 16 KB-window bodies
    at one block an SM. The kernels line takes the pop loop on the own
    table, read body A, `stack` on the chase table and exp_dma.py k_smem
    with the bulk copy at one block."""
    import torch

    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.probes import block, dma, prims, read

    def timer(fn):
        return cuda_ms(fn, 10, 7)

    for r in block.probe_pops("cuda", timer=timer):
        row = _kernel_row(r)
        say("3pr", f"pb_pop on the {r['table']} table: parity ok (bit-equal); {_probe_text(r)}")
        if r["table"] == "own":
            results["pb_pop"] = row
    for r in read.probe_reads("cuda", timer=timer):
        row = _kernel_row(r, r["library_ms"])
        say("3pr", f"pr_read<{r['body']}, {r['space']}> {r['probe']}: parity ok (bit-equal); "
                   f"{_probe_text(r)}")
        if r["body"] == "A":
            results["pr_read"] = row
    ceiling = read.smem_ceiling(torch.rand(read.SHAPE, device="cuda"), timer=timer)
    if not (ceiling["ceiling_bytes"] == ceiling["attribute_bytes"]
            and ceiling["above_error"] == read.REFUSED):
        raise AssertionError(f"shared-memory ceiling {ceiling}")
    say("3pr", f"pr_read<ceiling>: the largest dynamic shared memory a launch gets is "
               f"{ceiling['ceiling_bytes']} bytes = cudaDevAttrMaxSharedMemoryPerBlockOptin "
               f"{ceiling['attribute_bytes']}; {ceiling['ceiling_bytes'] + 16} bytes refused "
               f"(cudaError_t {ceiling['above_error']}); {len(ceiling['ladder'])} launches; "
               f"the launch at the ceiling {ceiling['ms']:.6f} ms, the plain fill "
               f"{ceiling['plain_ms']:.6f} ms; bound {bound(ceiling['bytes'], 0)[0]:.3g} ms")
    for r in prims.probe_prims("cuda", timer=probes.probe_ms):
        row = _kernel_row(r)
        say("3pr", f"pp_gang<{r['body']}> {r['probe']} on the {r['table']} table: parity ok "
                   f"(bit-equal at {r.get('parity_iters')} iterations); {_probe_text(r)}")
        if r["body"] == "stack" and r["table"] == "chase":
            results["pp_gang"] = row
    rows = dma.probe_copies("cuda", timer=timer)
    rows += dma.probe_copies("cuda", blocks=132, timer=timer, bodies=dma.WINDOW_BODIES)
    for r in rows:
        row = _kernel_row(r)
        say("3pr", f"pd_copy<{r['body']}, {r['mech']}> {r['probe']}, {r['blocks']} block(s): "
                   f"parity ok (exact); {_probe_text(r)}")
        if (r["body"], r["mech"], r["blocks"]) == ("dma.smem", "bulk", 1):
            results["pd_copy"] = row


def phase_slice(pt, phase: str, names: tuple, forbid: tuple = ()) -> dict:
    """Phases 4, 4tl, 4sm, 4sm1080 and 4st: one warm-up sample, then SPP timed
    samples, with every count set to 0 just before and read just after.
    Every kernel in `names` must launch, none in `forbid`, no plain version
    may run, and the frame must be finite, free of NaN samples and not
    black. Returns the launch counts."""
    import numpy as np
    import torch

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.render()
    torch.cuda.synchronize()
    first_ms = 1000.0 * (time.perf_counter() - t0)
    pt.reset_accumulation()
    per_sample = []
    for _ in range(SPP):
        t0 = time.perf_counter()
        pt.render()
        torch.cuda.synchronize()
        per_sample.append(1000.0 * (time.perf_counter() - t0))
    launched, plain = counts()
    for name in names:
        if launched[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the {phase} run")
    ran = {n: launched[n] for n in forbid if launched[n]}
    if ran:
        raise AssertionError(f"kernels off the {phase} route launched: {ran}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran in the {phase} run: {plain}")
    frame = pt.framebuffer()
    if not np.isfinite(frame).all():
        raise AssertionError(f"non-finite pixels in the {phase} frame")
    if pt.magenta_pixels:
        raise AssertionError(f"{pt.magenta_pixels} magenta (NaN) pixel samples")
    mean = float(frame.mean())
    if not mean > 0:
        raise AssertionError(f"frame mean {mean} is not > 0")
    dt = sum(per_sample) / 1000.0
    per = {n: launched[n] / (SPP + 1) for n in names}
    say(phase, f"{pt.width}x{pt.height} b{pt.gpu_config.num_bounces}: warm-up sample "
               f"{first_ms:.1f} ms; {SPP} spp: {1000.0 * dt / SPP:.1f} ms/sample (each: "
               f"{', '.join(f'{x:.1f}' for x in per_sample)}), {pt.rays_traced} rays, "
               f"{pt.rays_traced / dt / 1e6:.2f} Mrays/s, mean {mean:.4f}; "
               f"launches {launched} ({per} per sample); route {pt.route()}; "
               f"paths {pt.paths}")
    return launched


def phase_image(scene, pt, phase: str, route: str = "wide") -> None:
    """Phase 5: 256x256, 8 spp, kernels vs plain versions on the card, both
    on `route`."""
    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN, Pathtracer

    scene.film_width = scene.film_height = 256
    scene.camera.resize(256, 256)
    imgs, rays = [], []
    for kernels in (None, PLAIN):
        p = Pathtracer(scene, pt.cpu_config, pt.gpu_config, device=pt.device,
                       **({} if kernels is None else {"kernels": kernels}))
        p.buffers = pt.buffers
        p.reset_accumulation()
        if p.route() != route:
            raise AssertionError(f"{phase}: route {p.route()}, want {route}")
        imgs.append(p.render_samples(8))
        rays.append(p.rays_traced)
    rel_rmse = parity.compare_images(*imgs, *rays)
    say(phase, f"256x256 8 spp kernels vs plain on the {route} route: rel-RMSE "
               f"{rel_rmse:.3g}, rays {rays[0]} vs {rays[1]}")


def denoised_pathtracer(scene, pt):
    """A Pathtracer of the denoised path (SVGF + TAA, the GPUConfig
    defaults) on the tables of `pt`, with a history of its own."""
    import dataclasses

    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer

    p = Pathtracer(scene, pt.cpu_config,
                   dataclasses.replace(pt.gpu_config, enable_svgf=True,
                                       enable_taa=True),
                   device=pt.device)
    p.buffers = pt.buffers
    p.reset_accumulation()
    return p


def phase_svgf_kernels(scene, pt, results: dict) -> None:
    """Phase 3sv: both SVGF kernels against their plain versions on the
    inputs of the fifth 1080p denoised frame, timed, with bounds; the shade
    kernel with demod on a captured wave of the denoised path."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv

    pts = denoised_pathtracer(scene, pt)
    got = parity.capture_svgf(pts, 5)
    short = float((got["length"] < 4).float().mean())
    if not 0.0 < short < 1.0:
        raise AssertionError(f"share of pixels with history < 4 is {short}: "
                             f"one side of the select is missing")
    for role in ("svgf_variance", "svgf_atrous"):
        rows = []
        for args, kw in got[role]:
            kernel = getattr(DISPATCH, role)
            plain = getattr(PLAIN, role)
            out = kernel(*args, **kw)
            err = parity.compare_stencil(out, plain(*args, **kw))
            ms, plain_ms, text = time_pair(lambda: kernel(*args, **kw),
                                           lambda: plain(*args, **kw))
            ops = pointwise_ops(lambda: plain(*args, **kw))
            guide, dyn = args[0], args[1]
            b_ms, b_by = bound(nbytes(guide, dyn, out), ops)
            rows.append((err, ms, plain_ms, b_ms, b_by))
            step = f" step {args[2]}" if role == "svgf_atrous" else ""
            say("3sv", f"{KERNELS[role][0]}{step}: parity ok on {tuple(dyn.shape)} "
                       f"(max abs err {err:.3g}); {text}; {ops} pointwise ops of the "
                       f"plain version; bound {b_ms:.4f} ms ({b_by})")
        n = len(rows)  # a-trous: means over the steps (same bytes and ops)
        results[role] = {"max_abs_err": max(r[0] for r in rows),
                         "ms": sum(r[1] for r in rows) / n,
                         "plain_ms": sum(r[2] for r in rows) / n,
                         "bound_ms": sum(r[3] for r in rows) / n,
                         "bound_by": rows[0][4], "library_ms": None}
    say("3sv", f"history length < 4 on {short:.3f} of the pixels; svgf_atrous "
               f"numbers are means over its {len(got['svgf_atrous'])} steps")
    # The variance kernel's run-time instance (the path runs the static one).
    (guide, dyn, sigma_z, _, sigma_l), _ = got["svgf_variance"][0]
    before = dict(sv.variance_instances)
    for sigma_n in (8.0, 12.5):
        args = (guide, dyn, sigma_z, sigma_n, sigma_l)
        err = parity.compare_stencil(sv.svgf_variance(*args), sv.variance_plain(*args))
        say("3sv", f"svgf_stencil.variance sigma_n {sigma_n}: parity ok on "
                   f"{tuple(dyn.shape)} (max abs err {err:.3g})")
    if sv.variance_instances["runtime"] != before["runtime"] + 2:
        raise AssertionError(f"the run-time variance instance did not run: "
                             f"{sv.variance_instances} (before {before})")

    (tables, params, lanes), kw = parity.capture_wave(pts, pts.cpu_config.batch_size,
                                                      with_aovs=True)["shade"]
    if not kw.get("demod") or "rr_albedo" not in lanes:
        raise AssertionError("the denoised wave did not shade with demod")
    err = parity.compare_shade(DISPATCH.shade(tables, params, lanes, **kw),
                               PLAIN.shade(tables, params, lanes, **kw))
    say("3sv", f"shade_gather demod=True: parity ok on the {lanes['t'].shape[0]} "
               f"bounce-1 lanes of the denoised path (max abs err {err:.3g})")


def phase_denoised(scene, pt, phase: str) -> dict:
    """Phase 4sv: the denoised slice at full size. A warm-up frame, then
    SVGF_FRAMES timed frames with the history carried, the last SVGF_MOVING
    of them after a sideways camera step of ~PAN_PX pixels; every count set
    to 0 just before and read just after. Returns the launch counts."""
    import math

    import numpy as np
    import torch

    pts = denoised_pathtracer(scene, pt)
    cam = scene.camera
    saved = (cam.position.copy(), cam.rotation.copy())
    names = ("primary", "closest", "any", "shade", "shade_demod", "svgf_variance",
             "svgf_atrous")
    events = {"trace": [], "denoise": []}

    def timed(fn, key):
        def wrapped(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            events[key].append((start, stop))
            return out
        return wrapped

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts.render_frame_denoised()
    torch.cuda.synchronize()
    first_ms = 1000.0 * (time.perf_counter() - t0)
    depth = pts.svgf_history.depth
    z = float(depth[depth < 1e29].median())
    focal_px = 0.5 * pts.width / math.tan(0.5 * cam.fov)
    step = PAN_PX * z / focal_px
    lengths = [float(pts.svgf_history.length.mean())]
    pts.trace_aovs = timed(pts.trace_aovs, "trace")
    pts.denoise = timed(pts.denoise, "denoise")
    frame_ms = []
    try:
        for f in range(SVGF_FRAMES):
            if f >= SVGF_FRAMES - SVGF_MOVING:
                cam.position = cam.position + step * cam.x_axis_rotated.astype(np.float32)
                cam.update(0.0)
            t0 = time.perf_counter()
            colour = pts.render_frame_denoised()
            torch.cuda.synchronize()
            frame_ms.append(1000.0 * (time.perf_counter() - t0))
            lengths.append(float(pts.svgf_history.length.mean()))
            if not bool(torch.isfinite(colour).all()):
                raise AssertionError(f"non-finite pixels in denoised frame {f}")
    finally:
        cam.position, cam.rotation = saved
        cam.update(0.0)
    launched, plain = counts()
    for name in names:
        if launched[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the {phase} run")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran in the {phase} run: {plain}")
    frames = SVGF_FRAMES + 1
    iters = pts.gpu_config.svgf_atrous_iterations
    if (launched["svgf_variance"], launched["svgf_atrous"]) != (frames, iters * frames):
        raise AssertionError(f"SVGF launches {launched['svgf_variance']} / "
                             f"{launched['svgf_atrous']} for {frames} frames")
    if pts.magenta_pixels:
        raise AssertionError(f"{pts.magenta_pixels} magenta (NaN) pixel samples")
    static = lengths[:SVGF_FRAMES - SVGF_MOVING + 1]
    if not all(b > a for a, b in zip(static, static[1:])):
        raise AssertionError(f"mean history length does not rise over the static "
                             f"frames: {static}")
    if not lengths[-1] > 1.5:
        raise AssertionError(f"the pan reset the history: mean length {lengths[-1]}")
    image = pts.framebuffer()
    mean = float(image.mean())
    if not (np.isfinite(image).all() and mean > 0):
        raise AssertionError(f"denoised frame mean {mean} is not finite and > 0")
    trace = [a.elapsed_time(b) for a, b in events["trace"]]
    den = [a.elapsed_time(b) for a, b in events["denoise"]]
    per = {n: launched[n] / frames for n in names}
    say(phase, f"{pts.width}x{pts.height} b{pts.gpu_config.num_bounces} SVGF + TAA "
               f"({iters} a-trous iterations): warm-up frame {first_ms:.1f} ms; "
               f"{SVGF_FRAMES} frames: {sum(frame_ms) / SVGF_FRAMES:.1f} ms/frame (each: "
               f"{', '.join(f'{x:.1f}' for x in frame_ms)}); device ms per frame: trace "
               f"{sum(trace) / len(trace):.2f}, SVGF + TAA {sum(den) / len(den):.2f} "
               f"(trace {', '.join(f'{x:.1f}' for x in trace)}; SVGF + TAA "
               f"{', '.join(f'{x:.2f}' for x in den)}); camera step {step:.5f} per "
               f"moving frame (median depth {z:.3f}); mean history length "
               f"{', '.join(f'{x:.3f}' for x in lengths)}; {pts.rays_traced} rays; "
               f"frame mean {mean:.4f}; launches {launched} ({per} per frame); "
               f"paths {pts.paths}")
    return launched


def phase_denoised_image(scene, pt, phase: str) -> None:
    """Phase 5sv: 256x256, 4 denoised frames, kernels vs plain versions."""
    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN

    scene.film_width = scene.film_height = 256
    scene.camera.resize(256, 256)
    runs = []
    for kernels in (None, PLAIN):
        p = denoised_pathtracer(scene, pt)
        if kernels is not None:
            p.kernels = kernels
        runs.append(([p.render_frame_denoised().cpu().numpy() for _ in range(4)],
                     p.rays_traced))
    (fa, ra), (fb, rb) = runs
    errs = [parity.compare_images(a, b, ra, rb) for a, b in zip(fa, fb)]
    say(phase, f"256x256 4 denoised frames kernels vs plain: rel-RMSE "
               f"{', '.join(f'{e:.3g}' for e in errs)}; rays {ra} vs {rb}")


def build_stream_scene(gpu):
    """Phase "scene" for the streamed scene: (scene, Pathtracer on its paged
    tables, the merged wide tables of the same world tree on the card). The
    route must be "stream" with no constant patched. Prints the build times,
    the paged tables and the routing gates' numbers."""
    import torch

    from gpu_raytracer_tpu_torch.bvh import wide as wide_mod
    from gpu_raytracer_tpu_torch.ops import buffers as tb
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    spent = {"build_blas_cached": 0.0, "pack_wide_stream": 0.0}

    def timed(fn):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[fn.__name__] += time.perf_counter() - t0
        return wrapped

    saved = tb.build_blas_cached, tb.stream_mod.pack_wide_stream
    tb.build_blas_cached = timed(saved[0])
    tb.stream_mod.pack_wide_stream = timed(saved[1])
    try:
        scene, pt, t_geo, t_tab = build_pathtracer(
            lambda: procedural_scene(FULL_W, FULL_H, STREAM_SUBDIV, shared_sphere=True), gpu)
    finally:
        tb.build_blas_cached, tb.stream_mod.pack_wide_stream = saved
    stream = pt.buffers["stream"]
    if pt.route() != "stream" or pt.buffers["wide"] is not None or stream is None:
        raise AssertionError(f"the streamed scene takes the {pt.route()} route")
    # The yardstick: the merged wide tables of the same world tree, packed
    # with the budget lifted (the tree comes from the disk cache).
    t0 = time.perf_counter()
    budget = tb.VMEM_LIMIT
    tb.VMEM_LIMIT = 1 << 40
    try:
        host = tb.pack_scene(scene)
    finally:
        tb.VMEM_LIMIT = budget
    nodes, rows = host["wide"]
    dev = torch.device("cuda")
    merged = wt.make_tables(torch.as_tensor(nodes, device=dev),
                            torch.as_tensor(rows, device=dev), tb._max_stack_of(nodes, rows))
    t_merged = time.perf_counter() - t0
    merged_bytes = (nodes.shape[0] + rows.shape[0]) * 512
    # The page pass's stack: its deepest page walk with the up to K - 1
    # portals seeded beneath it (stream_traverse.make_stream_tables).
    page_stack = tb.stream_page_stack({k: getattr(stream, k).cpu().numpy() for k in (
        "pages", "portal_page", "portal_root")})
    shared = wide_mod.estimate_table_bytes(
        sum(md.bvh.num_nodes for md in scene.mesh_datas),
        host["tris"]["shade_rows"].shape[0], len(scene.instances))
    say("scene", f"stream: {scene.triangle_count()} triangles ({scene.unique_triangle_count()} "
                 f"unique), {len(scene.instances)} instances; tessellation {t_geo:.2f} s; "
                 f"tables {t_tab:.2f} s, of which BVH builds {spent['build_blas_cached']:.2f} s "
                 f"and the page packing {spent['pack_wide_stream']:.2f} s; paged tables: "
                 f"resident {stream.resident.shape[0]} rows, {stream.pages.shape[0]} pages x "
                 f"{stream.page_rows * 512} bytes, {stream.portal_page.shape[0]} portals, "
                 f"stack bound {stream.max_stack}, page walk {page_stack} + "
                 f"{st.K_PORTALS - 1} seeded portals = {page_stack + st.K_PORTALS - 1} of the "
                 f"kernel's {wt.STACK_CAPACITY}; gates: merged tables {merged_bytes} bytes "
                 f"> {tb.VMEM_LIMIT - tb.VMEM_MARGIN} (VMEM_LIMIT - margin), two-level "
                 f"estimate {shared} > {2 * tb.VMEM_LIMIT}; route {pt.route()}; the merged "
                 f"yardstick ({nodes.shape[0]} nodes + {rows.shape[0]} leaf rows, stack "
                 f"{merged.max_stack}) packed in {t_merged:.2f} s")
    return scene, pt, merged


def build_pathtracer(make_scene, gpu):
    """(scene, Pathtracer with its tables built, tessellation s, tables s)."""
    import torch

    from gpu_raytracer_tpu_torch import CPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer

    t0 = time.perf_counter()
    scene = make_scene()
    t_geo = time.perf_counter() - t0
    pt = Pathtracer(scene, CPUConfig(), gpu, device="cuda")
    t0 = time.perf_counter()
    pt.init_device()
    torch.cuda.synchronize()
    return scene, pt, t_geo, time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from gpu_raytracer_tpu_torch import GPUConfig, bvh_builder, read_exr
    from gpu_raytracer_tpu_torch.ops import _native
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
    from gpu_raytracer_tpu_torch.scenes import (
        cornell_scene,
        instanced_scene,
        procedural_scene,
        write_mitsuba_scene,
    )

    # ---- 1. device ----
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say("1", f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2. build (nvcc processes), while the scenes are built ----
    pool = ThreadPoolExecutor(1)
    building = pool.submit(_native.build, force=True, ptxas_verbose=True)

    # ---- scenes + tables ----
    scenes = {}
    for key, make, bounces in (
            ("merged", lambda: procedural_scene(FULL_W, FULL_H, SPHERE_SUBDIV), BOUNCES),
            ("two_level", lambda: instanced_scene(FULL_W, FULL_H), BOUNCES_TL)):
        scene, pt, t_geo, t_tab = build_pathtracer(make, GPUConfig(num_bounces=bounces))
        wide = pt.buffers["wide"]
        if wide.two_level != (key == "two_level"):
            raise AssertionError(f"{key} scene packed with two_level={wide.two_level}")
        table_bytes = nbytes(wide.nodes, wide.rows)
        say("scene", f"{key}: {scene.triangle_count()} triangles ({scene.unique_triangle_count()} "
                     f"unique), {len(scene.instances)} instances; tessellation {t_geo:.2f} s; "
                     f"BVH build + tables {t_tab:.2f} s ({bvh_builder()} builder); wide "
                     f"tables {wide.nodes.shape[0]} nodes + {wide.rows.shape[0]} leaf rows = "
                     f"{table_bytes} bytes, max stack {wide.max_stack}")
        scenes[key] = (scene, pt)
    scene, pt, t_geo, t_tab = build_pathtracer(lambda: cornell_scene(SMALL, SMALL),
                                               GPUConfig(num_bounces=BOUNCES_SM))
    binary, fused = pt.buffers["binary"], pt.buffers["fused_shade"]
    if binary is None or fused is None or pt.route() != "binary_shade":
        raise AssertionError(f"the small scene takes the {pt.route()} route")
    n, i, t = (x.shape[0] for x in binary)
    light_n = fused[6].shape[1]
    say("scene", f"small: {scene.triangle_count()} triangles, {len(scene.instances)} "
                 f"instances, {light_n} light triangles; tables {t_tab:.2f} s; binary "
                 f"tables {n} nodes + {i} instances + {t} triangles = {nbytes(*binary)} "
                 f"bytes (gate 64 (N+T+I) = {64 * (n + t + i)} <= {bt.MAX_TABLE_BYTES}: "
                 f"{bt.supports(n, t, i)}); fused shade tables {nbytes(*fused)} bytes "
                 f"(gate 64 (2T+2I+L+16) = {64 * (2 * t + 2 * i + light_n + 16)} <= "
                 f"{fs.MAX_SHADE_TABLE_BYTES}: {fs.supports_shade(pt.buffers['mat_types'], t, i, light_n, False, False, (1, 1))}); "
                 f"route {pt.route()}")
    scenes["small"] = (scene, pt)
    scene, pt, merged_yardstick = build_stream_scene(GPUConfig(num_bounces=BOUNCES))
    scenes["stream"] = (scene, pt)
    info = building.result()
    pool.shutdown()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    say("2", f"built {_native.library_path()} from {len(_native.SOURCES)} "
             f"sources in {info['seconds']:.2f} s")
    for ln in regs:
        say("2", f"ptxas: {ln}")
    for prefix in ("wt_", "bt_", "sv_", "fs_"):
        for name, lines in _native.ptxas_report(info["log"], prefix).items():
            say("2", f"ptxas {name}: {'; '.join(lines)}")
    infos = [(role + ("_tl" if two_level else ""), wt.kernel_info(mode, two_level))
             for two_level in (False, True) for mode, role in enumerate(wt.ROLES)]
    infos += [(f"{kind}_{mode}", st.kernel_info(kind, mode == "any"))
              for kind in ("resident", "page") for mode in ("closest", "any")]
    infos = [(KERNELS[name][0], k) for name, k in infos]
    infos += [(KERNELS[role][0], bt.kernel_info(role == "binary_any")) for role in bt.ROLES]
    infos += [(KERNELS.get(name, ("svgf_stencil.variance_runtime",))[0], sv.kernel_info(name))
              for name in sv.INFO_KERNELS]
    infos += [(KERNELS["fused_shade"][0], fs.kernel_info())]
    for name, k in infos:
        say("2", f"{name}: {k['registers']} registers, {k['local_bytes']} bytes "
                 f"stack frame, {k['shared_bytes']} bytes shared a block of {k['threads']}; "
                 f"occupancy API: {k['blocks_per_sm']} blocks = "
                 f"{k['blocks_per_sm'] * k['threads'] // 32} warps an SM, {k['sms']} SMs")

    # ---- 3. per-kernel parity ----
    results: dict = {}
    phase_kernels(scenes["merged"][1], results, with_shade=True)
    phase_kernels(scenes["two_level"][1], results, with_shade=False)
    phase_svgf_kernels(*scenes["merged"], results)
    phase_small_kernels(scenes["small"][1], results)
    phase_stream_kernels(scenes["stream"][1], merged_yardstick, results)
    del merged_yardstick
    phase_probes(scenes["merged"][1], results)

    # ---- 4. the slices at full size ----
    launched = phase_slice(scenes["merged"][1], "4", ("primary", "closest", "any", "shade"))
    launched_tl = phase_slice(scenes["two_level"][1], "4tl",
                              ("primary_tl", "closest_tl", "any_tl", "shade"))
    launched_sv = phase_denoised(*scenes["merged"], "4sv")
    launched_sm = phase_slice(scenes["small"][1], "4sm",
                              ("binary_closest", "binary_any", "fused_shade"),
                              forbid=WIDE_NAMES + ("shade",))
    scene_1080 = cornell_scene(FULL_W, FULL_H)
    pt_1080 = Pathtracer(scene_1080, scenes["small"][1].cpu_config,
                         GPUConfig(num_bounces=BOUNCES), device="cuda")
    pt_1080.buffers = scenes["small"][1].buffers
    pt_1080.reset_accumulation()
    if pt_1080.route() != "binary":
        raise AssertionError(f"the 1080p small scene takes the {pt_1080.route()} route")
    phase_slice(pt_1080, "4sm1080", ("binary_closest", "binary_any", "shade"),
                forbid=WIDE_NAMES + ("fused_shade",))
    launched_st = phase_slice(scenes["stream"][1], "4st", STREAM_NAMES + ("shade",),
                              forbid=WIDE_NAMES + ("binary_closest", "binary_any",
                                                   "fused_shade"))
    main_launches = {n: (launched_tl if n.endswith("_tl") else
                         launched_sv if n.startswith("svgf") else
                         launched_sm if n.startswith(("binary", "fused")) else
                         launched_st if n in STREAM_NAMES else
                         launched)[n]
                     for n in KERNELS}

    # ---- 5. image parity, kernels vs plain versions ----
    phase_image(*scenes["merged"], "5")
    phase_image(*scenes["two_level"], "5tl")
    phase_image(*scenes["small"], "5sm", route="binary_shade")
    phase_image(*scenes["stream"], "5st", route="stream")
    phase_denoised_image(*scenes["merged"], "5sv")

    # ---- 6. CLI ----
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "scene.xml")
        write_mitsuba_scene(xml)
        runs = []
        for i, extra in enumerate((["-N", "2"], ["-N", "4", "--svgf", "on"])):
            out = os.path.join(tmp, f"out{i}.exr")
            runs.append((extra, out, subprocess.Popen(
                [sys.executable, "-m", "gpu_raytracer_tpu_torch", xml, "-W", "256",
                 "-H", "256", *extra, "-o", out, "--device", "cuda"],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        try:
            for extra, out, proc in runs:
                stdout, stderr = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"CLI {extra} failed ({proc.returncode}):\n"
                                         f"{stdout}\n{stderr}")
                img = read_exr(out)
                if img.shape[:2] != (256, 256) or not np.isfinite(img).all():
                    raise AssertionError(f"CLI image {img.shape} not finite 256x256")
                paths = [ln for ln in stdout.splitlines() if ln.startswith("[paths]")]
                shade = "shade_gather.cu" if "--svgf" in extra else "fused_shade.cu"
                if len(paths) != 1 or "binary_traverse.cu" not in paths[0] \
                        or shade not in paths[0] or "wide_traverse.cu" in paths[0]:
                    raise AssertionError(f"CLI {extra}: the [paths] line does not name "
                                         f"the binary route with {shade}: {paths}")
                say("6", f"CLI {' '.join(extra)} wrote {img.shape[1]}x{img.shape[0]} "
                         f"EXR, mean {float(img[..., :3].mean()):.4f}; {paths[0]}")
        finally:
            for _, _, proc in runs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    jax_mods = sorted(m for m in sys.modules if m.startswith("jax")
                      or m == "gpu_raytracer_tpu" or m.startswith("gpu_raytracer_tpu."))
    if jax_mods:
        raise AssertionError(f"the port loaded JAX or the JAX package: {jax_mods[:5]}")

    say("done", "every phase passed")
    print(json.dumps({"kernels": [
        {"name": KERNELS[r][0], "route": "cuda", "source": KERNELS[r][1],
         "replaces": KERNELS[r][2], "launches": main_launches[r], **results[r]}
        for r in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
