#!/usr/bin/env python3
"""Time the wide traversal kernels of one or more source trees on the same
captured waves, in turns: chip_smoke.py phase 3's traversal rows alone.

    python3 tools/torch_time_traverse.py --trees .chip/parent . . .chip/parent
    python3 tools/torch_time_traverse.py --trees . WP_LEAF_MIN=1 WP_FETCH_MIN=1
    python3 tools/torch_time_traverse.py --skip-wide --small --svgf \\
        --trees .chip/parent . @fast_variance
    python3 tools/torch_time_traverse.py --device cpu --width 32 --height 32 \\
        --subdiv 2 --grid 3 --grid-subdiv 1 --force-two-level --small --small-size 32

A tree is a checkout of the repository (a directory that holds
`gpu_raytracer_tpu_torch/`; `.` is this one; the parent commit unpacked with
`git archive` into the git-ignored `.chip/` is another), or
NAME=VALUE[,NAME=VALUE...]: this tree with those `constexpr` integer constants
of its CUDA sources (csrc/*.cu, csrc/*.cuh; each name defined once) set so,
copied under `.chip/variants/`; or @NAME: this tree with the source patch
NAME of `PATCHES` (`@fast_variance`: the variance kernel with `__expf` and
the constant luminance denominator as a multiply by its reciprocal, an
arithmetic that is not bit-equal and is timed, not shipped). Trees run
in the order given, a tree named twice runs twice, each run in a process of
its own that imports only that tree's package.

This process builds the merged cell (procedural_scene(1920, 1080, 6), 3
bounces) and the instanced cell (instanced_scene(1920, 1080), 4 bounces:
two-level tables), captures one full wave a role as phase 3 does (primary:
the primary wave; closest: bounce 1; any: the bounce-0 shadow wave), and
runs the plain versions on them once: their visits give each role's bound
(tables and rays read once, outputs written once over 3.35 TB/s, or the
visits' operations over 67 TFLOP/s), their per-ray visits the warp
utilisation of a one-thread-a-ray schedule. Each tree's process builds its
kernels (the ptxas report of the traversal kernels printed), reports each
role's kernel (registers, stack frame, blocks an SM from the occupancy API;
for a tree without `wide_traverse.kernel_info` through a small shim built
against its source), launches each role once on the wave, times it (median
of 7 x 10 launches behind a device spin) and, where the tree has
`wide_traverse.trace_stats`, runs the persistent-warp kernel's instrumented
launch (its visits and warp utilisation). Back here each output is held to
the plain version's by parity.compare_closest's tie-aware bar or
compare_any. `--shade` adds K3 on the merged bounce-1 wave; `--stream` the
K6 passes (resident and page, closest on the bounce-1 wave, any on its
shadow wave) on the streamed cell (procedural_scene(1920, 1080, 8,
shared_sphere=True), about a minute and a half of host build), held as
chip_smoke.py phase 3st holds them (resident pass bit-equal, page pass
closest by the tie-aware bar, any exact), with their bounds (phase 3st's
bytes and operations), the one-thread-a-ray utilisation of the plain
per-ray visits and, where a tree has `stream_traverse.pass_stats` and
`kernel_info`, the walk's counters and kernel report. A tree's page pass
takes the captured portal lists in the layout it asks for (their values do
not depend on it). `--svgf` adds K5 on the merged cell's fifth denoised
frame (SVGF + TAA, as chip_smoke.py phase 3sv captures it): the variance
kernel and the a-trous kernel at each of its six steps, held to their plain
versions by the stencil bar, with their bounds (the images read and written
once, or the plain version's pointwise operations), each kernel's report
(`svgf_stencil.kernel_info`, where a tree has it) and the ptxas lines of the
`sv_` kernels; the variance output of every tree must be bit-equal to the
first tree's (the a-trous outputs' bit-equality is reported; an @NAME
tree's K5 outputs are measured against the plain versions, max |err| and
whether the stencil bar holds, and not held to it). `--small` adds the
small-scene kernels: K8 closest and any on the small cell's bounce-1 wave
and its shadow wave (cornell_scene at --small-size, route (a), 6 bounces, as
chip_smoke.py phase 3sm captures them), K8 on the route (b) waves of the
same scene at --width x --height (3 bounces, the bounce-1 wave and its
shadow wave), and K7 (the fused shade) on four waves of route (a): (a)
bounce 1, (b) bounce 1 on the synthetic mixed-BSDF tables
(parity.mixed_fused_args), (c) bounce 4 of 6 (most lanes dead), and
bounce 1 with every lane dead (--small-size 1024 gives wave (d), four
times the lanes); K8 held to trace_plain by parity.compare_binary /
compare_any, with its bound (phase 3sm's: tables, rays and outputs once
over 3.35 TB/s, or the plain visits' operations, binary_traverse.OPS_PER_*,
over 67 TFLOP/s), and the hits of every tree equal to the first tree's;
K7 held by parity.compare_shade, with its live share and bound
(fused_shade.moved_bytes, or the plain version's pointwise operations),
each tree's kernel report (fused_shade.kernel_info, or a shim for a tree
without it) and, for K7 and K3, the count of lanes whose outputs differ by
a bit from the first tree's where the bar reads them
(parity.shade_lanes_differ). A tree gets K7's tables in the layout its
`fused_shade.make_tables` builds (the JAX layout where it has none).
`@fast_shade` is this tree with sample_disk's sinf / cosf as __sinf /
__cosf (K7 and K3; timed, held to the bar only as a report, never
shipped). `--skip-wide` leaves out the wide traversal roles (the merged
cell is still built for --shade and --svgf).

On the CPU (`--device cpu`, a tiny size) the kernels' places are taken by
the plain versions: no build and no times; the visits and the utilisation
print (`--force-two-level` packs the small instanced cell two-level, as
the full-size one packs by itself). One line per tree run, then one JSON
line, also written to `--out` (default .chip/time_traverse/result.json).
Waves and outputs are kept in `--work` (default .chip/time_traverse/,
git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "gpu_raytracer_tpu_torch"
ROLES = ("primary", "closest", "any")
# wt_kernel_info for a tree that predates it: its kernel template
# wt_trace_kernel<MODE, TWO_LEVEL>, 128 threads a block; fs_kernel_info for
# one that predates that: fs_shade_kernel, 128 threads a block. Each is
# built against the tree's source and this checkout's kernel_report.cuh.
SHIM = r"""
#include "wide_traverse.cu"
#include "kernel_report.cuh"
extern "C" int shim_info(int mode, int two_level, int* out) {
  switch (mode * 2 + (two_level ? 1 : 0)) {
    case 0: return kernel_report((const void*)wt_trace_kernel<0, false>, 128, out);
    case 1: return kernel_report((const void*)wt_trace_kernel<0, true>, 128, out);
    case 2: return kernel_report((const void*)wt_trace_kernel<1, false>, 128, out);
    case 3: return kernel_report((const void*)wt_trace_kernel<1, true>, 128, out);
    case 4: return kernel_report((const void*)wt_trace_kernel<2, false>, 128, out);
    case 5: return kernel_report((const void*)wt_trace_kernel<2, true>, 128, out);
  }
  return 1;
}
"""
FS_SHIM = r"""
#include "fused_shade.cu"
#include "kernel_report.cuh"
extern "C" int shim_info(int, int, int* out) {
  return kernel_report((const void*)fs_shade_kernel, 128, out);
}
"""
INFO = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm", "sms")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trees", nargs="+", default=["."])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--subdiv", type=int, default=6, help="merged cell's icospheres")
    p.add_argument("--grid", type=int, default=21, help="instanced cell's grid")
    p.add_argument("--grid-subdiv", type=int, default=4, help="instanced cell's icosphere")
    p.add_argument("--force-two-level", action="store_true",
                   help="decline merged tables for the instanced cell (small sizes)")
    p.add_argument("--shade", action="store_true", help="also K3 on the merged wave")
    p.add_argument("--stream", action="store_true", help="also K6 on the streamed cell")
    p.add_argument("--svgf", action="store_true",
                   help="also K5 on the merged cell's fifth denoised frame")
    p.add_argument("--small", action="store_true",
                   help="also K8 and K7 on the small cell's waves (routes (a) and (b))")
    p.add_argument("--small-size", type=int, default=512, help="route (a) film side")
    p.add_argument("--skip-wide", action="store_true",
                   help="leave out the wide traversal roles")
    p.add_argument("--out", default=os.path.join(REPO, ".chip", "time_traverse", "result.json"))
    p.add_argument("--work", default=os.path.join(REPO, ".chip", "time_traverse"))
    p.add_argument("--worker", help=argparse.SUPPRESS)  # a tree's process
    p.add_argument("--result", help=argparse.SUPPRESS)
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

# @NAME trees: (source file under csrc/, [(text, replacement)]), each text
# found exactly once.
PATCHES = {
    "@fast_shade": ("shade_common.cuh", [
        ("  *x = r * cosf(phi);\n  *y = r * sinf(phi);",
         "  *x = r * __cosf(phi);\n  *y = r * __sinf(phi);"),
    ]),
    "@fast_variance": ("svgf_stencil.cu", [
        ("  const float c_dz = __ldg(g + 4 * plane + p);\n",
         "  const float c_dz = __ldg(g + 4 * plane + p);\n  const float inv_den = 1.0f / den;\n"),
        ("const float w_z = expf(-fabsf(cg.w - a.w)", "const float w_z = __expf(-fabsf(cg.w - a.w)"),
        ("expf(-fabsf(cl.z - l_dq) / den)", "__expf(-fabsf(cl.z - l_dq) * inv_den)"),
        ("expf(-fabsf(cl.w - l_iq) / den)", "__expf(-fabsf(cl.w - l_iq) * inv_den)"),
    ]),
}


def copy_tree(spec: str) -> tuple:
    """A fresh copy of this tree's package under .chip/variants/: (its
    directory, {csrc file: text})."""
    path = os.path.join(REPO, ".chip", "variants", re.sub(r"[^\w.-]+", "_", spec))
    shutil.rmtree(path, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(path, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(path, PKG, "csrc")
    return path, {f: open(os.path.join(csrc, f)).read() for f in sorted(os.listdir(csrc))
                  if f.endswith((".cu", ".cuh"))}


def write_sources(path: str, sources: dict) -> None:
    for f, text in sources.items():
        with open(os.path.join(path, PKG, "csrc", f), "w") as out:
            out.write(text)


def resolve_tree(spec: str, made: dict) -> str:
    """The directory of tree `spec` (a variant is made once a run)."""
    if spec in made:
        return made[spec]
    if spec.startswith("@"):
        if spec not in PATCHES:
            raise SystemExit(f"{spec}: no such patch (PATCHES: {sorted(PATCHES)})")
        path, sources = copy_tree(spec)
        f, edits = PATCHES[spec]
        for old, new in edits:
            if sources[f].count(old) != 1:
                raise SystemExit(f"{spec}: {sources[f].count(old)} copies of {old!r} in {f}")
            sources[f] = sources[f].replace(old, new)
        write_sources(path, {f: sources[f]})
        made[spec] = path
        return path
    if "=" not in spec:
        path = os.path.abspath(os.path.join(REPO, spec))
        if not os.path.isdir(os.path.join(path, PKG)):
            raise SystemExit(f"{spec}: no {PKG}/ there")
        return path
    path, sources = copy_tree(spec)
    for item in spec.split(","):
        name, value = item.split("=", 1)
        found = 0
        for f, text in sources.items():
            sources[f], n = re.subn(rf"constexpr (int|unsigned) {re.escape(name)} = [^;]+;",
                                    rf"constexpr \1 {name} = {value};", text)
            found += n
        if found != 1:
            raise SystemExit(f"{spec}: {found} definitions of `constexpr int|unsigned {name}` "
                             f"in csrc/")
    write_sources(path, sources)
    made[spec] = path
    return path


# ---------------------------------------------------------------------------
# Waves and the plain versions (this tree)
# ---------------------------------------------------------------------------

def capture(args) -> dict:
    """{key: wave}: the six traversal roles' waves (key = role, "_tl" on
    two-level tables), with --shade "shade", with --stream the K6 passes',
    with --svgf the K5 stencils' ("svgf_variance", "svgf_atrous_<step>")."""
    import torch

    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig, parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.ops import buffers as tb
    from gpu_raytracer_tpu_torch.scenes import instanced_scene, procedural_scene

    W, H, dev = args.width, args.height, args.device
    batch = min(CPUConfig().batch_size, W * H)
    waves, info = {}, {}
    cells = (("merged", lambda: procedural_scene(W, H, args.subdiv), 3),
             ("two_level", lambda: instanced_scene(W, H, grid=args.grid,
                                                   sphere_subdivisions=args.grid_subdiv), 4))
    if args.skip_wide:  # the merged cell only where K3 or K5 need it
        cells = cells[:1] if args.shade or args.svgf else ()
    for cell, make, bounces in cells:
        t0 = time.perf_counter()
        scene = make()
        pt = Pathtracer(scene, CPUConfig(batch_size=batch), GPUConfig(num_bounces=bounces),
                        device=dev)
        merged_packer = tb._pack_wide_merged
        if cell == "two_level" and args.force_two_level:
            tb._pack_wide_merged = lambda *a, **k: None
        try:
            pt.init_device()
        finally:
            tb._pack_wide_merged = merged_packer
        wide = pt.buffers["wide"]
        if pt.route() != "wide" or wide.two_level != (cell == "two_level"):
            raise RuntimeError(f"{cell} cell: route {pt.route()}, two_level {wide.two_level}")
        got = parity.capture_wave(pt, batch)
        info[cell] = {"triangles": scene.triangle_count(), "instances": len(scene.instances),
                      "table_bytes": 512 * (wide.nodes.shape[0] + wide.rows.shape[0]),
                      "max_stack": wide.max_stack, "build_s": time.perf_counter() - t0}
        for role in () if args.skip_wide else ROLES:
            (tables, o, d, tm), _ = got[role]
            waves[role + ("_tl" if tables.two_level else "")] = {
                "kind": "wide", "role": role, "cell": cell, "tables": tuple(tables),
                "rays": (o, d, tm)}
        if args.shade and cell == "merged":
            (tables, params, lanes), kw = got["shade"]
            waves["shade"] = {"kind": "shade", "cell": cell,
                              "args": (tables, params, lanes), "kw": kw}
        if args.svgf and cell == "merged":
            waves.update(capture_svgf(pt))
    if args.stream:
        waves.update(capture_stream(W, H, dev))
    if args.small:
        small, facts = capture_small(args)
        waves.update(small)
        info.update(facts)
    if dev == "cuda":
        torch.cuda.synchronize()
    return waves, info


def capture_svgf(pt) -> dict:
    """The K5 stencils' inputs on the fifth denoised frame of `pt`'s scene
    (SVGF + TAA on its tables, 1 sample a frame)."""
    import dataclasses

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer

    p = Pathtracer(pt.scene, pt.cpu_config,
                   dataclasses.replace(pt.gpu_config, enable_svgf=True), device=pt.device)
    p.buffers = pt.buffers
    p.reset_accumulation()
    got = parity.capture_svgf(p, 5)
    waves = {}
    for role in ("svgf_variance", "svgf_atrous"):
        for args, kw in got[role]:
            key = role if role == "svgf_variance" else f"{role}_{args[2]}"
            waves[key] = {"kind": "svgf", "role": role, "cell": "denoised", "args": args,
                          "kw": kw}
    return waves


def capture_small(args) -> tuple:
    """The small-scene kernels' inputs: K8 closest and any on the route (a)
    bounce-1 wave and its shadow wave and K7 on that bounce-1 wave
    (cornell_scene at --small-size, 6 bounces), K8 on the route (b)
    bounce-1 wave and its shadow wave (the same tables, the film at --width
    x --height, 3 bounces). Returns (waves, {cell: facts})."""
    import torch

    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig, parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs
    from gpu_raytracer_tpu_torch.scenes import cornell_scene

    S, dev = args.small_size, args.device
    t0 = time.perf_counter()
    pt = Pathtracer(cornell_scene(S, S), CPUConfig(), GPUConfig(num_bounces=6), device=dev)
    pt.init_device()
    tables = pt.buffers["binary"]
    facts = {"small": {"triangles": pt.scene.triangle_count(),
                       "instances": len(pt.scene.instances),
                       "table_bytes": nbytes(tables), "build_s": time.perf_counter() - t0}}
    waves = {}
    got = parity.capture_wave(pt, S * S, route="binary_shade", every=True)
    for role in ("binary_closest", "binary_any"):
        waves[role] = {"kind": "binary", "role": role, "cell": "small",
                       "args": tuple(got[role][1][0])}
    # K7's waves, with the tables in the JAX layout (each tree's process
    # builds its own kernel layout from them): (a) bounce 1, (b) bounce 1
    # on the synthetic mixed-BSDF tables, (c) bounce 4 of 6 (most lanes
    # dead), and the bounce-1 wave with every lane dead.
    calls = got["fused_shade"]
    if len(calls) < 5:
        raise RuntimeError(f"the small cell's sample ended after {len(calls)} bounces")
    for key, (a, kw) in (("fused_shade", calls[1]),
                         ("fused_mixed", (parity.mixed_fused_args(calls[1][0]), calls[1][1])),
                         ("fused_late", calls[4])):
        waves[key] = {"kind": "fused", "cell": "small",
                      "args": (fs.plain_tables(a[0]),) + tuple(a[1:]), "kw": kw}
    dead = list(waves["fused_shade"]["args"])
    dead[7] = torch.zeros_like(dead[7])
    waves["fused_dead"] = {"kind": "fused", "cell": "small", "args": tuple(dead),
                           "kw": waves["fused_shade"]["kw"]}
    pt_b = Pathtracer(cornell_scene(args.width, args.height), pt.cpu_config,
                      GPUConfig(num_bounces=3), device=dev)
    pt_b.buffers = pt.buffers
    pt_b.reset_accumulation()
    batch = min(pt.cpu_config.batch_size, args.width * args.height)
    got = parity.capture_wave(pt_b, batch, route="binary", every=True)
    for role in ("binary_closest", "binary_any"):
        waves[role + "_b"] = {"kind": "binary", "role": role, "cell": "small_b",
                              "args": tuple(got[role][1][0])}
    return waves, facts


def capture_stream(W, H, dev) -> dict:
    """The K6 passes' inputs on the streamed cell, as phase 3st takes them:
    resident and page pass, closest on the bounce-1 wave, any on its shadow
    wave; the page pass after pass 0's fold of the plain resident pass."""
    import torch

    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig, parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    pt = Pathtracer(procedural_scene(W, H, 8, shared_sphere=True), CPUConfig(),
                    GPUConfig(num_bounces=3), device=dev)
    pt.init_device()
    if pt.route() != "stream":
        raise RuntimeError(f"the streamed cell takes the {pt.route()} route")
    got = parity.capture_wave(pt, pt.cpu_config.batch_size, route="stream", every=True)
    waves = {}
    for any_hit, (tables, o, d, tm) in ((False, got["stream_closest"][1][0]),
                                       (True, got["stream_any"][1][0])):
        mode = "any" if any_hit else "closest"
        t1, tri1, pid, pt_, _ = st.resident_plain(any_hit, tables, o, d, tm)
        page_in = (pid, pt_, torch.where(tri1 >= 0, t1, tm), tri1)
        for kind, extra in (("resident", ()), ("page", page_in)):
            waves[f"{kind}_{mode}"] = {"kind": kind, "any": any_hit, "cell": "stream",
                                       "tables": tuple(tables), "rays": (o, d, tm) + extra}
    return waves


def nbytes(*xs) -> int:
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


def plain_results(waves: dict) -> dict:
    """{key: (plain output, facts)}: the plain version once on each wave;
    for the traversal roles its visits, the warp utilisation of a
    one-thread-a-ray schedule and the bound."""
    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    out = {}
    for key, w in waves.items():
        if w["kind"] == "wide":
            tables = wt.WideTables(*w["tables"])
            o, d, tm = w["rays"]
            res = getattr(PLAIN, w["role"])(tables, o, d, tm)
            work = dict(wt.last_work)
            ops = (work["nodes"] * wt.OPS_PER_NODE + work["triangles"] * wt.OPS_PER_TRIANGLE
                   + work["instances"] * wt.OPS_PER_INSTANCE)
            b_ms, b_by = probes.bound(nbytes(tables.nodes, tables.rows, o, d, tm, res), ops)
            facts = {"rays": int(tm.shape[0]), "live": int((tm > 0).sum()), "visits": work,
                     "one_thread_a_ray_util": wt.warp_utilisation(wt.last_pops),
                     "bound_ms": b_ms, "bound_by": b_by}
        elif w["kind"] == "shade":
            res = PLAIN.shade(*w["args"], **w["kw"])
            facts = {"rays": int(w["args"][2]["t"].shape[0])}
        elif w["kind"] == "binary":
            res = getattr(PLAIN, w["role"])(*w["args"])
            work = dict(bt.last_work)
            ops = (work["nodes"] * bt.OPS_PER_NODE + work["triangles"] * bt.OPS_PER_TRI
                   + work["instances"] * bt.OPS_PER_INST)
            b_ms, b_by = probes.bound(nbytes(w["args"], res), ops)
            tm = w["args"][3]
            facts = {"rays": int(tm.shape[0]), "live": int((tm > 0).sum()), "visits": work,
                     "bound_ms": b_ms, "bound_by": b_by}
        elif w["kind"] == "fused":
            def fn(w=w):
                return PLAIN.fused_shade(*w["args"], **w["kw"])
            res = fn()
            b_ms, b_by = probes.bound(fs.moved_bytes(w["args"], res), probes.pointwise_ops(fn))
            rays, live = int(w["args"][3].t.shape[0]), int(w["args"][7].sum())
            facts = {"rays": rays, "live": live, "live_share": live / rays,
                     "bytes": fs.moved_bytes(w["args"], res), "bound_ms": b_ms,
                     "bound_by": b_by}
        elif w["kind"] == "svgf":
            def fn(w=w):
                return getattr(PLAIN, w["role"])(*w["args"], **w["kw"])
            res = fn()
            b_ms, b_by = probes.bound(nbytes(w["args"][:2], res), probes.pointwise_ops(fn))
            facts = {"shape": list(res.shape), "bound_ms": b_ms, "bound_by": b_by}
        else:
            fn = st.resident_plain if w["kind"] == "resident" else st.page_plain
            res = fn(w["any"], st.StreamTables(*w["tables"]), *w["rays"])
            work = dict(st.last_work[key])
            ops = work["nodes"] * wt.OPS_PER_NODE + work["triangles"] * wt.OPS_PER_TRIANGLE
            # Bytes as chip_smoke.py phase 3st counts them.
            if w["kind"] == "resident":
                need = work["rows"] * 512 + nbytes(w["rays"], res)
            else:
                need = (work["rows"] * 512 + 8 * work["portals"] + 4 * work["entries"]
                        + 28 * work["lanes"] + nbytes(w["rays"][5:], res))
            b_ms, b_by = probes.bound(need, ops)
            facts = {"rays": int(w["rays"][2].shape[0]), "visits": work,
                     "one_thread_a_ray_util": wt.warp_utilisation(st.last_pops[key]),
                     "bound_ms": b_ms, "bound_by": b_by}
        out[key] = (res, facts)
    return out


def compare(key: str, w: dict, got, plain) -> float:
    """A tree's output against the plain version's, by the parity bars."""
    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    if w["kind"] == "wide":
        if w["role"] == "any":
            return parity.compare_any(got, plain)
        o, d, _ = w["rays"]
        got = wt.Hit(*got)
        return parity.compare_closest(
            got, plain, parity.TRI_MATCH_COHERENT if w["role"] == "primary"
            else parity.TRI_MATCH_INCOHERENT, w["role"] == "primary",
            (wt.WideTables(*w["tables"]), o, d))
    if w["kind"] in ("shade", "fused"):
        return parity.compare_shade(got, plain)
    if w["kind"] == "binary":
        if w["role"] == "binary_any":
            return parity.compare_any(got, plain)
        from gpu_raytracer_tpu_torch.ops import binary_traverse as bt

        return parity.compare_binary(bt.Hit(*got), plain)
    if w["kind"] == "svgf":
        return parity.compare_stencil(got, plain)
    if w["kind"] == "page" and not w["any"]:
        from gpu_raytracer_tpu_torch.ops import stream_traverse as st

        o, d = w["rays"][:2]
        return parity.compare_stream_closest(got, plain, (st.StreamTables(*w["tables"]), o, d))
    fields = ("t", "tri", "pid", "pt", "ovf") if w["kind"] == "resident" else ("t", "tri")
    return parity.compare_stream_pass(got, plain, fields)


# ---------------------------------------------------------------------------
# A tree's process
# ---------------------------------------------------------------------------

def shim_info(tree: str, mode: int, two_level: bool, which: str = "wt") -> dict:
    """wt_kernel_info (fs_kernel_info with `which` "fs") for a tree without
    it: a shim built against its wide_traverse.cu (fused_shade.cu), cached
    beside its library."""
    import ctypes

    from gpu_raytracer_tpu_torch.ops import _native

    lib_path = os.path.join(_native.BUILD_DIR, f"lib{which}_shim.so")
    if not os.path.exists(lib_path):
        src = os.path.join(_native.BUILD_DIR, f"{which}_shim.cu")
        with open(src, "w") as f:
            f.write(SHIM if which == "wt" else FS_SHIM)
        subprocess.run([_native.find_nvcc(), *_native.NVCC_FLAGS, "-shared", "-I",
                        _native.CSRC_DIR, "-I", os.path.join(REPO, PKG, "csrc"), "-o",
                        lib_path, src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.shim_info.restype = ctypes.c_int
    lib.shim_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * len(INFO))()
    if lib.shim_info(mode, int(two_level), out) != 0:
        raise RuntimeError("shim_info failed")
    return dict(zip(INFO, list(out)))


def worker(args) -> int:
    """One tree's run: build, report, launch once, time; results to
    --result."""
    tree = os.path.abspath(args.worker)
    sys.path.insert(0, tree)
    import torch

    import gpu_raytracer_tpu_torch as pkg
    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH
    from gpu_raytracer_tpu_torch.ops import _native
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    if not os.path.abspath(pkg.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the tree {tree}")
    cuda = args.device == "cuda"
    rep = {"tree": tree, "build_s": None, "ptxas": "", "info": {}, "ms": {}, "stats": {}}
    if cuda:
        # The first run of a tree builds it with the ptxas report (kept
        # beside its library for the later runs).
        log_path = os.path.join(_native.BUILD_DIR, "ptxas.log")
        if _native.is_stale() or not os.path.exists(log_path):
            built = _native.build(force=True, ptxas_verbose=True)
            rep["build_s"] = built["seconds"]
            with open(log_path, "w") as f:
                f.write(built["log"])
        with open(log_path) as f:
            rep["ptxas"] = f.read()  # parsed by the calling process
        _native.load()
    waves = torch.load(os.path.join(args.work, "waves.pt"), weights_only=False)
    with open(os.path.join(_native.CSRC_DIR, "wide_traverse.cu")) as f:
        primary_walk = "wt_primary_kernel" not in f.read()
    outs = {}
    for key, w in waves.items():
        if w["kind"] == "wide":
            nodes, rows, max_stack, two_level = w["tables"][:4]
            tables = wt.make_tables(nodes, rows, max_stack, two_level)
            mode = ROLES.index(w["role"])

            def fn(tables=tables, w=w):
                return getattr(DISPATCH, w["role"])(tables, *w["rays"])
            if cuda:
                rep["info"][key] = (wt.kernel_info(mode, two_level) if hasattr(wt, "kernel_info")
                                    else shim_info(tree, mode, two_level))
                # A tree whose primary wave runs the walk instruments it too.
                if hasattr(wt, "trace_stats") and (mode != wt.PRIMARY or primary_walk):
                    _, stats = wt.trace_stats(mode, tables, *w["rays"])
                    stats["util"] = wt.kernel_utilisation(stats)
                    rep["stats"][key] = stats
        elif w["kind"] == "shade":
            def fn(w=w):
                return DISPATCH.shade(*w["args"], **w["kw"])
        elif w["kind"] == "fused":
            # The tables in the layout the tree asks for (a tree before the
            # kernel's rows takes the JAX layout as it is).
            fused_args = w["args"]
            if hasattr(fs, "make_tables"):
                fused_args = (fs.make_tables(fused_args[0]),) + tuple(fused_args[1:])

            def fn(w=w, fused_args=fused_args):
                return DISPATCH.fused_shade(*fused_args, **w["kw"])
            if cuda:
                rep["info"][key] = (fs.kernel_info() if hasattr(fs, "kernel_info")
                                    else shim_info(tree, 0, False, "fs"))
        elif w["kind"] == "binary":
            def fn(w=w):
                return getattr(DISPATCH, w["role"])(*w["args"])
            if cuda and hasattr(bt, "kernel_info"):
                rep["info"][key] = bt.kernel_info(w["role"] == "binary_any")
        elif w["kind"] == "svgf":
            def fn(w=w):
                return getattr(DISPATCH, w["role"])(*w["args"], **w["kw"])
            if cuda and hasattr(sv, "kernel_info"):
                rep["info"][key] = sv.kernel_info(w["role"])
        else:
            tables = st.StreamTables(*w["tables"])
            kernel = st.resident_kernel if w["kind"] == "resident" else st.page_kernel
            if w["kind"] == "page" and not hasattr(st, "pass_stats"):
                # A tree before the slot-major lists takes them row-major
                # (its wrapper's own copy would be freed before its launch).
                w = dict(w, rays=tuple(x.contiguous() for x in w["rays"]))

            def fn(tables=tables, w=w, kernel=kernel):
                return kernel(w["any"], tables, *w["rays"])
            if cuda and hasattr(st, "pass_stats"):
                rep["info"][key] = st.kernel_info(w["kind"], w["any"])
                _, stats = st.pass_stats(w["kind"], w["any"], tables, *w["rays"])
                stats["util"] = wt.kernel_utilisation(stats)
                rep["stats"][key] = stats
        out = fn()
        if cuda:
            torch.cuda.synchronize()
            rep["ms"][key] = sorted(probes.device_ms(fn, 10, 7))[3]
        outs[key] = tuple(out) if isinstance(out, tuple) else out
    torch.save({"rep": rep, "outs": outs}, args.result)
    return 0


# ---------------------------------------------------------------------------
# This process
# ---------------------------------------------------------------------------

def main() -> int:
    args = parse()
    if args.worker:
        return worker(args)
    sys.path.insert(0, REPO)
    import torch

    from gpu_raytracer_tpu_torch import parity, probes
    from gpu_raytracer_tpu_torch.ops import _native

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_time_traverse: no CUDA device (use --device cpu)", file=sys.stderr)
        return 1
    if args.stream and args.device == "cpu":
        raise SystemExit("--stream needs the card (the streamed cell is 3.9M triangles)")
    t_start = time.perf_counter()
    card = probes.card() if args.device == "cuda" else "cpu"
    print(f"[time_traverse] card: {card}", flush=True)
    made, trees = {}, []
    for spec in args.trees:
        trees.append((spec, resolve_tree(spec, made)))
    os.makedirs(args.work, exist_ok=True)
    waves, cells = capture(args)
    torch.save(waves, os.path.join(args.work, "waves.pt"))
    plain = plain_results(waves)
    for cell, facts in cells.items():
        print(f"[time_traverse] {cell} cell: {json.dumps(facts)}", flush=True)
    for key, (_, facts) in plain.items():
        print(f"[time_traverse] wave {key}: {json.dumps(facts)}", flush=True)

    runs, first_outs = [], {}
    for k, (spec, path) in enumerate(trees):
        result = os.path.join(args.work, f"run{k}.pt")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", path,
                               "--result", result, "--work", args.work,
                               "--device", args.device], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
            raise RuntimeError(f"tree {spec} failed ({proc.returncode})")
        got = torch.load(result, weights_only=False)
        rep = got["rep"]
        # The traversal kernels: wt_* (and st_* of a tree before the paged
        # passes ran on the walk), bt_*; the stencils: sv_*.
        rep["ptxas"] = ({k: v for prefix in ("wt_", "st_", "bt_", "sv_", "fs_", "sg_")
                         for k, v in _native.ptxas_report(rep["ptxas"], prefix).items()}
                        if rep["ptxas"] else {})
        errs = {}
        for key, w in waves.items():
            out = got["outs"][key]
            patched = spec.startswith("@")
            if w["kind"] == "svgf" and patched:  # measured, not held to the bar
                want = plain[key][0]
                errs[key] = (out - want).abs().max().item()
                tol = parity.STENCIL_TOL
                rep.setdefault("stencil_bar_holds", {})[key] = not bool(
                    ((out - want).abs() > tol + tol * want.abs()).any())
            elif w["kind"] in ("shade", "fused") and patched:
                try:
                    errs[key] = compare(key, w, out, plain[key][0])
                    holds = True
                except AssertionError as e:
                    errs[key], holds = str(e), False
                rep.setdefault("shade_bar_holds", {})[key] = holds
            else:
                errs[key] = compare(key, w, out, plain[key][0])
            if w["kind"] == "svgf":
                # The first tree's output is the yardstick: the variance
                # kernel must not change by a bit.
                first = first_outs.setdefault(key, out)
                same = bool(torch.equal(out, first))
                rep.setdefault("bit_equal_first_tree", {})[key] = same
                if w["role"] == "svgf_variance" and not same and not patched:
                    raise AssertionError(f"tree {spec}: svgf_variance differs from tree "
                                         f"{trees[0][0]}'s")
            if w["kind"] in ("fused", "shade"):
                # The shade kernels: lanes whose outputs differ by a bit from
                # the first tree's where the bar reads them.
                first = first_outs.setdefault(key, out)
                rep.setdefault("lanes_differ_first_tree", {})[key] = \
                    parity.shade_lanes_differ(out, first)
            if w["kind"] == "binary":  # every tree's hits are the first tree's
                first = first_outs.setdefault(key, out)
                pairs = zip(out, first) if isinstance(out, tuple) else ((out, first),)
                if not all(torch.equal(a, b) for a, b in pairs):
                    raise AssertionError(f"tree {spec}: {key} hits differ from tree "
                                         f"{trees[0][0]}'s")
        rep["max_abs_err"] = errs
        rep["seconds"] = time.perf_counter() - t0
        runs.append((spec, rep))
        ms = ", ".join(f"{key} {v:.4f}" for key, v in rep["ms"].items()) or "no times (CPU)"
        print(f"[time_traverse] run {k} tree {spec}: parity ok on every wave; ms: {ms}; "
              f"{rep['seconds']:.1f} s", flush=True)
        for name, lines in rep["ptxas"].items():
            print(f"[time_traverse]   ptxas {name}: {'; '.join(lines)}", flush=True)
        for key, info in rep["info"].items():
            print(f"[time_traverse]   kernel of {key}: {json.dumps(info)}, "
                  f"{info['blocks_per_sm'] * info['threads'] // 32} warps an SM", flush=True)
        for key, stats in rep["stats"].items():
            print(f"[time_traverse]   {key} instrumented: {json.dumps(stats)}", flush=True)
        if rep.get("stencil_bar_holds"):
            print(f"[time_traverse]   K5 max |err| against the plain versions: "
                  f"{json.dumps({k: errs[k] for k in rep['stencil_bar_holds']})}; "
                  f"within the stencil bar: {json.dumps(rep['stencil_bar_holds'])}", flush=True)
        if rep.get("shade_bar_holds"):
            print(f"[time_traverse]   shade bar against the plain versions: "
                  f"{json.dumps(rep['shade_bar_holds'])}", flush=True)
        if rep.get("lanes_differ_first_tree"):
            print(f"[time_traverse]   shade lanes that differ by a bit from tree "
                  f"{trees[0][0]}'s where the bar reads them: "
                  f"{json.dumps(rep['lanes_differ_first_tree'])}", flush=True)
        if rep.get("bit_equal_first_tree"):
            print(f"[time_traverse]   K5 outputs bit-equal to tree {trees[0][0]}'s: "
                  f"{json.dumps(rep['bit_equal_first_tree'])}", flush=True)

    summary = {}
    for spec, rep in runs:
        s = summary.setdefault(spec, {"ms": {}, "info": rep["info"], "stats": rep["stats"],
                                      "ptxas": rep["ptxas"] or None})
        if rep["ptxas"]:
            s["ptxas"] = rep["ptxas"]
        for key, v in rep["ms"].items():
            s["ms"].setdefault(key, []).append(v)
    for spec, s in summary.items():
        s["median_ms"] = {k: sorted(v)[len(v) // 2] for k, v in s["ms"].items()}
        if s["median_ms"]:
            print(f"[time_traverse] tree {spec}, median ms: " + ", ".join(
                f"{k} {v:.4f} (bound {plain[k][1].get('bound_ms', float('nan')):.4f})"
                for k, v in s["median_ms"].items()), flush=True)
    line = {"card": card, "device": args.device, "cells": cells,
            "waves": {k: f for k, (_, f) in plain.items()}, "trees": summary,
            "order": [spec for spec, _ in runs],
            "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(line, f, indent=1)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
