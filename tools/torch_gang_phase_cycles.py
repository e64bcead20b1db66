#!/usr/bin/env python3
"""Where an iteration of the gang traversal goes on the H100: `pg_ablate`
with clock64 counters a phase.

    python3 tools/torch_gang_phase_cycles.py                  # on the card
    python3 tools/torch_gang_phase_cycles.py --variants full,nopush

Copies the port's csrc/probe_gang.cu into a directory of its own under the
kernels' build directory and adds
counters to `pg_ablate_kernel` (`patch`): each gang's warp sums the cycles
(clock64) it spends in node phases, in triangle phases with a leaf and
without one, and waiting at the tile's vote, the count of each phase, the
cycles before its first triangle and the triangles it tests, and adds them
with atomicAdd into a __device__ array that `pg_stats` reads and clears.
That one source is built with nvcc and the port's flags into a library of
its own. Every asked variant then runs on the merged 1080p cell's bounce-1
wave for the probe's 256 iterations; its output must equal the port's
uninstrumented kernel's (`probes/gang.ablate`). Prints the card and one
JSON line a variant: the sums, the cycles of a phase and of a warp's
iteration, the vote's share of a warp's cycles, the triangles of an active
triangle phase, and ms a launch with the counters on and off (CUDA events
behind a device spin). Needs the card and nvcc.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

NAMES = ("node_cycles", "tri_active_cycles", "vote_cycles", "tri_idle_cycles", "node_phases",
         "tri_first_cycles", "tri_active_phases", "triangles")

# (anchor, replacement): each anchor must occur once in probe_gang.cu.
PATCH = (
    ("struct __align__(16) PgTileShared {",
     "__device__ unsigned long long pg_st[8];\n\nstruct __align__(16) PgTileShared {"),
    ("  int trig = 0;  // no gang holds a leaf yet\n  bool busy = true;\n  int it = 0;\n",
     "  int trig = 0;  // no gang holds a leaf yet\n  bool busy = true;\n  int it = 0;\n"
     "  unsigned long long st[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long c0 = 0, ck = 0;\n"),
    ("    ++it;\n    const bool tri_phase",
     "    ++it;\n    c0 = clock64();\n    ck = 0;\n    const bool tri_phase"),
    ("        const int count = kind > 0.0f ? (int)ceilf(fminf(kind, (float)WT_LEAF_CAP)) : 0;\n",
     "        const int count = kind > 0.0f ? (int)ceilf(fminf(kind, (float)WT_LEAF_CAP)) : 0;\n"
     "        ck = clock64();\n        st[7] += count;\n"),
    ("    const bool trig_g = lq >= PG_QTRIG || (sp == 0 && lq > 0);\n",
     "    const long long c1 = clock64();\n"
     "    if (!tri_phase) {\n      st[0] += c1 - c0;\n      st[4] += 1;\n"
     "    } else if (ck) {\n      st[1] += c1 - c0;\n      st[5] += ck - c0;\n      st[6] += 1;\n"
     "    } else {\n      st[3] += c1 - c0;\n    }\n"
     "    const bool trig_g = lq >= PG_QTRIG || (sp == 0 && lq > 0);\n"),
    ("    busy = votes >= PG_BUSY_VOTES;\n",
     "    busy = votes >= PG_BUSY_VOTES;\n    st[2] += clock64() - c1;\n"),
    ("  if (threadIdx.x == 0) iters_out[blockIdx.x] = it;\n",
     "  if (threadIdx.x == 0) iters_out[blockIdx.x] = it;\n"
     "  if (lane == 0)\n    for (int i = 0; i < 8; ++i) atomicAdd(&pg_st[i], st[i]);\n"),
    ('extern "C" int pg_layout(int which) {',
     'extern "C" int pg_stats(unsigned long long* out) {\n'
     "  cudaError_t e = cudaMemcpyFromSymbol(out, pg_st, sizeof(pg_st));\n"
     "  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(pg_st, zero, sizeof(zero));\n"
     "  return (int)e;\n}\n\n"
     'extern "C" int pg_layout(int which) {'),
)


def patch(source: str) -> str:
    """probe_gang.cu with the phase counters; raises where an anchor is not
    found exactly once (the kernel changed under the tool)."""
    for anchor, replacement in PATCH:
        if source.count(anchor) != 1:
            raise ValueError(f"anchor found {source.count(anchor)} times: {anchor[:60]!r}")
        source = source.replace(anchor, replacement)
    return source


def build(workdir: str) -> ctypes.CDLL:
    """The patched probe_gang.cu as a library of its own (nvcc, the port's
    flags, the port's headers)."""
    from gpu_raytracer_tpu_torch.ops import _native

    src = os.path.join(workdir, "probe_gang_phases.cu")
    with open(os.path.join(_native.CSRC_DIR, "probe_gang.cu")) as f:
        text = patch(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(workdir, "libprobe_gang_phases.so")
    subprocess.run([_native.find_nvcc(), *_native.NVCC_FLAGS, "-I", _native.CSRC_DIR, "-shared",
                    "-o", lib_path, src], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pg_ablate.restype = lib.pg_stats.restype = ci
    lib.pg_ablate.argtypes = [ci, vp, ci, ci, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp]
    lib.pg_stats.argtypes = [vp]
    return lib


def launch(lib, gt, wave, variant: str, k_iters: int):
    """One instrumented launch on whole tiles (t, tri, iters), as
    probes/gang.ablate_kernel launches the port's kernel."""
    import torch

    from gpu_raytracer_tpu_torch.probes import c_ptr, c_stream, gang

    o, d, tm = wave
    G = tm.shape[0] // gang.BLOCK
    t = torch.empty(G * gang.BLOCK, dtype=torch.float32, device=tm.device)
    tri = torch.empty(G * gang.BLOCK, dtype=torch.int32, device=tm.device)
    iters = torch.empty(G, dtype=torch.int32, device=tm.device)
    err = lib.pg_ablate(gang.ABLATE_VARIANTS.index(variant), c_ptr(gt.table), gt.num_nodes,
                        gt.table.shape[0] - gt.num_nodes, c_ptr(o), c_ptr(d), c_ptr(tm), G,
                        k_iters, 0, c_ptr(t), c_ptr(tri), c_ptr(iters), c_stream(tm.device))
    if err:
        raise RuntimeError(f"instrumented pg_ablate<{variant}>: cudaError_t {err}")
    return t, tri, iters


def main(argv=None) -> int:
    import torch

    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.ops import _native
    from gpu_raytracer_tpu_torch.probes import gang

    ap = argparse.ArgumentParser(prog="torch_gang_phase_cycles", description=__doc__)
    ap.add_argument("--variants", default="full,node-only,nopush")
    ap.add_argument("--iters", type=int, default=gang.K_ITERS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gang_phase_cycles: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(json.dumps({"card": probes.card()}), flush=True)
    got = probes.bounce1(probes.merged_cell())
    gt, wave = got["gt"], gang.pad_wave(got["wave"])
    warp_iters = wave[2].shape[0] // gang.BLOCK * gang.GANGS * args.iters
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="gang_phases_", dir=_native.BUILD_DIR)
    try:
        lib = build(workdir)
        buf = (ctypes.c_ulonglong * len(NAMES))()
        for v in args.variants.split(","):
            want = gang.ablate(gt, wave, v, args.iters)
            lib.pg_stats(buf)  # clear
            t, tri, iters = launch(lib, gt, wave, v, args.iters)
            torch.cuda.synchronize()
            if lib.pg_stats(buf):
                raise RuntimeError("pg_stats failed")
            if not (torch.equal(t, want.t) and torch.equal(tri, want.tri)
                    and torch.equal(iters, want.iters)):
                raise AssertionError(f"the instrumented pg_ablate<{v}> differs from the port's")
            st = dict(zip(NAMES, list(buf)))
            spent = st["node_cycles"] + st["tri_active_cycles"] + st["tri_idle_cycles"]
            tri_idle = warp_iters - st["node_phases"] - st["tri_active_phases"]
            row = {"variant": v, "iters": args.iters, "warp_iterations": warp_iters, **st,
                   "node_phase_cycles": st["node_cycles"] / max(1, st["node_phases"]),
                   "tri_active_phase_cycles":
                       st["tri_active_cycles"] / max(1, st["tri_active_phases"]),
                   "tri_first_cycles_per_phase":
                       st["tri_first_cycles"] / max(1, st["tri_active_phases"]),
                   "tri_idle_phase_cycles": st["tri_idle_cycles"] / max(1, tri_idle),
                   "triangles_per_active_phase":
                       st["triangles"] / max(1, st["tri_active_phases"]),
                   "warp_iteration_cycles": (spent + st["vote_cycles"]) / warp_iters,
                   "vote_share": st["vote_cycles"] / max(1, spent + st["vote_cycles"])}
            row["ms_counters_on"] = probes.median_ms(
                probes.device_ms, lambda: launch(lib, gt, wave, v, args.iters))["ms"]
            row["ms_counters_off"] = probes.median_ms(
                probes.device_ms, lambda: gang.ablate_kernel(gt, wave, v, args.iters))["ms"]
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
