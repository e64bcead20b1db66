"""Build and load the port's CUDA kernels.

The sources under `gpu_raytracer_tpu_torch/csrc/` are compiled with `nvcc`
for Hopper (`sm_90a`), one `nvcc` per source, all started together, and
linked into ONE shared library with a plain C interface, loaded with ctypes.
The build runs at first use (never at import), writes into
`.cache/torch_kernels/` at the repository root, and reruns when a source or
a shared header is newer than the library (checked once per process, at the
first load). Nothing here falls back: a missing `nvcc` or a
failed compile raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".cache", "torch_kernels")
SOURCES = ("wide_traverse.cu", "shade_gather.cu", "svgf_stencil.cu",
           "binary_traverse.cu", "fused_shade.cu", "stream_traverse.cu",
           "probe_gang.cu", "probe_fetch.cu", "probe_block.cu", "probe_read.cu",
           "probe_prims.cu", "probe_dma.cu")
# Included by shade_gather.cu and fused_shade.cu; by wide_traverse.cu,
# stream_traverse.cu and probe_gang.cu; by wide_traverse.cu and
# stream_traverse.cu (the persistent-warp walk); by every source with a
# `*_kernel_info` (the compiler's and the occupancy API's report).
HEADERS = ("shade_common.cuh", "wide_common.cuh", "wide_walk.cuh", "kernel_report.cuh")
LIB_NAME = "libgpu_raytracer_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: no a*b+c -> fma contraction, so the kernels round like their
# plain PyTorch versions (contracted Moller-Trumbore terms moved barycentrics
# by up to 4.6e-4 on the H100, beyond the 1e-4 parity bar).
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC")

_lib = None


def source_paths() -> list:
    return [os.path.join(CSRC_DIR, s) for s in SOURCES]


def library_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def find_nvcc() -> str:
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def is_stale() -> bool:
    lib = library_path()
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    deps = source_paths() + [os.path.join(CSRC_DIR, h) for h in HEADERS]
    return any(os.path.getmtime(s) > built for s in deps)


def _run(cmds: list) -> str:
    """Run the commands at once; raise on the first that fails. Returns
    their stderr, joined."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    logs, failed = [], None
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                      f"{out}\n{err}")
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def build(force: bool = False, ptxas_verbose: bool = False) -> dict:
    """Compile the library if it is missing or stale: every source to an
    object at once, then one link. Returns {"built": bool, "seconds": float,
    "log": compiler stderr}."""
    if not (force or is_stale()):
        return {"built": False, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f".tmp{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + tag + ".o")
            for s in SOURCES]
    verbose = ["-Xptxas", "-v"] if ptxas_verbose else []
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, *verbose, "-c", "-o", obj, src]
                    for obj, src in zip(objs, source_paths())])
        tmp = library_path() + tag
        log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, library_path())
    return {"built": True, "seconds": time.perf_counter() - t0, "log": log}


def load() -> ctypes.CDLL:
    """The loaded library. The first call builds it if it is missing or
    stale, binds the C signatures and checks the library's layout constants
    against the Python side; later calls return the same handle."""
    global _lib
    if _lib is not None:
        return _lib
    from gpu_raytracer_tpu_torch.ops import (
        binary_traverse,
        fused_shade,
        shade_gather,
        stream_traverse,
        svgf_stencil,
        wide_traverse,
    )
    from gpu_raytracer_tpu_torch.probes import block, dma, fetch, gang, prims, read

    build()
    lib = ctypes.CDLL(library_path())
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wt_stack_capacity.restype = ci
    lib.wt_stack_capacity.argtypes = []
    lib.wt_num_stats.restype = ci
    lib.wt_num_stats.argtypes = []
    lib.wt_trace.restype = ci
    lib.wt_trace.argtypes = [ci, ci, vp, vp, ci, vp, vp, vp, ci, vp, vp, vp, vp, vp,
                            vp, vp, vp, vp]
    lib.wt_kernel_info.restype = ci
    lib.wt_kernel_info.argtypes = [ci, ci, vp]
    for fn in (lib.sg_num_fields, lib.sg_row_floats):
        fn.restype = ci
        fn.argtypes = [ci]
    lib.sg_shade.restype = ci
    lib.sg_shade.argtypes = [ci, vp, vp, vp, ci, vp, vp, ci, vp]
    lib.sg_kernel_info.restype = ci
    lib.sg_kernel_info.argtypes = [ci, vp]
    lib.sv_variance.restype = ci
    lib.sv_variance.argtypes = [vp, vp, vp, ci, ci, cf, cf, ci, cf, vp]
    lib.sv_atrous.restype = ci
    lib.sv_atrous.argtypes = [vp, vp, vp, ci, ci, ci, cf, cf, ci, cf, vp]
    lib.sv_kernel_info.restype = ci
    lib.sv_kernel_info.argtypes = [ci, vp]
    lib.sv_variance_static_pow.restype = ci
    lib.sv_variance_static_pow.argtypes = []
    lib.bt_stack_depth.restype = ci
    lib.bt_stack_depth.argtypes = []
    lib.bt_trace.restype = ci
    lib.bt_trace.argtypes = [ci, vp, vp, vp, ci, vp, vp, vp, ci, vp, vp, vp, vp,
                             vp, vp, vp, vp]
    lib.bt_kernel_info.restype = ci
    lib.bt_kernel_info.argtypes = [ci, vp]
    lib.fs_num_fields.restype = ci
    lib.fs_num_fields.argtypes = [ci]
    lib.fs_shade.restype = ci
    lib.fs_shade.argtypes = [vp, vp, vp, ci, vp, ci, ci, ci, ci, ci, vp]
    lib.fs_kernel_info.restype = ci
    lib.fs_kernel_info.argtypes = [vp]
    lib.fs_row_floats.restype = ci
    lib.fs_row_floats.argtypes = [ci]
    for fn in (lib.st_window, lib.st_stack_capacity, lib.st_portal_base, lib.st_root_bits):
        fn.restype = ci
        fn.argtypes = []
    lib.st_resident.restype = ci
    lib.st_resident.argtypes = [ci, vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.st_page.restype = ci
    lib.st_page.argtypes = [ci, vp, ci, vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp]
    lib.st_kernel_info.restype = ci
    lib.st_kernel_info.argtypes = [ci, ci, vp]
    lib.pg_layout.restype = lib.pf_layout.restype = ci
    lib.pg_layout.argtypes = lib.pf_layout.argtypes = [ci]
    lib.pg_ablate.restype = ci
    lib.pg_ablate.argtypes = [ci, vp, ci, ci, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp]
    lib.pg_kernel_info.restype = ci
    lib.pg_kernel_info.argtypes = [ci, vp]
    lib.pg_micro.restype = ci
    lib.pg_micro.argtypes = [ci, vp, ci, vp, ci, ci, vp, vp]
    lib.pg_micro_info.restype = ci
    lib.pg_micro_info.argtypes = [ci, vp]
    pi = ctypes.POINTER(ci)
    lib.pf_lane.restype = ci
    lib.pf_lane.argtypes = [ci, vp, ci, ci, vp, ci, ci, vp, ci, vp, pi, vp]
    lib.pf_window.restype = ci
    lib.pf_window.argtypes = [ci, vp, ci, ci, vp, ci, ci, ci, vp, ci, vp, pi, vp]
    lib.pf_col_floats.restype = ci
    lib.pf_col_floats.argtypes = [ci]
    for fn in (lib.pb_layout, lib.pr_layout, lib.pp_layout, lib.pd_layout):
        fn.restype = ci
        fn.argtypes = [ci]
    lib.pb_pop.restype = ci
    lib.pb_pop.argtypes = [vp, ci, vp, vp, ci, vp, vp]
    lib.pb_kernel_info.restype = ci
    lib.pb_kernel_info.argtypes = [vp]
    lib.pr_smem_optin.restype = ci
    lib.pr_smem_optin.argtypes = []
    lib.pr_kernel_info.restype = ci
    lib.pr_kernel_info.argtypes = [ci, ci, vp]
    lib.pr_read.restype = ci
    lib.pr_read.argtypes = [ci, ci, vp, ci, ci, ci, ci, vp, vp]
    lib.pp_gang.restype = ci
    lib.pp_gang.argtypes = [ci, vp, vp, vp, ci, ci, vp, vp]
    lib.pp_kernel_info.restype = ci
    lib.pp_kernel_info.argtypes = [ci, vp]
    lib.pd_copy.restype = ci
    lib.pd_copy.argtypes = [ci, ci, ci, vp, ci, ci, ci, ci, ci, ci, vp, ci, ci, ci, vp, vp]
    lib.pd_kernel_info.restype = ci
    lib.pd_kernel_info.argtypes = [ci, ci, ci, ci, vp]
    if lib.bt_stack_depth() != binary_traverse.STACK_DEPTH:
        raise RuntimeError("binary_traverse.cu BT_STACK != STACK_DEPTH")
    if lib.sv_variance_static_pow() != svgf_stencil.VARIANCE_STATIC_POW:
        raise RuntimeError("svgf_stencil.cu SV_POW_STATIC != VARIANCE_STATIC_POW")
    if (tuple(lib.sg_num_fields(k) for k in range(3))
            != tuple(map(len, (shade_gather.IN_FIELDS, shade_gather.OUT_FIELDS,
                               shade_gather.TAB_FIELDS)))):
        raise RuntimeError("shade_gather.cu field layout != IN_FIELDS/OUT_FIELDS/TAB_FIELDS")
    if (tuple(lib.sg_row_floats(k) for k in range(4))
            != (shade_gather.TRI_ROW, shade_gather.INST_ROW, shade_gather.MAT_ROW,
                shade_gather.LIGHT_ROW)):
        raise RuntimeError("shade_gather.cu row widths != TRI_ROW/INST_ROW/MAT_ROW/LIGHT_ROW")
    if (tuple(lib.fs_num_fields(k) for k in range(3))
            != tuple(map(len, (fused_shade.IN_FIELDS, fused_shade.OUT_FIELDS,
                               fused_shade.TAB_FIELDS)))):
        raise RuntimeError("fused_shade.cu field layout != IN_FIELDS/OUT_FIELDS/TAB_FIELDS")
    if (tuple(lib.fs_row_floats(k) for k in range(3))
            != (fused_shade.TRI_ROW, fused_shade.INST_ROW, fused_shade.LIGHT_ROW)):
        raise RuntimeError("fused_shade.cu row widths != TRI_ROW/INST_ROW/LIGHT_ROW")
    if lib.wt_stack_capacity() != wide_traverse.STACK_CAPACITY:
        raise RuntimeError("wide_traverse.cu WT_STACK != STACK_CAPACITY")
    if lib.wt_num_stats() != len(wide_traverse.STATS):
        raise RuntimeError("wide_walk.cuh WP_NUM_STATS != len(STATS)")
    if lib.st_window() != stream_traverse.K_PORTALS:
        raise RuntimeError("wide_walk.cuh WT_K != K_PORTALS")
    if lib.st_stack_capacity() != wide_traverse.STACK_CAPACITY:
        raise RuntimeError("stream_traverse.cu WT_STACK != STACK_CAPACITY")
    if lib.st_portal_base() != stream_traverse.PORTAL_BASE:
        raise RuntimeError("wide_walk.cuh WT_PORTAL_BASE != bvh.stream.PORTAL_BASE")
    if lib.st_root_bits() != stream_traverse.ROOT_BITS:
        raise RuntimeError("wide_walk.cuh WT_ROOT_BITS != stream_traverse.ROOT_BITS")
    if (lib.sg_num_fields(0) != len(shade_gather.IN_FIELDS)
            or lib.sg_num_fields(1) != len(shade_gather.OUT_FIELDS)):
        raise RuntimeError("shade_gather.cu field layout != IN_FIELDS/OUT_FIELDS")
    pg = (gang.GANGS, gang.LANES, gang.STACK_DEPTH, gang.LEAFQ_DEPTH, gang.QTRIG,
          gang.LEAF_CAP, gang.IDLE, len(gang.ABLATE_VARIANTS), len(gang.MICRO_STAGES),
          gang.MICRO_CAP, *(ctypes.c_int(gang.layer_map(x)).value
                            for x in gang.LAYERS + gang.LAYERS_HALF[-1:]),
          gang.TILE_THREADS)
    if tuple(lib.pg_layout(k) for k in range(len(pg))) != pg:
        raise RuntimeError("probe_gang.cu layout constants != probes/gang.py")
    pf = (fetch.TILE, len(fetch.LANE_MODES), len(fetch.WINDOW_MODES), fetch.ROW_LANES,
          len(fetch.LANE_PATHS))
    if tuple(lib.pf_layout(k) for k in range(len(pf))) != pf:
        raise RuntimeError("probe_fetch.cu layout constants != probes/fetch.py")
    for src, fn, want in (
            ("probe_block.cu", lib.pb_layout,
             (block.LANES, block.ROW, block.STACK, block.SP_CAP, block.CLUSTER)),
            ("probe_read.cu", lib.pr_layout,
             (read.SHAPE[0] * read.SHAPE[1], len(read.READ_BODIES), len(read.SPACES),
              read.STRIDE, read.CHUNK)),
            ("probe_prims.cu", lib.pp_layout,
             (prims.GANGS, prims.LANES, prims.STACK, len(prims.PRIMS_BODIES), prims.STRIDE,
              prims.CHUNK, prims.PATH_MAX_ROWS, prims.RUN, prims.PATH_THREADS, prims.WALK)),
            ("probe_dma.cu", lib.pd_layout,
             (dma.TILE, len(dma.MECHS), len(dma.OFFSETS), len(dma.OUTS)))):
        if tuple(fn(k) for k in range(len(want))) != want:
            raise RuntimeError(f"{src} layout constants != probes/{src[6:-3]}.py")
    _lib = lib
    return lib


def ptxas_report(log: str, match: str) -> dict:
    """{kernel: [ptxas lines]} from a build log of `build(ptxas_verbose=True)`:
    the register, spill and stack-frame lines of each kernel whose mangled
    name contains `match`, under its demangled name where `c++filt` is
    there."""
    import re

    rows, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", ln)
        if m:
            fn = m.group(1)
            continue
        if fn and match in fn and ("registers" in ln or "stack frame" in ln):
            rows.setdefault(fn, []).append(re.sub(r"\s+", " ", ln.split(":", 1)[-1]).strip())
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(rows), capture_output=True,
                               text=True).stdout.split("\n")
        rows = {re.sub(r"\(.*", "", n): v for n, v in zip(names, rows.values())}
    return rows


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
