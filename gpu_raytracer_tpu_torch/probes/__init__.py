"""Hopper counterparts of the JAX package's TPU probes (`tools/exp_*.py`).

The probes are instruments, not render paths: no `Pathtracer` route calls
them. Each module holds a plain PyTorch version of what a probe's Pallas
kernel computes and a wrapper that launches the hand-written CUDA kernel on
a CUDA tensor (and raises if it cannot); on a CPU tensor the wrapper runs
the plain version. The entry points are `tools/torch_exp_*.py`, named after
the JAX tools, and `chip_smoke.py` phase 3pr.

  gang   tools/exp_gang_ablate.py, exp_gang_micro.py: the fixed-iteration
         gang traversal (8 gangs x 128 lanes per 1024-ray tile, one stack
         per gang) and its ablation variants; csrc/probe_gang.cu
  fetch  tools/exp_gather.py, exp_gather2.py: per-lane table fetches, in
         place and through a staged window; csrc/probe_fetch.cu
  block  tools/exp_blocksync.py: the block-synchronous pop loop (one stack
         per 1024-lane tile); csrc/probe_block.cu
  read   tools/exp_scalar_read.py, exp_vmem2.py (and exp_blocksync.py's
         VMEM probe): single-element reads by table layout, a dynamic roll,
         the shared-memory ceiling; csrc/probe_read.cu
  prims  tools/exp_gang_prims.py, exp_gang_prims2.py: 8-gang primitives
         and dependent row loads; csrc/probe_prims.cu
  dma    tools/exp_dma.py, exp_dma2.py, exp_dma3.py, exp_dma4.py: copies at
         a dynamic offset by cp.async or the TMA bulk copy; csrc/probe_dma.cu
"""

from __future__ import annotations

import argparse
import ctypes

# H100 SXM peaks (NVIDIA data sheet): HBM rate and fp32 outside tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# The merged cell (PERF.md section 4): procedural_scene(1920, 1080, 6), 245,774
# triangles in merged wide tables, 3 bounces.
CELL = (1920, 1080, 6)
BOUNCES = 3


def pointwise_ops(fn) -> int:
    """Elements produced by pointwise PyTorch operations while `fn` runs
    (selects and casts included): a plain version's operation count."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                for o in (out if isinstance(out, (tuple, list)) else (out,)):
                    if torch.is_tensor(o):
                        Count.n += o.numel()
            return out

    with Count():
        fn()
    return Count.n


def merged_cell(width: int = CELL[0], height: int = CELL[1], subdiv: int = CELL[2],
                device: str = "cuda"):
    """The merged cell's `Pathtracer` (procedural room with three icospheres
    of `subdiv` subdivisions), its tables built on `device`."""
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    pt = Pathtracer(procedural_scene(width, height, subdiv), CPUConfig(),
                    GPUConfig(num_bounces=BOUNCES), device=device)
    pt.init_device()
    if pt.route() != "wide" or pt.buffers["wide"].two_level:
        raise RuntimeError(f"the cell takes route {pt.route()}, not merged wide tables")
    return pt


def bounce1(pt) -> dict:
    """The bounce-1 wave of sample 0 as `render_wave` traces it (captured
    with `parity.capture_wave`: the wave K2 takes): the unified gang table,
    the wide tables, the rays (o, d, t_max), the shade rows and the wave's
    hit triangles (leaf-order ids, -1 on a miss) as the glue fetches them;
    and the primary wave's rays, the coherent one (K1 takes it)."""
    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
    from gpu_raytracer_tpu_torch.probes import gang

    wave = min(pt.cpu_config.batch_size, pt.width * pt.height)
    got = parity.capture_wave(pt, wave)
    (tables, o, d, tm), _ = got["closest"]
    hit_tri, _ = wt.decode_prim(pt.buffers["prim_map"], DISPATCH.closest(tables, o, d, tm).tri)
    return {"gt": gang.gang_table(tables), "tables": tables, "wave": (o, d, tm),
            "shade_rows": pt.buffers["shade_rows"], "hit_tri": hit_tri,
            "primary": got["primary"][0][1:]}


def arguments(prog: str, doc: str, iters: int, tiles: int) -> argparse.ArgumentParser:
    """The entry points' common options."""
    ap = argparse.ArgumentParser(prog=prog, description=doc)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--width", type=int, default=CELL[0])
    ap.add_argument("--height", type=int, default=CELL[1])
    ap.add_argument("--subdiv", type=int, default=CELL[2], help="icosphere subdivisions")
    ap.add_argument("--iters", type=int, default=iters, help="fixed iterations")
    ap.add_argument("--tiles", type=int, default=tiles, help="1024-ray tiles")
    return ap


def c_ptr(x) -> ctypes.c_void_p:
    """A tensor's data pointer for a C entry point (None: a null pointer)."""
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def c_stream(device) -> ctypes.c_void_p:
    """The current CUDA stream of `device` for a C entry point."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def plain_on_card(plain) -> tuple:
    """(result, device ms) of one call of a plain version on the card."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = plain()
    stop.record()
    torch.cuda.synchronize()
    return ref, start.elapsed_time(stop)


def median_ms(timer, fn) -> dict:
    """{"ms": the median of `timer(fn)`, "ms_spread": [least, most]}."""
    ms = sorted(timer(fn))
    return {"ms": ms[len(ms) // 2], "ms_spread": [ms[0], ms[-1]]}


def bound(num_bytes: int, ops: int) -> tuple:
    """(bound ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over the fp32 rate."""
    b_ms, o_ms = 1e3 * num_bytes / PEAK_BYTES_S, 1e3 * ops / PEAK_FP32_S
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def card() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 10, repeats: int = 7, spin: bool = True) -> list:
    """Device ms per call of `fn` on the current CUDA device, as `repeats`
    means of `reps` back-to-back calls (CUDA events), after one warm-up
    call. With `spin`, a ~20 ms device spin is queued before each start
    event, so the host has enqueued the calls before the device reaches
    them (a kernel shorter than its wrapper's host cost is timed on the
    device)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(40_000_000)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return out


LONG_MS = 10.0


def probe_ms(fn) -> list:
    """`device_ms` for a call that may be long: 7 x 10 calls behind a spin,
    or 3 single calls without one where a first call takes over LONG_MS
    (the host enqueues a call long before the device ends the one ahead)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    if start.elapsed_time(stop) > LONG_MS:
        return device_ms(fn, 1, 3, spin=False)
    return device_ms(fn)
