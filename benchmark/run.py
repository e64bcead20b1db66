#!/usr/bin/env python3
"""Run one cell of the benchmark of `gpu_raytracer_tpu_torch` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the NVIDIA GPUs the cell
asks for. One run: build the cell's scene from its configuration file,
build the port's tables (`Pathtracer.init_device`), warm up as the traffic
file says, run the traffic for `--seconds`, then (with `--trace 1`)
profile a few more units; free the program, check what the window
produced against the plain reference (`benchmark/harness/check.py`), print
each number compared beside its limit on standard error, and print the
result as one JSON line, the last of standard output. With `--trace 0`
the line carries the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics. Exits 2 without a result where the GPUs are missing,
and 3 where a forbidden module (JAX, the JAX package) was loaded.
"""

from __future__ import annotations

import os
import time

_T0 = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (Linux /proc clock ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


_AGE0 = _process_age_s()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def since_start_s() -> float:
    return _AGE0 + time.perf_counter() - _T0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_program(config: dict, traffic: dict, data, seed: int, device: str):
    """The port's Pathtracer for the cell, tables not built yet."""
    from benchmark.harness import scene as scene_mod
    from gpu_raytracer_tpu_torch.config import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer

    gpu = GPUConfig(num_bounces=int(traffic["bounces"]),
                    enable_svgf=traffic["mode"] == "denoised", **traffic.get("gpu", {}))
    cpu = CPUConfig(seed=int(seed), batch_size=int(config["batch_size"]))
    return Pathtracer(scene_mod.to_port(data), cpu, gpu, device=device)


def _spans(program):
    """Wrap the denoised path's two halves in the benchmark's own profiler
    ranges for the traced slice; -> a function that unwraps them."""
    import torch

    saved = {}
    for name in ("trace_aovs", "denoise"):
        fn = getattr(program, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def wrapped(*args, _fn=fn, _name=name, **kw):
            with torch.profiler.record_function(f"bench.{_name}"):
                return _fn(*args, **kw)

        setattr(program, name, wrapped)

    def undo():
        for name, fn in saved.items():
            setattr(program, name, fn)
    return undo


def _walk_visits(rs, basis, W: int, H: int, chunk: int) -> dict:
    """The node and triangle tests of the reference's walk for a primary
    ray through every pixel (the Gaussian filter's jitter, a fixed seed)."""
    import torch

    from benchmark.reference import pathtrace as ref

    dev = rs.device
    walk = {"rays": W * H}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for s in range(0, W * H, chunk):
        p = torch.arange(s, min(s + chunk, W * H), device=dev)
        jx, jy = ref.gaussian_jitter(p.numel(), gen, dev)
        o, d = ref.camera_rays(basis, (p % W).double() + jx, (p // W).double() + jy, rs.dtype)
        ref.bvh.trace(rs.tree, o, d, torch.full((p.numel(),), float("inf"), device=dev),
                      stats=walk)
    return walk


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", plant=None, make_program=None) -> dict:
    """One run of `workload`; -> {"result": the result object, "limits":
    [(name, value, limit)], "forbidden": [module names]}. `plant(program)`
    breaks the timed path (tests of the check); `make_program` replaces
    `build_program` (the control)."""
    import torch

    from benchmark.harness import check, guard, host, profile
    from benchmark.harness import scene as scene_mod
    from benchmark.harness.spec import Spec
    from benchmark.harness.traffic import Loop
    from benchmark.reference import pathtrace as ref
    from benchmark.reference import svgf as ref_svgf

    spec = Spec(root)
    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    dev = torch.device(device)
    data = scene_mod.build(config)
    program = (make_program or build_program)(config, traffic, data, seed, device)
    t = time.perf_counter()
    program.init_device()
    _sync(dev)
    tables_s = time.perf_counter() - t
    undo = plant(program) if plant is not None else None
    loop = Loop(program, traffic)
    loop.warm()
    setup_s = since_start_s()
    host0 = host.snapshot()
    window_s = loop.window(seconds)
    host_line = host.over(host0, host.snapshot(), len(loop.times_s))
    unit_times = list(loop.times_s)
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    traced = None
    if trace:
        unwrap = _spans(program)
        traced = profile.trace_slice(loop.step, int(traffic["trace_units"]),
                                     ranges=("bench.trace_aovs", "bench.denoise"))
        unwrap()
    frames = loop.recorded_frames(2) if loop.mode == "denoised" else None
    if undo is not None:
        undo()
    forbidden = guard.forbidden_modules()
    H, W = data.height, data.width
    bounces = int(traffic["bounces"])
    if loop.mode == "batch":
        outputs = {"image": program.accumulator.view(H, W, 3), "samples": loop.samples,
                   "bad": int(program.magenta_pixels)}
    else:
        outputs = {"frames": frames, "bad": int(program.magenta_pixels)}
    del program, loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    rs = ref.RefScene(scene_mod.world_triangles(data), dev, torch.float32)
    params = traffic["check"]
    cam = data.camera
    basis = scene_mod.camera_basis(cam, W, H)
    if traffic["mode"] == "batch":
        numbers = check.check_batch(outputs["image"], outputs["samples"], outputs["bad"], rs,
                                    basis, bounces, params, seed)
    else:
        numbers = check.check_denoised(
            outputs["frames"], outputs["bad"], rs, basis,
            ref_svgf.view_projection(cam, cam["position"], W, H),
            bounces, ref_svgf.settings_of(traffic.get("gpu", {})), params, seed)
    correct, rows = check.judge(numbers, traffic["limits"])
    print(host_line, file=sys.stderr)
    print(f"benchmark: {workload}: {len(unit_times)} units in {window_s:.3f} s; set-up "
          f"{setup_s:.3f} s (tables {tables_s:.3f} s); the check took "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    walk = _walk_visits(rs, basis, W, H, int(params["chunk"])) if trace else None
    units = len(unit_times)
    ctx = {"mode": traffic["mode"], "setup_s": setup_s, "window_s": window_s, "units": units,
           "unit_times_s": unit_times,
           "tables_s": tables_s, "trace": traced, "walk": walk, "film": (H, W),
           "gpu": traffic.get("gpu", {})}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(kind, workload):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": memory_peak}
    if traced is not None:
        dev_info["busy_s"] = traced["busy_s"]
        dev_info["window_s"] = traced["wall_s"]
    result = {"correct": bool(correct), "attempted": units, "failed": 0 if correct else units,
              "metrics": metrics, "device": dev_info}
    if traced is not None:
        result["breakdown"] = traced["breakdown"]
    result["limits"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return {"result": result, "limits": rows,
            "forbidden": sorted(set(forbidden) | set(guard.forbidden_modules()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness.spec import Spec

    chips = int(Spec(ROOT).workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    if out["forbidden"]:
        print(f"benchmark: forbidden modules loaded: {out['forbidden']}", file=sys.stderr)
        return 3
    for name, value, limit in out["limits"]:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
