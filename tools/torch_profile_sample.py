#!/usr/bin/env python3
"""Where one warm sample of the PyTorch/CUDA port spends its time.

    python3 tools/torch_profile_sample.py [merged|instanced|denoised|small|small_wide|
                                           small1080|small1080_wide|stream|mixed|
                                           mixed_untextured|media|media_cornell ...]

For each cell (default: all twelve): build the tables, render 5 warm samples
(or denoised frames), each timed unprofiled (host clock to a synchronize),
then one more under `torch.profiler`. Prints, per scene, the wall time of
the profiled sample, the device busy time (the union of the device
intervals in that sample's trace) and the idle share, the host launch
count, and the device time by kernel name, largest first; then one JSON
line with the same numbers. The port's own kernels are listed whether or
not they are among the largest. The cells are chip_smoke.py's: the
procedural room (merged tables, 3 bounces), the instanced field (two-level
tables, 4 bounces), the procedural room's denoised frame (SVGF + TAA,
`render_frame_denoised`), all at 1920x1080, and the small scene: the Cornell
stand-in at 512x512, 6 bounces, on the binary kernel with the fused shade
(`small`), and at 1920x1080, 3 bounces, on the binary kernel with K3
(`small1080`, route (b)); and, for comparison, each on the wide route
(`small_wide`, `small1080_wide`: the binary tables withheld); and the
streamed scene (`stream`: the room with one subdivision-8 icosphere
instanced three times, 3,932,174 triangles on paged tables, 1920x1080, 3
bounces; about a minute and a half of cold host build); and the mixed
scene (`mixed`: `scenes.mixed_scene(1920, 1080, 6, True)`, every BSDF and
three textures, merged tables, 3 bounces; `mixed_untextured`: the same
materials without textures); and the media scenes (`media`:
`scenes.media_scene(1920, 1080, 6)`, three glass spheres holding media,
merged tables, 6 bounces; `media_cornell`: `scenes.media_cornell(512, 512)`,
6 bounces, route (b)). Needs an NVIDIA GPU; imports only the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = 5
TOP = 12
# The port's kernels (csrc/; wt_walk_kernel also runs K6's passes).
OWN = ("wt_walk_kernel", "sg_shade_kernel", "sv_variance_kernel",
       "sv_atrous_kernel", "bt_trace_kernel", "fs_shade_kernel")


def _kernels_under(event) -> list:
    """The device kernels launched by the ops under a host event."""
    return list(event.kernels) + [k for ch in event.cpu_children for k in _kernels_under(ch)]


def profile_sample(step, ranges=()) -> dict:
    """Profile one call of `step` (a sample or a denoised frame) after WARM.
    For each name in `ranges` (a `torch.profiler.record_function` range),
    also its calls and the launches and device ms of the kernels the ops
    under it launched ("ranges")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    warm_ms = []
    for _ in range(WARM):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        warm_ms.append(1000.0 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    device, launch_us, launches = [], 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(e)
        elif e.name == "cudaLaunchKernel":
            launches += 1
            launch_us += e.time_range.end - e.time_range.start
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1000.0
        by_name[e.name][1] += 1
    annotated = {name: [e for e in prof.events()
                        if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
                 for name in ranges}
    # (A range's own device span, where the profiler records one, is no kernel.)
    kernels = {name: [k for e in es for k in _kernels_under(e) if k.name != name]
               for name, es in annotated.items()}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    top = ranked[:TOP] + [kv for kv in ranked[TOP:]
                          if any(k in kv[0] for k in OWN)]
    return {"warm_ms": warm_ms, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1000.0,
            "idle_share": 1.0 - busy_us / 1000.0 / wall_ms,
            "device_events": len(device), "host_launches": launches,
            "host_launch_ms": launch_us / 1000.0,
            "top": [{"name": n, "ms": v[0], "count": v[1]} for n, v in top],
            "ranges": {name: {"calls": len(annotated[name]), "launches": len(ks),
                              "device_ms": sum(k.duration for k in ks) / 1000.0}
                       for name, ks in kernels.items()}}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.scenes import (
        cornell_scene,
        instanced_scene,
        media_cornell,
        media_scene,
        mixed_scene,
        procedural_scene,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    makers = {"merged": (lambda: procedural_scene(1920, 1080, 6), 3, False),
              "instanced": (lambda: instanced_scene(1920, 1080), 4, False),
              "denoised": (lambda: procedural_scene(1920, 1080, 6), 3, True),
              "small": (lambda: cornell_scene(512, 512), 6, False),
              "small_wide": (lambda: cornell_scene(512, 512), 6, False),
              "small1080": (lambda: cornell_scene(1920, 1080), 3, False),
              "small1080_wide": (lambda: cornell_scene(1920, 1080), 3, False),
              "stream": (lambda: procedural_scene(1920, 1080, 8, shared_sphere=True), 3,
                         False),
              "mixed": (lambda: mixed_scene(1920, 1080, 6, True), 3, False),
              "mixed_untextured": (lambda: mixed_scene(1920, 1080, 6, False), 3, False),
              "media": (lambda: media_scene(1920, 1080, 6), 6, False),
              "media_cornell": (lambda: media_cornell(512, 512), 6, False)}
    out = {"device": smi}
    for key in argv or list(makers):
        make, bounces, svgf = makers[key]
        pt = Pathtracer(make(), CPUConfig(),
                        GPUConfig(num_bounces=bounces, enable_svgf=svgf),
                        device="cuda")
        pt.init_device()
        if key.endswith("_wide"):
            pt.buffers["binary"] = None  # Pathtracer.route() falls back to "wide"
        r = profile_sample(pt.render_frame_denoised if svgf else pt.render)
        r["route"] = pt.route(svgf)
        out[key] = r
        print(f"[{key}] {smi}: route {r['route']}; unprofiled warm samples "
              f"{', '.join(f'{x:.2f}' for x in r['warm_ms'])} ms; profiled: wall "
              f"{r['wall_ms']:.2f} ms, device busy "
              f"{r['device_busy_ms']:.2f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['device_events']} device events, {r['host_launches']} "
              f"cudaLaunchKernel calls ({r['host_launch_ms']:.2f} ms host)", flush=True)
        for t in r["top"]:
            print(f"[{key}]   {t['ms']:9.3f} ms {t['count']:6d}x  {t['name'][:110]}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
