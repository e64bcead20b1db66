#!/usr/bin/env python3
"""The launch floor on the H100: an empty kernel timed as the probes are
timed (`probes.probe_ms`), beside the probes that do about one launch's
work: `pr_read<ceiling>` (one launch at the shared-memory ceiling) and
`pd_copy`'s one-copy bodies (every body but the 16 KB-window loops).

    python3 tools/torch_launch_floor.py                    # on the card

Builds tools/launch_floor.cu with nvcc and the port's flags into a library
of its own under the kernels' build directory, times the empty kernel in
each probe's launch shape (one block of 128 threads; one of 1,024; one of
1,024 with the ceiling's dynamic shared memory; a cluster of two blocks of
1,024), then the probes, each held to its plain version first. Prints the
card, one JSON line an empty shape and one a probe with its gap to the
empty kernel of its shape (`gap_ms`, `ratio`). Needs the card and nvcc.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "launch_floor.cu")
# name -> (blocks, threads, cluster); "ceiling" also takes the ceiling's bytes.
SHAPES = {"1x128": (1, 128, 1), "1x1024": (1, 1024, 1), "ceiling": (1, 1024, 1),
          "cluster2x1024": (2, 1024, 2)}


def build(workdir: str) -> ctypes.CDLL:
    """tools/launch_floor.cu as a library of its own (nvcc, the port's flags)."""
    from gpu_raytracer_tpu_torch.ops import _native

    lib_path = os.path.join(workdir, "liblaunch_floor.so")
    subprocess.run([_native.find_nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", lib_path,
                    SOURCE], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.lf_prepare.restype = ci
    lib.lf_prepare.argtypes = [ci]
    lib.lf_launch.restype = ci
    lib.lf_launch.argtypes = [ci, ci, ci, ci, vp]
    return lib


def main(argv=None) -> int:
    import torch

    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.ops import _native
    from gpu_raytracer_tpu_torch.probes import c_stream, dma, read

    if not torch.cuda.is_available():
        print("torch_launch_floor: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(json.dumps({"card": probes.card()}), flush=True)
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="launch_floor_", dir=_native.BUILD_DIR)
    try:
        lib = build(workdir)
        x = torch.rand(read.SHAPE, device="cuda")
        ceiling = read.smem_ceiling(x, timer=probes.probe_ms)
        stream = c_stream(x.device)
        floor = {}
        for name, (blocks, threads, cluster) in SHAPES.items():
            smem = ceiling["ceiling_bytes"] if name == "ceiling" else 0
            _native.check(lib.lf_prepare(smem), "lf_prepare")

            def launch(b=blocks, t=threads, s=smem, c=cluster):
                _native.check(lib.lf_launch(b, t, s, c, stream), f"lf_empty {name}")

            floor[name] = probes.median_ms(probes.probe_ms, launch)
            print(json.dumps({"kernel": "lf_empty", "shape": name, "blocks": blocks,
                              "threads": threads, "cluster": cluster, "smem_bytes": smem,
                              **floor[name]}), flush=True)

        def gap(row: dict, shape: str) -> dict:
            f = floor[shape]["ms"]
            return {**row, "floor_shape": shape, "floor_ms": f, "gap_ms": row["ms"] - f,
                    "ratio": row["ms"] / f}

        print(json.dumps(gap({"kernel": "pr_read", "body": "ceiling",
                              "smem_bytes": ceiling["ceiling_bytes"], "ms": ceiling["ms"]},
                             "ceiling")), flush=True)
        one_copy = [b for b in dma.BODIES if b not in dma.WINDOW_BODIES]
        for r in dma.probe_copies("cuda", timer=probes.probe_ms, bodies=one_copy):
            row = {k: r[k] for k in ("kernel", "body", "mech", "cluster", "ms", "ms_spread")}
            print(json.dumps(gap(row, "cluster2x1024" if r["cluster"] else "1x128"),
                             default=bool), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
