#!/usr/bin/env python3
"""The price of one cluster barrier on the H100, and of the hit-mask
exchange that `pb_pop` runs once a pop, by cluster size.

    python3 tools/torch_cluster_barrier.py                 # on the card
    python3 tools/torch_cluster_barrier.py --sizes 1,8 --iters 20000

Builds tools/cluster_barrier.cu with nvcc and the port's flags into a
library of its own under the kernels' build directory, then, for each
cluster size (the probe's 1,024 lanes spread over that many blocks) and
each mode (`syncthreads`, `barrier`, `relaxed`, `exchange`, `mbar`,
`flags`, `async`: see the source), times a launch of --iters iterations
and one of none (CUDA events over 5 x 3 launches behind a device spin) and
prints the card and one JSON line a case: ns an iteration, the difference
of the two over --iters. Needs the card and nvcc.
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

MODES = ("syncthreads", "barrier", "relaxed", "exchange", "mbar", "flags", "async")
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cluster_barrier.cu")


def build(workdir: str) -> ctypes.CDLL:
    """tools/cluster_barrier.cu as a library of its own (nvcc, the port's
    flags)."""
    from gpu_raytracer_tpu_torch.ops import _native

    lib_path = os.path.join(workdir, "libcluster_barrier.so")
    subprocess.run([_native.find_nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", lib_path,
                    SOURCE], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.cb_run.restype = ci
    lib.cb_run.argtypes = [ci, ci, ci, vp, vp]
    return lib


def main(argv=None) -> int:
    import torch

    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.ops import _native
    from gpu_raytracer_tpu_torch.probes import c_ptr, c_stream

    ap = argparse.ArgumentParser(prog="torch_cluster_barrier", description=__doc__)
    ap.add_argument("--sizes", default="1,2,4,8,16", help="cluster sizes")
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_cluster_barrier: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(json.dumps({"card": probes.card()}), flush=True)
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="cluster_barrier_", dir=_native.BUILD_DIR)
    out = torch.empty(1024, dtype=torch.int32, device="cuda")
    try:
        lib = build(workdir)
        for size in (int(x) for x in args.sizes.split(",")):
            for mode in MODES:
                def run(iters, m=MODES.index(mode), n=size):
                    err = lib.cb_run(m, n, iters, c_ptr(out), c_stream(out.device))
                    if err:
                        raise RuntimeError(f"cb_run({mode}, {n}): cudaError_t {err}")

                ms = {k: probes.median_ms(lambda f: probes.device_ms(f, 3, 5),
                                          lambda k=k: run(k))["ms"] for k in (args.iters, 0)}
                print(json.dumps({"cluster": size, "threads": 1024 // size, "mode": mode,
                                  "iters": args.iters, "ms": ms[args.iters], "ms_empty": ms[0],
                                  "ns_per_iter": 1e6 * (ms[args.iters] - ms[0]) / args.iters}),
                      flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
