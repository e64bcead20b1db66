#!/usr/bin/env python3
"""What a single-element read costs on the H100, by node-table layout, and
how much shared memory one block gets: the port's counterpart of the TPU
probes tools/exp_scalar_read.py (bodies A-E), tools/exp_vmem2.py (the
dynamic roll and the VMEM ceiling) and tools/exp_blocksync.py's VMEM probe.

    python3 tools/torch_exp_scalar_read.py                   # on the card
    python3 tools/torch_exp_scalar_read.py --device cpu --n 4096 --pops 4

Runs every body of probes/read.py (`pr_read`: one 1024-thread block that
gathers the values in parallel, sums each pop's on a thread and chains the
sums on one) at the probes' sizes (N = 40,000,
256 pops; inputs from seeded numpy), the roll in both spaces (read in
place through `__ldg`, or staged into shared memory; the other tables do
not fit one block). On the card each launch is held to its plain version
(bit-equal) and timed (CUDA events over 7 x 10 launches behind a device
spin), with ns a pop as the JAX tools print it, beside one `index_select`
of the values read and one `embedding_bag` summing them, and the bound;
then the shared-memory ceiling: the
largest dynamic shared memory a launch gets, against the device attribute,
and the launch at that size timed.
Prints the card and one JSON line a body. On the CPU the plain versions run
and no time or ceiling is printed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.probes import read

    ap = argparse.ArgumentParser(prog="torch_exp_scalar_read", description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=read.N, help="nodes (a multiple of 8)")
    ap.add_argument("--pops", type=int, default=read.POPS)
    args = ap.parse_args(argv)
    timer = None
    if args.device != "cpu":
        timer = probes.device_ms
        print(json.dumps({"card": probes.card()}), flush=True)
    for row in read.probe_reads(args.device, args.pops, args.n, timer=timer):
        if row["ms"] is not None:
            row["bound_ms"], row["bound_by"] = probes.bound(row["bytes"], row["ops"])
        print(json.dumps(row), flush=True)
    if args.device != "cpu":
        import torch

        x = torch.rand(read.SHAPE, device=args.device)
        ceiling = read.smem_ceiling(x, timer)
        print(json.dumps({"kernel": "pr_read", "body": "ceiling", **ceiling}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
