#!/usr/bin/env python3
"""What one stack for a whole 1024-lane tile costs on the H100: the port's
counterpart of the TPU probe tools/exp_blocksync.py (its pop loop; its VMEM
ladder is tools/torch_exp_scalar_read.py's shared-memory ceiling).

    python3 tools/torch_exp_blocksync.py                     # on the card
    python3 tools/torch_exp_blocksync.py --device cpu --n 256 --pops 4

Runs the block-synchronous pop loop (probes/block.py, `pb_pop`: the
tile's 1,024 lanes over a cluster of blocks, every warp replaying the
stack) at the probe's size (an
(N, 64) table, 20,000 rows, 256 pops; inputs from seeded numpy) on the
probe's own table and on the table scaled by 1e29 (where best_t varies).
On the card the kernel is held to its plain version (bit-equal) and timed
(CUDA events over 7 x 10 launches behind a device spin), with ns a pop as
the JAX tool prints it and the bound. Prints the card and one JSON line a
table. On the CPU the plain versions run and no time is printed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.probes import block

    ap = argparse.ArgumentParser(prog="torch_exp_blocksync", description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=block.N, help="table rows")
    ap.add_argument("--pops", type=int, default=block.POPS)
    args = ap.parse_args(argv)
    timer = None
    if args.device != "cpu":
        timer = probes.device_ms
        print(json.dumps({"card": probes.card()}), flush=True)
    for row in block.probe_pops(args.device, args.pops, args.n, timer=timer):
        if row["ms"] is not None:
            row["bound_ms"], row["bound_by"] = probes.bound(row["bytes"], row["ops"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
