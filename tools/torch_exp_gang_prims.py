#!/usr/bin/env python3
"""What a dependent row load and the 8-gang primitives cost on the H100:
the port's counterpart of the TPU probes tools/exp_gang_prims.py and
tools/exp_gang_prims2.py.

    python3 tools/torch_exp_gang_prims.py                    # on the card
    python3 tools/torch_exp_gang_prims.py --device cpu --n 256 --iters 3 \\
        --iters2 2 4                                   # plain versions, tiny
    python3 tools/torch_exp_gang_prims.py --trees .chip/parent . . .chip/parent \\
        PP_FULL_WARPS=8                               # trees in turns

Runs the eleven bodies of probes/prims.py (`pp_gang`: one 1024-thread
block, gang g = 4 warps) at the probes' sizes and iteration counts (4096 x
128 tables; 100,000 iterations for exp_gang_prims, 50,000 and 400,000 for
exp_gang_prims2; inputs from seeded numpy) on the probes' own table (every
chase reads row 0 from its second iteration on) and on a chase table whose
column 5 is a random cycle over the rows (a dependent 512-byte row load
every iteration), and `full` on its own table times 1e4 (where its
output varies). On the card each body is held to its plain version at
256 iterations (bit-equal) and timed at the probe's count (CUDA events;
3 launches where one takes over 10 ms, else 7 x 10), with ns an iteration
as the JAX tools print it and the bound. Prints the card and one JSON line
a body and table. On the CPU the plain versions run and no time is printed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    from torch_time_traverse import run_in_trees, tool_root

    argv = list(sys.argv[1:] if argv is None else argv)
    rest = tool_root(argv)
    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.probes import prims

    ap = argparse.ArgumentParser(prog="torch_exp_gang_prims", description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=prims.N, help="table rows (a power of two)")
    ap.add_argument("--iters", type=int, default=prims.ITERS, help="exp_gang_prims bodies")
    ap.add_argument("--iters2", type=int, nargs="+", default=list(prims.ITERS2),
                    help="exp_gang_prims2 bodies")
    ap.add_argument("--trees", nargs="+", help="run in turns in each tree: a checkout (`.` this "
                    "one) or NAME=VALUE[,...], this tree with those constexpr constants of its "
                    "CUDA sources (tools/torch_time_traverse.py); each line gains its tree")
    ap.add_argument("--root", help=argparse.SUPPRESS)  # a tree's run
    args = ap.parse_args(argv)
    if args.trees:
        return run_in_trees(__file__, args.trees, rest)
    if args.root and not probes.__file__.startswith(os.path.abspath(args.root) + os.sep):
        raise SystemExit(f"imported {probes.__file__}, not the tree {args.root}")
    timer = None
    if args.device != "cpu":
        timer = probes.probe_ms
        print(json.dumps({"card": probes.card()}), flush=True)
    for row in prims.probe_prims(args.device, args.iters, tuple(args.iters2), args.n,
                                 timer=timer):
        if row["ms"] is not None:
            row["bound_ms"], row["bound_by"] = probes.bound(row["bytes"], row["ops"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
