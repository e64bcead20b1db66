#!/usr/bin/env python3
"""What a copy at a dynamic offset costs on the H100, by mechanism: the
port's counterpart of the TPU probes tools/exp_dma.py, exp_dma2.py,
exp_dma3.py and exp_dma4.py.

    python3 tools/torch_exp_dma.py                           # on the card
    python3 tools/torch_exp_dma.py --device cpu --iters 2    # plain versions
    python3 tools/torch_exp_dma.py --trees .chip/parent . . .chip/parent PD_RING=2

Runs every body of the four probes that runs (probes/dma.py BODIES,
`pd_copy`) with both mechanisms (16-byte cp.async by every thread; the TMA
1-D bulk copy on an mbarrier) at the probes' sizes (inputs from seeded
numpy; --iters copies where the probe loops, default 64), one window at a
time (the probes' own: one block); the whole-table bodies on a 2-block
cluster. Then the 16 KB-window bodies (exp_dma.py, exp_dma3.py kF) again
with one window an SM (--blocks, default 132), each with its own offsets.
On the card each launch is held to its plain version (exact) and timed
(CUDA events over 7 x 10 launches behind a device spin), with ns a copy and
the bound. Prints the card and one JSON line a body and mechanism. On the
CPU the plain versions run and no time is printed.
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
    from gpu_raytracer_tpu_torch.probes import dma

    ap = argparse.ArgumentParser(prog="torch_exp_dma", description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=dma.ITERS, help="copies where the probe loops")
    ap.add_argument("--blocks", type=int, default=132, help="windows at once (the card only)")
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
        timer = probes.device_ms
        print(json.dumps({"card": probes.card()}), flush=True)
    rows = dma.probe_copies(args.device, args.iters, timer=timer)
    if args.device != "cpu":
        rows += dma.probe_copies(args.device, args.iters, args.blocks, timer=timer,
                                 bodies=dma.WINDOW_BODIES)
    for row in rows:
        if row["ms"] is not None:
            row["bound_ms"], row["bound_by"] = probes.bound(row["bytes"], row["ops"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
