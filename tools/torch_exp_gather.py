#!/usr/bin/env python3
"""Which per-lane table fetch pays on the H100: the port's counterpart of the
TPU probes tools/exp_gather.py and tools/exp_gather2.py.

    python3 tools/torch_exp_gather.py                   # on the card
    python3 tools/torch_exp_gather.py --tiles 760       # the wave's size
    python3 tools/torch_exp_gather.py --device cpu --width 64 --height 32 \\
        --subdiv 1 --iters 2                          # plain versions, tiny

Runs every ported body of the two JAX probes (probes/fetch.py CASES: the
fetches of `pf_lane` and the staged windows of `pf_window`) at the
probes' sizes on --tiles tiles of 1024 lanes (default 1, the probes' own)
with --iters fetches a lane (default 64), inputs from seeded numpy. Then the
glue's row gather at its real shape: `fetch_rows(shade_rows, hit_tri)` on
the bounce-1 wave of the merged cell (procedural_scene(1920, 1080, 6)) as
`pf_lane` rows beside `index_select`. On the card each kernel is held to its
plain version (exactly equal) and timed (CUDA events over 7 x 10 launches
behind a device spin), beside one `index_select` of the same values where
one call gathers them (and one `embedding_bag`, the same sums, for
pf_lane col0 and rowsum), with ns per fetch, the bound (bytes needed over
3.35 TB/s), its share of the kernel's time, and the path the launcher took
(pf_lane: staged, in place, or in place a row by a quad; pf_window: what a window
stages and the ring depths). Prints the card and one JSON line a case. On
the CPU the plain versions run and no time is printed.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.probes import fetch

    args = probes.arguments("torch_exp_gather", __doc__, fetch.ITERS, 1).parse_args(argv)
    timer = None
    if args.device != "cpu":
        timer = probes.device_ms
        print(json.dumps({"card": probes.card()}), flush=True)
    rows = fetch.probe_fetches(args.device, args.iters, args.tiles, timer=timer)
    got = probes.bounce1(probes.merged_cell(args.width, args.height, args.subdiv, args.device))
    rows.append(fetch.glue_fetch(got["shade_rows"], got["hit_tri"], timer))
    for row in rows:
        if row["ms"] is not None:
            row["bound_ms"] = probes.bound(row["bytes"], row["ops"])[0]
            row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
