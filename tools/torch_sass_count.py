#!/usr/bin/env python3
"""Count the SASS instructions of the port's CUDA kernels, by opcode.

    python3 tools/torch_sass_count.py --trees .chip/parent . --match sv_variance bt_

Each tree (a checkout of the repository: `.` is this one) builds its kernel
library if it is stale (`ops/_native.build`, in a process of its own that
imports only that tree's package), then `cuobjdump -sass` of the library is
split by function. For every function whose mangled name contains one of
the --match strings: its static instruction count, and the count of each
opcode (the mnemonic with its first modifier: MUFU.EX2, MUFU.RCP, LDS.128).
A static count is the instructions a fully unrolled body issues once; a
loop's body counts once. One JSON line ({tree: {function: {"total": n,
"ops": {...}}}}) is printed and written to --out; --dump DIR writes each
matched function's instructions there. Needs the CUDA toolkit
(the machine with the card).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from gpu_raytracer_tpu_torch.ops import _native; _native.build(); "
         "print(_native.library_path()); print(_native.find_nvcc())")


def sass_of(lib: str, nvcc: str) -> dict:
    """{mangled function name: [instruction lines]} of a library."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", ln)
        if name and m:
            funcs[name].append(m.group(1).strip())
    return funcs


def opcode(ins: str) -> str:
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)  # predicate guard
    parts = ins.split()[0].split(".")
    return ".".join(parts[:2])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trees", nargs="+", default=["."])
    p.add_argument("--match", nargs="+", default=["sv_variance", "bt_"])
    p.add_argument("--out", default=os.path.join(REPO, ".chip", "sass_count.json"))
    p.add_argument("--dump", help="also write each matched function's SASS here")
    args = p.parse_args()
    result = {}
    for tree in args.trees:
        path = os.path.abspath(os.path.join(REPO, tree))
        built = subprocess.run([sys.executable, "-c", BUILD, path], capture_output=True,
                               text=True, check=True).stdout.split()
        funcs = sass_of(built[-2], built[-1])
        rows = {}
        for name, ins in funcs.items():
            if any(s in name for s in args.match):
                ops = collections.Counter(opcode(i) for i in ins if i)
                rows[name] = {"total": sum(ops.values()), "ops": dict(ops.most_common())}
                if args.dump:
                    os.makedirs(args.dump, exist_ok=True)
                    tag = "this" if path == REPO else re.sub(r"[^\w-]+", "_", tree).strip("_")
                    with open(os.path.join(args.dump, f"{tag}.{name[:80]}.sass"), "w") as f:
                        f.write("\n".join(ins) + "\n")
                print(f"[sass] {tree} {name}: {rows[name]['total']} instructions; "
                      + ", ".join(f"{k} {v}" for k, v in ops.most_common(24)), flush=True)
        result[tree] = rows
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
