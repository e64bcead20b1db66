"""A tiny checkout for the CPU tests: the benchmark's files copied beside a
BENCHMARK.json that adds cells of its own (`tiny-batch`, `tiny-denoised`,
`tiny-instanced`) on configurations and mixes cut to a 64 x 36 film,
subdivision-2 spheres and small reference estimates, as new files only."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
CELLS = {"tiny-batch": ("tiny_merged_1080p", "tiny_batch_b3", "merged-batch-b3"),
         "tiny-denoised": ("tiny_merged_1080p", "tiny_denoised_still", "merged-denoised-still"),
         "tiny-instanced": ("tiny_instanced_1080p", "tiny_batch_b4", "instanced-batch-b4")}


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make(root: str) -> str:
    """Write the tiny checkout under `root`; -> root."""
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in ("merged_1080p", "instanced_1080p"):
        with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
            cfg = json.load(f)
        cfg.update(name=f"tiny_{name}", film={"width": 64, "height": 36}, batch_size=2304)
        cfg["scene"]["meshes"] = {k: (dict(v, subdivisions=2) if v["shape"] == "icosphere"
                                      else v) for k, v in cfg["scene"]["meshes"].items()}
        for e in cfg["scene"]["instances"]:
            if "grid" in e:
                e["grid"]["n"] = 4
        path = f"benchmark/configs/tiny_{name}.json"
        _dump(cfg, os.path.join(root, path))
        bench["configs"].append({"name": f"tiny_{name}", "source": "tests", "file": path,
                                 "reduced": [], "why": "CPU tests"})
    for name in ("batch_b3", "batch_b4", "denoised_still"):
        with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
            t = json.load(f)
        t["check"].update(paths_per_block=4000, chunk=65536)
        if t["mode"] == "batch":
            t["check"].update(blocks=[4, 3], pixels=64, paths_per_pixel=512)
        else:
            t["check"].update(blocks=[1, 1], paths_per_block=8000)
        t.update(trace_units=1, warm_units=min(int(t["warm_units"]), 2))
        _dump(t, os.path.join(root, "benchmark", "traffic", f"tiny_{name}.json"))
    for cell, (config, traffic, like) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    _dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root
