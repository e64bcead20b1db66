"""Finding a cell's pieces by name: `BENCHMARK.json` at the checkout's
root names the cells, configurations and metrics; a configuration is the
JSON file its entry names, a traffic mix is `benchmark/traffic/<name>.json`
and a metric is read by `benchmark/metrics/<name>.py`'s `read(ctx)`. A new
cell, mix or metric is new files and entries: nothing here lists them.
A mix may carry a `gpu` object of the port's `GPUConfig` fields (the
compaction tiers, the filter's settings, ...), so that a mix that needs
other render settings is a data file too; the mixes here use the
defaults and carry none.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = "benchmark"


class Spec:
    """The benchmark of the checkout at `root`."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.root, BENCH_DIR, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def metrics(self, kind: str, workload: str) -> list:
        """The `end_to_end` or `per_layer` entries that `workload` reports:
        those that list it under `workloads`, and those with no such key."""
        return [m for m in self.bench[kind] if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        """The `read(ctx)` of metric `name`."""
        path = os.path.join(self.root, BENCH_DIR, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
