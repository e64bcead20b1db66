"""Cells, configurations, mixes and metrics are found by name, and a new
one is new files and entries: nothing that exists is edited."""

import hashlib
import json
import os

from benchmark.harness.spec import Spec
from benchmark.tests import tiny


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_every_cell_finds_its_pieces():
    spec = Spec(tiny.REPO)
    for w in spec.bench["workloads"]:
        config = spec.config(w["config"])
        traffic = spec.traffic(w["traffic"])
        assert config["name"] == w["config"]
        assert traffic["mode"] in ("batch", "denoised")
        for kind in ("end_to_end", "per_layer"):
            for m in spec.metrics(kind, w["name"]):
                assert callable(spec.reader(m["name"]))


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path, run_tiny, tiny_root):
    before = _digests(tiny.REPO)
    root = tiny.make(str(tmp_path))
    base = _digests(root)
    with open(os.path.join(root, "benchmark", "traffic", "tiny_batch_b3.json")) as f:
        mix = json.load(f)
    mix["bounces"] = 2
    with open(os.path.join(root, "benchmark", "traffic", "throwaway_b2.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "benchmark", "metrics", "throwaway_count.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['units'] if ctx['trace'] is None else None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "throwaway-b2", "config": "tiny_merged_1080p",
                               "traffic": "throwaway_b2", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "throwaway_count", "unit": "samples", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["throwaway-b2"]})
    bench["end_to_end"][0]["workloads"].append("throwaway-b2")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in base} == base
    assert set(after) - set(base) == {"benchmark/traffic/throwaway_b2.json",
                                      "benchmark/metrics/throwaway_count.py"}
    from benchmark import run

    out = run.run_cell(root, "throwaway-b2", 7, 1.0, False, device="cpu")
    metrics = out["result"]["metrics"]
    assert metrics["throwaway_count"]["value"] == out["result"]["attempted"] >= 1
    assert {"sample_ms", "setup_s"} <= set(metrics)
    assert _digests(tiny.REPO) == before
