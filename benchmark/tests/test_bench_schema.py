"""BENCHMARK.json keeps to the benchmark's contract, and a run's last line
has the shape the contract gives it."""

import json
import os
import re

import pytest

from benchmark.harness.spec import Spec
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = Spec(tiny.REPO)
B = SPEC.bench


def test_top_level_keys_and_paths():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"] and B["command"][1] == "benchmark/run.py"
    assert 1 <= B["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(tiny.REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and NAME.match(c["name"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["name"])
        assert os.path.exists(os.path.join(tiny.REPO, "benchmark", "traffic",
                                           f"{w['traffic']}.json"))
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(tiny.REPO, "benchmark", "metrics", f"{m['name']}.py"))
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        for w in m.get("workloads", []):
            assert w in SPEC.metrics("end_to_end", w) or any(
                e["name"] == m["moves"] for e in SPEC.metrics("end_to_end", w))


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = {m["name"] for m in SPEC.metrics("end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert SPEC.metrics("per_layer", cell)


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(run_tiny, tiny_root, trace):
    out = run_tiny("tiny-batch", seconds=1.0, trace=bool(trace))
    line = json.loads(json.dumps(out["result"]))
    assert list(line)[-1] == "limits"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in Spec(tiny_root).metrics(kind, "tiny-batch")}
    for k, v in line["metrics"].items():
        assert allowed[k] == v["unit"] and isinstance(v["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "tables_s" in line["metrics"]
        assert len(line["breakdown"]["device_ops"]) <= 10
    else:
        assert {"sample_ms", "setup_s"} <= set(line["metrics"])
    for v in line["limits"].values():
        assert set(v) == {"value", "limit"}
