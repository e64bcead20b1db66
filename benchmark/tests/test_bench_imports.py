"""Nothing the benchmark runs loads JAX or the JAX package: module names
are compared by their whole top-level name, so the port passes and the JAX
package does not; no file of the benchmark reads the JAX-era bench files."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness.guard import FORBIDDEN, forbidden_modules
from benchmark.tests import tiny


@pytest.mark.parametrize("names,found", [
    (["gpu_raytracer_tpu_torch", "gpu_raytracer_tpu_torch.ops.vec", "torch"], []),
    (["gpu_raytracer_tpu", "gpu_raytracer_tpu_torch"], ["gpu_raytracer_tpu"]),
    (["gpu_raytracer_tpu.ops.vec"], ["gpu_raytracer_tpu"]),
    (["jax._src.core", "jaxlib", "flax.linen", "jaxtyping"], ["flax", "jax", "jaxlib"]),
])
def test_top_level_names_compared_whole(names, found):
    assert forbidden_modules(names) == found


def _sources():
    for d, _, files in os.walk(tiny.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_forbidden_import_or_read(path):
    with open(path) as f:
        text = f.read()
    for node in ast.walk(ast.parse(text)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        assert not forbidden_modules(names), (path, names)
    for name in ("bench" + ".py", "BENCH" + "_r0", "MULTICHIP" + "_r0"):
        assert name not in text.replace("benchmark", ""), (path, name)


@pytest.mark.parametrize("package", ["reference", "harness/yardstick.py", "harness/check.py"])
def test_the_yardstick_imports_nothing_of_the_port(package):
    path = os.path.join(tiny.BENCH, package)
    files = [path] if path.endswith(".py") else [
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".py")]
    for p in files:
        with open(p) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                assert not any(m.split(".")[0] == "gpu_raytracer_tpu_torch" for m in mods), p


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = ("import sys, json; sys.path.insert(0, %r); import torch; torch.set_num_threads(2);"
            "from benchmark import run;"
            "out = run.run_cell(%r, 'tiny-batch', 5, 0.5, False, device='cpu');"
            "print(json.dumps({'forbidden': out['forbidden'], 'mods': sorted(m for m in sys.modules"
            " if m.split('.')[0] in %r)}))") % (tiny.REPO, tiny_root, FORBIDDEN)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last == '{"forbidden": [], "mods": []}'
