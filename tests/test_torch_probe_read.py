"""The scalar-read and ceiling probes' plain versions (gpu_raytracer_tpu_torch/
probes/read.py) held to the JAX package's TPU probes, run in interpret
mode: tools/exp_scalar_read.py A-E and `kernelE`, tools/exp_vmem2.py
`kernel_roll` and `vmem_probe`, tools/exp_blocksync.py `vmem_probe`.

exp_scalar_read.py and exp_vmem2.py run their probes at module level, so
the test compiles their functions, and the assignments it names from the
body of their top-level `try` (`fE`, `f`), from the source
(tests/test_torch_probe_gang.load_tool), with POPS = 12 and N = 4,096; the
files stay as they are. `makeE` (:130) is never called by the tool; its
kernel is `kernelE`'s body, and the test runs that site too, through
`makeE()()`. The roll runs its own 256 pops.

`vmem_probe(mb)` returns only whether the kernel ran: 1 MB runs in
interpret mode. The test also takes the jitted call it builds (`returns=`)
and holds the plain `ceiling` body, x[0, 0] in every element, to it; on
the card `smem_ceiling` finds the largest launch (tests/test_torch_cuda.py).

Bars: f32 sums within rtol 1e-6; the ceiling exactly."""

import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpu_raytracer_tpu_torch.probes import read

from tests.test_torch_import import private_bvh_cache  # noqa: F401
from tests.test_torch_probe_gang import load_tool

torch.set_num_threads(2)

POPS, N = 12, 4096


@pytest.fixture(scope="module")
def scalar_tool():
    return load_tool("exp_scalar_read.py",
                     {"makeA", "makeB", "makeC", "makeD", "makeE", "kernelE", "fE"},
                     {"POPS": POPS, "N": N})


def _table(body):
    return read.probe_table(np.random.default_rng(7 + read.READ_BODIES.index(body)), body, N)


def _run(fn, x):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("body", ["A", "B", "C", "D"])
def test_scalar_reads_match_jax_probe(scalar_tool, body):
    table = _table(body)
    ref = _run(scalar_tool["make" + body](), table)
    ours = read.read_plain(body, torch.as_tensor(table), POPS).numpy()
    assert (ref == ref[0, 0]).all() and ref[0, 0] > 0
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_smem_table_reads_match_both_sites(scalar_tool):
    """E: `kernelE` through the tool's `fE`, and the never-called `makeE`
    through `makeE()()` (the same body)."""
    table = _table("E")
    ours = read.read_plain("E", torch.as_tensor(table), POPS).numpy()
    for fn in (scalar_tool["fE"], scalar_tool["makeE"]()()):
        np.testing.assert_allclose(ours, _run(fn, table), rtol=1e-6)


def test_roll_matches_jax_probe():
    tool = load_tool("exp_vmem2.py", {"kernel_roll", "f"}, {})
    x = _table("roll")
    ours = read.read_plain("roll", torch.as_tensor(x), read.ROLL_POPS).numpy()
    np.testing.assert_allclose(ours, _run(tool["f"], x), rtol=1e-6)


@pytest.mark.parametrize("name", ["exp_vmem2.py", "exp_blocksync.py"])
def test_ceiling_matches_vmem_probe(name):
    """vmem_probe(1) runs in interpret mode; its kernel fills (8, 128) with
    x[0, 0], as the plain ceiling body does."""
    tool = load_tool(name, {"vmem_probe"}, {})
    with pltpu.force_tpu_interpret_mode():
        assert tool["vmem_probe"](1) is True
    built = load_tool(name, {"vmem_probe"}, {}, returns={"vmem_probe": "f"})
    x = _table("ceiling")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(built["vmem_probe"](1)(jnp.asarray(x)))
    ours = read.read_plain("ceiling", torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours == x[0, 0]).all()


def _chunked(body, table, pops):
    """pr_read's decomposition: CHUNK pops a round; thread t gathers values
    e = t + 1024 j (pop e % CHUNK, read e // CHUNK) by the kernel's index
    arithmetic; pop p's sum from 0.0 in read order; one chain over the pops'
    sums, carried from round to round."""
    K = read.EXTRACT if body in ("C", "roll") else read.READS
    rows, cols = table.shape
    flat = table.reshape(-1)
    acc = torch.zeros((), dtype=torch.float32)
    for p0 in range(0, pops, read.CHUNK):
        n = min(read.CHUNK, pops - p0)
        e = torch.arange(K * read.CHUNK)
        i, k = p0 + e % read.CHUNK, e // read.CHUNK
        node = {"B": i * read.STRIDE % rows, "C": i * read.STRIDE % (8 * rows),
                "roll": i % rows}.get(body, i * read.STRIDE % cols)
        at = {"B": node * cols + k, "C": node // 8 * cols + node % 8 * read.EXTRACT + k,
              "roll": node * cols + (k + i % 8 * read.EXTRACT) % 128}.get(body, k * cols + node)
        v = flat[torch.where(e % read.CHUNK < n, at, 0)]
        if body == "D":
            v = ((v & 0xFF) + ((v >> 8) & 0xFF) + ((v >> 16) & 0xFF) + ((v >> 24) & 0xFF)).float()
        vals = v.view(K, read.CHUNK)[:, :n]
        s = torch.zeros(n, dtype=torch.float32)
        for row in vals:
            s = s + row
        for x in s:
            acc = acc + x
    return acc.expand(read.SHAPE)


@pytest.mark.parametrize("pops", [0, 1, 255, 1500])
def test_gather_then_chain_equals_the_scalar_loop(pops):
    """The kernel's order of work (parallel gather, per-pop sums, one chain)
    gives the plain version's bits for every body: ragged rounds, more pops
    than a block has threads and no pops at all included."""
    for body in read.READ_BODIES[:-1]:
        table = torch.as_tensor(_table(body))
        assert torch.equal(_chunked(body, table, pops), read.read_plain(body, table, pops)), body


def test_bytes_and_wrappers_route_by_device():
    """The bytes a body needs count its distinct values; on CPU tensors the
    wrapper runs the plain version, the kernel entry points and the ceiling
    search refuse them."""
    table = torch.as_tensor(_table("B"))
    nbytes, ops, flat = read.needed("B", table, 8)
    assert ops == 8 * read.READS and flat.numel() == 8 * read.READS
    assert nbytes == 4 * 8 * read.READS + 4 * 1024  # 8 distinct rows at 1237 apart
    before = dict(read.plain_calls), dict(read.launches)
    assert torch.equal(read.read("B", table, 8), read.read_plain("B", table, 8))
    assert read.plain_calls["pr_read"] == before[0]["pr_read"] + 2
    assert read.launches == before[1]
    with pytest.raises(RuntimeError):
        read.read_kernel("B", table, 8)
    with pytest.raises(RuntimeError):
        read.smem_ceiling(torch.zeros(8, 128))
    with pytest.raises(ValueError):
        read.read_plain("D", table, 8)  # D takes int32 words


def test_entry_point_runs_on_cpu():
    """tools/torch_exp_scalar_read.py end to end at a tiny size on the CPU:
    one JSON line a body and space (the ceiling is the card's: no line), no
    times."""
    import importlib

    mod = importlib.import_module("tools.torch_exp_scalar_read")
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main(["--device", "cpu", "--n", "4096", "--pops", "4"])
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert [(x["body"], x["space"]) for x in lines] == (
        [(b, "ldg") for b in read.READ_BODIES[:-1]] + [("roll", "shared")])
    assert all(x["device"] == "cpu" and x["ms"] is None for x in lines)
