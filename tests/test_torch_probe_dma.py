"""The copy probes' plain version (gpu_raytracer_tpu_torch/probes/dma.py) held
to every body of the JAX package's TPU probes tools/exp_dma.py, exp_dma2.py,
exp_dma3.py and exp_dma4.py that runs, in interpret mode.

Each tool is run whole from its source (tests/test_torch_probe_gang.
load_tool, whole=True), its tables and offsets set from seeded numpy under
their own global names and its sizes cut (exp_dma: N = 4,096, ITERS = 8;
the others N = 1,024, exp_dma3's ITERS = 8). Its `run` returns the jitted
call's output on the body's inputs instead of timing or printing it
(`returns=`), so every module-level `run(...)` line runs once with the
tool's own specs; the files stay as they are.

Probe faults: exp_dma3.py kE (:81-84) indexes its 1-D scratch with two
indices and fails to trace; the test shows that and holds its body to
what it means, tab1[0:8] down the rows. exp_dma4.py kG (:56-58) is a stub
no `run` line calls.

Bars: exact (copies, and sums in copy order)."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpu_raytracer_tpu_torch.probes import dma

from tests.test_torch_import import private_bvh_cache  # noqa: F401
from tests.test_torch_probe_gang import load_tool

torch.set_num_threads(2)

ITERS = 8
SIZES = {"exp_dma": 4096, "exp_dma2": 1024, "exp_dma3": 1024, "exp_dma4": 1024}
CALL = {"exp_dma2": "(tab,)"}   # exp_dma2's run calls f(tab); the others f(*inputs)


def _tool_shapes(tool: str, inp: dict) -> dict:
    """Our (B = 1) inputs in the shapes the tool's globals have."""
    out = dict(inp)
    if tool == "exp_dma":
        out["los"], out["idx"] = inp["los"][0], inp["idx"][0].reshape(ITERS, 8, 128)
    elif tool == "exp_dma3":
        out["idx"], out["bs"] = inp["idx"][0, 0].reshape(8, 128), inp["bs"][0]
    elif tool == "exp_dma4":
        out["lo"] = inp["lo"][0]
    return out


@pytest.fixture(scope="module")
def runs():
    """{tool: (our inputs, [(run name, output or the exception), ...])}."""
    got = {}
    for t, n in SIZES.items():
        inp = dma.probe_inputs(np.random.default_rng(5 + n), t, ITERS, 1, n)
        captured = []

        def call(f, args):
            try:
                return np.asarray(f(*args))
            except Exception as e:  # a probe fault, held by its test
                return e

        consts = {"N": n, "CHUNK": dma.CHUNK, "ITERS": ITERS, "_got": captured,
                  "_call": call, **_tool_shapes(t, inp)}
        with pltpu.force_tpu_interpret_mode():
            load_tool(t + ".py", set(), consts, whole=True,
                      returns={"run": f"_got.append((name, _call(f, {CALL.get(t, 'inputs')})))"})
        got[t] = (inp, captured)
    return got


@pytest.mark.parametrize("name", list(dma.BODIES))
def test_body_matches_jax_probe(runs, name):
    body = dma.BODIES[name]
    inp, captured = runs[body.tool]
    names = [n for n, b in dma.BODIES.items() if b.tool == body.tool]
    assert len(captured) == len(names)  # every run line, in file order
    label, ref = captured[names.index(name)]
    table = torch.as_tensor(inp[body.table])
    offs = torch.as_tensor(inp[body.offs]) if body.offs else None
    ours = dma.copy_plain(name, table, offs, ITERS)[0].numpy()
    if name == "dma3.kE":
        assert isinstance(ref, Exception), label  # the probe fault
        ref = np.repeat(inp["tab1"][:8, None], 128, axis=1)
    np.testing.assert_array_equal(ours, ref.reshape(ours.shape))
    assert (ours != 0).all()


def test_offsets_in_blocks_and_wrappers_route_by_device():
    """B windows at once are B single windows; on CPU tensors the wrapper
    runs the plain version, the kernel entry point refuses; the bytes count
    the distinct floats copied."""
    rng = np.random.default_rng(1)
    inp = {k: torch.as_tensor(v) for k, v in dma.probe_inputs(rng, "exp_dma", 4, 3, 4096).items()}
    for name, key in (("dma.smem", "los"), ("dma.vmin", "idx"), ("dma.vmin_smem", "idx")):
        many = dma.copy(name, "bulk", inp["tab"], inp[key], 4)
        for b in range(3):
            one = dma.copy_plain(name, inp["tab"], inp[key][b:b + 1], 4)
            assert torch.equal(many[b:b + 1], one)
    before = dict(dma.launches)
    with pytest.raises(RuntimeError):
        dma.copy_kernel("dma.smem", "bulk", inp["tab"], inp["los"], 4)
    assert dma.launches == before
    with pytest.raises(ValueError):
        dma.copy_plain("dma.static", inp["tab"], inp["los"], 4)  # static takes no offsets
    nbytes, ops = dma.needed("dma.static", inp["tab"], None, 4, 1)
    assert nbytes == 4 * dma.WINDOW + 4 and ops == 4
    whole = torch.zeros(4096 * 16)
    assert dma.cluster_half("dma4.kJ", whole, 232_448) == (4352 * 16) // 2
    assert dma.cluster_half("dma2.k2", whole, 232_448) == 0


def test_entry_point_runs_on_cpu():
    """tools/torch_exp_dma.py end to end at a tiny size on the CPU: one JSON
    line a body and mechanism, no times (no card)."""
    import importlib

    mod = importlib.import_module("tools.torch_exp_dma")
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main(["--device", "cpu", "--iters", "2"])
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert len(lines) == len(dma.BODIES) * len(dma.MECHS)
    assert all(x["device"] == "cpu" and x["ms"] is None for x in lines)


def _ring_schedule(iters: int, ring: int) -> list:
    """The ring kernel's loop (csrc/probe_dma.cu pd_copy_kernel) as events:
    ("read", copy, slot, parity) where thread 0 waits for a copy and reads
    it, ("issue", copy, slot) where a copy goes out, and the last copy's
    read by every thread after the loop. K = min(ring, iters) slots; at
    iteration c copy c - K is read from slot c % K, then copy c issued into
    it; cp.async commits one group an iteration."""
    K = min(ring, iters)
    out, s, q = [], 0, 0
    for c in range(iters + K):
        if c >= K:
            out.append(("read", c - K, s, (q - 1) & 1))
        if c < iters:
            out.append(("issue", c, s))
        s += 1
        if s == K:
            s, q = 0, q + 1
    out.append(("last", iters - 1, (iters - 1) % K, (iters - 1) // K & 1))
    return out


@pytest.mark.parametrize("ring", [2, 4, 8])
@pytest.mark.parametrize("count", ["1", "K-1", "K", "K+1", "64"])
def test_ring_reads_each_copy_from_its_slot(ring, count):
    """The ring's slot and phase schedule at iters = 1, K - 1, K, K + 1 and
    64: every copy is read once, in copy order, from the slot it was staged
    into, at the parity of its own phase of that slot's mbarrier; no slot is
    refilled before its copy is read; cp.async's wait_group K - 1 has seen
    the copy's group complete; the last copy's slot is never refilled."""
    iters = {"1": 1, "K-1": ring - 1, "K": ring, "K+1": ring + 1, "64": 64}[count]
    K = min(ring, iters)
    held = {}       # slot: the copy in it, not yet read
    phases = {}     # slot: copies staged into it so far
    staged = {}     # copy: (slot, its phase of the slot, its commit group)
    reads = []
    group = 0
    for ev in _ring_schedule(iters, ring):
        if ev[0] == "issue":
            _, c, slot = ev
            assert slot < K and slot not in held  # read before refilled
            held[slot] = c
            staged[c] = (slot, phases.get(slot, 0), c)
            phases[slot] = phases.get(slot, 0) + 1
            group = c
        elif ev[0] == "read":
            _, c, slot, parity = ev
            assert held.pop(slot) == c and staged[c][0] == slot
            assert parity == staged[c][1] & 1
            # wait_group K - 1 at iteration c + K: groups 0 .. c + K - 1 are
            # committed, so every group up to c is complete
            assert staged[c][2] <= (c + K - 1) - (K - 1)
            reads.append(c)
        else:
            _, c, slot, parity = ev
            assert staged[c][0] == slot and parity == staged[c][1] & 1
            assert phases[slot] == staged[c][1] + 1  # its slot's last phase
    assert reads == list(range(iters)) and not held and group == iters - 1


def test_entry_point_runs_trees_in_turns_on_cpu(capfd):
    """--trees runs the tool once a tree, each in a process of its own that
    imports the tree's package, and tags every line with its tree."""
    import importlib

    mod = importlib.import_module("tools.torch_exp_dma")
    assert mod.main(["--device", "cpu", "--iters", "2", "--trees", "."]) == 0
    lines = [json.loads(x) for x in capfd.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["tree"] for x in lines] == ["."] * (len(dma.BODIES) * len(dma.MECHS))
    assert all(x["device"] == "cpu" and x["ms"] is None for x in lines)
