"""The pop-loop probe's plain version (gpu_raytracer_tpu_torch/probes/
block.py) held to the JAX package's TPU probe tools/exp_blocksync.py,
`make_pop_kernel`, run in interpret mode.

The tool's runs sit under `__main__`; the test compiles its functions from
the source (tests/test_torch_probe_gang.load_tool) at a small size: N = 512
rows, 12 pops. The site the tool times is `wrapper` (call :101), which runs
`kernel` through `kernel_flat`. The other call site, `f` (:89-98), is never
returned by the tool and cannot run as written: its pallas_call passes the
7 inputs flat to `kernel`, which takes (tab, o_refs, d_refs, ...), a
TypeError when traced (ROADMAP C). Its body is the same `kernel`, so the
`wrapper` site holds it.

Bars: best_t exactly equal (a min of f32 values computed in the same
order). On the probe's own inputs every lane returns 1e30 (tn + 1e30 rounds
back to 1e30); the table scaled by 1e29 makes best_t vary."""

import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpu_raytracer_tpu_torch.probes import block

from tests.test_torch_import import private_bvh_cache  # noqa: F401
from tests.test_torch_probe_gang import load_tool

torch.set_num_threads(2)

N, POPS = 512, 12


@pytest.fixture(scope="module")
def tool():
    return load_tool("exp_blocksync.py", {"make_pop_kernel"}, {})


def _inputs(scale):
    return block.pop_inputs(np.random.default_rng(3), N, scale)


@pytest.mark.parametrize("scale", [1.0, 1e29])
def test_pop_loop_matches_jax_probe(tool, scale):
    tab, o, d = _inputs(scale)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(tool["make_pop_kernel"](N, POPS)(
            jnp.asarray(tab), *(jnp.asarray(x) for x in o), *(jnp.asarray(x) for x in d)))
    ours = block.pop_plain(*(torch.as_tensor(x) for x in (tab, o, d)), POPS).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert block.last_work["rows"] > 1
    if scale == 1.0:
        assert (ours == np.float32(block.FAR)).all()  # the probe's own output is constant
    else:
        assert len(np.unique(ours)) > 1


def test_dead_site_cannot_trace():
    """`f` (the call at :90) is held through `wrapper`: run as written it
    fails to trace."""
    dead = load_tool("exp_blocksync.py", {"make_pop_kernel"}, {},
                     returns={"make_pop_kernel": "f"})
    tab, o, d = _inputs(1e29)
    with pltpu.force_tpu_interpret_mode(), pytest.raises(TypeError):
        dead["make_pop_kernel"](N, POPS)(jnp.asarray(tab), [jnp.asarray(x) for x in o],
                                         [jnp.asarray(x) for x in d])


def test_stack_caps_and_wrappers_route_by_device():
    """A table whose every child is hit pushes 8 a pop (past the cap of 48
    within 7 pops), so the pops walk many rows; on CPU tensors the wrapper
    runs the plain version and the kernel entry point refuses."""
    tab = np.tile(np.array([-1, -1, -1, 1, 1, 1] * 8 + [0] * 16, np.float32), (1000, 1))
    o = torch.full((3, 8, 128), 0.5)
    d = torch.ones((3, 8, 128))
    before = dict(block.plain_calls), dict(block.launches)
    out = block.pop(torch.as_tensor(tab), o, d, 20)
    assert block.plain_calls["pb_pop"] == before[0]["pb_pop"] + 1
    assert block.launches == before[1]
    assert block.last_work["rows"] > 10
    # tn = -1.5 everywhere: best_t = min(1e30, -1.5 + 1e30) stays 1e30.
    assert torch.equal(out, torch.full((8, 128), np.float32(block.FAR)))
    with pytest.raises(RuntimeError):
        block.pop_kernel(torch.as_tensor(tab), o, d, 2)
    with pytest.raises(ValueError):
        block.pop_plain(torch.zeros(4, 48), o, d, 2)


class _Table(torch.Tensor):
    """The table, noting the row of every int index (pop_plain reads the
    popped node's row so); what its operations return notes nothing."""

    def __getitem__(self, i):
        if isinstance(i, int) and getattr(self, "read", None) is not None:
            self.read.append(i)
        return super().__getitem__(i)


def _replayed_pops(tab, o, d, pops):
    """pop_plain's arithmetic with pb_pop's stack rule: a pop's 8-bit any-hit
    mask, child c pushed at sp + the set bits below c, sp capped, the next
    node read from the stack and checked against the candidate the kernel
    takes it from (`block.next_candidates`: the child pushed on top, else the
    entry below). Returns the popped nodes, best_t and the largest sp before
    the cap."""
    n = tab.shape[0]
    ox, oy, oz = o
    ix, iy, iz = (1.0 / x for x in d)
    best = torch.full(block.SHAPE, block.FAR, dtype=torch.float32)
    stack, node, sp, most, popped = [0] * block.STACK, 0, 0, 0, []
    for _ in range(pops):
        popped.append(node)
        cand = block.next_candidates(node, stack, sp, n)
        row, kids = tab[node], []
        for c in range(8):
            b = row[6 * c:6 * c + 6]
            tx0, tx1 = (b[0] - ox) * ix, (b[3] - ox) * ix
            ty0, ty1 = (b[1] - oy) * iy, (b[4] - oy) * iy
            tz0, tz1 = (b[2] - oz) * iz, (b[5] - oz) * iz
            tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                               torch.minimum(tz0, tz1))
            tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                               torch.maximum(tz0, tz1))
            hit = (tn <= tf) & (tf > 0.0) & (tn < best)
            if bool(hit.any()):
                kids.append(c)
            best = torch.where(hit, torch.minimum(best, tn + block.FAR), best)
        for rank, c in enumerate(kids):
            stack[sp + rank] = cand[c]
        most = max(most, sp + len(kids))
        top = max(min(sp + len(kids), block.SP_CAP) - 1, 0)
        node = stack[top]
        assert node == cand[kids[top - sp] if kids else 8]
        sp = top
    return popped, best, most


@pytest.mark.parametrize("n, scale", [(block.N, 1.0), (block.N, 1e29), (37, 1.0), (37, 1e29)])
def test_pop_candidates_hold_the_next_row(n, scale):
    """pb_pop fetches the next pop's row before its slab test, from
    `next_candidates`: held on pop_plain's own loop at the probe's size (256
    pops) on the probe's table and on 37 rows (the children wrap), at both
    scales: the replayed rule pops the nodes pop_plain reads, in order, to
    the same best_t; the stack passes the cap of 48 and never reaches 64 (so
    the plain version's sp < 64 check never binds)."""
    tab, o, d = (torch.as_tensor(x) for x in block.pop_inputs(np.random.default_rng(4), n, scale))
    noted = torch.Tensor._make_subclass(_Table, tab)
    noted.read = []
    want = block.pop_plain(noted, o, d, block.POPS)
    popped, best, most = _replayed_pops(tab, o, d, block.POPS)
    assert popped == noted.read
    assert torch.equal(best, want.as_subclass(torch.Tensor))
    assert block.SP_CAP < most < block.STACK
    assert len(set(popped)) > (5 if n == 37 else 100)


def test_entry_point_runs_on_cpu():
    """tools/torch_exp_blocksync.py end to end at a tiny size on the CPU:
    one JSON line a table, no times (no card)."""
    import importlib

    mod = importlib.import_module("tools.torch_exp_blocksync")
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main(["--device", "cpu", "--n", "256", "--pops", "4"])
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert [x["table"] for x in lines] == ["own", "scaled 1e29"]
    assert all(x["device"] == "cpu" and x["ms"] is None for x in lines)
    assert lines[0]["distinct"] == 1 and lines[1]["distinct"] > 1
