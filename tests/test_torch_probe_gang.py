"""The gang-traversal probes' plain versions (gpu_raytracer_tpu_torch/probes/
gang.py) held to the JAX package's TPU probes, run in interpret mode:
tools/exp_gang_ablate.py `_kernel` (the ablation variants) and
tools/exp_gang_micro.py `_kernel` (the stages).

Both tools run module-level code against a cached Sponza wave, so the test
compiles only their imports, literal constants and named functions from the
source (`ast`), without `compile_cache`, and overrides the iteration counts
(and the micro tool's tile count) in that namespace; the files stay as they
are. The ablation tool's `run` returns t alone: the test's copy returns
(t, tri) from the same `pallas_call`.

Inputs: the merged wide tables of a small procedural room and 2 tiles (2,048
rays: one coherent tile, one incoherent, with dead lanes and finite t_max).
Bars: ablation hits equal in mask, tri equal on >= 99.9% of hits (an exact
tie at equal t may resolve to either triangle,
tests/test_torch_traverse_binary._compare), t within rtol 1e-4; micro acc
within rtol 1e-5. `nopush` and `nopushst` are not held to the JAX probe:
they pop stack slots nobody pushed, uninitialised scratch in the TPU kernel
and zeros here, so they are held kernel-to-plain on the card
(tests/test_torch_cuda.py)."""

import ast
import io
import os
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpu_raytracer_tpu_torch.ops import buffers as tb
from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
from gpu_raytracer_tpu_torch.probes import gang
from gpu_raytracer_tpu_torch.scenes import procedural_scene

from tests.test_torch_import import REPO
from tests.test_torch_import import private_bvh_cache  # noqa: F401
from tests.test_torch_traverse_binary import _rays

torch.set_num_threads(2)

K_ITERS = 16
MICRO_ITERS = 16
MICRO_TILES = 2
JAX_VARIANTS = ("full", "node-only", "tri-only", "nosort", "noload", "nored",
                "sorthalf", "pushbase")


def _assigned(node) -> set:
    """The names an assignment binds (`a = ...`, `a, b = ...`)."""
    names = set()
    for t in getattr(node, "targets", ()):
        for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(e, ast.Name):
                names.add(e.id)
    return names


def load_tool(name: str, keep: set, consts: dict, returns: dict = None,
              whole: bool = False) -> dict:
    """tools/<name> compiled from its source into a namespace with `consts`
    set (`compile_cache` is left out). By default only its imports, literal
    constants and the functions and assignments named in `keep` are
    compiled, from the top level and from the body of a top-level `try`;
    the tool's own runs are not. With `whole`, every top-level statement
    runs but loops, `if` blocks and the assignments and functions named in
    `consts`, which are set first. `returns` maps a function (at any depth)
    to the expression its last statement returns instead."""
    path = os.path.join(REPO, "tools", name)
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and returns and node.name in returns:
            node.body[-1] = ast.Return(ast.parse(returns[node.name], mode="eval").body)
    top = tree.body if whole else [s for node in tree.body
                                   for s in (node.body if isinstance(node, ast.Try) else [node])]
    body = []
    for node in top:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            if not any("compile_cache" in a.name for a in node.names):
                body.append(node)
        elif whole:
            named = _assigned(node) | {getattr(node, "name", None)}
            if not isinstance(node, (ast.For, ast.If)) and not named & set(consts):
                body.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in keep:
            body.append(node)
        elif isinstance(node, ast.Assign):
            if not _assigned(node) & keep:
                try:
                    ast.literal_eval(node.value)
                except ValueError:
                    continue
            body.append(node)
    ns = {"__name__": f"tool_{name}", **(consts if whole else {})}
    exec(compile(ast.fix_missing_locations(ast.Module(body=body, type_ignores=[])),
                 path, "exec"), ns)
    ns.update(consts)
    return ns


@pytest.fixture(scope="module")
def room():
    """The room's merged wide tables as the unified gang table, and 2 tiles
    of rays."""
    host = tb.pack_scene(procedural_scene(16, 16, 2))
    nodes, rows = host["wide"]
    assert host["wide_prim_map"] is not None  # merged tables
    co, inc = _rays("coherent", 3), _rays("incoherent", 4)
    o, d, tm = (np.concatenate([a, b]) for a, b in zip(co, inc))
    gt = gang.GangTable(torch.cat([torch.as_tensor(nodes), torch.as_tensor(rows)]),
                        nodes.shape[0])
    tables = wt.make_tables(torch.as_tensor(nodes), torch.as_tensor(rows),
                            tb._max_stack_of(nodes, rows))
    return SimpleNamespace(nodes=nodes, rows=rows, o=o, d=d, tm=tm, gt=gt, tables=tables,
                           wave=tuple(torch.as_tensor(x) for x in (o, d, tm)))


@pytest.fixture(scope="module")
def ablate_tool():
    return load_tool("exp_gang_ablate.py", {"_kernel", "run"}, {"K_ITERS": K_ITERS},
                     returns={"run": "(t, tri)"})


def _hits_agree(ours, t_j, tri_j):
    tri_o, t_o = ours.tri.numpy(), ours.t.numpy()
    hit = tri_j >= 0
    np.testing.assert_array_equal(tri_o >= 0, hit)
    assert ((tri_o == tri_j) & hit).sum() >= 0.999 * hit.sum()
    np.testing.assert_allclose(t_o[hit], t_j[hit], rtol=1e-4)
    assert np.isinf(t_o[~hit]).all() and np.isinf(t_j[~hit]).all()
    return int(hit.sum())


@pytest.mark.parametrize("variant", JAX_VARIANTS)
def test_ablate_matches_jax_probe(room, ablate_tool, variant):
    with pltpu.force_tpu_interpret_mode():
        t_j, tri_j = ablate_tool["run"](*(jnp.asarray(x) for x in (
            room.nodes, room.rows, room.o, room.d, room.tm)), variant=variant)
    ours = gang.ablate_plain(room.gt, room.wave, variant, K_ITERS)
    hits = _hits_agree(ours, np.asarray(t_j).reshape(-1), np.asarray(tri_j).reshape(-1))
    # The phase-forcing variants never reach a hit in either; the others do.
    assert (hits == 0) == (variant in ("node-only", "tri-only"))
    assert torch.equal(ours.iters, torch.full((2,), K_ITERS, dtype=torch.int32))


@pytest.mark.parametrize("variant", ["nopush", "nopushst"])
def test_scratch_popping_variants_are_deterministic(room, variant):
    """The variants that pop slots nobody pushed read the zeroed scratch:
    the same hits every call; nopush queues no leaf, so it hits nothing."""
    a = gang.ablate_plain(room.gt, room.wave, variant, K_ITERS)
    b = gang.ablate_plain(room.gt, room.wave, variant, K_ITERS)
    assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t)
    if variant == "nopush":
        assert not bool((a.tri >= 0).any())


def test_converged_full_equals_wide_closest(room):
    """Run to the end (every gang's stack and leaf queue empty), the gang
    traversal finds every lane's closest hit: the plain K2 traversal's."""
    ours = gang.ablate_plain(room.gt, room.wave, "full", 4096, converge=True)
    assert 0 < int(ours.iters.max()) < 4096
    ref = wt.trace_closest_plain(room.tables, *room.wave)
    hits = _hits_agree(ours, ref.t.numpy(), ref.tri.numpy())
    assert hits > 1024 // 4
    work = gang.last_work
    assert work["node_visits"] > 0 and work["triangles"] > 0 and work["rows"] > 0


@pytest.fixture(scope="module")
def micro_inputs():
    """A synthetic 96-row table and rays for the micro probe, whose rays all
    start on the diagonal (ox, 1.01 ox, 0.99 ox) heading into +x+y+z: child
    boxes about (3, 3, 3), so most are entered at t > 0 and the gang minima
    stay finite; child refs are node rows (60%), leaf refs (30%) or empty
    (-1, 10% of slots 1-7)."""
    rng = np.random.default_rng(5)
    M = 96
    table = rng.normal(size=(M, 128)).astype(np.float32)
    c = 3.0 + rng.normal(0.0, 0.4, (M, 8, 3))
    h = rng.uniform(0.4, 1.0, (M, 8, 3))
    table[:, :48] = np.concatenate([c - h, c + h], -1).reshape(M, 48)
    refs = rng.integers(0, M, (M, 8)).astype(np.float32)
    leaf = rng.random((M, 8)) < 0.3
    refs[leaf] = -2 - rng.integers(0, 50, int(leaf.sum()))
    refs[:, 1:][rng.random((M, 7)) < 0.1] = -1  # slot 0, the slab stage's key, is never empty
    table[:, 48:56] = refs
    rays = rng.uniform(-0.4, 1.8, (MICRO_TILES, 8, 128)).astype(np.float32)
    return torch.as_tensor(table), torch.as_tensor(rays)


@pytest.mark.parametrize("stage", gang.MICRO_STAGES)
def test_micro_matches_jax_probe(micro_inputs, stage):
    tool = load_tool("exp_gang_micro.py", {"_bc", "_kernel", "run"},
                     {"N_ITERS": MICRO_ITERS, "TILES": MICRO_TILES})
    table, rays = micro_inputs
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(tool["run"](stage, jnp.asarray(table.numpy()),
                                     jnp.asarray(rays.numpy())))
    ours = gang.micro_plain(table, rays, stage, MICRO_ITERS).numpy()
    # A gang whose lanes all miss the keyed child adds +inf from then on.
    assert np.isfinite(ours).mean() > 0.25 and (ours != 0).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def _layered_sort(keys, refs, layers):
    """pg_ablate's network: lane c holds child c; a layer is one exchange
    with the partner its map names (itself where it sits out), the lower
    lane keeping the smaller key, a tie staying."""
    lane = torch.arange(8)
    for layer in layers:
        m = gang.layer_map(layer)
        partner = torch.tensor([(m >> (4 * c)) & 0xF for c in range(8)])
        pk, pr = keys[..., partner], refs[..., partner]
        swap = torch.where(lane < partner, keys > pk, pk > keys)
        keys, refs = torch.where(swap, pk, keys), torch.where(swap, pr, refs)
    return keys, refs


def _serial_pushes(refs, sps, lqs, stack, leafq, variant):
    """ablate_plain's pushes on every row (probes/gang.py: the c = 7 .. 0 loop,
    nopush, pushbase)."""
    if variant == "nopush":
        return (sps + 2).clamp(max=gang.STACK_DEPTH - 1), lqs
    if variant == "pushbase":
        s0, l0 = sps, lqs
        for c in range(8):
            r = refs[..., c]
            stack.scatter_(1, (s0 + c).clamp(max=gang.SCRAP)[..., None], r[..., None])
            leafq.scatter_(1, (l0 + c).clamp(max=gang.QSCRAP)[..., None], (-r - 2)[..., None])
        return ((s0 + (refs >= 0).sum(-1)).clamp(max=gang.STACK_DEPTH - 1),
                (l0 + (refs <= -2).sum(-1)).clamp(max=gang.LEAFQ_DEPTH - 1))
    for c in range(7, -1, -1):
        r = refs[..., c]
        take_n = (r >= 0) & (sps < gang.STACK_DEPTH)
        pos = torch.full_like(sps, gang.SCRAP) if variant == "nopushst" else \
            torch.where(take_n, sps, gang.SCRAP)
        stack.scatter_(1, pos[..., None], r[..., None])
        sps = sps + take_n.long()
        take_l = (r <= -2) & (lqs < gang.LEAFQ_DEPTH)
        pos = torch.full_like(lqs, gang.QSCRAP) if variant == "nopushst" else \
            torch.where(take_l, lqs, gang.QSCRAP)
        leafq.scatter_(1, pos[..., None], (-r - 2)[..., None])
        lqs = lqs + take_l.long()
    return sps, lqs


def _prefix_pushes(refs, sps, lqs, stack, leafq, variant):
    """pg_ablate's lane-parallel pushes: ballots of the node and the leaf
    children; lane c stores at the pointer plus the count of its kind among
    the children > c, where that slot is under the capacity (the scrap
    slots, which no pop reads, are not stored)."""
    nodes, leaves = refs >= 0, refs <= -2
    if variant == "nopush":
        return (sps + 2).clamp(max=gang.STACK_DEPTH - 1), lqs
    c = torch.arange(8)
    if variant == "pushbase":
        for a, b, val, scrap in ((stack, sps, refs, gang.SCRAP),
                                 (leafq, lqs, -refs - 2, gang.QSCRAP)):
            slot = b[..., None] + c
            a.scatter_(1, torch.where(slot < scrap, slot, scrap), val)
        return ((sps + nodes.sum(-1)).clamp(max=gang.STACK_DEPTH - 1),
                (lqs + leaves.sum(-1)).clamp(max=gang.LEAFQ_DEPTH - 1))
    for a, b, kind, val, cap in ((stack, sps, nodes, refs, gang.STACK_DEPTH),
                                 (leafq, lqs, leaves, -refs - 2, gang.LEAFQ_DEPTH)):
        later = kind.flip(-1).long().cumsum(-1).flip(-1) - kind.long()  # kind among c' > c
        slot = b[..., None] + later
        take = kind & (slot < cap) & (variant != "nopushst")
        a.scatter_(1, torch.where(take, slot, cap), val)  # cap: the scrap slot
    return ((sps + nodes.sum(-1)).clamp(max=gang.STACK_DEPTH),
            (lqs + leaves.sum(-1)).clamp(max=gang.LEAFQ_DEPTH))


@pytest.mark.parametrize("swaps", ["SWAPS", "SWAPS_HALF"])
def test_layered_network_and_prefix_pushes_equal_serial(swaps):
    """The kernel's decomposition of the sort and the pushes, held equal to
    the serial network (`_sort`) and ablate_plain's push loop on seeded keys
    full of ties (0.0, -0.0, +inf) and refs of every kind, with stacks and
    leaf queues near full so that the capacity checks bite; the layers are
    the swaps in order."""
    layers = gang.LAYERS if swaps == "SWAPS" else gang.LAYERS_HALF
    assert [p for layer in layers for p in layer] == list(getattr(gang, swaps))
    rng = np.random.default_rng(11)
    B = 20_000
    keys = torch.as_tensor(rng.choice(np.array([0.0, -0.0, np.inf, 0.5, 1.0, 2.0, 3.5],
                                               dtype=np.float32), (B, 8)))
    refs = torch.as_tensor(rng.choice(np.array([-1, 0, 7, 1234, -2, -3, -90], dtype=np.int32),
                                      (B, 8)) + rng.integers(0, 3, (B, 8)).astype(np.int32)
                           * (rng.random((B, 8)) < 0.5))
    k_s, r_s = gang._sort(keys, refs, getattr(gang, swaps))
    k_l, r_l = _layered_sort(keys, refs, layers)
    assert torch.equal(k_s, k_l) and torch.equal(r_s, r_l)
    sps = torch.as_tensor(np.where(rng.random(B) < 0.7, rng.integers(150, 161, B),
                                   rng.integers(0, 161, B)))
    lqs = torch.as_tensor(np.where(rng.random(B) < 0.7, rng.integers(8, 16, B),
                                   rng.integers(0, 16, B)))
    start = torch.as_tensor(rng.integers(-5, 5, (B, gang.STACK_DEPTH + 1)).astype(np.int32))
    qstart = torch.as_tensor(rng.integers(-5, 5, (B, gang.LEAFQ_DEPTH + 1)).astype(np.int32))
    for variant in ("full", "nopushst", "pushbase", "nopush"):
        got = [start.clone(), qstart.clone()]
        want = [start.clone(), qstart.clone()]
        sp_g, lq_g = _prefix_pushes(r_l, sps, lqs, *got, variant)
        sp_w, lq_w = _serial_pushes(r_s, sps, lqs, *want, variant)
        assert torch.equal(sp_g, sp_w) and torch.equal(lq_g, lq_w), variant
        # What a pop can read: the slots below the scrap slot.
        assert torch.equal(got[0][:, :gang.SCRAP], want[0][:, :gang.SCRAP]), variant
        assert torch.equal(got[1][:, :gang.QSCRAP], want[1][:, :gang.QSCRAP]), variant
    assert int((sps + (r_s >= 0).sum(-1) > gang.STACK_DEPTH).sum()) > 1000  # stacks overflow


def _micro_serial_pushes(refs, sps, stack):
    """micro_plain's push stage on every row: c = 7 .. 0, each taken child
    stored at sp (an untaken one at the scrap slot), sp capped at MICRO_CAP
    after each."""
    for c in range(7, -1, -1):
        r = refs[..., c]
        take = (r != -1) & (sps < gang.STACK_DEPTH)
        stack.scatter_(1, torch.where(take, sps, gang.SCRAP)[..., None], r[..., None])
        sps = torch.where(take, (sps + 1).clamp(max=gang.MICRO_CAP), sps)
    return sps


def _micro_ballot_pushes(refs, sps, stack):
    """pg_micro's push stage: one ballot of the taken children (ref != -1);
    child c's slot is sp + the taken children > c; under the cap each stores
    there, past it only the lowest taken child stores, at the cap; sp + the
    taken count, capped."""
    taken = refs != -1
    later = taken.flip(-1).long().cumsum(-1).flip(-1) - taken.long()
    slot = sps[..., None] + later
    lowest = torch.arange(8) == taken.long().argmax(-1, keepdim=True)
    store = taken & ((slot < gang.MICRO_CAP) | lowest)
    stack.scatter_(1, torch.where(store, slot.clamp(max=gang.MICRO_CAP), gang.SCRAP), refs)
    return (sps + taken.sum(-1)).clamp(max=gang.MICRO_CAP)


def test_micro_ballot_pushes_equal_capped_serial():
    """pg_micro's decomposition of the sort and the capped pushes, held to
    micro_plain's serial network and push loop on seeded keys full of ties
    (0.0, -0.0, +inf) and refs of every kind (-1 untaken, leaves, nodes),
    with stack pointers from empty to the cap, so that the pushes end below,
    at and past MICRO_CAP; every slot a pop can read (below the cap) and the
    slot at the cap equal."""
    rng = np.random.default_rng(13)
    B = 20_000
    keys = torch.as_tensor(rng.choice(np.array([0.0, -0.0, np.inf, 0.5, 1.0, 2.0],
                                               dtype=np.float32), (B, 8)))
    refs = torch.as_tensor(rng.choice(np.array([-1, -1, 0, 7, 1234, -2, -90], dtype=np.int32),
                                      (B, 8)))
    k_s, r_s = gang._sort(keys, refs, gang.SWAPS)
    k_l, r_l = _layered_sort(keys, refs, gang.LAYERS)
    assert torch.equal(k_s, k_l) and torch.equal(r_s, r_l)
    sps = torch.as_tensor(rng.integers(0, gang.MICRO_CAP + 1, B))
    start = torch.as_tensor(rng.integers(-5, 5, (B, gang.STACK_DEPTH + 1)).astype(np.int32))
    got, want = start.clone(), start.clone()
    assert torch.equal(_micro_ballot_pushes(r_l, sps, got), _micro_serial_pushes(r_s, sps, want))
    assert torch.equal(got[:, :gang.MICRO_CAP + 1], want[:, :gang.MICRO_CAP + 1])
    end = sps + (r_s != -1).sum(-1)
    for case in (end < gang.MICRO_CAP, end == gang.MICRO_CAP, end > gang.MICRO_CAP + 1):
        assert int(case.sum()) > 1000


def test_gang_minimum_on_unsigned_bits():
    """The kernel's gang minimum: fminf over a thread's 4 rays, + 0.0f, then
    the least of the 32 lanes' float bits read as unsigned. Equal to the
    minimum over the 128 rays for keys >= 0 or +inf, -0.0 among them; without
    the + 0.0f a -0.0 orders above +inf."""
    rng = np.random.default_rng(12)
    vals = np.array([0.0, -0.0, np.inf, 1e-30, 0.25, 7.0], dtype=np.float32)
    keys = torch.as_tensor(rng.choice(vals, (4096, 32, 4), p=[.2, .2, .4, .05, .1, .05]))
    keys[:64] = torch.where(torch.rand(64, 32, 4) < 0.99, float("inf"), -0.0)  # lone -0.0s
    thread = torch.fmin(torch.fmin(keys[..., 0], keys[..., 1]),
                        torch.fmin(keys[..., 2], keys[..., 3])) + 0.0

    def bits_min(x):
        u = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
        return u.amin(-1).to(torch.int32).view(torch.float32)

    got = bits_min(thread)
    want = keys.reshape(4096, 128).amin(-1)
    assert torch.equal(got, want)
    assert not bool(torch.signbit(got).any())
    flat = keys.reshape(4096, 128)
    zero = flat == 0
    neg_zero = zero.any(-1) & ~(zero & ~torch.signbit(flat)).any(-1)  # only -0.0 zeros
    assert int(neg_zero.sum()) > 0
    raw = torch.fmin(torch.fmin(keys[..., 0], keys[..., 1]), torch.fmin(keys[..., 2], keys[..., 3]))
    assert not torch.equal(bits_min(raw)[neg_zero], want[neg_zero])


def test_wrappers_route_by_device(room):
    """On CPU tensors the wrappers run the plain versions (counted there);
    the kernel entry points refuse CPU tensors; two-level tables are refused."""
    before = dict(gang.plain_calls), dict(gang.launches)
    gang.ablate(room.gt, room.wave, "full", 2)
    gang.micro(room.gt.table, torch.zeros(1, 8, 128), "loop", 2)
    assert gang.plain_calls == {k: v + 1 for k, v in before[0].items()}
    assert gang.launches == before[1]
    with pytest.raises(RuntimeError):
        gang.ablate_kernel(room.gt, room.wave, "full", 2)
    with pytest.raises(RuntimeError):
        gang.micro_kernel(room.gt.table, torch.zeros(1, 8, 128), "loop", 2)
    with pytest.raises(ValueError):
        gang.ablate_plain(room.gt, room.wave, "nothing", 2)
    with pytest.raises(ValueError):
        gang.gang_table(room.tables._replace(two_level=True))


def test_phase_counters_patch_the_kernel():
    """tools/torch_gang_phase_cycles.py finds each of its anchors in
    csrc/probe_gang.cu once, and refuses to run without a card."""
    import importlib

    mod = importlib.import_module("tools.torch_gang_phase_cycles")
    with open(os.path.join(REPO, "gpu_raytracer_tpu_torch", "csrc", "probe_gang.cu")) as f:
        source = f.read()
    patched = mod.patch(source)
    assert patched.count("clock64()") == 4 and 'extern "C" int pg_stats' in patched
    with pytest.raises(ValueError):
        mod.patch(source.replace("    busy = votes >= PG_BUSY_VOTES;\n", ""))
    assert mod.main([]) == 1


@pytest.mark.parametrize("tool", ["torch_exp_gang_ablate", "torch_exp_gang_micro"])
def test_entry_point_runs_on_cpu(tool):
    """The entry points end to end at a tiny size on the CPU: one JSON line
    a variant (stage), no times (no card)."""
    import importlib
    import json

    mod = importlib.import_module(f"tools.{tool}")
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main(["--device", "cpu", "--width", "64", "--height", "32", "--subdiv", "1",
                  "--iters", "4", "--tiles", "2"])
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    names = gang.ABLATE_VARIANTS if tool.endswith("ablate") else gang.MICRO_STAGES
    assert [x["variant"] for x in lines if "variant" in x] == list(names)
    assert all(x["device"] == "cpu" and x["ms"] is None for x in lines if "variant" in x)
