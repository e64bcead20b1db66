"""The gang-primitive probes' plain versions (gpu_raytracer_tpu_torch/probes/
prims.py) held to the JAX package's TPU probes tools/exp_gang_prims.py (7
bodies) and tools/exp_gang_prims2.py (4), run in interpret mode.

Both tools run their probes at module level, so the test compiles their
`run` and kernel functions from the source (tests/test_torch_probe_gang.
load_tool) and sets their table, table2 and seed globals from seeded numpy,
at N = 256 rows and 12 iterations; the files stay as they are.

Inputs: the probes' own (tables uniform in [0, 1): every chase reads row 0
from its second iteration on) and a chase table (column 5 a random cycle
over the rows; `cond`'s second table another), on which every
data-dependent body walks a fresh row every iteration; and
for `full`, whose own output is 0.5 everywhere, the table scaled by 1e8
and by prims.SCALED.

Bars: f32 sums within rtol 1e-6; `full` and `maskupd` within rtol 1e-5,
because XLA on the CPU may contract a*b+c (ROADMAP C6); the kernels keep
them unfused, as the plain version does."""

import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpu_raytracer_tpu_torch.probes import prims

from tests.test_torch_import import private_bvh_cache  # noqa: F401
from tests.test_torch_probe_gang import load_tool

torch.set_num_threads(2)

N, ITERS = 256, 12
CHASING = ("single", "stack", "scratch", "full", "smem", "cond", "maskupd", "v3", "v4")


@pytest.fixture(scope="module")
def inputs():
    return prims.probe_inputs(np.random.default_rng(11), N)


def _jax(body, table, table2, seed):
    """The JAX probe's output for `body` on these inputs (interpret mode)."""
    if body.startswith("v"):
        tool = load_tool("exp_gang_prims2.py", {"run", "k_" + body},
                         {"N": N, "table": jnp.asarray(table), "seed": jnp.asarray(seed)})
        fn = tool["run"](tool["k_" + body], ITERS)
    else:
        tool = load_tool("exp_gang_prims.py", {"run", "k_" + body},
                         {"N": N, "ITERS": ITERS, "table": jnp.asarray(table),
                          "table2": jnp.asarray(table2)})
        fn = tool["run"](tool["k_" + body], jnp.asarray(seed))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn())


def _ours(body, table, table2, seed):
    return prims.prims_plain(body, *(torch.as_tensor(x) for x in (table, table2, seed)),
                             ITERS).numpy()


def _rtol(body):
    return 1e-5 if body in ("full", "maskupd") else 1e-6


@pytest.mark.parametrize("body", prims.PRIMS_BODIES)
def test_own_tables_match_jax_probe(inputs, body):
    args = (inputs["table"], inputs["table2"], inputs["seed"])
    ours = _ours(body, *args)
    np.testing.assert_allclose(ours, _jax(body, *args), rtol=_rtol(body))
    if body in CHASING and body != "smem":  # smem's rows do not chase the table
        assert prims.rows_read(body, *args, ITERS) <= 16  # seeds, then row 0 (or table2's)
    if body == "full":
        assert (ours == np.float32(0.5)).all()


@pytest.mark.parametrize("body", [b for b in CHASING if b != "smem"])
def test_chase_table_matches_jax_probe(inputs, body):
    """On the chase table each chase walks a fresh row every iteration."""
    args = (inputs["chase"], inputs["chase2"], inputs["seed"])
    ours = _ours(body, *args)
    np.testing.assert_allclose(ours, _jax(body, *args), rtol=_rtol(body))
    assert prims.rows_read(body, *args, ITERS) >= ITERS
    if body not in ("single", "v3", "full"):  # scalar sums; full: the scaled table
        assert len(np.unique(ours)) > 1


@pytest.mark.parametrize("scale", [1e8, prims.SCALED])
def test_full_on_scaled_table_matches_jax_probe(inputs, scale):
    """The table times 1e8, and times prims.SCALED (the card's run: finite
    over the probe's 100,000 iterations), make `full` vary."""
    args = (inputs["table"] * np.float32(scale), inputs["table2"], inputs["seed"])
    ours = _ours("full", *args)
    np.testing.assert_allclose(ours, _jax("full", *args), rtol=1e-5)
    assert len(np.unique(ours)) > 1


def test_wrappers_route_by_device(inputs):
    """On CPU tensors the wrapper runs the plain version (counted there) and
    the kernel entry point refuses; tables whose rows are no power of two
    are refused."""
    t, t2, sd = (torch.as_tensor(inputs[k]) for k in ("table", "table2", "seed"))
    before = dict(prims.plain_calls), dict(prims.launches)
    prims.prims("stack", t, t2, sd, 2)
    assert prims.plain_calls["pp_gang"] == before[0]["pp_gang"] + 1
    assert prims.launches == before[1]
    with pytest.raises(RuntimeError):
        prims.prims_kernel("stack", t, t2, sd, 2)
    with pytest.raises(ValueError):
        prims.prims_plain("stack", t[:200], t2[:200], sd, 2)


def test_entry_point_runs_on_cpu():
    """tools/torch_exp_gang_prims.py end to end at a tiny size on the CPU:
    one JSON line a body and table, no times (no card)."""
    import importlib

    mod = importlib.import_module("tools.torch_exp_gang_prims")
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main(["--device", "cpu", "--n", "256", "--iters", "3", "--iters2", "2", "4"])
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert len(lines) == 2 * len(prims.runs(3, (2, 4))) + 1
    assert all(x["device"] == "cpu" and x["ms"] is None for x in lines)
    assert {x["table"] for x in lines} == {"own", "chase", "scaled"}
    assert [x for x in lines if x["table"] == "scaled"][0]["distinct"] > 1


# ---------------------------------------------------------------------------
# The redesigned kernels' decompositions (csrc/probe_prims.cu), mirrored
# ---------------------------------------------------------------------------

def _stack_pops(seeds, iters: int, n: int) -> list:
    """prims_plain's smem stack loop, its pops as they come: [(8 pops), ...]."""
    mask = n - 1
    stack = np.zeros((prims.GANGS, prims.STACK), np.int64)
    stack[:, 0] = seeds
    sp, out = 1, []
    for i in range(iters):
        spm = sp - 1 if sp > 0 else 0
        v = stack[:, spm].copy()
        ok = sp > 0 and spm + 1 < prims.STACK - 1
        stack[:, spm + 1 if ok else prims.STACK - 1] = (v + i) & mask
        sp = spm + 1 + int(ok)
        out.append(tuple(v))
    return out


def _smem_pops_ahead(seeds, iters: int, n: int) -> list:
    """pp_smem_kernel's rule: each stack is its top in a register (a push
    goes just above the slot popped, or to the scrap slot once full); once a
    push finds the stack full nothing moves again, so the kernel stops
    stepping and repeats the last pops for the rest of the iterations."""
    mask = n - 1
    top = [int(x) & 0xFFFFFFFF for x in seeds]
    sp, out, i = 1, [], 0
    while i < iters:
        spm = sp - 1 if sp > 0 else 0
        ok = sp > 0 and spm + 1 < prims.STACK - 1
        out.append(tuple(top))
        if ok:
            top = [(t + i) & mask for t in top]
        nsp = spm + 1 + int(ok)
        i += 1
        if not ok and nsp == sp:  # the fixed point: every later pop is this one
            out += [out[-1]] * (iters - i)
            break
        sp = nsp
    return out


@pytest.mark.parametrize("n", [8, 4096])
@pytest.mark.parametrize("iters", [0, 1, 61, 62, 63, 64, 300])
def test_smem_pops_ahead_match_the_stack_loop(n, iters):
    """smem's pops worked out ahead in registers equal the plain version's
    stack loop at 0, 1, 61, 62 (the stacks fill), 63, 64 and 300 iterations,
    at n = 8 and 4096 (seeds past n too: only their low bits count); at
    4096 the kernel's sum (one row a step at the pops' sum, the same for
    all 8 gangs) is prims_plain's bit for bit."""
    rng = np.random.default_rng(n + iters)
    seeds = rng.integers(0, 4 * n, prims.GANGS)
    ahead = _smem_pops_ahead(seeds, iters, n)
    loop = _stack_pops(seeds, iters, n)
    assert [tuple(v & (n - 1) for v in p) for p in ahead] == \
        [tuple(v & (n - 1) for v in p) for p in loop]
    if iters > 62:
        assert len(set(ahead[62:])) == 1  # from i = 62 the same pops
    if n >= 128:
        table = torch.as_tensor(rng.random((n, prims.LANES), dtype=np.float32))
        seed = torch.as_tensor(np.repeat(seeds[:, None], prims.LANES, 1).astype(np.int32))
        acc = np.zeros(prims.LANES, np.float32)
        for p in ahead:
            acc = acc + table[sum(p) & (n - 1)].numpy()
        ref = prims.prims_plain("smem", table, table, seed, iters).numpy()
        np.testing.assert_array_equal(np.broadcast_to(acc, ref.shape), ref)


def _chunked_sum(table: np.ndarray, body: str, iters: int) -> np.float32:
    """pp_sum_kernel: round r gathers iterations r * CHUNK + t on thread t,
    each thread's row carried modulo n from round to round (one add, no
    product that could overflow), then one thread adds the round's values
    in iteration order (row[0], then row[64] for v1) in f32."""
    n = table.shape[0]
    step = prims.CHUNK * prims.STRIDE % n
    node = np.arange(prims.CHUNK, dtype=np.uint32) * np.uint32(prims.STRIDE) % np.uint32(n)
    acc = np.float32(0.0)
    for r in range(-(-iters // prims.CHUNK)):
        m = min(prims.CHUNK, iters - r * prims.CHUNK)
        i = r * prims.CHUNK + np.arange(m)
        assert (node[:m] == i * prims.STRIDE % n).all()
        cols = (0, 64) if body == "v1" else (0,)
        vals = np.stack([table[node[:m], c] for c in cols], axis=1).reshape(-1)
        for v in vals:
            acc = np.float32(acc + v)
        node = np.where(node + step >= n, node + step - n, node + step).astype(np.uint32)
    return acc


@pytest.mark.parametrize("body", ["v1", "v2"])
@pytest.mark.parametrize("count", ["1", "CHUNK-1", "CHUNK", "CHUNK+1", "2CHUNK+3"])
def test_sum_gathered_in_chunks_matches_plain(body, count):
    """v1 and v2 gathered a chunk at a time and summed in iteration order
    are prims_plain's bit for bit, at counts that straddle one and two
    chunks."""
    C = prims.CHUNK
    iters = {"1": 1, "CHUNK-1": C - 1, "CHUNK": C, "CHUNK+1": C + 1, "2CHUNK+3": 2 * C + 3}[count]
    rng = np.random.default_rng(iters)
    table = rng.random((256, prims.LANES), dtype=np.float32)
    seed = torch.zeros(prims.SHAPE, dtype=torch.int32)
    t = torch.as_tensor(table)
    ref = prims.prims_plain(body, t, t, seed, iters).numpy()
    got = _chunked_sum(table, body, iters)
    assert (ref.view(np.int32) == np.float32(got).view(np.int32)).all()


def test_sum_rows_carried_at_the_probe_count():
    """The carried row of every thread equals (i * 1237) % n for all of
    400,000 iterations at n = 4096 (the probe's count and table)."""
    n, iters = 4096, 400_000
    step = prims.CHUNK * prims.STRIDE % n
    node = np.arange(prims.CHUNK, dtype=np.int64) * prims.STRIDE % n
    for r in range(-(-iters // prims.CHUNK)):
        i = r * prims.CHUNK + np.arange(prims.CHUNK)
        assert (node == i * prims.STRIDE % n).all()
        node = (node + step) % n


def _key(x: np.ndarray) -> np.ndarray:
    """pp_key: the bits of x + 0.0f, negatives' magnitude bits flipped, so
    the signed int order is the float order (-0.0 becomes +0.0); a NaN
    keys as INT32_MIN."""
    b = (x.astype(np.float32) + np.float32(0.0)).view(np.int32)
    k = b ^ ((b >> 31) & 0x7FFFFFFF)
    return np.where(np.isnan(x), np.int32(np.iinfo(np.int32).min), k).astype(np.int32)


def _unkey(k) -> np.float32:
    k = np.int32(k)
    return np.array([k ^ ((k >> 31) & 0x7FFFFFFF)], np.int32).view(np.float32)[0]


def _gang_min(s: np.ndarray) -> np.float32:
    """pp_full_kernel's gang minimum of 128 lanes: a thread's least key over
    its lanes lane + 32 j, then the warp's least (one REDUX)."""
    return _unkey(_key(s.reshape(4, 32)).min(axis=0).min())


def test_full_gang_minimum_by_float_bits_matches_amin(inputs):
    """The float-bits minimum `full` uses equals torch.amin on mixes of
    +-0.0, ties, negatives and the scaled table's values; a NaN lane makes
    it a NaN, as amin's; a -0.0 minimum comes back +0.0, which the kernel's
    next step (s + m, then s * 1e-9 + acc) cannot tell from -0.0 unless s
    and acc are zeros too."""
    rng = np.random.default_rng(3)
    scaled = (inputs["table"] * np.float32(prims.SCALED)).astype(np.float32)
    cases = [scaled[r] for r in range(0, 256, 37)]
    cases += [-scaled[5], np.zeros(128, np.float32), -np.zeros(128, np.float32)]
    mix = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, 2.0**-149, -(2.0**-149), 3e38, -3e38],
                              np.float32), (20, 128))
    cases += list(mix)
    tie = rng.random(128, dtype=np.float32)
    tie[[3, 77, 100]] = -7.25
    cases.append(tie)
    for s in cases:
        got, ref = _gang_min(s), torch.amin(torch.as_tensor(s)).item()
        assert got == ref
        if ref != 0.0:
            assert np.float32(got).view(np.int32) == np.float32(ref).view(np.int32)
    assert np.float32(_gang_min(-np.zeros(128, np.float32))).view(np.int32) == 0  # +0.0
    nan = scaled[0].copy()
    nan[40] = np.nan
    assert np.isnan(_gang_min(nan)) and np.isnan(torch.amin(torch.as_tensor(nan)).item())


@pytest.mark.parametrize("body", ["v1", "v2", "smem"])
def test_library_call_reads_the_same_values(inputs, body):
    """The library yardstick of v1, v2 and smem (one index_select of the
    values read, one torch.sum) is the plain version's value up to the
    order of the sum; smem's rows are the stack rule's."""
    t, sd = torch.as_tensor(inputs["chase"]), torch.as_tensor(inputs["seed"])
    iters = 300
    ref = prims.prims_plain(body, t, t, sd, iters)
    got = prims.library_call(body, t, sd, iters)()
    np.testing.assert_allclose(np.broadcast_to(got.numpy(), ref.shape), ref.numpy(), rtol=1e-5)
    if body == "smem":
        pops = _smem_pops_ahead(inputs["seed"][:, 0], iters, N)
        assert prims.smem_rows(inputs["seed"][:, 0], iters, N) == [sum(p) % N for p in pops]
    assert prims.library_call("stack", t, sd, iters) is None


# ---------------------------------------------------------------------------
# The chasing bodies' kernel (pp_path_kernel): its walk (prims.next_map,
# prims.walk), its staged path and its ordered sums, mirrored in numpy
# ---------------------------------------------------------------------------




def _staged_rows(path, mu: int, lam: int, iters: int) -> tuple:
    """(rows, lp): the rows whose values pp_path_kernel stages, in order (the
    path, then its cycle again up to mu + lp, at most `iters`), and lp, the
    least multiple of lam that is >= RUN (0 where the walk found no cycle)."""
    if lam == 0:
        return path, 0
    lp = lam if lam >= prims.RUN else -(-prims.RUN // lam) * lam
    j = np.arange(min(iters, mu + lp))
    return path[np.where(j < len(path), j, mu + (j - mu) % lam)], lp


def _iteration_entries(staged: int, mu: int, lp: int, iters: int):
    """The staged entry each iteration reads: the `staged` entries once, then
    entries mu .. mu + lp - 1 run after run (the kernel's counter)."""
    runs, left = [np.arange(min(staged, iters))], iters - staged
    while left > 0:
        runs.append(mu + np.arange(min(lp, left)))
        left -= lp
    return np.concatenate(runs)


_TABLES = {}


def _path_inputs(n: int) -> dict:
    """probe_inputs at n rows (n may be under the wrapper's 128: the schedule
    is numpy), made once a size."""
    if n not in _TABLES:
        _TABLES[n] = prims.probe_inputs(np.random.default_rng(100 + n), n)
    return _TABLES[n]


_KINDS = {"own": ("stack", "table", "table2"), "chase": ("stack", "chase", "chase2"),
          "rmap": ("stack", "rmap", "rmap2"), "cond": ("cond", "rmap", "rmap2")}


def _direct_rows(body, table, table2, seed: int, iters: int) -> list:
    """The rows a chase reads, iteration by iteration, straight from the
    tables: next = int(row[5]) & (n - 1), `cond`'s row v from `table2`
    where v is even (column 5 holds small whole numbers or [0, 1) here)."""
    n, v, out = table.shape[0], int(seed) & (table.shape[0] - 1), []
    for _ in range(iters):
        out.append(v)
        src = table2 if body == "cond" and not v & 1 else table
        v = int(src[v, 5]) & (n - 1)
    return out


@pytest.mark.parametrize("n", [8, 256, 4096])
@pytest.mark.parametrize("kind", list(_KINDS))
@pytest.mark.parametrize("count", ["0", "1", "mu", "mu+lam-1", "mu+lam", "3(mu+lam)+1"])
def test_path_schedule_matches_the_direct_chase(n, kind, count):
    """The kernel's schedule (the next-row map, the walk with stamps until a
    row repeats, mu and lam, the staged path with its cycle repeated to at
    least RUN iterations, and the staged entry of iteration i by a counter)
    reads the rows the direct chase reads, on the own table (mu <= 1, lam =
    1), the chase table (mu = 0, lam = n), a random map (a tail and a short
    cycle) and `cond`'s two-table map, at 0, 1, mu, mu + lam - 1, mu + lam
    and 3 (mu + lam) + 1 iterations."""
    body, a, b = _KINDS[kind]
    inp = _path_inputs(n)
    table, table2, seed = inp[a], inp[b], int(inp["seed"][3, 0])
    nxt = prims.next_map(body, table, table2)
    full, mu, lam = prims.walk(nxt, seed, n + 1)
    assert 1 <= lam and mu + lam <= n and len(full) == mu + lam
    if kind == "own":
        assert mu <= 1 and lam == 1
    if kind == "chase":
        assert mu == 0 and lam == n
    iters = {"0": 0, "1": 1, "mu": mu, "mu+lam-1": mu + lam - 1, "mu+lam": mu + lam,
             "3(mu+lam)+1": 3 * (mu + lam) + 1}[count]
    path, m, lm = prims.walk(nxt, seed, iters)
    if iters > mu + lam:
        assert (m, lm) == (mu, lam)
    else:
        assert (m, lm) == (0, 0) and len(path) == iters
    rows, lp = _staged_rows(path, m, lm, iters)
    assert len(rows) <= n + prims.RUN
    if lm:  # lp: the least multiple of lam that is >= RUN
        assert lp % lm == 0 and lp >= prims.RUN and lp - lm < prims.RUN
    got = rows[_iteration_entries(len(rows), m, lp, iters)] if iters else rows[:0]
    assert got.tolist() == _direct_rows(body, table, table2, seed, iters)


def _path_sums(body, table, table2, seed, iters: int) -> np.ndarray:
    """pp_path_kernel's output in numpy: a gang's (or the one) chase walked,
    its path's values staged, and each chain run over the staged entries in
    the kernel's order in f32."""
    nxt = prims.next_map(body, table, table2)
    gangs = range(prims.GANGS) if body in ("stack", "scratch", "cond", "maskupd") else [0]
    out = np.zeros(prims.SHAPE, np.float32)
    for g in gangs:
        path, mu, lam = prims.walk(nxt, seed[g, 0], iters)
        rows, lp = _staged_rows(path, mu, lam, iters)
        staged = table[rows].copy()
        if body == "cond":
            even = rows % 2 == 0
            staged[even] = table2[rows[even]]
        acc = np.full(prims.LANES, np.float32(1.0 if body == "maskupd" else 0.0), np.float32)
        for j in _iteration_entries(len(rows), mu, lp, iters) if iters else []:
            r = staged[j]
            if body == "single":
                acc = (acc + r[0]) + r[64]
            elif body == "v3":
                acc = acc + r[0]
            elif body == "maskupd":
                acc = acc * r[0] + r[1]
            else:
                acc = acc + r
        if body in ("single", "v3", "v4"):
            out[:] = acc
        else:
            out[g] = acc
    return out


@pytest.mark.parametrize("body", prims.PATH_BODIES)
@pytest.mark.parametrize("kind", ["own", "chase", "rmap"])
def test_path_sums_match_plain(body, kind):
    """The chains over the staged path values, in the kernel's order (the
    staged run once, then the cycle run after run), are prims_plain's bit
    for bit for all seven chasing bodies at 2 (n + RUN) + 3 iterations on a
    128-row table: past two wraps of every gang's staged cycle."""
    _, a, b = _KINDS[kind]
    inp = _path_inputs(128)
    table, table2, seed = inp[a], inp[b], inp["seed"]
    iters = 2 * (128 + prims.RUN) + 3
    ref = prims.prims_plain(body, *(torch.as_tensor(x) for x in (table, table2, seed)),
                            iters).numpy()
    got = _path_sums(body, table, table2, seed, iters)
    assert (ref.view(np.int32) == got.view(np.int32)).all()


def _path_bytes(body: str, n: int) -> int:
    """pp_path_bytes: the path (n + WALK ints), then the larger of the map
    and the stamps (n ints each) and the staged values (cols chains of
    pp_stride values, a pair a value for single and maskupd)."""
    cols = 1 if body in ("single", "maskupd", "v3") else 8 if n <= 4096 else 4 if n <= 8192 else 2
    stride = n + prims.RUN if cols == 1 else -(-(n + prims.RUN) // 32) * 32 + 32 // cols
    staged = cols * stride * (8 if body in ("single", "maskupd") else 4)
    return 4 * (n + prims.WALK) + max(8 * n, staged)


def test_path_kernel_refuses_tables_past_its_cap():
    """Every chasing body's shared memory fits the H100's 232,448 opt-in bytes
    at every table size up to PATH_MAX_ROWS; the wrapper refuses a table of
    more rows with a ValueError before it looks at the device (the plain
    version takes it)."""
    for body in prims.PATH_BODIES:
        for n in (128, 1024, 4096, 8192, prims.PATH_MAX_ROWS):
            assert _path_bytes(body, n) <= 232_448, (body, n)
    big = torch.zeros((2 * prims.PATH_MAX_ROWS, prims.LANES), dtype=torch.float32)
    seed = torch.zeros(prims.SHAPE, dtype=torch.int32)
    for body in prims.PATH_BODIES:
        with pytest.raises(ValueError):
            prims.prims_kernel(body, big, big, seed, 1)
    assert prims.prims_plain("stack", big, big, seed, 2).shape == prims.SHAPE
