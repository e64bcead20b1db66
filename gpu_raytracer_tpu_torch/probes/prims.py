"""Gang-primitive probes: the Hopper counterparts of the TPU probes
tools/exp_gang_prims.py (seven bodies) and tools/exp_gang_prims2.py (four),
which priced what an 8-gang traversal needs: dependent row loads, row
assembly, lane broadcasts, a row reduction, per-gang SMEM stacks, a
per-gang choice of table, a masked row update.

A tile is 8 gangs (rows) of 128 lanes; out (8, 128) f32. Tables are (n,
128) f32 with n a power of two; a chase takes the next row index from the
row just loaded: next = int(row[5]) & (n - 1) (truncating). Per iteration:

  single   one chase from seed[0, 0]; acc += row[0] + row[64] (every element)
  stack    gang g chases from seed[g, 0]; acc[g] += its row
  scratch  the same (the TPU assembled the rows through VMEM scratch)
  full     as stack, then s = sum_c row_g[6c] * acc (c = 0..7, in order),
           s += min over the gang's lanes of s, acc = s * 1e-9 + acc; acc
           starts at 0.5
  smem     8 stacks of 64 int32 (SMEM), each seeded with seed[g, 0]: every
           gang pops v, pushes (v + i) & (n - 1) (sp capped: slot 63 is
           scrap); acc += the row at (sum of the 8 popped v) & (n - 1)
  cond     as stack, the row from `table` if the index is odd, else `table2`
  maskupd  acc[g] = acc[g] * row_g[0] + row_g[1]; acc starts at 1
  v1       no chase: row (i * 1237) % n; a scalar acc += row[0] + row[64]
  v2       the same row; acc += row[0] (every element)
  v3       one chase from seed[0, 0]; a scalar acc += row[0]
  v4       one chase from seed[0, 0]; acc[:, l] += row[l]

On the probes' own tables (uniform in [0, 1)) every chase reads row 0 from
its second iteration on, and `full` returns 0.5 everywhere (s * 1e-9
vanishes beside 0.5); `chase_table` makes column 5 a random cycle over the
rows, and a table times SCALED makes `full` vary.

On a CUDA tensor `prims` launches `csrc/probe_prims.cu` and raises if it
cannot. The seven chasing bodies (PATH_BODIES) run `pp_path_kernel<BODY>`:
a block reads column 5 of every row into a next-row map in shared memory,
walks the chase once through it until a row repeats (a tail of mu rows,
then a cycle of lam), stages the values each iteration adds for the path's
rows, and runs each output's chain in the plain version's f32 order over
them (`next_map` and `walk` are its map and walk in numpy); tables of more
than PATH_MAX_ROWS rows are refused. v1 and v2 gather CHUNK iterations'
values at once, summed by one thread in iteration order; smem keeps the
stacks' tops in registers, 128 threads summing the row all 8 gangs add;
full runs a warp a gang, the chase an iteration ahead of the arithmetic
(ROADMAP C46, C47). On a CPU tensor it runs `prims_plain`: the same
arithmetic in the same f32 order, the gangs a batch dimension, the
iterations a Python loop, float-to-int as the kernel's truncating cast
(`gang.trunc_i32`).
"""

from __future__ import annotations

import torch

from gpu_raytracer_tpu_torch.ops import _native
from gpu_raytracer_tpu_torch.ops.wide_traverse import INFO
from gpu_raytracer_tpu_torch.probes import c_ptr, c_stream, median_ms, plain_on_card
from gpu_raytracer_tpu_torch.probes.gang import trunc_i32

SHAPE = (8, 128)
GANGS, LANES = SHAPE
PRIMS_BODIES = ("single", "stack", "scratch", "full", "smem", "cond", "maskupd",
                "v1", "v2", "v3", "v4")
STACK = 64           # k_smem: (8, 64) int32, slot 63 the scrap
STRIDE = 1237
CHUNK = 1024         # v1, v2: iterations gathered at once (probe_prims.cu PP_CHUNK)
# The chasing bodies' kernel (pp_path_kernel): the most table rows it takes,
# the least run of its staged cycle, its block's threads, the steps of its
# walk between two checks for a repeated row.
PATH_MAX_ROWS = 16384
RUN = 512
PATH_THREADS = 512
WALK = 128
FULL_SCALE = 1e-9
# `full` on its own table returns 0.5 everywhere; on the table times
# SCALED its output varies by gang and stays finite over the probe's 100,000
# iterations (a table times 1e8 overflows to inf within a few hundred).
SCALED = 1e4
# The JAX probes' sizes (tools/exp_gang_prims.py, exp_gang_prims2.py).
N = 4096
ITERS = 100_000
ITERS2 = (50_000, 400_000)

SITES = {
    "single": "exp_gang_prims.py:64 k_single", "stack": "exp_gang_prims.py:82 k_stack",
    "scratch": "exp_gang_prims.py:100 k_scratch", "full": "exp_gang_prims.py:121 k_full",
    "smem": "exp_gang_prims.py:146 k_smem", "cond": "exp_gang_prims.py:177 k_cond",
    "maskupd": "exp_gang_prims.py:201 k_maskupd", "v1": "exp_gang_prims2.py:52 k_v1",
    "v2": "exp_gang_prims2.py:62 k_v2", "v3": "exp_gang_prims2.py:72 k_v3",
    "v4": "exp_gang_prims2.py:85 k_v4",
}
# Distinct f32 values one iteration computes (the bound's operations).
OPS_PER_ITER = {"single": 2, "stack": 1024, "scratch": 1024, "full": 20 * 1024,
                "smem": 1024 + 8 * 4, "cond": 1024, "maskupd": 2 * 1024, "v1": 2, "v2": 1,
                "v3": 1, "v4": 128}

# The chasing bodies, which run pp_path_kernel; every body has a kernel of its
# own (kernel_info reports each).
PATH_BODIES = ("single", "stack", "scratch", "cond", "maskupd", "v3", "v4")
OWN_KERNELS = PRIMS_BODIES

launches = {"pp_gang": 0}
plain_calls = {"pp_gang": 0}


def _check(body, table, table2, seed):
    if body not in PRIMS_BODIES:
        raise ValueError(f"body {body!r} not in {PRIMS_BODIES}")
    n = table.shape[0]
    for t in (table, table2):
        if t.shape != (n, LANES) or t.dtype != torch.float32 or t.device != table.device:
            raise ValueError("tables must be (n, 128) float32 on one device")
    if n & (n - 1) or n < 128:
        raise ValueError(f"the table rows must be a power of two >= 128, got {n}")
    if seed.shape != SHAPE or seed.dtype != torch.int32 or seed.device != table.device:
        raise ValueError("seed must be (8, 128) int32 on the table's device")


def prims_plain(body: str, table: torch.Tensor, table2: torch.Tensor, seed: torch.Tensor,
                iters: int) -> torch.Tensor:
    """Plain PyTorch version of `pp_gang<body>` (any device)."""
    _check(body, table, table2, seed)
    plain_calls["pp_gang"] += 1
    dev = table.device
    mask = table.shape[0] - 1

    def chase(rows):
        return (trunc_i32(rows[..., 5]) & mask).long()

    if body in ("v1", "v2"):
        idx = torch.arange(iters, dtype=torch.int64, device=dev) * STRIDE % table.shape[0]
        rows = table[idx]
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(iters):
            acc = acc + rows[i, 0]
            if body == "v1":
                acc = acc + rows[i, 64]
        return acc.expand(SHAPE).clone()
    if body in ("single", "v3", "v4"):
        v = seed[0, 0].long()
        acc = torch.zeros(() if body != "v4" else LANES, dtype=torch.float32, device=dev)
        for _ in range(iters):
            row = table[v]
            acc = acc + (row if body == "v4" else row[0])
            if body == "single":
                acc = acc + row[64]
            v = chase(row)
        return acc.expand(SHAPE).clone()
    if body == "smem":
        stack = torch.zeros((GANGS, STACK), dtype=torch.int64, device=dev)
        stack[:, 0] = seed[:, 0]
        sp = 1  # every gang's: the pushes never differ in count
        acc = torch.zeros(SHAPE, dtype=torch.float32, device=dev)
        for i in range(iters):
            spm = sp - 1 if sp > 0 else 0
            v = stack[:, spm]
            ok = sp > 0 and spm + 1 < STACK - 1
            stack[:, spm + 1 if ok else STACK - 1] = (v + i) & mask
            sp = spm + 1 + int(ok)
            acc = acc + table[v.sum() & mask]
        return acc
    v = seed[:, 0].long()
    acc = torch.full(SHAPE, {"full": 0.5, "maskupd": 1.0}.get(body, 0.0), dtype=torch.float32,
                     device=dev)
    for _ in range(iters):
        rows = table[v]
        if body == "cond":
            rows = torch.where((v & 1 != 0)[:, None], rows, table2[v])
        if body == "full":
            s = torch.zeros(SHAPE, dtype=torch.float32, device=dev)
            for c in range(8):
                s = s + rows[:, 6 * c:6 * c + 1] * acc
            s = s + s.amin(dim=1, keepdim=True)
            acc = s * FULL_SCALE + acc
        elif body == "maskupd":
            acc = acc * rows[:, 0:1] + rows[:, 1:2]
        else:
            acc = acc + rows
        v = chase(rows)
    return acc


def prims_kernel(body: str, table: torch.Tensor, table2: torch.Tensor, seed: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Launch `pp_gang<body>` on CUDA tensors (raises otherwise)."""
    _check(body, table, table2, seed)
    if body in PATH_BODIES and table.shape[0] > PATH_MAX_ROWS:
        raise ValueError(f"pp_gang<{body}> takes at most {PATH_MAX_ROWS} table rows, "
                         f"got {table.shape[0]}")
    if table.device.type != "cuda":
        raise RuntimeError("prims_kernel needs CUDA tensors")
    lib = _native.load()
    table, table2, seed = table.contiguous(), table2.contiguous(), seed.contiguous()
    out = torch.empty(SHAPE, dtype=torch.float32, device=table.device)
    err = lib.pp_gang(PRIMS_BODIES.index(body), c_ptr(table), c_ptr(table2), c_ptr(seed),
                      table.shape[0], int(iters), c_ptr(out), c_stream(table.device))
    _native.check(err, f"probe_prims.pp_gang<{body}>")
    launches["pp_gang"] += 1
    return out


def kernel_info(body: str = "stack") -> dict:
    """What the compiler and the occupancy API report for the kernel that
    runs `body` (INFO; the chasing bodies' at the probes' N rows, with the
    dynamic shared memory it takes there)."""
    import ctypes

    if body not in PRIMS_BODIES:
        raise ValueError(f"body {body!r} not in {PRIMS_BODIES}")
    lib = _native.load()
    out = (ctypes.c_int * len(INFO))()
    _native.check(lib.pp_kernel_info(PRIMS_BODIES.index(body), out),
                  f"probe_prims.kernel_info({body})")
    return dict(zip(INFO, list(out)))


def prims(body: str, table: torch.Tensor, table2: torch.Tensor, seed: torch.Tensor,
          iters: int) -> torch.Tensor:
    """The kernel on a CUDA table, the plain version on a CPU one."""
    if table.device.type == "cuda":
        return prims_kernel(body, table, table2, seed, iters)
    if table.device.type == "cpu":
        return prims_plain(body, table, table2, seed, iters)
    raise RuntimeError(f"no gang-primitive probe for device {table.device}")


# ---------------------------------------------------------------------------
# The probe runs (tools/torch_exp_gang_prims.py and chip_smoke.py phase 3pr)
# ---------------------------------------------------------------------------

def chase_table(rng, n: int = N):
    """A table uniform in [0, 1) whose column 5 holds a random cycle over
    its n rows (row r's next index), as float32 (numpy)."""
    import numpy as np

    table = rng.random((n, LANES), dtype=np.float32)
    perm = rng.permutation(n)
    nxt = np.empty(n, np.int64)
    nxt[perm] = np.roll(perm, -1)
    table[:, 5] = nxt.astype(np.float32)
    return table


def random_map_table(rng, n: int = N):
    """A table uniform in [0, 1) whose column 5 is uniform over its n rows
    (a random map: a chase runs a tail into a short cycle), as float32
    (numpy)."""
    import numpy as np

    table = rng.random((n, LANES), dtype=np.float32)
    table[:, 5] = rng.integers(0, n, n)
    return table


def probe_inputs(rng, n: int = N) -> dict:
    """The probes' inputs from seeded numpy, as numpy: the tables uniform in
    [0, 1), the seed uniform over the rows; two chase tables (column 5 a
    random cycle over the rows), the second `cond`'s other table; the first
    table times SCALED (where `full` varies); and two random-map tables."""
    import numpy as np

    table = rng.random((n, LANES), dtype=np.float32)
    out = {"table": table, "table2": rng.random((n, LANES), dtype=np.float32),
           "seed": rng.integers(0, n, SHAPE).astype(np.int32),
           "chase": chase_table(rng, n), "chase2": chase_table(rng, n),
           "scaled": table * np.float32(SCALED)}
    out["rmap"], out["rmap2"] = random_map_table(rng, n), random_map_table(rng, n)
    return out


def next_map(body: str, table, table2):
    """pp_path_kernel's next-row map (numpy): nxt[r] = int(row_r[5]) & (n -
    1), row r from `table`, or for `cond` from `table2` where r is even."""
    col = table[:, 5].copy()
    if body == "cond":
        col[::2] = table2[::2, 5]
    return trunc_i32(torch.as_tensor(col)).long().numpy() & (table.shape[0] - 1)


def walk(nxt, seed: int, iters: int) -> tuple:
    """pp_path_kernel's walk (numpy): (path, mu, lam). path[k] is the row
    iteration k reads, for k < len(path); the walk stops at the first row
    reached again (mu the step that first reached it, lam = len(path) - mu)
    or after `iters` steps (mu = lam = 0). The kernel walks WALK steps at a
    time and finds the first repeat between batches, to the same result.
    The seed's low bits name its row, as torch indexing does for any seed
    in [-n, n)."""
    import numpy as np

    n = len(nxt)
    stamp = np.full(n, -1, np.int64)
    v, path = int(seed) & (n - 1), []
    while len(path) < iters:
        if stamp[v] >= 0:
            return np.array(path, np.int64), int(stamp[v]), len(path) - int(stamp[v])
        stamp[v] = len(path)
        path.append(v)
        v = int(nxt[v])
    return np.array(path, np.int64), 0, 0


def runs(iters: int = ITERS, iters2=ITERS2) -> list:
    """(body, iterations) as the JAX tools run them."""
    return ([(b, iters) for b in PRIMS_BODIES[:7]]
            + [(b, it) for it in iters2 for b in PRIMS_BODIES[7:]])


def needed(body: str, rows_read: int, iters: int) -> tuple:
    """(bytes, operations): each distinct row read once (512 bytes), the
    seed read and the output written once; OPS_PER_ITER a iteration."""
    return rows_read * 512 + 2 * GANGS * LANES * 4, iters * OPS_PER_ITER[body]


def rows_read(body: str, table, table2, seed, iters: int) -> int:
    """Distinct rows a body reads in `iters` iterations: the kernel's walk of
    each chase (numpy tables; `cond`'s row v comes from one table, fixed by
    v's parity)."""
    import numpy as np

    n = table.shape[0]
    if body in ("v1", "v2"):
        return len(np.unique(np.arange(min(iters, n), dtype=np.int64) * STRIDE % n))
    if body == "smem":
        # The pops freeze once every stack pointer reaches its cap.
        stack = [[int(s)] + [0] * (STACK - 1) for s in seed[:, 0]]
        sp, seen = 1, set()
        for i in range(min(iters, 2 * STACK)):
            spm = max(sp - 1, 0)
            v = [st[spm] for st in stack]
            ok = sp > 0 and spm + 1 < STACK - 1
            for st, x in zip(stack, v):
                st[spm + 1 if ok else STACK - 1] = (x + i) & (n - 1)
            sp = spm + 1 + int(ok)
            seen.add(sum(v) & (n - 1))
        return len(seen)
    starts = seed[:1, 0] if body in ("single", "v3", "v4") else seed[:, 0]
    nxt = next_map(body, table, table2)
    return len(set().union(*(walk(nxt, s, iters)[0].tolist() for s in starts)))


def smem_rows(seeds, iters: int, n: int) -> list:
    """The row `smem` adds at each iteration: the sum of the 8 gangs' pops
    & (n - 1), each stack its top (a push goes just above the slot popped
    until the stack is full, then to the scrap slot, and nothing moves)."""
    top, sp, out = [int(x) for x in seeds], 1, []
    for i in range(iters):
        out.append(sum(top) & (n - 1))
        if sp >= STACK - 1:  # full: every later pop is this one
            return out + out[-1:] * (iters - i - 1)
        top, sp = [(t + i) & (n - 1) for t in top], sp + 1
    return out


def library_call(body: str, table: torch.Tensor, seed: torch.Tensor, iters: int):
    """One `index_select` of the values `body` reads, then one `torch.sum`:
    its value up to the order of the sum (v1, v2 a scalar, smem a row of
    128), a call with no arguments; None for the chases, which no library
    call computes."""
    n = table.shape[0]
    if body in ("v1", "v2"):
        at = torch.arange(iters, dtype=torch.int64, device=table.device) * STRIDE % n * LANES
        idx = torch.stack((at, at + 64), 1).reshape(-1) if body == "v1" else at
        flat = table.reshape(-1)
        return lambda: torch.sum(flat.index_select(0, idx))
    if body == "smem":
        idx = torch.as_tensor(smem_rows(seed[:, 0].tolist(), iters, n), device=table.device)
        return lambda: torch.sum(table.index_select(0, idx), dim=0)
    return None


def probe_prims(device, iters: int = ITERS, iters2=ITERS2, n: int = N, seed: int = 0,
                timer=None) -> list:
    """Every body at the probes' iteration counts, on the probes' own tables
    and on the chase tables, and `full` on the scaled table; on the card the
    chasing bodies also on the random-map tables. On the card each body
    against its plain version (bit-equal) at 2n + 3 iterations for the
    chasing bodies (past the walk's longest path and two of its wraps) and
    2 * CHUNK + 3 for the others (past two of v1's and v2's chunks and past
    smem's stacks filling at 62), then the kernel timed with `timer` at the
    probe's count, ns an iteration as the JAX tools print it, and for v1,
    v2 and smem `library_call` timed beside it (`library_ms`); on the CPU
    the plain version at `iters`, no times."""
    import numpy as np

    inp = probe_inputs(np.random.default_rng(seed), n)
    sd = torch.as_tensor(inp["seed"], device=device)
    on_card = torch.device(device).type == "cuda"
    out = []
    for kind, first, second in (("own", "table", "table2"), ("chase", "chase", "chase2"),
                                ("scaled", "scaled", "table2"), ("rmap", "rmap", "rmap2")):
        if kind == "rmap" and not on_card:
            continue
        t, t2 = (torch.as_tensor(inp[k], device=device) for k in (first, second))
        for body, it in runs(iters, iters2):
            if (kind == "scaled" and body != "full") or (kind == "rmap"
                                                         and body not in PATH_BODIES):
                continue
            res = prims(body, t, t2, sd, it)
            row = {"kernel": "pp_gang", "body": body, "probe": SITES[body], "table": kind,
                   "iters": it, "device": t.device.type, "ms": None, "ns_per_iter": None,
                   "plain_ms": None, "library_ms": None,
                   "distinct": int(torch.unique(res).numel())}
            if t.device.type == "cuda":
                pi = min(it, 2 * n + 3 if body in PATH_BODIES else 2 * CHUNK + 3)
                k = prims_kernel(body, t, t2, sd, pi)
                ref, row["plain_ms"] = plain_on_card(lambda: prims_plain(body, t, t2, sd, pi))
                if not torch.equal(k, ref):
                    raise AssertionError(f"pp_gang<{body}> ({kind} table) differs from its "
                                         f"plain version on {int((k != ref).sum())} lanes")
                row.update(median_ms(timer, lambda: prims_kernel(body, t, t2, sd, it)),
                           parity_iters=pi)
                row["ns_per_iter"] = 1e6 * row["ms"] / it
                call = library_call(body, t, sd, it)
                if call is not None:
                    row["library_ms"] = median_ms(timer, call)["ms"]
            r = rows_read(body, inp[first], inp[second], inp["seed"], it)
            row["rows"] = r
            row["bytes"], row["ops"] = needed(body, r, it)
            out.append(row)
    return out
