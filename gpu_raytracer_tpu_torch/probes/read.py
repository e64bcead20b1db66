"""Scalar-read and shared-memory-ceiling probes: the Hopper counterparts of
the TPU probes tools/exp_scalar_read.py (bodies A-E, `kernelE`), which
chose the TPU node-table layout, and tools/exp_vmem2.py (`kernel_roll`,
`vmem_probe`) with tools/exp_blocksync.py `vmem_probe`.

Each body sums, in f32 and in pop order, what one pop reads; every value
is a single element at an index the scalar core computes (node = (i *
1237) % n for pop i). Out: (8, 128) f32, every element the sum.

  A     20 reads tab[c, node], c < 20, of a component-major (24, n) table
  B     row tab[node] of (n, 128) (node < n); the sum of row[0..19]
  C     row tab[node // 8] of (n / 8, 128), node < n; the sum of
        row[off .. off + 15], off = (node % 8) * 16 (a dynamic extract)
  D     20 int32 words tab[c, node] of (20, n); each word's 4 bytes added
        as int32, then to the f32 sum
  E     as A, of a (20, 8192) table (the TPU probe's SMEM table)
  roll  row x[i % 64] of (64, 128), rotated left by (i % 8) * 16
        (`pltpu.roll(row, -(i % 8) * 16)`); the sum of its first 16
        (exp_vmem2.py kernel_roll, 256 pops)
  ceiling  x[0, :] stored into a dynamic shared-memory buffer of the asked
        bytes, (8, 128) filled with its element 0 (the `vmem_probe`
        kernels: a scratch of `mb` MB; the TPU tool reports which sizes
        compile; `smem_ceiling` finds the largest that launches on the card)

A sum starts at 0.0 and adds in the probe's order (Python `sum` from 0).

On a CUDA tensor `read` launches `csrc/probe_read.cu` (`pr_read<BODY,
SPACE>`: SPACE "ldg", the table read in place through the read-only path,
or "shared", staged into shared memory first, where it fits one block) and
raises if it cannot; on a CPU tensor it runs `read_plain`. One 1024-thread
block takes the pops CHUNK at a time: it gathers the chunk's values in
parallel, sums each pop's values on its own thread, then one thread adds the
pops' sums in order, the probe's f32 order; every thread writes the result.
"""

from __future__ import annotations

import torch

from gpu_raytracer_tpu_torch.ops import _native
from gpu_raytracer_tpu_torch.ops.wide_traverse import INFO
from gpu_raytracer_tpu_torch.probes import c_ptr, c_stream, median_ms, plain_on_card

SHAPE = (8, 128)
READ_BODIES = ("A", "B", "C", "D", "E", "roll", "ceiling")
SPACES = ("ldg", "shared")
STRIDE = 1237
READS = 20          # A, B, D, E
EXTRACT = 16        # C, roll
ROLL_ROWS = 64
# The JAX probes' sizes (tools/exp_scalar_read.py, exp_vmem2.py).
N = 40_000
POPS = 256
E_COLS = 8192
ROLL_POPS = 256
CHUNK = 256         # pops a round of the kernel: gather, per-pop sums, chain

SITES = {
    "A": "exp_scalar_read.py:38 makeA.kernel",
    "B": "exp_scalar_read.py:60 makeB.kernel",
    "C": "exp_scalar_read.py:80 makeC.kernel",
    "D": "exp_scalar_read.py:105 makeD.kernel",
    "E": "exp_scalar_read.py:150 kernelE (and makeE.kernel :132)",
    "roll": "exp_vmem2.py:41 kernel_roll",
    "ceiling": "exp_vmem2.py:14 / exp_blocksync.py:25 vmem_probe.kernel",
}

launches = {"pr_read": 0}
plain_calls = {"pr_read": 0}


def _check(body: str, table: torch.Tensor):
    if body not in READ_BODIES:
        raise ValueError(f"body {body!r} not in {READ_BODIES}")
    want = torch.int32 if body == "D" else torch.float32
    if table.dim() != 2 or table.dtype != want:
        raise ValueError(f"body {body} takes a 2-D {want} table, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if body in ("A", "D", "E") and table.shape[0] < READS:
        raise ValueError(f"body {body} reads {READS} rows")
    if body in ("B", "C", "roll", "ceiling") and table.shape[1] != 128:
        raise ValueError(f"body {body} takes rows of 128")


def nodes(body: str, table: torch.Tensor, pops: int) -> torch.Tensor:
    """The node index of each pop, (pops,) int64."""
    i = torch.arange(pops, dtype=torch.int64, device=table.device)
    n = {"B": table.shape[0], "C": 8 * table.shape[0]}.get(body, table.shape[1])
    return i * STRIDE % n if body != "roll" else i % table.shape[0]


def flat_index(body: str, table: torch.Tensor, pops: int) -> torch.Tensor:
    """(K, pops) int64: the flat table index of read k of each pop, in the
    probe's order (K = 20 for A, B, D, E; 16 for C and roll)."""
    node = nodes(body, table, pops)
    C = table.shape[1]
    k = torch.arange(READS if body in ("A", "B", "D", "E") else EXTRACT,
                     device=table.device)[:, None]
    if body in ("A", "D", "E"):
        return k * C + node
    if body == "B":
        return node * C + k
    if body == "C":
        return (node // 8) * C + (node % 8) * EXTRACT + k
    i = torch.arange(pops, device=table.device)
    return node * C + (k + (i % 8) * EXTRACT) % C


def _pop_sums(body: str, table: torch.Tensor, pops: int) -> torch.Tensor:
    """(pops,) f32: what each pop adds, summed in the probe's order."""
    vals = table.reshape(-1)[flat_index(body, table, pops)]
    if body == "D":
        vals = ((vals & 0xFF) + ((vals >> 8) & 0xFF) + ((vals >> 16) & 0xFF)
                + ((vals >> 24) & 0xFF)).float()
    s = torch.zeros(pops, dtype=torch.float32, device=table.device)
    for v in vals:
        s = s + v
    return s


def read_plain(body: str, table: torch.Tensor, pops: int = POPS) -> torch.Tensor:
    """Plain PyTorch version of `pr_read<body>` (any device). For `ceiling`
    the table is x (8, 128) and `pops` is not used."""
    _check(body, table)
    plain_calls["pr_read"] += 1
    if body == "ceiling":
        return table[0, 0].expand(SHAPE).clone()
    acc = torch.zeros((), dtype=torch.float32, device=table.device)
    for s in _pop_sums(body, table, pops):
        acc = acc + s
    return acc.expand(SHAPE).clone()


def read_kernel(body: str, table: torch.Tensor, pops: int = POPS, space: str = "ldg",
                smem_bytes: int = 0) -> torch.Tensor:
    """Launch `pr_read<body, space>` on a CUDA table (raises otherwise);
    `ceiling` launches with `smem_bytes` of dynamic shared memory."""
    out, err = _launch(body, table, pops, space, smem_bytes)
    _native.check(err, f"probe_read.pr_read<{body}, {space}>")
    return out


def _launch(body, table, pops, space, smem_bytes):
    _check(body, table)
    if space not in SPACES:
        raise ValueError(f"space {space!r} not in {SPACES}")
    if table.device.type != "cuda":
        raise RuntimeError("read_kernel needs CUDA tensors")
    lib = _native.load()
    table = table.contiguous()
    if table.data_ptr() % 16 or table.numel() % 4:
        raise ValueError("the table must be 16-byte aligned, a multiple of 4 words")
    out = torch.empty(SHAPE, dtype=torch.float32, device=table.device)
    err = lib.pr_read(READ_BODIES.index(body), SPACES.index(space), c_ptr(table),
                      table.shape[0], table.shape[1], int(pops), int(smem_bytes), c_ptr(out),
                      c_stream(table.device))
    if err == 0:
        launches["pr_read"] += 1
    return out, err


def read(body: str, table: torch.Tensor, pops: int = POPS, space: str = "ldg",
         smem_bytes: int = 0) -> torch.Tensor:
    """The kernel on a CUDA table, the plain version on a CPU one."""
    if table.device.type == "cuda":
        return read_kernel(body, table, pops, space, smem_bytes)
    if table.device.type == "cpu":
        return read_plain(body, table, pops)
    raise RuntimeError(f"no read probe for device {table.device}")


def kernel_info(body: str = "A", space: str = "ldg") -> dict:
    """What the compiler and the occupancy API report for `pr_read<body,
    space>` on the card (INFO)."""
    import ctypes

    lib = _native.load()
    out = (ctypes.c_int * len(INFO))()
    _native.check(lib.pr_kernel_info(READ_BODIES.index(body), SPACES.index(space), out),
                  f"probe_read.kernel_info({body}, {space})")
    return dict(zip(INFO, list(out)))


# cudaErrorInvalidValue: the launch asked for more dynamic shared memory
# than a block may opt in to.
REFUSED = 1


def smem_ceiling(x: torch.Tensor, timer=None) -> dict:
    """The largest dynamic shared memory (a multiple of 16 bytes) with which
    `pr_read<ceiling>` launches, found by bisection over launches on the
    card (card only), each launch's output held to x[0, 0]; the device
    attribute cudaDevAttrMaxSharedMemoryPerBlockOptin beside it, and the
    error code of the launch one 16-byte step above the ceiling. A launch
    that fails with another code than REFUSED raises. With `timer`, the
    launch at the ceiling and the plain fill are timed."""
    if x.device.type != "cuda":
        raise RuntimeError("smem_ceiling needs a CUDA tensor (the ceiling is the card's)")
    lib = _native.load()
    want = read_plain("ceiling", x)

    def fits(nbytes: int) -> bool:
        out, err = _launch("ceiling", x, 0, "ldg", nbytes)
        if err == REFUSED:
            return False
        _native.check(err, f"probe_read.pr_read<ceiling> at {nbytes} bytes")
        if not torch.equal(out, want):
            raise AssertionError(f"pr_read<ceiling> at {nbytes} bytes does not fill x[0, 0]")
        return True

    lo, hi, ladder = 0, 1 << 20, []
    while hi - lo > 16:
        mid = (lo + hi) // 32 * 16
        ok = fits(mid)
        ladder.append((mid, ok))
        lo, hi = (mid, hi) if ok else (lo, mid)
    _, above = _launch("ceiling", x, 0, "ldg", lo + 16)
    out = {"ceiling_bytes": lo, "attribute_bytes": int(lib.pr_smem_optin()),
           "above_error": int(above), "ladder": ladder, "ms": None, "plain_ms": None,
           "bytes": 4 * (SHAPE[1] + SHAPE[0] * SHAPE[1]), "ops": 0}
    if timer is not None:
        out["ms"] = median_ms(timer, lambda: read_kernel("ceiling", x, 0, "ldg", lo))["ms"]
        out["plain_ms"] = median_ms(timer, lambda: read_plain("ceiling", x))["ms"]
    return out


# ---------------------------------------------------------------------------
# The probe runs (tools/torch_exp_scalar_read.py and chip_smoke.py phase 3pr)
# ---------------------------------------------------------------------------

def probe_table(rng, body: str, n: int = N):
    """A body's input as the JAX probes draw it (seeded numpy): A (24, n),
    B and C (n / 8, 128), E (20, 8192) and roll (64, 128) uniform in [0, 1);
    D (20, n) int32 uniform in [0, 2^31); ceiling x (8, 128)."""
    import numpy as np

    if body == "D":
        return (rng.random((READS, n)) * 2 ** 31).astype(np.int32)
    shape = {"A": (24, n), "B": (n // 8, 128), "C": (n // 8, 128), "E": (READS, E_COLS),
             "roll": (ROLL_ROWS, 128), "ceiling": SHAPE}[body]
    return rng.random(shape, dtype=np.float32)


def needed(body: str, table: torch.Tensor, pops: int) -> tuple:
    """(bytes, operations, flat indices of the values read in pop order):
    each distinct value read once, the output written once; an add a value
    (D: 7 integer operations and the add)."""
    flat = flat_index(body, table, pops).T.reshape(-1)
    per = 8 if body == "D" else 1
    return (4 * int(torch.unique(flat).numel()) + 4 * SHAPE[0] * SHAPE[1],
            flat.numel() * per, flat)


def probe_reads(device, pops: int = POPS, n: int = N, seed: int = 0, timer=None) -> list:
    """Every body but the ceiling at the probes' sizes (roll: 256 pops),
    in both spaces where the table fits one block's shared memory (roll)
    and in place otherwise. On the card each launch against the plain
    version (bit-equal), timed with `timer`, ns a pop, beside two PyTorch
    calls on the values read (A, B, C, E, roll): one `index_select` (the
    gather alone, `library_ms`) and one `embedding_bag` of them as one bag
    with mode="sum" (the probe's value up to the order of the sum,
    `embedding_bag_ms`); on the CPU the plain version, no times."""
    import torch.nn.functional as F

    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for body in READ_BODIES[:-1]:
        table = torch.as_tensor(probe_table(rng, body, n), device=device)
        p = ROLL_POPS if body == "roll" else pops
        nbytes, ops, flat = needed(body, table, p)
        ref = None
        for space in (SPACES if body == "roll" else SPACES[:1]):
            out = read(body, table, p, space)
            row = {"kernel": "pr_read", "body": body, "probe": SITES[body], "space": space,
                   "table": list(table.shape), "table_bytes": table.numel() * 4, "pops": p,
                   "device": table.device.type, "ms": None, "ns_per_pop": None,
                   "plain_ms": None, "library_ms": None, "embedding_bag_ms": None,
                   "bytes": nbytes, "ops": ops,
                   "sum": float(out[0, 0])}
            if table.device.type == "cuda":
                if ref is None:
                    ref, plain_ms = plain_on_card(lambda: read_plain(body, table, p))
                if not torch.equal(out, ref):
                    raise AssertionError(f"pr_read<{body}, {space}> differs from its plain "
                                         f"version: {float(out[0, 0])} vs {float(ref[0, 0])}")
                row.update(median_ms(timer, lambda: read_kernel(body, table, p, space)),
                           plain_ms=plain_ms)
                row["ns_per_pop"] = 1e6 * row["ms"] / p
                if body != "D":
                    flat_t = table.view(-1)
                    one_bag = torch.zeros(1, dtype=torch.int64, device=table.device)
                    row["library_ms"] = median_ms(
                        timer, lambda: flat_t.index_select(0, flat))["ms"]
                    row["embedding_bag_ms"] = median_ms(
                        timer, lambda: F.embedding_bag(flat, flat_t.view(-1, 1), one_bag,
                                                       mode="sum"))["ms"]
            rows.append(row)
    return rows
