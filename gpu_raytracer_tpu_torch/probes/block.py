"""Block-synchronous pop loop: the Hopper counterpart of the TPU probe
tools/exp_blocksync.py (`make_pop_kernel`, the body its `wrapper` runs
through `kernel_flat`), which priced one stack for a whole (8, 128) tile.

One tile is 1,024 lanes that share ONE stack of STACK int32 node ids (the
TPU's SMEM scalars). Each of `pops` iterations pops the top (an empty stack
pops slot 0 again), reads the node's (64,) f32 row of the (N, 64) table
([48 child bounds | 8 child refs | 8 pad]; the probe reads only the
bounds), and slab-tests its 8 children on every lane in child order:

    tx0 = (bx0 - ox) * ix ...        ix = 1 / dx (f32)
    tn  = max(max(min(tx0, tx1), min(ty0, ty1)), min(tz0, tz1))
    tf  = min(min(max(tx0, tx1), max(ty0, ty1)), max(tz0, tz1))
    hit = tn <= tf and tf > 0 and tn < best_t
    if any lane hits and sp < STACK: push (node * 8 + c + 1) % N
    best_t = hit ? min(best_t, tn + 1e30) : best_t

then caps sp at SP_CAP. Out: best_t (8, 128) f32, 1e30 at the start.

On the probe's own inputs (a table uniform in [-1, 1), origins 0) every
lane returns 1e30: tn + 1e30 rounds back to 1e30 for |tn| << 1e23. A table
scaled by 1e29 makes best_t vary (`pop_inputs(scale=1e29)`).

On a CUDA tensor `pop` launches `csrc/probe_block.cu` (`pb_pop`: the
tile's lanes spread over a cluster of CLUSTER blocks, the hit masks
exchanged through distributed shared memory, every warp replaying the
stack, the next pop's row fetched ahead from `next_candidates`) and raises
if it cannot; on a CPU tensor it runs `pop_plain`, the plain PyTorch
version: the same arithmetic in the same order, the stack a Python list.
"""

from __future__ import annotations

import torch

from gpu_raytracer_tpu_torch.ops import _native
from gpu_raytracer_tpu_torch.ops.wide_traverse import INFO
from gpu_raytracer_tpu_torch.probes import c_ptr, c_stream, median_ms, plain_on_card

SHAPE = (8, 128)
LANES = SHAPE[0] * SHAPE[1]   # one tile
CLUSTER = 8                   # pb_pop's blocks a tile (a cluster)
ROW = 64                      # floats a node row
STACK = 64
SP_CAP = 48
FAR = 1e30
# The JAX probe's sizes (tools/exp_blocksync.py).
N = 20_000
POPS = 256
# Operations a lane spends on one child: 6 subtractions and 6 products, 10
# min/max, 5 compares and ands, the add, min and select of best_t.
OPS_PER_CHILD = 30

launches = {"pb_pop": 0}
plain_calls = {"pb_pop": 0}
# The latest plain call's distinct popped nodes (the rows it reads).
last_work = {"rows": 0}


def _check(tab: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    if tab.dim() != 2 or tab.shape[1] != ROW or tab.dtype != torch.float32:
        raise ValueError(f"the table must be (N, {ROW}) float32, got {tuple(tab.shape)} "
                         f"{tab.dtype}")
    for x in (o, d):
        if x.shape != (3, *SHAPE) or x.dtype != torch.float32 or x.device != tab.device:
            raise ValueError("o and d must be (3, 8, 128) float32 on the table's device")


def pop_plain(tab: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
              pops: int = POPS) -> torch.Tensor:
    """Plain PyTorch version of `pb_pop` (any device)."""
    _check(tab, o, d)
    plain_calls["pb_pop"] += 1
    n = tab.shape[0]
    ox, oy, oz = o
    ix, iy, iz = (1.0 / x for x in d)
    stack, sp = [0] * STACK, 1
    best = torch.full(SHAPE, FAR, dtype=torch.float32, device=tab.device)
    seen = set()
    for _ in range(pops):
        top = max(sp - 1, 0)
        node, sp = stack[top], top
        seen.add(node)
        row = tab[node]
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
            if sp < STACK and bool(hit.any()):
                stack[sp] = (node * 8 + c + 1) % n
                sp += 1
            best = torch.where(hit, torch.minimum(best, tn + FAR), best)
        sp = min(sp, SP_CAP)
    last_work["rows"] = len(seen)
    return best


def next_candidates(node: int, stack: list, sp: int, n: int) -> list:
    """The rows `pb_pop` fetches at the top of a pop of `node`, before its
    slab test (sp after the pop): the 8 children the pop may push, (node * 8
    + c + 1) % n, then the entry below the popped one, stack[sp - 1] (the
    popped node itself, slot 0, where sp is 0). The next pop reads the child
    pushed on top, or the last where the pop pushed nothing."""
    return [(node * 8 + c + 1) % n for c in range(8)] + [stack[max(sp - 1, 0)]]


def pop_kernel(tab: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
               pops: int = POPS) -> torch.Tensor:
    """Launch `pb_pop` on CUDA tensors (raises otherwise)."""
    _check(tab, o, d)
    if tab.device.type != "cuda":
        raise RuntimeError("pop_kernel needs CUDA tensors")
    lib = _native.load()
    tab, o, d = tab.contiguous(), o.contiguous(), d.contiguous()
    if tab.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    out = torch.empty(SHAPE, dtype=torch.float32, device=tab.device)
    err = lib.pb_pop(c_ptr(tab), tab.shape[0], c_ptr(o), c_ptr(d), int(pops), c_ptr(out),
                     c_stream(tab.device))
    _native.check(err, "probe_block.pb_pop")
    launches["pb_pop"] += 1
    return out


def kernel_info() -> dict:
    """What the compiler and the occupancy API report for `pb_pop` (INFO: a
    block of the cluster), and its cluster size."""
    import ctypes

    lib = _native.load()
    out = (ctypes.c_int * len(INFO))()
    _native.check(lib.pb_kernel_info(out), "probe_block.kernel_info")
    return {**dict(zip(INFO, list(out))), "cluster": CLUSTER}


def pop(tab: torch.Tensor, o: torch.Tensor, d: torch.Tensor, pops: int = POPS) -> torch.Tensor:
    """The kernel on a CUDA table, the plain version on a CPU one."""
    if tab.device.type == "cuda":
        return pop_kernel(tab, o, d, pops)
    if tab.device.type == "cpu":
        return pop_plain(tab, o, d, pops)
    raise RuntimeError(f"no pop probe for device {tab.device}")


# ---------------------------------------------------------------------------
# The probe runs (tools/torch_exp_blocksync.py and chip_smoke.py phase 3pr)
# ---------------------------------------------------------------------------

def pop_inputs(rng, n: int = N, scale: float = 1.0) -> tuple:
    """The probe's inputs from seeded numpy, as exp_blocksync.py draws them:
    a table uniform in [-1, 1) times `scale`, origins 0, directions uniform
    in [0.1, 1.1). As numpy (tab (n, 64), o (3, 8, 128), d (3, 8, 128))."""
    import numpy as np

    tab = (rng.random((n, ROW), dtype=np.float32) * 2 - 1) * np.float32(scale)
    o = np.zeros((3, *SHAPE), np.float32)
    d = rng.random((3, *SHAPE), dtype=np.float32) + np.float32(0.1)
    return tab, o, d


def bytes_ops(rows: int, pops: int) -> tuple:
    """(bytes, operations) of one run: each popped row and the rays read
    once, best_t written once; every lane slab-tests 8 children a pop."""
    return rows * ROW * 4 + 7 * LANES * 4, pops * LANES * 8 * OPS_PER_CHILD


def probe_pops(device, pops: int = POPS, n: int = N, seed: int = 0, timer=None) -> list:
    """The pop loop on the probe's own inputs and on the table scaled by
    1e29 (where best_t varies). On the card the kernel against its plain
    version (bit-equal), timed with `timer`, ns a pop as the JAX tool prints
    it; on the CPU the plain version, no times."""
    import numpy as np

    rows = []
    for label, scale in (("own", 1.0), ("scaled 1e29", 1e29)):
        tab, o, d = (torch.as_tensor(x, device=device)
                     for x in pop_inputs(np.random.default_rng(seed), n, scale))
        out = pop(tab, o, d, pops)
        row = {"kernel": "pb_pop", "probe": "exp_blocksync.py:110 kernel_flat", "table": label,
               "n": n, "pops": pops, "device": tab.device.type, "ms": None, "ns_per_pop": None,
               "plain_ms": None, "distinct": int(torch.unique(out).numel())}
        if tab.device.type == "cuda":
            ref, row["plain_ms"] = plain_on_card(lambda: pop_plain(tab, o, d, pops))
            if not torch.equal(out, ref):
                raise AssertionError(f"pb_pop ({label}) differs from its plain version on "
                                     f"{int((out != ref).sum())} lanes")
            row.update(median_ms(timer, lambda: pop_kernel(tab, o, d, pops)))
            row["ns_per_pop"] = 1e6 * row["ms"] / pops
        row["bytes"], row["ops"] = bytes_ops(last_work["rows"], pops)
        rows.append(row)
    return rows
