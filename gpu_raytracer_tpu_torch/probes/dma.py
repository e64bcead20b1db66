"""Dynamic-offset copy probes: the Hopper counterparts of the TPU probes
tools/exp_dma.py, exp_dma2.py, exp_dma3.py and exp_dma4.py, which looked
for a form of windowed HBM -> VMEM copy that Mosaic would compile.

Every body copies a window of `count` floats of a table (a flat f32 view)
into on-chip memory at an offset, `iters` times, and reads it:

  offset (in floats) = (raw // div) * unit, raw from the body's OFFSET:
    static     a constant, `base`
    smem       `base` written to shared memory and read back (exp_dma3 kC)
    array      offs[b, i], a device int32 array (the TPU's SMEM input)
    vmin       the minimum of an (8, 128) index tile offs[b, i, :]
    vmin_smem  the same, routed through shared memory
  out:
    sum1  (1, 1): sum over the copies of window[0], in copy order from 0.0
    sum   (8, 128): the same sum in every element
    col   (8, 128): row r is window[r * stride] (the window of the last
          copy), the TPU's scratch[0:8, 0:1] broadcast along the lanes
    rows  (8, 128): table rows read in place at the offset, no copy
          (exp_dma4 kG2, a dynamic-slice read of an input)

`count` 0 copies the whole table; `pad` floats of destination lie beyond
the copy (exp_dma4 kJ: a (N + 256, 16) destination). B independent
windows run at once (one block each, or one 2-block cluster each): offs
(B, iters) for array, (B, iters, 1024) for vmin; out (B, *shape).

exp_dma3 kE cannot trace: it indexes its 1-D scratch with two indices
(`scratch[0:8, 0:1]` on (4096,)). Its body here is what it means,
tab1[0:8] down the rows (stride 1). exp_dma4 kG is a stub that nothing
runs; it has no body here.

On a CUDA tensor `copy` launches `csrc/probe_dma.cu` (`pd_copy`, with the
copy mechanism MECH: "cp_async", 16-byte cp.async by every thread, or
"bulk", the TMA 1-D bulk copy issued by one thread and completed on an
mbarrier) and raises if it cannot; on a CPU tensor it runs `copy_plain`:
the windows gathered, the values read and summed in the same order.
A block keeps up to PD_RING copies in flight (`kernel_info`'s "ring"),
each in a slot of its own, and refills a slot once thread 0, the only
thread that reads a window before the last, has read it (ROADMAP C46).
A destination larger than one block's shared memory is split over a
2-block cluster, each block holding half and the reading block taking its
values from the owner through distributed shared memory once the owner
has signalled that its half landed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpu_raytracer_tpu_torch.ops import _native
from gpu_raytracer_tpu_torch.ops.wide_traverse import INFO
from gpu_raytracer_tpu_torch.probes import c_ptr, c_stream, median_ms, plain_on_card

SHAPE = (8, 128)
TILE = SHAPE[0] * SHAPE[1]
OFFSETS = ("static", "smem", "array", "vmin", "vmin_smem")
OUTS = ("sum1", "sum", "col", "rows")
MECHS = ("cp_async", "bulk")
# Shared memory a copy block keeps besides its window (its barrier, the
# warp minima): a destination within the opt-in limit less this fits one
# block.
STATIC_SMEM = 1024
# The JAX probes' sizes.
N = 160_000           # exp_dma.py
N_SMALL = 4096        # exp_dma2-4
CHUNK = 256
WIDTH = 16
ITERS = 64
WINDOW = CHUNK * WIDTH


class Body(NamedTuple):
    site: str       # TPU body: file:line name
    tool: str       # the JAX tool (its globals name the inputs below)
    table: str      # the tool's global holding the table
    offs: str       # the tool's global holding the offsets ("" for static, smem)
    offset: str     # OFFSETS
    base: int
    unit: int
    div: int
    count: int      # floats copied; 0: the whole table
    pad: int        # destination floats beyond the copy
    iters: int      # copies; 0: the tool's ITERS
    out: str        # OUTS
    stride: int     # col: floats between the rows read


def _b(site, tool, table, offs, offset, base=0, unit=WIDTH, div=1, count=WINDOW, pad=0,
       iters=1, out="col", stride=WIDTH):
    return Body(site, tool, table, offs, offset, base, unit, div, count, pad, iters, out, stride)


BLOCK_UNIT = CHUNK * WIDTH   # one (256, 16) block of the 3-D table
BODIES = {
    "dma.static": _b("exp_dma.py:44 k_static", "exp_dma", "tab", "", "static", iters=0,
                     out="sum1"),
    "dma.smem": _b("exp_dma.py:58 k_smem", "exp_dma", "tab", "los", "array", iters=0,
                   out="sum1"),
    "dma.vmin": _b("exp_dma.py:73 k_vmin", "exp_dma", "tab", "idx", "vmin", iters=0,
                   out="sum1"),
    "dma.vmin_smem": _b("exp_dma.py:88 k_vmin_smem", "exp_dma", "tab", "idx", "vmin_smem",
                        iters=0, out="sum1"),
    "dma.hbm": _b("exp_dma.py:105 k_hbm", "exp_dma", "tab", "los", "array", iters=0,
                  out="sum1"),
    "dma2.k1": _b("exp_dma2.py:30 k1", "exp_dma2", "tab", "", "static", count=0),
    "dma2.k2": _b("exp_dma2.py:42 k2", "exp_dma2", "tab", "", "static"),
    "dma2.k3": _b("exp_dma2.py:54 k3", "exp_dma2", "tab", "", "static", iters=4, out="sum"),
    "dma2.k4": _b("exp_dma2.py:69 k4", "exp_dma2", "tab", "", "static"),
    "dma2.k5": _b("exp_dma2.py:82 k5", "exp_dma2", "tab", "", "static", out="sum1"),
    "dma3.kA": _b("exp_dma3.py:35 kA", "exp_dma3", "tab2", "", "static"),
    "dma3.kB": _b("exp_dma3.py:45 kB", "exp_dma3", "tab3", "", "static", base=2,
                  unit=BLOCK_UNIT),
    "dma3.kC": _b("exp_dma3.py:55 kC", "exp_dma3", "tab3", "", "smem", base=3,
                  unit=BLOCK_UNIT),
    "dma3.kD": _b("exp_dma3.py:68 kD", "exp_dma3", "tab3", "idx", "vmin", unit=BLOCK_UNIT,
                  div=CHUNK),
    "dma3.kE": _b("exp_dma3.py:81 kE (cannot trace; held to tab1[0:8])", "exp_dma3", "tab1",
                  "", "static", unit=1, stride=1),
    "dma3.kF": _b("exp_dma3.py:92 kF", "exp_dma3", "tab3", "bs", "array", unit=BLOCK_UNIT,
                  iters=0, out="sum"),
    "dma4.kE": _b("exp_dma4.py:33 kE", "exp_dma4", "tab1", "", "static", base=256, unit=1,
                  out="sum"),
    "dma4.kE3": _b("exp_dma4.py:43 kE3", "exp_dma4", "tab1", "lo", "array", out="sum"),
    "dma4.kG2": _b("exp_dma4.py:60 kG2", "exp_dma4", "tabv", "lo", "array", unit=128,
                   count=TILE, out="rows"),
    "dma4.kJ": _b("exp_dma4.py:77 kJ", "exp_dma4", "tab2", "", "static", count=0,
                  pad=CHUNK * WIDTH, out="sum"),
}

# The bodies that copy a 16 KB window at a dynamic offset in a loop, timed
# also at one window an SM.
WINDOW_BODIES = ("dma.static", "dma.smem", "dma.vmin", "dma.vmin_smem", "dma.hbm", "dma3.kF")

launches = {"pd_copy": 0}
plain_calls = {"pd_copy": 0}


def _iters(body: Body, offs, tool_iters: int) -> int:
    n_it = offs.shape[1] if offs is not None else body.iters or tool_iters
    if n_it <= 0:
        raise ValueError("a body copies at least once")
    return n_it


def _check(name: str, table: torch.Tensor, offs, blocks: int) -> Body:
    if name not in BODIES:
        raise ValueError(f"body {name!r} not in {tuple(BODIES)}")
    body = BODIES[name]
    if table.dtype != torch.float32:
        raise ValueError(f"the table must be float32, got {table.dtype}")
    if body.offset in ("static", "smem"):
        if offs is not None:
            raise ValueError(f"body {name} takes no offsets")
    else:
        want = 3 if body.offset.startswith("vmin") else 2
        if (offs is None or offs.dim() != want or offs.dtype != torch.int32
                or offs.device != table.device or (want == 3 and offs.shape[2] != TILE)):
            raise ValueError(f"body {name} takes int32 offsets (B, iters{', 1024' * (want == 3)})"
                             " on the table's device")
    if blocks <= 0:
        raise ValueError("blocks must be positive")
    return body


def _shape(body: Body):
    return (1, 1) if body.out == "sum1" else SHAPE


def copy_plain(name: str, table: torch.Tensor, offs: torch.Tensor = None,
               iters: int = ITERS, blocks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of `pd_copy` for body `name` (any device).
    `iters` counts the copies of a body whose count is the tool's ITERS and
    that takes no offsets; `blocks` the windows of a body that takes none."""
    body = _check(name, table, offs, blocks)
    n_it = _iters(body, offs, iters)
    plain_calls["pd_copy"] += 1
    flat = table.reshape(-1)
    B = blocks if offs is None else offs.shape[0]
    dev = table.device
    if offs is None:
        raw = torch.full((B, n_it), body.base, dtype=torch.int64, device=dev)
    elif body.offset == "array":
        raw = offs.long()
    else:
        raw = offs.amin(dim=2).long()
    off = raw // body.div * body.unit
    if body.out == "rows":
        return flat[off[:, -1, None] + torch.arange(TILE, device=dev)].view(B, *SHAPE)
    span = torch.arange(body.count or flat.numel(), device=dev)
    acc = torch.zeros(B, dtype=torch.float32, device=dev)
    for i in range(n_it):
        window = flat[off[:, i, None] + span]   # the copy
        acc = acc + window[:, 0]
    if body.out == "col":
        col = window[:, torch.arange(SHAPE[0], device=dev) * body.stride]
        return col[:, :, None].expand(B, *SHAPE).clone()
    return acc.view(B, 1, 1).expand(B, *_shape(body)).clone()


def dest_floats(name: str, table: torch.Tensor) -> int:
    body = BODIES[name]
    return (body.count or table.numel()) + body.pad


def cluster_half(name: str, table: torch.Tensor, optin: int) -> int:
    """0 where the destination fits one block's shared memory (`optin`
    bytes less STATIC_SMEM); else the floats each block of a 2-block
    cluster holds (half the destination, rounded up to 16 bytes)."""
    dest = dest_floats(name, table)
    if BODIES[name].out == "rows" or 4 * dest <= optin - STATIC_SMEM:
        return 0
    return (dest + 1) // 2 + 3 & ~3


def copy_kernel(name: str, mech: str, table: torch.Tensor, offs: torch.Tensor = None,
                iters: int = ITERS, blocks: int = 1) -> torch.Tensor:
    """Launch `pd_copy` for body `name` with mechanism `mech` on CUDA
    tensors (raises otherwise)."""
    if mech not in MECHS:
        raise ValueError(f"mech {mech!r} not in {MECHS}")
    body = _check(name, table, offs, blocks)
    n_it = _iters(body, offs, iters)
    if table.device.type != "cuda":
        raise RuntimeError("copy_kernel needs CUDA tensors")
    step = body.base // body.div * body.unit if body.offset in ("static", "smem") else body.unit
    if table.data_ptr() % 16 or step % 4:
        raise ValueError("windows must start on 16-byte boundaries")
    lib = _native.load()
    table = table.contiguous()
    offs = None if offs is None else offs.contiguous()
    B = blocks if offs is None else offs.shape[0]
    count = body.count or table.numel()
    if count % 4:
        raise ValueError("a copy must be a multiple of 16 bytes")
    half = cluster_half(name, table, lib.pr_smem_optin())
    out = torch.empty((B, *_shape(body)), dtype=torch.float32, device=table.device)
    err = lib.pd_copy(MECHS.index(mech), OFFSETS.index(body.offset), OUTS.index(body.out),
                      c_ptr(table), count, dest_floats(name, table), body.base, body.unit,
                      body.div, body.stride, c_ptr(offs), n_it, B, half, c_ptr(out),
                      c_stream(table.device))
    _native.check(err, f"probe_dma.pd_copy<{name}, {mech}>")
    launches["pd_copy"] += 1
    return out


def kernel_info(mech: str = "bulk", offset: str = "array", iters: int = ITERS) -> dict:
    """What the compiler and the occupancy API report for the ring kernel
    `pd_copy<mech, offset>` with the ring it runs for `iters` copies of a
    16 KB window (INFO, and "ring": its slots)."""
    import ctypes

    lib = _native.load()
    out = (ctypes.c_int * (len(INFO) + 1))()
    _native.check(lib.pd_kernel_info(MECHS.index(mech), OFFSETS.index(offset), WINDOW, iters, out),
                  f"probe_dma.kernel_info({mech}, {offset})")
    return {**dict(zip(INFO, list(out))), "ring": out[len(INFO)]}


def copy(name: str, mech: str, table: torch.Tensor, offs: torch.Tensor = None,
         iters: int = ITERS, blocks: int = 1) -> torch.Tensor:
    """The kernel on a CUDA table, the plain version on a CPU one."""
    if table.device.type == "cuda":
        return copy_kernel(name, mech, table, offs, iters, blocks)
    if table.device.type == "cpu":
        return copy_plain(name, table, offs, iters, blocks)
    raise RuntimeError(f"no copy probe for device {table.device}")


# ---------------------------------------------------------------------------
# The probe runs (tools/torch_exp_dma.py and chip_smoke.py phase 3pr)
# ---------------------------------------------------------------------------

def probe_inputs(rng, tool: str, iters: int = ITERS, blocks: int = 1, n: int = None) -> dict:
    """A tool's inputs from seeded numpy, under the tool's own global names
    (as numpy; the offsets with a leading block axis of `blocks`):
    exp_dma: tab (160,000, 16), los (B, iters) and idx (B, iters, 1024) in
    [0, N - 256); exp_dma2: tab (4096, 16); exp_dma3: tab2, tab3 (16, 256,
    16), tab1 (the same floats), idx (B, 1, 1024) in [0, 4096), bs (B,
    iters) in [0, 16); exp_dma4: tab1 (65,536,), tab2 (its (4096, 16) view),
    lo (B, 1) = 128, tabv (4096, 128)."""
    import numpy as np

    n = n or (N if tool == "exp_dma" else N_SMALL)
    table = rng.random((n, WIDTH), dtype=np.float32)
    if tool == "exp_dma":
        return {"tab": table,
                "los": rng.integers(0, n - CHUNK, (blocks, iters)).astype(np.int32),
                "idx": rng.integers(0, n - CHUNK, (blocks, iters, TILE)).astype(np.int32)}
    if tool == "exp_dma2":
        return {"tab": table}
    if tool == "exp_dma3":
        return {"tab2": table, "tab3": table.reshape(n // CHUNK, CHUNK, WIDTH),
                "tab1": table.reshape(-1),
                "idx": rng.integers(0, n, (blocks, 1, TILE)).astype(np.int32),
                "bs": rng.integers(0, n // CHUNK, (blocks, iters)).astype(np.int32)}
    return {"tab1": table.reshape(-1), "tab2": table,
            "lo": np.full((blocks, 1), 128, np.int32),
            "tabv": rng.random((n, 128), dtype=np.float32)}


def needed(name: str, table: torch.Tensor, offs, iters: int, blocks: int) -> tuple:
    """(bytes, operations): the distinct table floats the copies read (the
    rows a `rows` body reads), the offsets read and the output written once;
    an add a copy and block."""
    body = BODIES[name]
    flat_n = table.numel()
    if offs is None:
        raw = torch.full((blocks, iters), body.base, dtype=torch.int64)
    else:
        o = offs.cpu().long()
        raw = o if body.offset == "array" else o.amin(dim=2)
    starts = torch.unique(raw // body.div * body.unit)
    count = body.count or flat_n
    covered = torch.zeros(flat_n + body.pad, dtype=torch.bool)
    for s in starts.tolist():
        covered[s:s + count] = True
    B = raw.shape[0]
    out = B * (1 if body.out == "sum1" else TILE)
    return (4 * int(covered.sum()) + (0 if offs is None else offs.numel() * 4) + 4 * out,
            B * iters)


def runs() -> list:
    """(body, tool) in order: every body that runs."""
    return [(name, b.tool) for name, b in BODIES.items()]


def probe_copies(device, iters: int = ITERS, blocks: int = 1, seed: int = 0, timer=None,
                 bodies=None, mechs=MECHS) -> list:
    """Every body (or those in `bodies`) with each mechanism at the probes'
    sizes over `blocks` independent windows (the probes' own: 1), inputs
    from seeded numpy. On the card each launch against its plain version
    (exact), timed with `timer`, ns a copy; on the CPU the plain version,
    no times."""
    import numpy as np

    rng = np.random.default_rng(seed)
    inputs = {}
    rows = []
    for name, tool in runs():
        if bodies is not None and name not in bodies:
            continue
        if tool not in inputs:
            inputs[tool] = {k: torch.as_tensor(v, device=device)
                            for k, v in probe_inputs(rng, tool, iters, blocks).items()}
        body = BODIES[name]
        table = inputs[tool][body.table]
        offs = None
        if body.offs:
            offs = inputs[tool][body.offs]
            offs = offs.reshape(blocks, -1, TILE) if body.offset.startswith("vmin") else offs
        n_it = _iters(body, offs, iters)
        nbytes, ops = needed(name, table, offs, n_it, blocks)
        ref = None
        for mech in mechs:
            out = copy(name, mech, table, offs, iters, blocks)
            row = {"kernel": "pd_copy", "body": name, "probe": body.site, "mech": mech,
                   "iters": n_it, "blocks": blocks, "device": table.device.type,
                   "copy_bytes": 4 * (body.count or table.numel()) if body.out != "rows" else 0,
                   "cluster": 0, "ms": None, "ns_per_copy": None, "plain_ms": None,
                   "bytes": nbytes, "ops": ops, "first": float(out.reshape(-1)[0])}
            if table.device.type == "cuda":
                row["cluster"] = cluster_half(name, table, _native.load().pr_smem_optin()) > 0
                if ref is None:
                    ref, plain_ms = plain_on_card(
                        lambda: copy_plain(name, table, offs, iters, blocks))
                if not torch.equal(out, ref):
                    raise AssertionError(f"pd_copy<{name}, {mech}> differs from its plain "
                                         f"version on {int((out != ref).sum())} values")
                row.update(median_ms(timer, lambda: copy_kernel(name, mech, table, offs, iters,
                                                                blocks)), plain_ms=plain_ms)
                row["ns_per_copy"] = 1e6 * row["ms"] / n_it
            rows.append(row)
    return rows
