"""Per-lane table-fetch probes: the Hopper counterparts of the TPU probes
tools/exp_gather.py and tools/exp_gather2.py, which price fetch mechanisms
for the traversal and the wavefront glue's row gathers.

Every body sums, per lane and in f32, ITERS fetches from a table (M, C) f32
at indices idx (ITERS, R) int32, in iteration order from 0.

`lane_fetch` (`pf_lane<MODE>`): each lane fetches in place.

  col0     out[r] = sum_i table[idx[i, r], 0]
           exp_gather.py A (:52), the in-kernel gather from an 8k-row table
  lane     out[r] = sum_i table[(r // 128) % M, idx[i, r] % 128], table (M, 128)
           exp_gather.py A2 (:76), take_along_axis along the lanes of the
           lane's sublane row
  rowsum   out[r] = sum_i (sum_c table[idx[i, r], c]), columns in order
           exp_gather2.py rowgather (:39), 16-column rows
  sublane  out[r] = sum_i table[idx[i, r], r % 128], table (M, 128)
           exp_gather2.py sublane (:61), take_along_axis along rows
  rows     out[r, :] = sum_i table[idx[i, r], :]
           the glue's row gather (ops/vec.fetch_rows, `index_select`) at
           ITERS = 1; the yardstick of the probes' XLA gather (exp_gather D)

`window_fetch` (`pf_window<MODE>`): R = T * 1024 lanes in tiles of 1024.
Each iteration a tile takes lo = min(idx[i]) over its lanes, clamped to
N - CHUNK (N = table rows), and reads the window rows [lo, lo + CHUNK); a
lane whose row lies outside the window reads 0.

  col0       window[rel, 0]              exp_gather.py B f32 (:100), C (:141);
                                         exp_gather2.py dma_scan (:114)
  col0_bf16  window[rel, 0] as bf16      exp_gather.py B bf16: the one-hot
                                         matmul of the window cast to bf16
  rowsum     sum_c window[rel, c]        exp_gather2.py dma_rowgather (:148)
  copy       window[0, 0] (every lane)   exp_gather2.py dma_test (:82): the
                                         window copied at lo and read at
                                         [0, 0]; lo comes as idx (every lane
                                         of a tile holding it)

The TPU's one-hot matmul (f32) and select scan both give window[rel, 0],
0 outside the window; on the card each is one shared-memory read, so one
mode stands for both. exp_gather2.py's own `dma_test` cannot run: its
kernel takes scratch and a semaphore that its pallas_call never declares
(ROADMAP C); the port's copy mode computes what it means.

On a CUDA tensor `lane_fetch` / `window_fetch` launch `csrc/probe_fetch.cu`
and raise if they cannot; on a CPU tensor they run the plain PyTorch
versions (`*_plain`), which apply the same arithmetic in the same order
(so kernel and plain agree exactly).

How the card computes them (csrc/probe_fetch.cu, which holds the choices):
`pf_lane` takes a path (`LANE_PATHS`) from the mode, the table's bytes and
the lane count: the values its mode reads staged in shared memory where
they fit the card's opt-in limit (column 0 for col0, the table for
sublane, the rows and then one sum a row for rowsum), or read in place;
`pf_window` stages each window by TMA bulk copy (`WINDOW_PATHS`: column 0
for the column modes where every lane of the tile falls in the window, else
each lane reads in place; the whole rows for rowsum and copy), its index
tiles and windows in rings that a producer warp fills ahead of the
consumer warps. Each launch reports what it took in `last_path`.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_raytracer_tpu_torch.ops import _native
from gpu_raytracer_tpu_torch.probes import c_ptr, c_stream, median_ms

TILE = 1024         # lanes of one (8, 128) TPU tile, one block of pf_window
ROW_LANES = 128
LANE_MODES = ("col0", "lane", "rowsum", "sublane", "rows")
WINDOW_MODES = ("col0", "col0_bf16", "rowsum", "copy")
COLUMN_MODES = ("col0", "col0_bf16")
# pf_lane's paths (csrc/probe_fetch.cu P_*): one lane a thread in place;
# staged in shared memory; rowsum of a large table read in place, a row by a
# quad of threads.
LANE_PATHS = ("in_place", "staged", "quad")
# What a pf_window window stages (WP_*): column 0 (the column modes, read in
# place on an iteration whose lanes do not all fall in the window), or rows.
WINDOW_PATHS = ("column", "rows")
# The JAX probes' sizes (tools/exp_gather.py, exp_gather2.py).
N = 160_000
ROWS = 16
ITERS = 64

launches = {"pf_lane": 0, "pf_window": 0}
plain_calls = {"pf_lane": 0, "pf_window": 0}
# What the last launch of each kernel ran (its path and shape), as the
# launcher reported it.
last_path = {"pf_lane": None, "pf_window": None}


def _row_sum(rows: torch.Tensor) -> torch.Tensor:
    """(K, C) -> (K,): the columns added in order, from 0 (the kernel's
    order)."""
    s = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for c in range(rows.shape[1]):
        s = s + rows[:, c]
    return s


def _check(table: torch.Tensor, idx: torch.Tensor):
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"the table must be (M, C) float32, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be (ITERS, R) int32, got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != table.device:
        raise ValueError("table and idx must be on one device")


def _check_lane(table, idx, mode):
    if mode not in LANE_MODES:
        raise ValueError(f"mode {mode!r} not in {LANE_MODES}")
    _check(table, idx)
    if mode in ("lane", "sublane") and table.shape[1] != ROW_LANES:
        raise ValueError(f"mode {mode} takes a (M, {ROW_LANES}) table")
    if mode in ("rowsum", "rows") and table.shape[1] % 4:
        raise ValueError(f"mode {mode} takes rows of a multiple of 4 columns")


def _check_window(table, idx, mode, chunk):
    if mode not in WINDOW_MODES:
        raise ValueError(f"mode {mode!r} not in {WINDOW_MODES}")
    _check(table, idx)
    if idx.shape[1] % TILE:
        raise ValueError(f"window lanes come in tiles of {TILE}, got {idx.shape[1]}")
    if table.shape[1] % 4 or not 0 < chunk <= table.shape[0]:
        raise ValueError("the window takes rows of a multiple of 4 columns and "
                         "0 < chunk <= table rows")


def lane_fetch_plain(table: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version of `pf_lane` (any device)."""
    _check_lane(table, idx, mode)
    plain_calls["pf_lane"] += 1
    iters, R = idx.shape
    r = torch.arange(R, device=table.device)
    acc = torch.zeros((R, table.shape[1]) if mode == "rows" else R,
                      dtype=torch.float32, device=table.device)
    for i in range(iters):
        j = idx[i].long()
        if mode == "col0":
            v = table[j, 0]
        elif mode == "lane":
            v = table[(r // ROW_LANES) % table.shape[0], j % ROW_LANES]
        elif mode == "rowsum":
            v = _row_sum(table[j])
        elif mode == "sublane":
            v = table[j, r % ROW_LANES]
        else:
            v = table[j]
        acc = acc + v
    return acc


def window_fetch_plain(table: torch.Tensor, idx: torch.Tensor, mode: str,
                       chunk: int) -> torch.Tensor:
    """Plain PyTorch version of `pf_window` (any device)."""
    _check_window(table, idx, mode, chunk)
    plain_calls["pf_window"] += 1
    iters, R = idx.shape
    T = R // TILE
    top = table.shape[0] - chunk
    acc = torch.zeros((T, TILE), dtype=torch.float32, device=table.device)
    for i in range(iters):
        j = idx[i].view(T, TILE).long()
        lo = j.amin(dim=1).clamp(max=top)[:, None]
        rel = j - lo
        inside = (rel >= 0) & (rel < chunk)
        row = table[lo + rel.clamp(0, chunk - 1)]  # (T, TILE, C)
        if mode == "copy":
            v = table[lo, 0].expand(T, TILE)
        elif mode == "rowsum":
            v = _row_sum(row.reshape(R, -1)).view(T, TILE)
        elif mode == "col0_bf16":
            v = row[..., 0].to(torch.bfloat16).float()
        else:
            v = row[..., 0]
        if mode != "copy":
            v = torch.where(inside, v, torch.zeros((), device=table.device))
        acc = acc + v
    return acc.reshape(R)


def _on_card(table: torch.Tensor, idx: torch.Tensor):
    if table.device.type != "cuda":
        raise RuntimeError("the fetch kernels need CUDA tensors")
    table, idx = table.contiguous(), idx.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    if idx.data_ptr() % 16:  # pf_window bulk-copies index rows from 16-byte addresses
        idx = idx.clone()
    return table, idx, c_stream(table.device)


def lane_fetch_kernel(table: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    """Launch `pf_lane<mode>` on CUDA tensors (raises otherwise)."""
    _check_lane(table, idx, mode)
    table, idx, stream = _on_card(table, idx)
    lib = _native.load()
    iters, R = idx.shape
    M, C = table.shape
    out = torch.empty((R, C) if mode == "rows" else R, dtype=torch.float32,
                      device=table.device)
    col = (torch.empty(lib.pf_col_floats(M), dtype=torch.float32, device=table.device)
           if mode == "col0" else None)
    info = (ctypes.c_int * 4)()
    err = lib.pf_lane(LANE_MODES.index(mode), c_ptr(table), M, C, c_ptr(idx), iters, R,
                      c_ptr(col), 0 if col is None else col.numel(), c_ptr(out), info, stream)
    _native.check(err, f"probe_fetch.pf_lane<{mode}>")
    launches["pf_lane"] += 1
    last_path["pf_lane"] = {"path": LANE_PATHS[info[0]], "blocks": info[1],
                            "blocks_per_sm": info[2], "smem": info[3]}
    return out


def window_fetch_kernel(table: torch.Tensor, idx: torch.Tensor, mode: str,
                        chunk: int) -> torch.Tensor:
    """Launch `pf_window<mode>` on CUDA tensors (raises otherwise; a window
    whose smallest ring does not fit the card's shared memory a block
    raises ValueError)."""
    _check_window(table, idx, mode, chunk)
    table, idx, stream = _on_card(table, idx)
    lib = _native.load()
    iters, R = idx.shape
    N, C = table.shape
    out = torch.empty(R, dtype=torch.float32, device=table.device)
    col = (torch.empty(lib.pf_col_floats(N), dtype=torch.float32, device=table.device)
           if mode in COLUMN_MODES else None)
    info = (ctypes.c_int * 5)()
    err = lib.pf_window(WINDOW_MODES.index(mode), c_ptr(table), N, C, c_ptr(idx), iters,
                        R // TILE, int(chunk), c_ptr(col), 0 if col is None else col.numel(),
                        c_ptr(out), info, stream)
    if err and info[4] > info[3] > 0:
        raise ValueError(f"pf_window<{mode}>: a window of {chunk} rows of {C} columns needs "
                         f"{info[4]} bytes of shared memory a block at the least (one window, "
                         f"two index tiles), over the card's {info[3]}")
    _native.check(err, f"probe_fetch.pf_window<{mode}>")
    launches["pf_window"] += 1
    last_path["pf_window"] = {"path": WINDOW_PATHS[info[0]], "ahead": info[1],
                              "depth": info[2], "blocks_per_sm": info[3], "smem": info[4]}
    return out


def lane_fetch(table: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    """The kernel on a CUDA table, the plain version on a CPU one."""
    if table.device.type == "cuda":
        return lane_fetch_kernel(table, idx, mode)
    if table.device.type == "cpu":
        return lane_fetch_plain(table, idx, mode)
    raise RuntimeError(f"no fetch probe for device {table.device}")


def window_fetch(table: torch.Tensor, idx: torch.Tensor, mode: str,
                 chunk: int) -> torch.Tensor:
    """The kernel on a CUDA table, the plain version on a CPU one."""
    if table.device.type == "cuda":
        return window_fetch_kernel(table, idx, mode, chunk)
    if table.device.type == "cpu":
        return window_fetch_plain(table, idx, mode, chunk)
    raise RuntimeError(f"no fetch probe for device {table.device}")


# ---------------------------------------------------------------------------
# The probes' inputs (seeded numpy) and what a fetch needs
# ---------------------------------------------------------------------------

def probe_indices(rng, iters: int, tiles: int, n: int, coherent: bool,
                  spread: int = 256):
    """(iters, tiles * 1024) int32 indices into n rows, as the JAX probes
    draw them: coherent ones a random centre per iteration (and tile) plus a
    spread in [0, spread); incoherent ones uniform over [0, n). Drawn as
    int32 (half the host time of int64 at 760 tiles)."""
    import numpy as np

    if coherent:
        centres = rng.integers(0, n - max(spread, 512), (iters, tiles, 1), dtype=np.int32)
        out = centres + rng.integers(0, spread, (iters, tiles, TILE), dtype=np.int32)
    else:
        out = rng.integers(0, n, (iters, tiles, TILE), dtype=np.int32)
    return out.reshape(iters, tiles * TILE)


def needed_bytes(table: torch.Tensor, idx: torch.Tensor, mode: str, window: bool = False,
                 chunk: int = 0) -> int:
    """Bytes a fetch needs at the least: idx read once, the output written
    once, and each distinct table value the lanes use read once (4 bytes a
    column; a row sum or a row gather uses the whole row; a window lane
    outside its window uses nothing)."""
    iters, R = idx.shape
    C = table.shape[1]
    j = idx.long()
    r = torch.arange(R, device=idx.device)
    if window:
        T = R // TILE
        lo = j.view(iters, T, TILE).amin(dim=2).clamp(max=table.shape[0] - chunk)
        lo_lane = lo.repeat_interleave(TILE, dim=1)
        if mode == "copy":
            cells, width = lo.reshape(-1) * C, 4
        else:
            inside = (j >= lo_lane) & (j < lo_lane + chunk)
            rows = j[inside]
            cells, width = (rows * C, 4) if mode.startswith("col0") else (rows, 4 * C)
    elif mode == "col0":
        cells, width = j.reshape(-1) * C, 4
    elif mode == "lane":
        cells, width = (((r // ROW_LANES) % table.shape[0]) * C + j % ROW_LANES).reshape(-1), 4
    elif mode == "sublane":
        cells, width = (j * C + r % ROW_LANES).reshape(-1), 4
    else:
        cells, width = j.reshape(-1), 4 * C
    out_bytes = 4 * R * (C if mode == "rows" else 1)
    return 4 * idx.numel() + out_bytes + width * int(torch.unique(cells).numel())


# ---------------------------------------------------------------------------
# The probe runs (tools/torch_exp_gather.py and chip_smoke.py phase 3pr)
# ---------------------------------------------------------------------------

# (site of the JAX body, kernel, mode, chunk, table, indices), at the JAX
# probes' sizes: exp_gather.py's 160,000 x 16 table (A: its first 8,192
# rows) with coherent indices (a centre a tile and iteration plus a spread
# of 256) or incoherent ones; exp_gather2.py's (M, 16) and (M, 128) tables
# with uniform indices, its windows of coherent rows and its copy offsets.
CASES = (
    ("exp_gather.py:52 A", "lane", "col0", 0, "t8192", "coherent"),
    ("exp_gather.py:52 A", "lane", "col0", 0, "t8192", "incoherent"),
    ("exp_gather.py:76 A2", "lane", "lane", 0, "lane8", "coherent"),
    ("exp_gather.py:100 B bf16", "window", "col0_bf16", 256, "t160k", "coherent"),
    ("exp_gather.py:100 B bf16", "window", "col0_bf16", 512, "t160k", "coherent"),
    ("exp_gather.py:100 B bf16", "window", "col0_bf16", 1024, "t160k", "coherent"),
    ("exp_gather.py:100 B f32", "window", "col0", 512, "t160k", "coherent"),
    ("exp_gather.py:100 B f32", "window", "col0", 512, "t160k", "incoherent"),
    ("exp_gather.py:141 C", "window", "col0", 256, "t160k", "coherent"),
    ("exp_gather.py:141 C", "window", "col0", 512, "t160k", "coherent"),
    ("exp_gather2.py:39 rowgather", "lane", "rowsum", 0, "row1024", "uniform"),
    ("exp_gather2.py:39 rowgather", "lane", "rowsum", 0, "row8192", "uniform"),
    ("exp_gather2.py:39 rowgather", "lane", "rowsum", 0, "row65536", "uniform"),
    ("exp_gather2.py:61 sublane", "lane", "sublane", 0, "sub8", "uniform"),
    ("exp_gather2.py:61 sublane", "lane", "sublane", 0, "sub64", "uniform"),
    ("exp_gather2.py:82 dma_test", "window", "copy", 256, "t160k", "static"),
    ("exp_gather2.py:82 dma_test", "window", "copy", 256, "t160k", "dynamic"),
    ("exp_gather2.py:114 dma_scan", "window", "col0", 256, "t160k", "coherent"),
    ("exp_gather2.py:148 dma_rowgather", "window", "rowsum", 256, "t160k", "window"),
    ("exp_gather2.py:148 dma_rowgather", "window", "rowsum", 512, "t160k", "window"),
)


def probe_table(rng, name: str):
    """The probes' tables, uniform in [0, 1) (seeded numpy)."""
    import numpy as np

    if name in ("t160k", "t8192"):
        return rng.random((N if name == "t160k" else 8192, ROWS), dtype=np.float32)
    if name == "lane8":
        return rng.random((8, ROW_LANES), dtype=np.float32)
    rows = int(name[3:])
    return rng.random((rows, ROW_LANES if name.startswith("sub") else ROWS), dtype=np.float32)


def probe_idx(rng, kind: str, iters: int, tiles: int, n: int, chunk: int):
    """The probes' indices (iters, tiles * 1024) int32 into n rows: `coherent`
    and `incoherent` as exp_gather.py draws them; `uniform` over [0, n);
    `window` a centre in [0, n - chunk) and a spread in [0, chunk)
    (dma_rowgather); `static` / `dynamic` a copy offset, 0 or uniform in
    [0, n - chunk), the same for every lane of a tile (dma_test)."""
    import numpy as np

    if kind in ("coherent", "incoherent"):
        return probe_indices(rng, iters, tiles, n, kind == "coherent")
    if kind == "uniform":
        return rng.integers(0, n, (iters, tiles * TILE), dtype=np.int32)
    if kind == "window":
        centres = rng.integers(0, n - chunk, (iters, tiles, 1), dtype=np.int32)
        return (centres + rng.integers(0, chunk, (iters, tiles, TILE), dtype=np.int32)).reshape(
            iters, tiles * TILE)
    lo = (np.zeros((iters, tiles, 1), np.int32) if kind == "static"
          else rng.integers(0, n - chunk, (iters, tiles, 1), dtype=np.int32))
    return np.repeat(lo, TILE, axis=2).reshape(iters, tiles * TILE)


def library_fetch(table: torch.Tensor, idx: torch.Tensor, kind: str, mode: str) -> dict:
    """The library yardsticks of a case, {name: call}:
    `index_select`, one call that gathers the table values a mode fetches
    (every lane, every iteration; no sum, no window; gather only), where one
    call gathers them (not lane, sublane: the column depends on the lane; not
    copy); `embedding_bag`, one call that computes pf_lane's function (each
    lane's sum of its fetches; the bag of a lane is its column of idx), for
    col0 and for rowsum with the row's column sum as a second call. No one
    call computes a window's masked sum."""
    import torch.nn.functional as F

    calls = {}
    if mode in COLUMN_MODES:
        calls["index_select"] = lambda: torch.index_select(table[:, 0], 0, idx.view(-1))
    elif mode in ("rowsum", "rows"):
        calls["index_select"] = lambda: table.index_select(0, idx.view(-1))
    if kind == "lane" and mode == "col0":
        calls["embedding_bag"] = lambda: F.embedding_bag(idx.t(), table[:, :1], mode="sum")
    elif kind == "lane" and mode == "rowsum":
        calls["embedding_bag"] = lambda: F.embedding_bag(idx.t(), table, mode="sum").sum(1)
    return calls


def fetch_case(table, idx, kind: str, mode: str, chunk: int, timer=None) -> dict:
    """One fetch run: on a CUDA table the kernel against its plain version
    (exactly equal), the path it took and, with `timer`, the kernel's and
    the library yardsticks' ms (medians; `library_ms` is `index_select`'s),
    ns per fetch, and the bytes and operations it needs. On a CPU table the
    plain version. Returns the result and the output."""
    iters, R = idx.shape
    run = ((lambda: lane_fetch(table, idx, mode)) if kind == "lane"
           else (lambda: window_fetch(table, idx, mode, chunk)))
    out = run()
    row = {"kernel": "pf_" + kind, "mode": mode, "chunk": chunk or None,
           "table": list(table.shape), "iters": iters, "lanes": R,
           "device": table.device.type, "path": "plain", "ms": None, "library_ms": None,
           "embedding_bag_ms": None}
    if table.device.type == "cuda":
        launch = last_path["pf_" + kind]
        row["path"] = launch["path"]
        row["launch"] = {k: v for k, v in launch.items() if k != "path"}
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = (lane_fetch_plain(table, idx, mode) if kind == "lane"
               else window_fetch_plain(table, idx, mode, chunk))
        stop.record()
        torch.cuda.synchronize()
        row["plain_ms"] = start.elapsed_time(stop)
        if not torch.equal(out, ref):
            raise AssertionError(f"pf_{kind}<{mode}> differs from its plain version on "
                                 f"{int((out != ref).sum())} values")
        if timer is not None:
            row.update(median_ms(timer, run))
            row["ns_per_fetch"] = 1e6 * row["ms"] / (iters * R)
            for name, call in library_fetch(table, idx, kind, mode).items():
                key = "library_ms" if name == "index_select" else name + "_ms"
                row[key] = median_ms(timer, call)["ms"]
    row["bytes"] = needed_bytes(table, idx, mode, kind == "window", chunk)
    row["ops"] = iters * R * (table.shape[1] if mode in ("rowsum", "rows") else 1)
    if kind == "window":
        j = idx.long().view(iters, R // TILE, TILE)
        lo = j.amin(dim=2, keepdim=True).clamp(max=table.shape[0] - chunk)
        row["inside"] = float(((j - lo) < chunk).float().mean())
    return row, out


def probe_fetches(device, iters: int = ITERS, tiles: int = 1, seed: int = 0,
                  timer=None) -> list:
    """Every case of CASES at the probes' sizes over `tiles` tiles (the
    probes' own: 1), inputs from seeded numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tables, indices = {}, {}
    rows = []
    for site, kind, mode, chunk, tname, ikind in CASES:
        if tname not in tables:
            tables[tname] = torch.as_tensor(probe_table(rng, tname), device=device)
        table = tables[tname]
        n = N if mode == "lane" else table.shape[0]  # A2 takes idx % 128 of exp_gather's
        key = (ikind, n, chunk if ikind in ("window", "dynamic") else 0)
        if key not in indices:  # cases of one kind share their indices
            indices[key] = torch.as_tensor(probe_idx(rng, ikind, iters, tiles, n, chunk),
                                           device=device)
        row, _ = fetch_case(table, indices[key], kind, mode, chunk, timer)
        rows.append({"probe": site, "indices": ikind, **row})
    return rows


# The input edges a pipelined kernel can get wrong, at a small size:
# (name, kernel, mode, chunk, table (rows, columns), iters, lanes, indices);
# 20-column rows have a fifth column group past the rotated four (quad: a
# second round of the warp buffer), 12-column ones fill three of a quad's
# four. The launchers' choices are crossed too: windows whose deepest rings
# do not fit shared memory (1,100 rows of 16 columns; 2,500 take the
# one-window ring), and lane counts that fill every SM at 4 lanes a thread
# (400,000: staged sublane, quad row sums of tables over 1 MiB).
# Indices (edge_idx): `uniform` over the rows; `window` a centre a tile and
# iteration plus a spread under the chunk; `top` in the last half chunk of
# rows (lo clamps to N - chunk); `outside` tile 0 past the table's last row
# (every lane outside its window), the other tiles `window`; `dynamic` one
# copy offset a tile and iteration, uniform in [0, N - chunk]; `turns`
# `window` in even iterations and `uniform` in odd ones.
EDGE_CASES = (
    ("one iteration", "window", "col0", 16, (64, 4), 1, 1024, "window"),
    ("odd iterations, rows", "window", "rowsum", 16, (64, 20), 5, 2048, "window"),
    ("odd iterations, bf16", "window", "col0_bf16", 32, (200, 4), 7, 1024, "uniform"),
    ("lo clamped at N - chunk", "window", "col0", 32, (100, 4), 3, 2048, "top"),
    ("lo clamped, rows", "window", "rowsum", 32, (100, 4), 3, 1024, "top"),
    ("every lane outside", "window", "col0", 16, (64, 4), 3, 2048, "outside"),
    ("copy, dynamic offsets", "window", "copy", 16, (64, 4), 5, 3072, "dynamic"),
    ("three tiles", "window", "col0_bf16", 8, (40, 4), 2, 3072, "window"),
    ("staged and in place by turns", "window", "col0", 16, (64, 4), 6, 2048, "turns"),
    ("window past the deepest ring", "window", "rowsum", 1100, (1200, 16), 2, 2048, "window"),
    ("one-window ring", "window", "rowsum", 2500, (2600, 16), 3, 2048, "window"),
    ("one iteration, lanes", "lane", "col0", 0, (50, 4), 1, 1024, "uniform"),
    ("odd iterations, ragged lanes", "lane", "col0", 0, (50, 4), 5, 4099, "uniform"),
    ("odd iterations, row sums", "lane", "rowsum", 0, (30, 20), 7, 1030, "uniform"),
    ("row sums past the staging limit", "lane", "rowsum", 0, (5000, 12), 3, 1030, "uniform"),
    ("wide row sums past the staging limit", "lane", "rowsum", 0, (3000, 20), 3, 1030,
     "uniform"),
    ("ragged lanes, sublane", "lane", "sublane", 0, (8, 128), 3, 1027, "uniform"),
    ("ragged lanes, lane", "lane", "lane", 0, (3, 128), 6, 2050, "uniform"),
    ("more lanes than one grid", "lane", "col0", 0, (64, 4), 3, 1_200_000, "uniform"),
    ("more lanes than one grid, ragged", "lane", "rowsum", 0, (64, 4), 2, 1_200_003, "uniform"),
    ("staged sublane", "lane", "sublane", 0, (64, 128), 2, 400_000, "uniform"),
    ("quad row sums", "lane", "rowsum", 0, (25_000, 12), 3, 400_003, "uniform"),
    ("quad row sums, five column groups", "lane", "rowsum", 0, (15_000, 20), 2, 400_001,
     "uniform"),
)


def edge_idx(rng, kind: str, iters: int, lanes: int, n: int, chunk: int):
    """(iters, lanes) int32 indices into n rows for EDGE_CASES (seeded
    numpy)."""
    import numpy as np

    tiles = max(lanes // TILE, 1)
    if kind == "uniform":
        return rng.integers(0, n, (iters, lanes), dtype=np.int32)
    if kind == "top":
        return rng.integers(n - chunk // 2, n, (iters, lanes), dtype=np.int32)
    if kind == "dynamic":
        lo = rng.integers(0, n - chunk + 1, (iters, tiles, 1), dtype=np.int32)
        return np.repeat(lo, TILE, axis=2).reshape(iters, lanes)
    centres = rng.integers(0, n - chunk + 1, (iters, tiles, 1), dtype=np.int32)
    out = centres + rng.integers(0, chunk, (iters, tiles, TILE), dtype=np.int32)
    if kind == "turns":
        out[1::2] = rng.integers(0, n, out[1::2].shape, dtype=np.int32)
    if kind == "outside":
        out[:, 0] = rng.integers(n, n + 3 * chunk, (iters, TILE), dtype=np.int32)
    return out.reshape(iters, lanes)


def edge_inputs(rng, case) -> tuple:
    """(table, idx) as numpy arrays for one case of EDGE_CASES."""
    import numpy as np

    _, _, _, chunk, shape, iters, lanes, kind = case
    table = rng.random(shape, dtype=np.float32)
    return table, edge_idx(rng, kind, iters, lanes, shape[0], chunk)


def edge_fetches(device, seed: int = 0) -> list:
    """Every case of EDGE_CASES through fetch_case on `device` (on the card:
    kernel against plain, exactly, with the path it took)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for case in EDGE_CASES:
        table, idx = (torch.as_tensor(x, device=device) for x in edge_inputs(rng, case))
        row, _ = fetch_case(table, idx, case[1], case[2], case[3])
        rows.append({"probe": "edge: " + case[0], "indices": case[7], **row})
    return rows


def glue_fetch(shade_rows: torch.Tensor, hit_tri: torch.Tensor, timer=None) -> dict:
    """The glue's row gather at its real shape: `fetch_rows(shade_rows,
    hit_tri)` of a bounce-1 wave (integrators/pathtracer.py) as `pf_lane`
    rows, held to `index_select` (the library call, exactly equal) and timed
    beside it; also timed: `index_select` with the int64 indices the glue
    passes, and advanced indexing `shade_rows[idx]`."""
    idx = hit_tri.clamp(min=0).to(torch.int32)[None].contiguous()
    row, out = fetch_case(shade_rows, idx, "lane", "rows", 0, timer)
    if not torch.equal(out, shade_rows.index_select(0, idx[0])):
        raise AssertionError("pf_lane<rows> differs from index_select")
    if row["ms"] is not None:
        idx64 = idx[0].long()
        for key, fn in (("index_select_int64_ms", lambda: shade_rows.index_select(0, idx64)),
                        ("advanced_index_ms", lambda: shade_rows[idx64])):
            ms = sorted(timer(fn))
            row[key] = ms[len(ms) // 2]
    return {"probe": "glue fetch_rows(shade_rows, hit_tri)", "indices": "bounce-1 wave",
            **row}
