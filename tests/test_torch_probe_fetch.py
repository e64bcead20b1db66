"""The fetch probes' plain versions (gpu_raytracer_tpu_torch/probes/fetch.py)
held to every body of the JAX package's TPU probes tools/exp_gather.py and
tools/exp_gather2.py, run in interpret mode on the probes' own inputs.

Both tools import cleanly (their runs sit under `__main__`); the test sets
their ITERS to 2 and replaces `bench` (and exp_gather2.py's `report`) in
the imported module objects with a capture of the jitted call and its
inputs, so each body is compiled and run once here. The files stay as they
are.

Bars: column and lane fetches exactly equal; 16-column row sums within rtol
1e-6 (the JAX reduction may add the columns in another order).
exp_gather2.py's `dma_test` cannot run: its kernel takes `scratch, sem` but
its pallas_call declares no scratch_shapes (a fault of the probe, ROADMAP
C). The test shows that, and holds the copy mode to the numpy sum the probe
means instead."""

import importlib
import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpu_raytracer_tpu_torch.probes import fetch

from tests.test_torch_import import private_bvh_cache  # noqa: F401

torch.set_num_threads(2)

ITERS = 2


def _tool(name: str) -> tuple:
    """The imported tool with ITERS = 2 and its timing calls captured."""
    mod = importlib.import_module(f"tools.{name}")
    mod.ITERS = ITERS
    captured = []
    mod.bench = lambda fn, *args, n=20: captured.append((fn, args)) or 1.0
    if hasattr(mod, "report"):
        mod.report = lambda label, fn, *args: captured.append((fn, args))
    return mod, captured


def _run(fn, *args) -> np.ndarray:
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args))


def _t(x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x) if dtype is None else np.array(x).astype(dtype))


def _idx(x) -> torch.Tensor:
    """(ITERS, ...) indices -> the first ITERS as (ITERS, R) int32."""
    x = np.asarray(x)
    return torch.as_tensor(x[:ITERS].reshape(ITERS, -1).astype(np.int32))


@pytest.fixture(scope="module")
def gather():
    return _tool("exp_gather")


@pytest.fixture(scope="module")
def gather2():
    return _tool("exp_gather2")


def test_in_kernel_gathers(gather):
    """exp_gather.py A (column 0 of an 8k-row table) and A2 (take_along_axis
    along lanes; the probe passes zeros, so a random table goes in)."""
    mod, captured = gather
    mod.try_dyngather()
    fn, (table, idx) = captured[-1]
    ref = _run(fn, table, idx).reshape(-1)
    np.testing.assert_array_equal(fetch.lane_fetch_plain(_t(table), _idx(idx), "col0").numpy(), ref)
    mod.try_dyngather2d()
    fn, (_, idx) = captured[-1]
    tab = np.random.default_rng(1).random((8, 128), dtype=np.float32)
    ref = _run(fn, jnp.asarray(tab), idx).reshape(-1)
    np.testing.assert_array_equal(fetch.lane_fetch_plain(_t(tab), _idx(idx), "lane").numpy(), ref)


@pytest.mark.parametrize("chunk, dtype", [(256, "bf16"), (512, "bf16"), (1024, "bf16"),
                                          (512, "f32")])
def test_onehot_window(gather, chunk, dtype):
    """exp_gather.py B: the DMA'd window read by a one-hot matmul, coherent
    indices (inside the window) and, for f32, incoherent ones (mostly
    outside: 0)."""
    mod, _ = gather
    fn = mod.make_onehot(chunk, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    mode = "col0_bf16" if dtype == "bf16" else "col0"
    for idx in ((mod.idx_all, mod.idx_rand) if dtype == "f32" else (mod.idx_all,)):
        ref = _run(fn, mod.table, idx).reshape(-1)
        ours = fetch.window_fetch_plain(_t(mod.table), _idx(idx), mode, chunk).numpy()
        np.testing.assert_array_equal(ours, ref)
        assert (ours != 0).any()


@pytest.mark.parametrize("chunk", [256, 512])
def test_select_scan_window(gather, chunk):
    """exp_gather.py C: the same window read by a select scan."""
    mod, _ = gather
    ref = _run(mod.make_scan(chunk), mod.table, mod.idx_all).reshape(-1)
    np.testing.assert_array_equal(
        fetch.window_fetch_plain(_t(mod.table), _idx(mod.idx_all), "col0", chunk).numpy(), ref)


@pytest.mark.parametrize("M", [1024, 8192, 65536])
def test_rowgather(gather2, M):
    """exp_gather2.py rowgather: 16-column rows gathered and summed."""
    mod, captured = gather2
    mod.rowgather_vmem(M)
    fn, (tab, idx) = captured[-1]
    ours = fetch.lane_fetch_plain(_t(tab), _idx(idx), "rowsum").numpy()
    np.testing.assert_allclose(ours, _run(fn, tab, idx).reshape(-1), rtol=1e-6)


@pytest.mark.parametrize("M", [8, 64])
def test_sublane_gather(gather2, M):
    """exp_gather2.py sublane: take_along_axis along the rows of (M, 128)."""
    mod, captured = gather2
    mod.sublane_gather(M)
    fn, (tab, idx) = captured[-1]
    np.testing.assert_array_equal(
        fetch.lane_fetch_plain(_t(tab), _idx(idx), "sublane").numpy(),
        _run(fn, tab, idx).reshape(-1))


def test_dma_scan_and_rowgather(gather2):
    """exp_gather2.py dma_scan (window, select scan) and dma_rowgather
    (window, 16-column row sums) at chunks 256 and 512."""
    mod, captured = gather2
    mod.dma_scan(256)
    fn, (tab, idx) = captured[-1]
    np.testing.assert_array_equal(
        fetch.window_fetch_plain(_t(tab), _idx(idx), "col0", 256).numpy(),
        _run(fn, tab, idx).reshape(-1))
    for chunk in (256, 512):
        mod.dma_rowgather(chunk)
        fn, (tab, idx) = captured[-1]
        ours = fetch.window_fetch_plain(_t(tab), _idx(idx), "rowsum", chunk).numpy()
        np.testing.assert_allclose(ours, _run(fn, tab, idx).reshape(-1), rtol=1e-6)


@pytest.mark.parametrize("dynamic", [False, True])
def test_dma_test_fault_and_copy_mode(gather2, dynamic):
    """exp_gather2.py dma_test: its pallas_call gives the kernel no scratch
    and semaphore, so the probe fails to trace; the copy mode gives the sum
    of window[0, 0] = table[lo_i, 0] that it means."""
    mod, captured = gather2
    mod.dma_test(256, dynamic)
    fn, (los, tab) = captured[-1]
    with pytest.raises(TypeError):
        _run(fn, los, tab)
    lo = np.asarray(los)[:ITERS] if dynamic else np.zeros(ITERS, np.int64)
    idx = torch.as_tensor(np.repeat(lo[:, None], fetch.TILE, axis=1).astype(np.int32))
    ours = fetch.window_fetch_plain(_t(tab), idx, "copy", 256).numpy()
    want = np.float32(0.0)
    for i in range(ITERS):
        want = want + np.asarray(tab)[lo[i], 0]
    np.testing.assert_array_equal(ours, np.full(fetch.TILE, want, np.float32))


def test_rows_is_index_select_and_wrappers_route_by_device():
    """Mode rows at ITERS = 1 is the glue's `index_select`; the wrappers run
    the plain versions on CPU tensors and the kernel entry points refuse
    them; the bytes a fetch needs count distinct values."""
    rng = np.random.default_rng(2)
    table = torch.as_tensor(rng.random((500, 32), dtype=np.float32))
    idx = torch.as_tensor(rng.integers(0, 500, (1, 3000)).astype(np.int32))
    before = dict(fetch.plain_calls), dict(fetch.launches)
    assert torch.equal(fetch.lane_fetch(table, idx, "rows"), table.index_select(0, idx[0]))
    wide = torch.as_tensor(rng.random((600, 16), dtype=np.float32))
    fetch.window_fetch(wide, torch.zeros((1, 1024), dtype=torch.int32), "copy", 256)
    assert fetch.plain_calls == {k: v + 1 for k, v in before[0].items()}
    assert fetch.launches == before[1]
    with pytest.raises(RuntimeError):
        fetch.lane_fetch_kernel(table, idx, "rows")
    with pytest.raises(ValueError):
        fetch.lane_fetch_plain(table, idx, "sublane")  # needs (M, 128)
    distinct = int(torch.unique(idx).numel())
    assert fetch.needed_bytes(table, idx, "rows") == 4 * 3000 * 33 + 128 * distinct


def test_entry_point_runs_on_cpu():
    """tools/torch_exp_gather.py end to end at a tiny size on the CPU: one
    JSON line a case and the glue line, no times (no card)."""
    mod = importlib.import_module("tools.torch_exp_gather")
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main(["--device", "cpu", "--width", "64", "--height", "32", "--subdiv", "1",
                  "--iters", "2"])
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert len(lines) == len(fetch.CASES) + 1
    assert all(x["device"] == "cpu" and x["ms"] is None for x in lines)
    assert lines[-1]["mode"] == "rows" and lines[-1]["lanes"] == 64 * 32
    window = [x for x in lines if x["kernel"] == "pf_window" and x["indices"] == "coherent"]
    assert window and all(x["inside"] == 1.0 for x in window)


# ---------------------------------------------------------------------------
# The input edges a pipelined kernel can get wrong (fetch.EDGE_CASES, which
# the card test runs kernel against plain): the plain versions held to a
# numpy reference written here, exactly.
# ---------------------------------------------------------------------------

def _np_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 -> float32, round to nearest even (finite x)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _np_row_sums(rows: np.ndarray) -> np.ndarray:
    s = np.zeros(rows.shape[:-1], np.float32)
    for c in range(rows.shape[-1]):
        s = s + rows[..., c]
    return s


def _np_lane(table: np.ndarray, idx: np.ndarray, mode: str) -> np.ndarray:
    M = table.shape[0]
    r = np.arange(idx.shape[1])
    acc = np.zeros(idx.shape[1], np.float32)
    for j in idx:
        if mode == "col0":
            v = table[j, 0]
        elif mode == "lane":
            v = table[(r // 128) % M, j % 128]
        elif mode == "sublane":
            v = table[j, r % 128]
        else:
            v = _np_row_sums(table[j])
        acc = acc + v
    return acc


def _np_window(table: np.ndarray, idx: np.ndarray, mode: str, chunk: int) -> np.ndarray:
    N = table.shape[0]
    iters, R = idx.shape
    acc = np.zeros((R // 1024, 1024), np.float32)
    for i in range(iters):
        for t in range(R // 1024):
            j = idx[i, t * 1024:(t + 1) * 1024]
            lo = min(int(j.min()), N - chunk)
            inside = (j >= lo) & (j < lo + chunk)
            row = table[np.where(inside, j, lo)]
            if mode == "copy":
                v = np.full(1024, table[lo, 0], np.float32)
            elif mode == "rowsum":
                v = np.where(inside, _np_row_sums(row), np.float32(0))
            else:
                col = _np_bf16(row[:, 0]) if mode == "col0_bf16" else row[:, 0]
                v = np.where(inside, col, np.float32(0))
            acc[t] = acc[t] + v
    return acc.reshape(R)


@pytest.mark.parametrize("case", fetch.EDGE_CASES, ids=[c[0] for c in fetch.EDGE_CASES])
def test_edge_cases_plain_match_numpy(case):
    """Each edge (one or an odd number of iterations, lo clamped at N -
    chunk, a tile with every lane outside its window, copies at dynamic
    offsets, tile and lane counts no grid divides): the plain version
    equals the numpy reference exactly, and the edge is really there."""
    name, kind, mode, chunk, shape, iters, lanes, ikind = case
    table, idx = fetch.edge_inputs(np.random.default_rng(7), case)
    assert table.shape == shape and idx.shape == (iters, lanes) and idx.dtype == np.int32
    if kind == "lane":
        ours = fetch.lane_fetch_plain(torch.as_tensor(table), torch.as_tensor(idx), mode)
        want = _np_lane(table, idx, mode)
    else:
        ours = fetch.window_fetch_plain(torch.as_tensor(table), torch.as_tensor(idx), mode, chunk)
        want = _np_window(table, idx, mode, chunk)
        tile_min = idx.reshape(iters, -1, 1024).min(axis=2)
        if ikind == "top":
            assert (tile_min > shape[0] - chunk).all()  # lo is clamped
        if ikind == "outside":
            assert (idx.reshape(iters, -1, 1024)[:, 0] >= shape[0]).all()
            assert (ours[:1024] == 0).all() and (ours[1024:] != 0).all()
        if ikind == "dynamic":
            assert len(np.unique(tile_min)) > 1
    np.testing.assert_array_equal(ours.numpy(), want)
    assert (want != 0).any()


def test_path_names_follow_the_kernel_source():
    """The paths the launchers report come back as names: LANE_PATHS and
    WINDOW_PATHS list csrc/probe_fetch.cu's P_* and WP_* enums in order (the
    card's layout check counts only P_COUNT)."""
    import re
    from pathlib import Path

    src = (Path(fetch.__file__).parents[1] / "csrc" / "probe_fetch.cu").read_text()
    lane = re.search(r"enum \{ (P_\w+(?:, P_\w+)*) \};", src).group(1).split(", ")
    window = re.search(r"enum \{ (WP_\w+(?:, WP_\w+)*) \};", src).group(1).split(", ")
    assert lane[-1] == "P_COUNT"
    assert [n.lower() for n in lane[:-1]] == ["p_" + p for p in fetch.LANE_PATHS]
    assert [n.lower() for n in window] == ["wp_" + p for p in fetch.WINDOW_PATHS]


@pytest.mark.parametrize("mode", ["col0", "rowsum"])
def test_embedding_bag_yardstick_computes_the_lane_sums(mode):
    """The library yardstick `embedding_bag` gives each lane its sum of
    fetches (rowsum: with its column sum as the second call), which is
    pf_lane's function; `index_select` only gathers."""
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.random((300, 16), dtype=np.float32))
    idx = torch.as_tensor(rng.integers(0, 300, (6, 2048), dtype=np.int32))
    calls = fetch.library_fetch(table, idx, "lane", mode)
    assert set(calls) == {"index_select", "embedding_bag"}
    got = calls["embedding_bag"]().reshape(-1)
    np.testing.assert_allclose(got.numpy(), fetch.lane_fetch_plain(table, idx, mode).numpy(),
                               rtol=1e-5)
    assert calls["index_select"]().numel() == idx.numel() * (16 if mode == "rowsum" else 1)
    assert set(fetch.library_fetch(table, idx, "window", "col0")) == {"index_select"}
    assert fetch.library_fetch(table, idx, "window", "copy") == {}
