"""The paged-table passes' contracts on the persistent-warp walk
(ops/stream_traverse.py, csrc/wide_walk.cuh), on the CPU at a small size.

  * The page pass's plain version seeds one stack with a ray's portals,
    nearest on top, and walks it once, as the kernel does. Portal subtrees
    are disjoint, so that is the loop over the portals nearest first, each
    walked to its end while its entry lies before the running best: built
    here from single-portal calls, it gives the same hits and visits,
    on the soup of tests/test_torch_traverse_stream.py and on its
    overflowing diagonal soup, whose multi-pass trace also matches the JAX
    package's `trace_closest_stream` in interpret mode.
  * The portal lists are slot-major ((K, R) storage behind an (R, K) view)
    and round-trip from the resident pass into the page pass.
  * make_stream_tables rejects tables whose page walk plus the up to
    K_PORTALS - 1 seeded portals passes the kernel's stack.
  * The per-ray visits of both passes, from which the warp utilisation of a
    one-thread-a-ray schedule is computed.
  * The tie-aware bar of the page pass and the paged trace
    (parity.compare_stream_closest) on paged tables with a duplicated
    triangle: a true tie passes, a false tie and t one ulp off fail."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_raytracer_tpu.ops import pallas_stream as ps
from gpu_raytracer_tpu_torch import parity
from gpu_raytracer_tpu_torch.bvh import stream as stream_mod
from gpu_raytracer_tpu_torch.bvh import wide as wide_mod
from gpu_raytracer_tpu_torch.bvh.sah import build_bvh2
from gpu_raytracer_tpu_torch.ops import buffers as tb
from gpu_raytracer_tpu_torch.ops import stream_traverse as st
from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
from gpu_raytracer_tpu_torch.scene.types import TriangleData

from tests.test_torch_stream_tables import soup
from tests.test_torch_traverse_stream import rays, tables_of

torch.set_num_threads(2)

K = st.K_PORTALS


@pytest.fixture(scope="module", params=["soup", "diagonal"])
def wave(request):
    """(tables, o, d, t_max): the soup on 48-row pages with random rays (a
    ninth dead), or the dense soup on 24-row pages with long diagonals
    (more than K_PORTALS portals a ray)."""
    if request.param == "soup":
        tables, jt, _ = tables_of(soup(1500), 48)
        o, d = rays(512, 3)
        tm = np.full(512, np.inf, np.float32)
        tm[::9] = 0.0
    else:
        tables, jt, _ = tables_of(soup(4000, seed=21), 24)
        o, d = rays(512, 4, diagonal=True)
        tm = np.full(512, np.inf, np.float32)
    return tables, jt, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tm)


def _per_portal(any_hit, tables, o, d, tm, pid, pt, best_t, best_tri):
    """The page pass as a loop over each ray's portals, nearest first (a
    stable sort), each walked to its end by a single-portal call while it is
    entered before the running best (closest) or the ray is not occluded
    (any): (t, tri, node visits, triangle visits, portals walked, per-ray
    visits)."""
    R = o.shape[0]
    key, order = torch.sort(torch.where(pid >= 0, pt, float("inf")), dim=1, stable=True)
    ids = torch.gather(pid, 1, order)
    t, tri = best_t.clone(), best_tri.clone()
    name = st._name("page", any_hit)
    nodes = triangles = 0
    portals = set()
    pops = torch.zeros(R, dtype=torch.int64)
    for k in range(K):
        go = (ids[:, k] >= 0) & ((tri < 0) if any_hit else (key[:, k] < t))
        ri = torch.nonzero(go).flatten()
        if ri.numel() == 0:
            continue
        one_id = torch.full((ri.numel(), K), -1, dtype=torch.int32)
        one_t = torch.full((ri.numel(), K), float("inf"))
        one_id[:, 0], one_t[:, 0] = ids[ri, k], key[ri, k]
        t[ri], tri[ri] = st.page_plain(any_hit, tables, o[ri], d[ri], tm[ri], one_id, one_t,
                                       t[ri], tri[ri])
        work = st.last_work[name]
        nodes += work["nodes"]
        triangles += work["triangles"]
        pops[ri] += st.last_pops[name]
        portals |= set(ids[ri, k].tolist())
    return t, tri, nodes, triangles, len(portals), pops


@pytest.mark.parametrize("any_hit", [False, True])
def test_seeded_walk_is_the_per_portal_loop(wave, any_hit):
    tables, _, o, d, tm = wave
    if any_hit:
        tm = torch.where(tm > 0, torch.tensor(1.5), tm)
    t1, tri1, pid, pt, _ = st.resident_plain(any_hit, tables, o, d, tm)
    page_in = (pid, pt, torch.where(tri1 >= 0, t1, tm), tri1)
    t, tri = st.page_plain(any_hit, tables, o, d, tm, *page_in)
    name = st._name("page", any_hit)
    work, pops = dict(st.last_work[name]), st.last_pops[name]
    t_ref, tri_ref, nodes, triangles, portals, pops_ref = _per_portal(
        any_hit, tables, o, d, tm, *page_in)
    # The same visits in the same order: every output and count equal.
    assert torch.equal(t, t_ref) and torch.equal(tri, tri_ref)
    assert (work["nodes"], work["triangles"], work["portals"]) == (nodes, triangles, portals)
    assert torch.equal(pops, pops_ref)
    assert int((tri >= 0).sum()) > int((tri1 >= 0).sum())  # the pages hold hits


def test_multi_pass_trace_matches_jax(wave):
    """The loss-free pass loop on seeded page passes against the JAX
    package's streamed trace (its own gang-order lists), interpret mode."""
    tables, jt, o, d, tm = wave
    hit, residual = st.trace_closest(tables, o, d, tm)
    assert not bool(residual.any())
    ref = ps.trace_closest_stream(jt, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                  jnp.asarray(tm.numpy()), interpret=True)
    rtri, tri = np.asarray(ref.tri), hit.tri.numpy()
    np.testing.assert_array_equal(rtri >= 0, tri >= 0)
    both = rtri >= 0
    assert both.sum() > 50
    np.testing.assert_allclose(hit.t.numpy()[both], np.asarray(ref.t)[both], rtol=1e-5)
    assert np.mean(rtri[both] == tri[both]) > 0.995


def test_lists_are_slot_major(wave):
    tables, _, o, d, tm = wave
    t1, tri1, pid, pt, ovf = st.resident_plain(False, tables, o, d, tm)
    R = o.shape[0]
    assert pid.shape == pt.shape == (R, K)
    assert pid.t().is_contiguous() and pt.t().is_contiguous()
    assert pid.stride() == (1, R)
    # A list fills from slot 0; -1 / +inf past it.
    n = (pid >= 0).sum(dim=1)
    slots = torch.arange(K)[None, :]
    assert torch.equal(pid >= 0, slots < n[:, None])
    assert bool(torch.isinf(pt[pid < 0]).all()) and bool(torch.isfinite(pt[pid >= 0]).all())
    assert bool((n[tm <= 0] == 0).all()) and int(n.max()) > 1
    # The page pass takes the slot-major view as it takes a row-major copy.
    page_in = (torch.where(tri1 >= 0, t1, tm), tri1)
    a = st.page_plain(False, tables, o, d, tm, pid, pt, *page_in)
    b = st.page_plain(False, tables, o, d, tm, pid.contiguous(), pt.contiguous(), *page_in)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_make_stream_tables_checks_the_seeded_stack(monkeypatch):
    world = soup(1500)
    geo = np.concatenate([world[:, 0], world[:, 1] - world[:, 0],
                          world[:, 2] - world[:, 0]], axis=-1).astype(np.float32)
    bvh = build_bvh2(TriangleData(world), max_leaf_size=wide_mod.LEAF_CAP)
    paged = stream_mod.pack_wide_stream(wide_mod.collapse_wide(bvh), bvh.indices,
                                        geo[bvh.indices], page_rows=48)
    arrays = [torch.as_tensor(paged[k]) for k in ("resident", "pages", "portal_page",
                                                  "portal_root")]
    page_stack, max_stack = tb.stream_page_stack(paged), tb.stream_max_stack(paged)
    assert 1 < page_stack <= max_stack
    fit = page_stack + K - 1
    monkeypatch.setattr(wt, "STACK_CAPACITY", fit)
    st.make_stream_tables(*arrays, max_stack, page_stack)
    monkeypatch.setattr(wt, "STACK_CAPACITY", fit - 1)
    with pytest.raises(ValueError, match="seeded portals"):
        st.make_stream_tables(*arrays, max_stack, page_stack)
    # Without the page bound the larger one is checked.
    monkeypatch.setattr(wt, "STACK_CAPACITY", max_stack + K - 2)
    with pytest.raises(ValueError, match="seeded portals"):
        st.make_stream_tables(*arrays, max_stack)
    monkeypatch.setattr(wt, "STACK_CAPACITY", 160)
    # The page pass's root rows are packed into 28 bits of its sort keys.
    monkeypatch.setattr(st, "ROOT_BITS", 4)
    with pytest.raises(ValueError, match="global rows"):
        st.make_stream_tables(*arrays, max_stack, page_stack)


@pytest.mark.parametrize("kind", ["resident", "page"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_pass_pops(wave, kind, any_hit):
    """Per-ray visits (rows popped and not culled): at least the pass's node
    visits, none on a dead lane, and a wave of one ray repeated uses every
    lane."""
    tables, _, o, d, tm = wave
    t1, tri1, pid, pt, _ = st.resident_plain(any_hit, tables, o, d, tm)
    args = (o, d, tm) if kind == "resident" else \
        (o, d, tm, pid, pt, torch.where(tri1 >= 0, t1, tm), tri1)
    (st.resident_plain if kind == "resident" else st.page_plain)(any_hit, tables, *args)
    name = st._name(kind, any_hit)
    pops, work = st.last_pops[name], st.last_work[name]
    assert pops.shape == (o.shape[0],) and pops.dtype == torch.int64
    assert int(pops.sum()) >= work["nodes"] > 0
    assert bool((pops[tm <= 0] == 0).all())
    if kind == "resident":
        assert bool((pops[tm > 0] >= 1).all())  # the root at least
    assert 0.0 < wt.warp_utilisation(pops) <= 1.0
    i = int(torch.nonzero(pops).flatten()[0])
    same = [x[i:i + 1].repeat(64, *([1] * (x.dim() - 1))) for x in args]
    (st.resident_plain if kind == "resident" else st.page_plain)(any_hit, tables, *same)
    assert wt.warp_utilisation(st.last_pops[name]) == 1.0


def test_kernel_utilisation_counts_inline_leaf_rounds():
    # The resident pass tests leaves inline: the most leaf rows a lane
    # tested in a node step are warp steps too.
    stats = {"nodes": 60, "leaves": 20, "instances": 0, "triangles": 50,
             "node_steps": 3, "leaf_phases": 0, "fetches": 2, "leaf_rounds": 2}
    assert wt.kernel_utilisation(stats) == 80 / (32 * 5)


# ---- the tie-aware bar of the paged closest hit ----

@pytest.fixture(scope="module")
def tie():
    """Paged tables (12-row pages) of a soup beside the triangle `a` twice
    (ids 0 and 1: an exact tie for a ray through it) and `b` (id 2) beside
    them; rays along +z through `a`."""
    a = np.array([[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]], np.float32)
    b = a + np.array([2.0, 0.0, 0.5], np.float32)
    rest = soup(600, seed=7) + np.array([0.0, 0.0, 4.0], np.float32)
    world = np.concatenate([np.stack([a, a, b]), rest])
    tables, _, _ = tables_of(world, 12)
    n = 64
    rng = np.random.default_rng(3)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.1, 0.1, (n, 2))
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    tm = torch.full((n,), float("inf"))
    hit, _ = st.trace_closest_plain(tables, o, d, tm)
    assert bool((hit.tri >= 0).all()) and set(hit.tri.tolist()) <= {0, 1}
    leaves = parity.stream_leaf_rows(tables)
    assert int(leaves[:, 0].sum()) == world.shape[0]  # every triangle once
    return tables, o, d, hit


def _other(hit, lane, tri, t=None):
    tri_out, t_out = hit.tri.clone(), hit.t.clone()
    tri_out[lane] = tri
    if t is not None:
        t_out[lane] = t
    return st.StreamHit(t_out, tri_out)


def test_stream_bar_passes_a_true_tie(tie):
    tables, o, d, hit = tie
    assert parity.compare_stream_closest(hit, hit, (tables, o, d)) == 0.0
    kernel = _other(hit, 5, 1 - int(hit.tri[5]))
    assert parity.compare_stream_closest(kernel, hit, (tables, o, d)) == 0.0


def test_stream_bar_fails_a_false_tie(tie):
    tables, o, d, hit = tie
    with pytest.raises(AssertionError, match="not at an exact tie"):
        parity.compare_stream_closest(_other(hit, 5, 2), hit, (tables, o, d))


def test_stream_bar_fails_t_one_ulp_off(tie):
    tables, o, d, hit = tie
    off = torch.nextafter(hit.t[7], torch.tensor(float("inf")))
    with pytest.raises(AssertionError, match="not bit-equal on 1 of"):
        parity.compare_stream_closest(_other(hit, 7, int(hit.tri[7]), off), hit, (tables, o, d))
