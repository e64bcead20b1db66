"""Wide traversal: the plain version's per-ray visit counts, from which the
warp utilisation of the one-thread-a-ray schedule is computed, and the
tie-aware closest-hit bar (parity.compare_closest) that holds the
persistent-warp kernel, whose visit order differs from the plain version's,
to it.

Visit counts: on the procedural room (merged tables) and on the small
instanced scene packed two-level, the per-ray counts (`last_pops`) sum to
the interior nodes, leaf rows and instance rows of `last_work`, and a wave
of identical rays has a utilisation of 1. The counts are checked against
the JAX package's gang kernel in interpret mode on the same rays: equal
hits mean both walked the same tree.

The bar: synthetic kernel hits against the plain version's on a triangle
soup with one triangle duplicated, so a ray through it meets two
triangles at exactly the same t (a true tie, which passes), and a claim of
a third triangle at that t (a false tie, which fails); t one ulp off, a
hit mask that differs and a match fraction below the bar fail too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_raytracer_tpu.ops import pallas_gang as pg
from gpu_raytracer_tpu_torch import parity
from gpu_raytracer_tpu_torch.bvh import wide as wide_mod
from gpu_raytracer_tpu_torch.bvh.sah import build_bvh2
from gpu_raytracer_tpu_torch.ops import buffers as tb
from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
from gpu_raytracer_tpu_torch.scene.types import TriangleData
from gpu_raytracer_tpu_torch.scenes import instanced_scene, procedural_scene

from tests.test_torch_import import force_two_level
from tests.test_torch_import import private_bvh_cache  # noqa: F401

torch.set_num_threads(2)

R = 512


def _rays(seed, lo, hi, y=None):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    if y is not None:
        o[:, 1] = rng.uniform(*y, R)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(R, np.inf, np.float32)
    tmax[::29] = 0.0  # dead lanes
    return o, d, tmax


@pytest.fixture(scope="module", params=["merged", "two_level"])
def wave(request):
    if request.param == "merged":
        tables = tb.build_scene_buffers(procedural_scene(16, 16, 2), "cpu")["wide"]
        o, d, tmax = _rays(11, -1.5, 1.5)
    else:
        with force_two_level():
            tables = tb.build_scene_buffers(
                instanced_scene(16, 16, grid=3, sphere_subdivisions=1), "cpu")["wide"]
        o, d, tmax = _rays(13, -1.9, 1.9, y=(-1.95, -1.2))
    assert tables.two_level == (request.param == "two_level")
    return tables, o, d, tmax


@pytest.mark.parametrize("mode", [wt.CLOSEST, wt.ANY])
def test_pops_sum_to_the_visits(wave, mode):
    tables, o, d, tmax = wave
    if mode == wt.ANY:
        tmax = np.where(tmax > 0, np.float32(1.2), np.float32(0.0))
    out = wt.trace_plain(mode, tables, *(torch.as_tensor(x) for x in (o, d, tmax)))
    pops, work = wt.last_pops, dict(wt.last_work)
    assert pops.shape == (R,) and pops.dtype == torch.int64
    assert int(pops.sum()) == work["nodes"] + work["leaves"] + work["instances"]
    assert work["leaves"] > 0 and work["triangles"] >= work["leaves"]
    assert (work["instances"] > 0) == tables.two_level
    assert bool((pops[torch.as_tensor(tmax) <= 0] == 0).all())  # dead lanes pop nothing
    assert bool((pops[torch.as_tensor(tmax) > 0] >= 1).all())   # the root at least
    util = wt.warp_utilisation(pops)
    assert 0.0 < util < 1.0
    # The same walk as the JAX package's gang kernel (interpret mode).
    ref = (pg.trace_any_gang if mode == wt.ANY else pg.trace_closest_gang)(
        jnp.asarray(tables.nodes.numpy()), jnp.asarray(tables.rows.numpy()),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        flat=not tables.two_level, interpret=True)
    if mode == wt.ANY:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    else:
        np.testing.assert_array_equal(out.tri.numpy() >= 0, np.asarray(ref.tri) >= 0)


def test_identical_rays_use_every_lane(wave):
    tables, o, d, tmax = wave
    live = np.nonzero(tmax > 0)[0][:3]
    for i in live:  # a ray that hits, one that may not: any ray will do
        same = [torch.as_tensor(np.repeat(x[i:i + 1], 64, axis=0)) for x in (o, d, tmax)]
        wt.trace_plain(wt.CLOSEST, tables, *same)
        assert int(wt.last_pops[0]) >= 1
        assert bool((wt.last_pops == wt.last_pops[0]).all())
        assert wt.warp_utilisation(wt.last_pops) == 1.0


def test_warp_utilisation_by_hand():
    # Two warps: 32 lanes of 1 and 2 visits (max 2); 8 lanes of 4 visits
    # (max 4, the rest of the warp empty).
    pops = torch.tensor([1, 2] * 16 + [4] * 8)
    assert wt.warp_utilisation(pops) == (48 + 32) / (32 * (2 + 4))
    stats = {"nodes": 30, "leaves": 20, "instances": 14, "triangles": 90,
             "node_steps": 3, "leaf_phases": 1, "fetches": 5}
    assert wt.kernel_utilisation(stats) == 50 / (32 * 4)


# ---- the tie-aware closest-hit bar ----

def _soup():
    """Three triangles in the z = 1 plane region, packed merged: 0 and 1 the
    same triangle (an exact tie for any ray through it), 2 beside them."""
    a = np.array([[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]], np.float32)
    b = a + np.array([2.0, 0.0, 0.5], np.float32)
    world = np.stack([a, a, b])
    bvh = build_bvh2(TriangleData(world), max_leaf_size=wide_mod.LEAF_CAP)
    wideb = wide_mod.collapse_wide(bvh)
    geo = np.concatenate([world[:, 0], world[:, 1] - world[:, 0],
                          world[:, 2] - world[:, 0]], axis=-1)
    packed = wide_mod.pack_wide_merged(wideb, bvh.indices,
                                       geo[bvh.indices].astype(np.float32))
    return wt.make_tables(torch.as_tensor(packed["nodes"]), torch.as_tensor(packed["rows"]),
                          packed["max_stack"])


@pytest.fixture(scope="module")
def tie():
    tables = _soup()
    n = 64
    rng = np.random.default_rng(3)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.1, 0.1, (n, 2))
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    tm = torch.full((n,), float("inf"))
    plain = wt.trace_closest_plain(tables, o, d, tm)
    assert bool((plain.tri >= 0).all()) and set(plain.tri.tolist()) <= {0, 1}
    return tables, o, d, plain


def _swap(hit, lanes, tri, t=None):
    tri_out, t_out = hit.tri.clone(), hit.t.clone()
    tri_out[lanes] = tri
    if t is not None:
        t_out[lanes] = t
    return wt.Hit(t_out, tri_out, hit.inst)


def test_bar_passes_a_true_tie(tie):
    tables, o, d, plain = tie
    assert parity.compare_closest(plain, plain, 0.98, False, (tables, o, d)) == 0.0
    # The other copy of the triangle on one ray: the same t, a true tie.
    kernel = _swap(plain, [5], 1 - int(plain.tri[5]))
    assert parity.compare_closest(kernel, plain, 0.98, False, (tables, o, d)) == 0.0


def test_bar_fails_a_false_tie(tie):
    tables, o, d, plain = tie
    kernel = _swap(plain, [5], 2)  # the triangle beside them, claimed at t
    with pytest.raises(AssertionError, match="not at an exact tie"):
        parity.compare_closest(kernel, plain, 0.98, False, (tables, o, d))
    t_re = parity.retest(tables, o[[5]], d[[5]], torch.tensor([2]), None)[0]
    assert bool(torch.isnan(t_re).all())  # the ray misses triangle 2


def test_bar_fails_t_one_ulp_off(tie):
    tables, o, d, plain = tie
    t = plain.t.clone()
    t[7] = torch.nextafter(t[7], torch.tensor(float("inf")))
    kernel = wt.Hit(t, plain.tri, None)
    with pytest.raises(AssertionError, match="not bit-equal on 1 of"):
        parity.compare_closest(kernel, plain, 0.98, False, (tables, o, d))


def test_bar_keeps_masks_and_match_fraction(tie):
    tables, o, d, plain = tie
    miss = _swap(plain, [0], -1, float("inf"))
    with pytest.raises(AssertionError, match="hit masks differ"):
        parity.compare_closest(miss, plain, 0.98, False, (tables, o, d))
    # Every ray a true tie: still below the match fraction.
    kernel = wt.Hit(plain.t, 1 - plain.tri, None)
    with pytest.raises(AssertionError, match="tri match"):
        parity.compare_closest(kernel, plain, 0.98, False, (tables, o, d))


def test_retest_two_level(wave):
    """retest re-derives the plain version's own closest t from (tri,
    inst) on two-level tables (the ray in the instance's space); a wrong
    instance does not."""
    tables, o, d, tmax = wave
    o, d, tmax = (torch.as_tensor(x) for x in (o, d, tmax))
    hit = wt.trace_closest_plain(tables, o, d, tmax)
    lanes = torch.nonzero(hit.tri >= 0).flatten()
    inst = None if hit.inst is None else hit.inst[lanes]
    t_re = parity.retest(tables, o[lanes], d[lanes], hit.tri[lanes], inst)[0]
    assert torch.equal(t_re, hit.t[lanes])
    if tables.two_level:
        sphere = torch.nonzero(hit.inst[lanes] >= 2).flatten()  # past room and light
        assert sphere.numel() > 0
        k = lanes[sphere]
        moved = (hit.inst[k] - 2 + 1) % 9 + 2  # another sphere of the 3 x 3 grid
        t_bad = parity.retest(tables, o[k], d[k], hit.tri[k], moved)[0]
        assert not bool((t_bad == hit.t[k]).any())
