"""The primary wave (K1): the plain version the persistent-warp walk is held
to, on a tile-ordered camera wave through a scene with coincident
triangles, and the u, v part of the tie-aware bar (parity.compare_closest).

The scene: room, light and three instances of one icosphere, two of them
at the same place and scale, so a ray that meets one meets the other's
copy of the triangle at exactly the same t (a true tie, in world space on
merged tables and across instances on two-level ones).

- The plain primary (`trace_primary` on CPU tensors) against the JAX
  package's `pallas_wide.trace_closest_wide` (TPU kernel `_kernel`, interpret
  mode), merged and two-level (`force_two_level`): hit masks, tri and inst
  equal on every ray; t within rtol 1e-4 (XLA on the CPU rounds its
  products apart from PyTorch); u, v within parity.UV_ATOL.
- Its per-ray visits (`last_pops`) sum to the visits, and the warp
  utilisation of a tile-ordered wave beats that of the same rays shuffled.
- compare_closest: a tie-swapped id with its own u, v passes; the same swap
  with u moved by 1e-3 fails, as does a moved u on an agreed id.
- trace_stats refuses CPU tensors and an unknown role."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_raytracer_tpu.config import ReconstructionFilter
from gpu_raytracer_tpu.ops import camera_rays as jcam
from gpu_raytracer_tpu.ops import pallas_wide as pwd
from gpu_raytracer_tpu.ops.buffers import build_scene_buffers as jax_build
from gpu_raytracer_tpu_torch import parity
from gpu_raytracer_tpu_torch.assets import geometry
from gpu_raytracer_tpu_torch.ops import buffers as tb
from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
from gpu_raytracer_tpu_torch.scene.scene import Scene
from gpu_raytracer_tpu_torch.scene.types import Material
from gpu_raytracer_tpu_torch.scenes import _light_and_camera, _room

from tests.test_torch_import import force_two_level, jax_scene_of
from tests.test_torch_import import private_bvh_cache  # noqa: F401

torch.set_num_threads(2)

W = H = 32
TWIN, COPY = 1, 2  # instance ids of the coincident pair (the room is 0)


def _scene():
    scene = Scene()
    _room(scene)
    mesh = scene.add_mesh_data(geometry.sphere(np.eye(4, dtype=np.float32), 1), "s")
    mat = scene.add_material(Material(name="m"))
    for k, (pos, s) in enumerate((((0.0, -1.2, 0.0), 0.7), ((0.0, -1.2, 0.0), 0.7),
                                  ((1.0, -1.5, -0.5), 0.5))):
        inst = scene.add_instance(f"s{k}", mesh, mat)
        inst.position = np.array(pos, np.float32)
        inst.scale = s
    return _light_and_camera(scene, W, H, position=(0.0, 0.0, 1.9), pitch=-0.4)


@pytest.fixture(scope="module", params=["merged", "two_level"])
def primary(request):
    scene = _scene()
    jscene = jax_scene_of(scene)
    if request.param == "two_level":
        with force_two_level():
            ours = tb.build_scene_buffers(scene, "cpu")
            jax_build(jscene)
    else:
        ours = tb.build_scene_buffers(scene, "cpu")
        jax_build(jscene)
    tables = ours["wide"]
    assert tables.two_level == (request.param == "two_level")
    nodes, rows = (jnp.asarray(np.asarray(x)) for x in jscene._host_buffers["wide"])
    cam = {k: jnp.asarray(v) for k, v in jscene.camera.params().items()}
    o, d = jcam.generate_primary_rays(cam, jnp.asarray(jcam.tile_order(W, H)), W, 0,
                                      ReconstructionFilter.BOX)
    o, d = np.array(o), np.array(d)
    tmax = np.full(W * H, np.inf, np.float32)
    tmax[::29] = 0.0  # dead lanes
    ref = pwd.trace_closest_wide(nodes, rows, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tmax), interpret=True)
    rays = tuple(torch.as_tensor(x) for x in (o, d, tmax))
    out = wt.trace_primary(tables, *rays)
    pops, work = wt.last_pops, dict(wt.last_work)
    return {"tables": tables, "prim_map": ours["prim_map"], "rays": rays, "ref": ref,
            "out": out, "pops": pops, "work": work}


def _instances(p):
    """(triangle, instance) of each ray's hit."""
    out = p["out"]
    if out.inst is not None:
        return out.tri, out.inst
    return wt.decode_prim(p["prim_map"], out.tri)


def _twin_lanes(p, n=None):
    """Rays that hit the twin instance, and the id each would name on the
    copy: the copy's prim code (merged) or the same triangle in the copy."""
    tri, inst = _instances(p)
    lanes = torch.nonzero(inst == TWIN).flatten()[:n]
    if p["out"].inst is not None:
        return lanes, p["out"].tri[lanes], torch.full_like(lanes, COPY).to(torch.int32)
    codes = p["prim_map"].long()
    where = {int(c): i for i, c in enumerate(codes.tolist())}
    swapped = torch.tensor([where[(COPY << 22) | int(t)] for t in tri[lanes]],
                           dtype=torch.int32)
    return lanes, swapped, None


def test_plain_primary_matches_wide_kernel(primary):
    ref, out = primary["ref"], primary["out"]
    rtri, otri = np.asarray(ref.tri), out.tri.numpy()
    hit = rtri >= 0
    np.testing.assert_array_equal(hit, otri >= 0)
    assert 0.5 < hit.mean() < 1.0
    np.testing.assert_array_equal(otri, rtri)
    if out.inst is not None:
        np.testing.assert_array_equal(out.inst.numpy(), np.asarray(ref.inst))
    np.testing.assert_allclose(out.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-4)
    assert np.all(np.isinf(out.t.numpy()[~hit]))
    for k in ("u", "v"):
        err = np.abs(getattr(out, k).numpy() - np.asarray(getattr(ref, k)))[hit].max()
        assert err <= parity.UV_ATOL
    # The twin's hits are true ties: the copy's triangle meets each ray at
    # the same t, u, v (re-tested), and both sides named the twin.
    _, inst = _instances(primary)
    assert not bool((inst == COPY).any())
    lanes, swapped, inst_swapped = _twin_lanes(primary)
    assert lanes.numel() >= 32
    o, d, _ = primary["rays"]
    t_re, u_re, v_re = parity.retest(primary["tables"], o[lanes], d[lanes], swapped,
                                     inst_swapped)
    assert torch.equal(t_re, out.t[lanes])
    assert torch.equal(u_re, out.u[lanes]) and torch.equal(v_re, out.v[lanes])


def test_plain_primary_pops_on_a_tile_ordered_wave(primary):
    pops, work = primary["pops"], primary["work"]
    _, _, tmax = primary["rays"]
    assert int(pops.sum()) == work["nodes"] + work["leaves"] + work["instances"]
    assert (work["instances"] > 0) == primary["tables"].two_level
    assert bool((pops[tmax <= 0] == 0).all()) and bool((pops[tmax > 0] >= 1).all())
    util = wt.warp_utilisation(pops)
    assert 0.0 < util < 1.0
    # The same rays in a shuffled order: warps of far-apart pixels diverge.
    perm = torch.as_tensor(np.random.default_rng(5).permutation(W * H))
    shuffled = wt.warp_utilisation(pops[perm])
    assert util > shuffled


def _swap(p, n, du=0.0):
    """The plain hit with `n` twin rays naming the copy's triangle, their u
    moved by `du`."""
    out = p["out"]
    lanes, swapped, inst_swapped = _twin_lanes(p, n)
    tri, u = out.tri.clone(), out.u.clone()
    tri[lanes] = swapped
    u[lanes] += du
    inst = None
    if out.inst is not None:
        inst = out.inst.clone()
        inst[lanes] = inst_swapped
    return wt.Hit(out.t, tri, inst, u, out.v)


def test_bar_accepts_a_tie_swapped_id_with_its_uv(primary):
    rays = (primary["tables"], *primary["rays"][:2])
    kernel = _swap(primary, 3)
    assert int((kernel.tri != primary["out"].tri).sum()) + int(
        0 if kernel.inst is None else (kernel.inst != primary["out"].inst).sum()) > 0
    assert parity.compare_closest(kernel, primary["out"], parity.TRI_MATCH_COHERENT,
                                  True, rays) == 0.0


def test_bar_refuses_a_tie_swapped_id_with_moved_u(primary):
    rays = (primary["tables"], *primary["rays"][:2])
    kernel = _swap(primary, 3, du=1e-3)
    with pytest.raises(AssertionError, match="tie-swapped"):
        parity.compare_closest(kernel, primary["out"], parity.TRI_MATCH_COHERENT, True, rays)
    # Without u, v in the bar the same swap passes.
    parity.compare_closest(kernel, primary["out"], parity.TRI_MATCH_COHERENT, False, rays)


def test_bar_refuses_a_moved_u_on_an_agreed_id(primary):
    rays = (primary["tables"], *primary["rays"][:2])
    out = primary["out"]
    u = out.u.clone()
    lane = int(torch.nonzero(out.tri >= 0).flatten()[7])
    u[lane] += 1e-3
    kernel = wt.Hit(out.t, out.tri, out.inst, u, out.v)
    with pytest.raises(AssertionError, match="u/v err"):
        parity.compare_closest(kernel, out, parity.TRI_MATCH_COHERENT, True, rays)


def test_trace_stats_primary_needs_the_card(primary):
    tables = primary["tables"]
    with pytest.raises(ValueError, match="on the card"):
        wt.trace_stats(wt.PRIMARY, tables, *primary["rays"])
    with pytest.raises(ValueError, match="no traversal role"):
        wt.trace_stats(7, tables, *primary["rays"])
