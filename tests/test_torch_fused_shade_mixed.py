"""The fused shade on every BSDF: the plain version (`fused_shade_plain`)
against the JAX package's `shade_diffuse_pallas` (TPU kernel
`pallas_shade._kernel` in interpret mode) on a scene with plastic,
dielectric, conductor, diffuse and light materials, built like the JAX
test's `_mixed_scene` through the port's own geometry and scene types.
The JAX package packs the tables with its Kulla-Conty curves baked
(`_pack_pallas_shade`), `from_jax_buffers` converts them, and the port's
fused-shade route on the CPU gives the waves: 64x32 (two 1024-lane blocks,
two noise tiles), 8 bounces, sample 3; bounces 0 to 3 and the first bounce
on which most lanes are dead. Bar: parity.compare_shade (>= 99.9% of lanes
agree)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_raytracer_tpu.ops.buffers import build_scene_buffers as jax_build
from gpu_raytracer_tpu.ops.pallas_shade import shade_diffuse_pallas
from gpu_raytracer_tpu.ops.traverse import HitInstanced
from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig, parity
from gpu_raytracer_tpu_torch.assets import geometry
from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
from gpu_raytracer_tpu_torch.ops import buffers as tb
from gpu_raytracer_tpu_torch.ops import fused_shade as fs
from gpu_raytracer_tpu_torch.ops import shade_gather as sg
from gpu_raytracer_tpu_torch.scene.scene import Scene
from gpu_raytracer_tpu_torch.scene.sky import Sky
from gpu_raytracer_tpu_torch.scene.types import Material, MaterialType

from tests.test_torch_import import jax_scene_of
from tests.test_torch_import import private_bvh_cache  # noqa: F401

torch.set_num_threads(2)

W, H = 64, 32
SAMPLE = 3
BSDFS = {sg.MAT_DIFFUSE, sg.MAT_PLASTIC, sg.MAT_DIELECTRIC, sg.MAT_CONDUCTOR}


def mixed_scene() -> Scene:
    """Plastic, rough dielectric and rough conductor spheres and a diffuse
    floor under an area light and a constant sky (tests/test_pallas_shade.py
    `_mixed_scene`), the camera nearer so that the spheres fill the film."""
    scene = Scene()
    sphere = scene.add_mesh_data(
        geometry.sphere(np.eye(4, dtype=np.float32), num_subdivisions=2), "sphere")
    floor = scene.add_mesh_data(geometry.rectangle(np.vstack([
        [6.0, 0, 0, 0], [0, 0, -6.0, -1.0], [0, 6.0, 0, 0],
        [0, 0, 0, 1]]).astype(np.float32)), "floor")
    panel = scene.add_mesh_data(geometry.rectangle(np.vstack([
        [1.5, 0, 0, 0], [0, 0, 1.5, 3.0], [0, 1.5, 0, 0],
        [0, 0, 0, 1]]).astype(np.float32)), "panel")
    glass = scene.add_material(Material(
        name="glass", type=MaterialType.DIELECTRIC, index_of_refraction=1.5,
        linear_roughness=0.35))
    gold = scene.add_material(Material(
        name="gold", type=MaterialType.CONDUCTOR,
        eta=np.array([0.13, 0.45, 1.43], np.float32),
        k=np.array([3.98, 2.38, 1.60], np.float32), linear_roughness=0.4))
    shell = scene.add_material(Material(
        name="shell", type=MaterialType.PLASTIC,
        diffuse=np.array([0.7, 0.2, 0.2], np.float32), linear_roughness=0.25))
    gray = scene.add_material(Material(name="gray"))
    lamp = scene.add_material(Material(
        name="lamp", type=MaterialType.LIGHT,
        emission=np.array([8.0, 7.0, 6.0], np.float32)))
    for name, mat, x in (("glass", glass, -2.2), ("gold", gold, 0.0), ("shell", shell, 2.2)):
        inst = scene.add_instance(name, sphere, mat)
        inst.position = np.array([x, 0.0, 0.0], np.float32)
    scene.add_instance("floor", floor, gray)
    scene.add_instance("lamp", panel, lamp)
    scene.update()
    scene.sky = Sky.constant([0.25, 0.3, 0.35], 1, 1)
    scene.finalize()
    scene.camera.position = np.array([0.0, 0.5, 4.5], np.float32)
    scene.film_width, scene.film_height = W, H
    scene.camera.resize(W, H)
    scene.camera.update(0.0)
    return scene


@pytest.fixture(scope="module")
def setup():
    """The JAX tables (curves baked), and every fused shade call of one
    sample of the port's route on the same tables, with its plain outputs
    and the JAX kernel's (one jit of the interpret-mode kernel serves every
    bounce)."""
    scene = mixed_scene()
    jscene = jax_scene_of(scene)
    jbufs = jax_build(jscene)
    assert jbufs["pallas_shade"] is not None
    assert np.abs(np.asarray(jbufs["pallas_shade"][5])).sum() > 0  # curves baked
    pt = Pathtracer(scene, CPUConfig(batch_size=W * H), GPUConfig(num_bounces=8),
                    device="cpu")
    pt.buffers = tb.from_jax_buffers(jscene._host_buffers, jbufs["sampler"], "cpu")
    pt.reset_accumulation()
    calls = parity.capture_wave(pt, W * H, route="binary_shade", sample=SAMPLE,
                                every=True)["fused_shade"]

    @jax.jit
    def jax_shade(params, t, tri, inst, u, v, o, d, tp, alive, pnee, lpdf, pix):
        return shade_diffuse_pallas(
            jbufs["pallas_shade"], jbufs["sampler"], params,
            HitInstanced(t=t, tri=tri, inst=inst, u=u, v=v), o, d, tp, alive, pnee,
            lpdf, pix, W, interpret=True)

    def run(args, kw):
        assert kw == {"enable_nee": True, "enable_mis": True, "enable_rr": True}
        _, _, params, hit, o, d, tp, alive, pnee, lpdf, pix, width = args
        j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
        out = jax_shade(jnp.asarray(params), j(hit.t), j(hit.tri), j(hit.inst), j(hit.u),
                        j(hit.v), j(o), j(d), j(tp), j(alive), j(pnee), j(lpdf),
                        j(pix.int()))
        return ({k: torch.as_tensor(np.array(v)) for k, v in out.items()},
                fs.fused_shade_plain(*args, **kw))

    late = next(b for b, (a, _) in enumerate(calls) if int(a[7].sum()) < a[7].numel() // 2
                and b > 3)
    bounces = (0, 1, 2, 3, late)
    return {"calls": calls, "late": late,
            "out": {b: run(*calls[b]) for b in bounces}}


@pytest.mark.parametrize("bounce", [0, 1, 2, 3, "late"])
def test_plain_matches_jax_kernel_on_every_bsdf(setup, bounce):
    b = setup["late"] if bounce == "late" else bounce
    args = setup["calls"][b][0]
    theirs, ours = setup["out"][b]
    parity.compare_shade(ours, theirs)
    alive = args[7]
    if bounce == "late":
        assert int(alive.sum()) < alive.numel() // 2  # most lanes come in dead
    # Each BSDF is alive on some lane (every bounce but the last few).
    if bounce in (0, 1):
        cols = fs.plain_tables(args[0])
        inst = args[3].inst.long().clamp(min=0)
        mtype = cols[4][0].long()[cols[2][12].long()[inst]]
        live_types = set(mtype[alive & (args[3].tri >= 0)].tolist())
        assert BSDFS <= live_types, live_types
    assert bool(ours["alive"].any()) and bool((ours["shadow_tmax"] > 0).any())
