"""The plain reference agrees with the semantics it stands for, on the
CPU: the scene the benchmark builds is the port's own scene, its camera
is the port's camera, and its SVGF + TAA is the port's plain filter."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import scene as scene_mod
from benchmark.reference import svgf as ref_svgf
from benchmark.tests import tiny


def _tiny_config(name):
    with open(os.path.join(tiny.BENCH, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["film"] = {"width": 64, "height": 36}
    cfg["scene"]["meshes"] = {k: (dict(v, subdivisions=2) if v["shape"] == "icosphere" else v)
                              for k, v in cfg["scene"]["meshes"].items()}
    for e in cfg["scene"]["instances"]:
        if "grid" in e:
            e["grid"]["n"] = 5
    return cfg


@pytest.mark.parametrize("name,make", [
    ("merged_1080p", lambda s: s.procedural_scene(64, 36, 2)),
    ("instanced_1080p", lambda s: s.instanced_scene(64, 36, 5, 2)),
])
def test_scene_is_the_ports_scene(name, make):
    from gpu_raytracer_tpu_torch import scenes

    data = scene_mod.build(_tiny_config(name))
    theirs = make(scenes)
    tris = []
    for inst in theirs.instances:
        m = inst.transform
        p = theirs.mesh_datas[inst.mesh_data_id].triangles.positions
        tris.append((p.reshape(-1, 3) @ m[:, :3].T + m[:, 3]).reshape(-1, 3, 3))
    w = scene_mod.world_triangles(data)
    np.testing.assert_allclose(np.stack([w["v0"], w["v1"], w["v2"]], 1), np.concatenate(tris),
                               atol=1e-6)
    ours = scene_mod.to_port(data).camera.params()
    basis = scene_mod.camera_basis(data.camera, 64, 36)
    for k, b in (("position", "position"), ("bottom_left_corner", "blc"), ("x_axis", "xa"),
                 ("y_axis", "ya")):
        np.testing.assert_allclose(theirs.camera.params()[k], ours[k], atol=1e-6)
        np.testing.assert_allclose(ours[k], basis[b], atol=1e-5)


def test_full_size_counts():
    for name, tris, inst in (("merged_1080p", 245774, 5), ("instanced_1080p", 2257934, 443)):
        with open(os.path.join(tiny.BENCH, "configs", f"{name}.json")) as f:
            cfg = json.load(f)
        cfg["scene"]["meshes"] = {k: v for k, v in cfg["scene"]["meshes"].items()}
        data = scene_mod.build(cfg)
        assert (data.triangle_count(), len(data.instances)) == (tris, inst)


@pytest.mark.parametrize("offset", [0.0, 0.03])
def test_view_projection_is_the_cameras(offset):
    data = scene_mod.build(_tiny_config("merged_1080p"))
    port = scene_mod.to_port(data)
    cam = port.camera
    cam.position = (data.camera["position"] + np.array([offset, 0, 0])).astype(np.float32)
    cam.update(0.0)
    np.testing.assert_array_equal(
        ref_svgf.view_projection(data.camera, cam.position, 64, 36), cam.view_projection)


def test_denoise_is_the_ports_plain_filter():
    from gpu_raytracer_tpu_torch.config import GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN
    from gpu_raytracer_tpu_torch.ops import svgf as port_svgf
    from gpu_raytracer_tpu_torch.ops import taa as port_taa

    g = torch.Generator().manual_seed(4)
    H, W = 20, 28

    def r(*s):
        return torch.rand(s, generator=g)
    n = torch.nn.functional.normalize(r(H, W, 3) + 0.5, dim=-1)
    frame = {"direct": r(H, W, 3), "indirect": r(H, W, 3), "albedo": r(H, W, 3),
             "normal": n, "depth": 2 + r(H, W), "instance": torch.zeros((H, W), dtype=torch.int32),
             "position_prev": torch.stack([r(H, W) - 0.5, r(H, W) - 0.5, -2 - r(H, W)], -1)}
    hist = port_svgf.SVGFHistory(r(H, W, 3), r(H, W, 3), r(H, W, 4), 1 + 3 * r(H, W), n,
                                 2 + r(H, W), torch.zeros((H, W), dtype=torch.int32))
    vp = torch.as_tensor(np.array([[1.2, 0, 0, 0], [0, 1.9, 0, 0], [0, 0, -1, -0.2],
                                   [0, 0, -1, 0]], np.float32))
    taa_prev = r(H, W, 3)
    cfg = GPUConfig(enable_svgf=True)
    colour, new = port_svgf.svgf_step(frame, hist, vp, cfg, kernels=PLAIN)
    taa_in = port_taa.to_taa_space(colour.clamp(min=0.0))
    screen = port_svgf.project_to_screen(frame["position_prev"], vp, W, H)
    expect = port_taa.from_taa_space(port_taa.taa_step(taa_in, taa_prev, screen))
    got, got_hist, _ = ref_svgf.denoise(frame, ref_svgf.History(*hist), taa_prev, vp, False,
                                        ref_svgf.settings_of({}))
    torch.testing.assert_close(got, expect, rtol=0, atol=0)
    for a, b in zip(got_hist, new):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
