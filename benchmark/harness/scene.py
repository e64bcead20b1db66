"""Scenes from a configuration file: the benchmark makes the triangles,
materials, instances and camera itself and hands the same data to the
port (`to_port`) and to the plain reference (`world_triangles`,
`camera_basis`).

The tessellators are frozen copies of
`gpu_raytracer_tpu_torch/assets/geometry.py` (`_affine`, `_xform_pts`,
`_xform_normals`, `_build`: lines 17-39; `rectangle`: 42-50; `cube` and its
tables: 53-80; `sphere`: 133-183, here vectorised with numpy: the same
vertices, faces in the same order), and the instance grid is a frozen copy
of `gpu_raytracer_tpu_torch/scenes.py` `instanced_scene` (lines 109-131), so
that a configuration built here is the scene those functions build.
Nothing here imports the port until `to_port`.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np


def _affine(transform) -> np.ndarray:
    t = np.asarray(transform, np.float32)
    if t.shape == (4, 4):
        return t[:3, :]
    if t.shape != (3, 4):
        raise ValueError(f"a mesh matrix is 3x4 or 4x4, not {t.shape}")
    return t


def _xform_pts(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:, :3].T + m[:, 3]


def _xform_normals(m: np.ndarray, normals: np.ndarray) -> np.ndarray:
    cof = np.linalg.inv(m[:, :3].astype(np.float64)).T.astype(np.float32)
    n = normals @ cof.T
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


def _build(m, tri_pos, tri_normals, tri_uvs) -> tuple:
    """(positions (T, 3, 3), normals (T, 3, 3), uvs (T, 3, 2)) float32,
    with the reference's winding rule (Triangle.h
    fix_winding_order_if_needed; the port's `TriangleData`, types.py
    :132-166): where all three shading normals oppose the geometric
    normal, vertices 1 and 2 swap."""
    pos = _xform_pts(m, np.asarray(tri_pos, np.float32).reshape(-1, 3)).reshape(-1, 3, 3)
    nrm = _xform_normals(m, np.asarray(tri_normals, np.float32).reshape(-1, 3)).reshape(-1, 3, 3)
    uvs = np.asarray(tri_uvs, np.float32).reshape(-1, 3, 2).copy()
    geom = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    geom = geom / np.maximum(np.linalg.norm(geom, axis=-1, keepdims=True), 1e-20)
    flipped = np.all(np.einsum("tvc,tc->tv", nrm, geom) < 0.0, axis=1)
    for a in (pos, nrm, uvs):
        a[flipped] = a[flipped][:, [0, 2, 1]]
    return pos, nrm, uvs


def rectangle(transform) -> tuple:
    m = _affine(transform)
    v = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    n = np.array([0, 0, 1], np.float32)
    tri_pos = [v[0], v[1], v[2], v[0], v[2], v[3]]
    tri_uv = [uv[0], uv[1], uv[2], uv[0], uv[2], uv[3]]
    return _build(m, tri_pos, [n] * 6, tri_uv)


_CUBE_FACES = [
    ([0, 1, 2, 3], [0, 1, 0]),
    ([0, 1, 5, 4], [0, 0, -1]),
    ([1, 2, 6, 5], [1, 0, 0]),
    ([2, 3, 7, 6], [0, 0, 1]),
    ([3, 0, 4, 7], [-1, 0, 0]),
    ([4, 5, 6, 7], [0, -1, 0]),
]
_CUBE_VERTS = np.array([[-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1],
                        [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1]], np.float32)


def cube(transform) -> tuple:
    m = _affine(transform)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tri_pos, tri_n, tri_uv = [], [], []
    for idx, n in _CUBE_FACES:
        quad = _CUBE_VERTS[idx]
        tri_pos += [quad[0], quad[1], quad[2], quad[0], quad[2], quad[3]]
        tri_n += [n] * 6
        tri_uv += [uv[0], uv[1], uv[2], uv[0], uv[2], uv[3]]
    return _build(m, tri_pos, tri_n, tri_uv)


_ICO_FACES = np.array([
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
    (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
    (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)], np.int64)


def icosphere(transform, num_subdivisions: int) -> tuple:
    """Unit icosphere by midpoint subdivision: each face (a, b, c) becomes
    (a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca), every midpoint
    normalised in float64."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = _ICO_FACES
    for _ in range(num_subdivisions):
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        edges = np.stack([np.stack([a, b], 1), np.stack([b, c], 1),
                          np.stack([c, a], 1)], 1).reshape(-1, 2)
        keys, inverse = np.unique(np.sort(edges, axis=1), axis=0, return_inverse=True)
        mid = (verts[keys[:, 0]] + verts[keys[:, 1]]) * 0.5
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        ids = (len(verts) + inverse.reshape(-1)).reshape(-1, 3)
        ab, bc, ca = ids[:, 0], ids[:, 1], ids[:, 2]
        verts = np.concatenate([verts, mid])
        faces = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                          np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)],
                         1).reshape(-1, 3)
    p = verts.astype(np.float32)[faces]                      # (F, 3, 3)
    uv = np.stack([0.5 + np.arctan2(p[..., 2], p[..., 0]) / (2 * np.pi),
                   0.5 - np.arcsin(np.clip(p[..., 1], -1, 1)) / np.pi], -1)
    return _build(_affine(transform), p, p, uv)


SHAPES = {"cube": lambda s, m: cube(m), "rectangle": lambda s, m: rectangle(m),
          "icosphere": lambda s, m: icosphere(m, int(s["subdivisions"]))}


def quat_axis_angle(axis, angle_rad: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle_rad * 0.5
    return np.array([*(axis * np.sin(half)), np.cos(half)], np.float32)


def quat_matrix(q) -> np.ndarray:
    """3x3 rotation of the quaternion (x, y, z, w), float64."""
    x, y, z, w = (float(v) for v in q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


@dataclass
class Instance:
    name: str
    mesh: str
    material: str
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    scale: float = 1.0


@dataclass
class SceneData:
    """A configuration's scene: meshes (name -> positions, normals, uvs in
    object space), materials (name -> dict), instances in order, the camera
    (position, rotation quaternion, fov across the width) and the film."""
    meshes: dict
    materials: dict
    instances: list
    camera: dict
    width: int
    height: int

    def triangle_count(self) -> int:
        return sum(len(self.meshes[i.mesh][0]) for i in self.instances)


def _grid(spec: dict, materials: list) -> list:
    """`instanced_scene`'s field: `n` x `n` instances of one mesh on the
    floor, seeded yaw and scale, materials cycling."""
    rng = np.random.default_rng(int(spec["seed"]))
    n, extent = int(spec["n"]), float(spec["extent"])
    lo, hi = spec["scale_range"]
    spacing = extent / n
    out = []
    for k in range(n * n):
        i, j = divmod(k, n)
        scale = spacing * rng.uniform(lo, hi)
        out.append(Instance(
            name=f"{spec['prefix']}{k}", mesh=spec["mesh"], material=materials[k % len(materials)],
            position=np.array([-0.5 * extent + spacing * (j + 0.5), float(spec["floor_y"]) + scale,
                               -0.5 * extent + spacing * (i + 0.5)], np.float32),
            rotation=quat_axis_angle([0.0, 1.0, 0.0], rng.uniform(0.0, 2.0 * np.pi)),
            scale=float(scale)))
    return out


def build(config: dict) -> SceneData:
    """SceneData of a configuration (its `scene` and `film` entries)."""
    sc = config["scene"]
    meshes, made = {}, {}
    for name, spec in sc["meshes"].items():
        key = json.dumps(spec, sort_keys=True)
        if key not in made:
            made[key] = SHAPES[spec["shape"]](spec, spec.get("matrix", np.eye(4)))
        meshes[name] = made[key]
    instances = []
    for entry in sc["instances"]:
        if "grid" in entry:
            instances += _grid(entry["grid"], entry["grid"]["materials"])
            continue
        inst = Instance(name=entry["name"], mesh=entry["mesh"], material=entry["material"])
        if "position" in entry:
            inst.position = np.array(entry["position"], np.float32)
        if "scale" in entry:
            inst.scale = float(entry["scale"])
        instances.append(inst)
    cam = sc["camera"]
    rotation = (quat_axis_angle([1.0, 0.0, 0.0], float(cam["pitch"])) if cam.get("pitch")
                else np.array([0, 0, 0, 1], np.float32))
    camera = {"position": np.array(cam["position"], np.float32), "rotation": rotation,
              "fov": math.radians(float(cam["fov_deg"]))}
    film = config["film"]
    return SceneData(meshes, sc["materials"], instances, camera,
                     int(film["width"]), int(film["height"]))


def to_port(data: SceneData):
    """The port's Scene of `data`: one mesh record per mesh name, the
    instances in order, the camera, as `scenes._light_and_camera` sets
    them up."""
    from gpu_raytracer_tpu_torch.scene.scene import Scene
    from gpu_raytracer_tpu_torch.scene.types import Material, MaterialType, TriangleData

    scene = Scene()
    mesh_ids = {name: scene.add_mesh_data(TriangleData(*m), name)
                for name, m in data.meshes.items()}
    mat_ids = {}
    for name, m in data.materials.items():
        if m["type"] == "light":
            mat = Material(name=name, type=MaterialType.LIGHT,
                           emission=np.array(m["emission"], np.float32))
        elif m["type"] == "diffuse":
            mat = Material(name=name, diffuse=np.array(m["albedo"], np.float32))
        else:
            raise ValueError(f"material {name}: type {m['type']!r} is not built here")
        mat_ids[name] = scene.add_material(mat)
    for i in data.instances:
        inst = scene.add_instance(i.name, mesh_ids[i.mesh], mat_ids[i.material])
        inst.position = np.asarray(i.position, np.float32)
        inst.rotation = np.asarray(i.rotation, np.float32)
        inst.scale = float(i.scale)
    scene.update()
    scene.finalize()
    scene.camera.position = data.camera["position"].copy()
    scene.camera.rotation = data.camera["rotation"].copy()
    scene.camera.fov = data.camera["fov"]
    scene.film_width, scene.film_height = data.width, data.height
    scene.camera.resize(data.width, data.height)
    scene.camera.update(0.0)
    scene.check_materials()
    return scene


def world_triangles(data: SceneData) -> dict:
    """World-space triangle soup of every instance, in float32:
    v0, v1, v2, n0, n1, n2 (T, 3); material row and instance per
    triangle (T,);
    the material table: kind (0 diffuse, 2 light), albedo, emission."""
    names = list(data.materials)
    kinds = np.array([2 if data.materials[n]["type"] == "light" else 0 for n in names], np.int64)
    albedo = np.array([data.materials[n].get("albedo", [0, 0, 0]) for n in names], np.float32)
    emission = np.array([data.materials[n].get("emission", [0, 0, 0]) for n in names],
                        np.float32)
    pos, nrm, mat, inst = [], [], [], []
    for k, i in enumerate(data.instances):
        p, n, _ = data.meshes[i.mesh]
        r = quat_matrix(i.rotation) * float(i.scale)
        t = np.asarray(i.position, np.float64)
        pos.append((p.reshape(-1, 3) @ r.T + t).reshape(-1, 3, 3))
        inv_t = np.linalg.inv(r).T
        w = n.reshape(-1, 3) @ inv_t.T
        w /= np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-20)
        nrm.append(w.reshape(-1, 3, 3))
        mat.append(np.full(len(p), names.index(i.material), np.int64))
        inst.append(np.full(len(p), k, np.int32))
    pos = np.concatenate(pos).astype(np.float32)
    nrm = np.concatenate(nrm).astype(np.float32)
    return {"v0": pos[:, 0], "v1": pos[:, 1], "v2": pos[:, 2],
            "n0": nrm[:, 0], "n1": nrm[:, 1], "n2": nrm[:, 2],
            "mat": np.concatenate(mat), "inst": np.concatenate(inst), "kind": kinds,
            "albedo": albedo, "emission": emission}


def camera_basis(camera: dict, width: int, height: int) -> dict:
    """Pinhole camera rays' frame (Camera.cpp's view pyramid, the fov across
    the width): position, bottom-left corner, x and y axes, float64;
    a pixel (x, y) + jitter looks along blc + (x + jx) xa + (y + jy) ya."""
    rot = quat_matrix(camera["rotation"])
    half_w, half_h = 0.5 * width, 0.5 * height
    d = half_w / math.tan(0.5 * camera["fov"])
    return {"position": np.asarray(camera["position"], np.float64),
            "blc": rot @ np.array([-half_w, -half_h, -d]),
            "xa": rot @ np.array([1.0, 0.0, 0.0]), "ya": rot @ np.array([0.0, 1.0, 0.0])}
