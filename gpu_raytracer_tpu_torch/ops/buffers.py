"""Scene -> device tables for the main path (JAX: gpu_raytracer_tpu/ops/
buffers.py).

`pack_scene` is a numpy packer that produces, for every key the main path
reads, the same arrays as the JAX package's host pytree
(`scene._host_buffers`), bit for bit:

  nodes.root_min / root_max  TLAS root bounds (coherence-sort Morton box)
  tris.shade_rows     (T, 32)  p0|e1|e2|n0|n1|n2|uv0..2 in leaf order
  instances.rows      (I, 32)  fwd 12 | inv 12 | material id | baked facts
  instances.prev_rows (I, 12)  previous-frame fwd transform (motion vectors)
  materials.rows      (M, 24)  type | emission | diffuse | rough | ior | ...
  lights              power CDF over (instance, triangle) pairs
  sky, sky_scale
  wide, wide_prim_map 8-wide BVH tables (bvh/wide.py) in one of two layouts:
                      merged: ONE world-space tree, prim_map[p] =
                        inst << 22 | leaf-order triangle id;
                      two-level: a TLAS over instance rows and per-mesh BLAS
                        trees (pack_wide_scene), prim_map None
  wide_stream,        or, instead of `wide`, the merged tree paged
  stream_prim         (bvh/stream.py: resident, pages, portal_page,
                      portal_root) with the split (P,) decode arrays
                      (prim_inst, prim_tri)
  shade_gather        (mat_tbl, kc_tbl, lgt_tbl) for the fused shade kernel
  pallas              binary two-level tables (node_mat, inst_mat, tri_mat),
                      (16, .) f32 each, for the binary traversal kernel
                      (ops/binary_traverse.py), under its gate
                      (`binary_traverse.supports`), else None
  pallas_shade        (tri_geo, tri_nrm, inst_a, inst_b, mat_tbl, kc_tbl,
                      lgt_tbl) for the fused shade kernel with its in-kernel
                      sampler (ops/fused_shade.py), under its gate
                      (`fused_shade.supports_shade`) when `pallas` is packed,
                      else None
  binary              the same three binary tables at any size, for `--bvh
                      sah|sbvh` (no wide tables are packed for those types:
                      every wave goes through the binary kernel); else None

The wide tables follow the JAX package's `_pack_wide` decision tree, with
its TPU budgets kept as routing constants (`VMEM_LIMIT`, `STACK_DEPTH`, the
prim-id limits; ROADMAP C11): merged tables for multi-instance scenes whose
merged world copy passes the pre-gate, resident when they fit the budget,
else paged; two-level tables for single-instance and heavily instanced
scenes, and in place of paged merged tables where they fit; no wide tables
where nothing fits (the binary tables then serve every wave).

`upload` moves those arrays to a torch device and marks the layout on the
tables; `from_jax_buffers` does the same for the JAX package's own host
pytree, so tests can run both packages on identical tables.

Scenes with textures, media or materials other than LIGHT and DIFFUSE raise
NotImplementedError naming the ROADMAP item that brings them, and so does
`--bvh qbvh` (the 4-wide device route).
"""

from __future__ import annotations

import numpy as np
import torch

from gpu_raytracer_tpu_torch.bvh import stream as stream_mod
from gpu_raytracer_tpu_torch.bvh import wide as wide_mod
from gpu_raytracer_tpu_torch.bvh.cache import build_blas_cached
from gpu_raytracer_tpu_torch.bvh.sah import SAHBuilder
from gpu_raytracer_tpu_torch.bvh.tlas import (
    build_tlas,
    instance_world_aabbs,
    tlas_region_size,
)
from gpu_raytracer_tpu_torch.config import BVHType
from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
from gpu_raytracer_tpu_torch.ops import fused_shade as fs
from gpu_raytracer_tpu_torch.scene.scene import Scene
from gpu_raytracer_tpu_torch.scene.types import MaterialType, TriangleData

LUMA = np.array([0.2126, 0.7152, 0.0722], np.float32)
LEAF_SIZE = 4        # per-mesh BLAS leaf size (JAX ops/traverse.LEAF_SIZE)
MERGED_SAH_NODE = 10.0
# The JAX package's routing constants (gpu_raytracer_tpu/ops/buffers.py
# _pack_wide and _pack_wide_merged), kept under their JAX names so that both
# packages pick the same tables for a scene and tests can patch both. The
# byte and stack limits are TPU budgets (ROADMAP C11); retuning them for the
# H100 is perf work, decided by measurement.
VMEM_LIMIT = 100 * 1024 * 1024  # pallas_wide.VMEM_LIMIT; x2: the pre-gates
VMEM_MARGIN = 8 * 1024 * 1024   # pallas_wide.supports: ray state
STACK_DEPTH = 160               # pallas_wide.STACK_DEPTH
MAX_INSTANCES = 1 << 9          # _pack_wide_merged: prim-map instance bits
MAX_PRIMS = 1 << 22             # _pack_wide_merged: prim-map triangle bits
MAX_STREAM_PRIMS = 1 << 24      # _pack_wide_merged: f32-exact prim ids
MERGED, TWO_LEVEL = "merged", "two_level"

# Host-pytree paths the main path reads; parity tests compare each of them.
MAIN_PATH_KEYS = (
    ("nodes", "root_min"), ("nodes", "root_max"),
    ("tris", "shade_rows"), ("instances", "rows"), ("instances", "prev_rows"),
    ("materials", "rows"),
    ("lights", "tri"), ("lights", "inst"), ("lights", "cdf"),
    ("lights", "total_weight"), ("sky",), ("sky_scale",),
    ("wide", 0), ("wide", 1), ("wide_prim_map",),
    ("shade_gather", 0), ("shade_gather", 1), ("shade_gather", 2),
    *(("pallas", i) for i in range(3)),
    *(("pallas_shade", i) for i in range(7)),
)


def get_path(tree, path):
    """The value at `path`, or None where the path passes through None."""
    for k in path:
        if tree is None:
            return None
        tree = tree[k]
    return tree


def check_supported(scene: Scene) -> None:
    if scene.textures:
        raise NotImplementedError("textured scenes: texture pool and taps are "
                                  "not ported yet (ROADMAP queue A: textures)")
    if scene.mediums:
        raise NotImplementedError("homogeneous media are not ported yet "
                                  "(ROADMAP queue A: the rest of render_wave "
                                  "(homogeneous media))")
    cfg = scene.config
    if cfg is not None and cfg.bvh_type == BVHType.BVH4:
        raise NotImplementedError(
            f"--bvh {cfg.bvh_type.value}: the 4-wide device route is not "
            f"ported; the port traverses 8-wide tables (cwbvh) and binary "
            f"tables (sah, sbvh)")
    if not scene.instances:
        raise ValueError("scene has no instances")


def pack_materials(scene: Scene) -> dict:
    """Materials as SoA plus the (M, 24) shading rows (JAX pack_materials)."""
    M = len(scene.materials)
    out = {
        "type": np.zeros(M, np.int32),
        "emission": np.zeros((M, 3), np.float32),
        "diffuse": np.zeros((M, 3), np.float32),
        "roughness": np.zeros(M, np.float32),
        "ior": np.zeros(M, np.float32),
        "eta": np.zeros((M, 3), np.float32),
        "k": np.zeros((M, 3), np.float32),
        "medium": np.full(M, -1, np.int32),
        "texture": np.full(M, -1, np.int32),
    }
    for i, m in enumerate(scene.materials):
        out["type"][i] = int(m.type)
        out["emission"][i] = m.emission
        out["diffuse"][i] = m.diffuse
        out["roughness"][i] = m.linear_roughness
        out["ior"][i] = m.index_of_refraction
        out["eta"][i] = m.eta
        out["k"][i] = m.k
        out["medium"][i] = m.medium_id
        out["texture"][i] = m.texture_id
    out["rows"] = np.concatenate(
        [out["type"][:, None].astype(np.float32), out["emission"],
         out["diffuse"], out["roughness"][:, None], out["ior"][:, None],
         out["eta"], out["k"], out["texture"][:, None].astype(np.float32),
         out["medium"][:, None].astype(np.float32),
         np.zeros((M, 7), np.float32)], axis=-1)
    return out


def uses_wide_tables(scene: Scene) -> bool:
    """Whether `--bvh` asks for the 8-wide device tables (the default); sah
    and sbvh keep the binary tables (JAX _pack_wide returns None for them)."""
    cfg = scene.config
    return cfg is None or cfg.bvh_type == BVHType.BVH8


def _aggregate_blas(scene: Scene, sah_cost_node, sah_cost_leaf, force_rebuild):
    """Build every unique per-mesh BVH (disk-cached; the SBVH builder for
    `--bvh sbvh`) and aggregate the triangles in leaf order and the BLAS
    nodes behind the TLAS region of the unified node arrays (JAX
    _aggregate_blas). Returns a dict of per-mesh offsets, the BLAS node
    arrays and the aggregated TriangleData."""
    cfg = scene.config
    builder = "sbvh" if (cfg and cfg.bvh_type == BVHType.SBVH) else "sah"
    geo = {"tri_base": [], "tri_count": [], "canon_slots": [], "blas_root": []}
    blas = {"min": [], "max": [], "left": [], "count": []}
    tri_parts = []
    tri_base = 0
    node_base = tlas_region_size(len(scene.instances))
    for md in scene.mesh_datas:
        bvh = md.bvh
        if bvh is None:
            bvh = build_blas_cached(
                md.triangles, sah_cost_node, sah_cost_leaf, LEAF_SIZE,
                force_rebuild, builder=builder,
                sbvh_alpha=cfg.sbvh_alpha if cfg else 1e-4,
                optimize_tree=bool(cfg and cfg.enable_bvh_optimization),
                optimize_max_batches=cfg.bvh_optimizer_max_num_batches if cfg else 1000,
                optimize_max_time_ms=cfg.bvh_optimizer_max_time_ms if cfg else 60_000)
            md.bvh = bvh
        geo["blas_root"].append(node_base)
        geo["tri_base"].append(tri_base)
        geo["tri_count"].append(bvh.num_prims)
        is_leaf = bvh.node_count > 0
        blas["min"].append(bvh.node_min)
        blas["max"].append(bvh.node_max)
        blas["left"].append(np.where(is_leaf, bvh.node_left + tri_base,
                                     bvh.node_left + node_base).astype(np.int32))
        blas["count"].append(bvh.node_count.astype(np.int32))
        node_base += bvh.num_nodes
        # One canonical leaf slot per original triangle (split builders may
        # duplicate triangles in leaf order; the light CDF counts each once).
        order = np.argsort(bvh.indices, kind="stable")
        sorted_ids = bvh.indices[order]
        first = np.ones(len(order), bool)
        first[1:] = sorted_ids[1:] != sorted_ids[:-1]
        geo["canon_slots"].append(order[first].astype(np.int32))
        tri_parts.append(md.triangles.select(bvh.indices))
        tri_base += bvh.num_prims
    tris = TriangleData.concatenate(tri_parts)
    pos = tris.positions
    geo["obj_e1"] = pos[:, 1] - pos[:, 0]
    geo["obj_e2"] = pos[:, 2] - pos[:, 0]
    geo["blas"] = {k: np.concatenate(v, axis=0) for k, v in blas.items()}
    return geo, tris


def _binary_nodes(tlas: tuple, blas: dict) -> dict:
    """Unified [TLAS region; BLAS] node arrays as the binary kernel reads
    them (JAX _pack_nodes): (12, N) child AABBs of interior nodes (leaf and
    instance-leaf rows carry empty boxes), left, count."""
    node_min = np.concatenate([tlas[0], blas["min"]], axis=0)
    node_max = np.concatenate([tlas[1], blas["max"]], axis=0)
    node_left = np.concatenate([tlas[2], blas["left"]], axis=0)
    node_count = np.concatenate([tlas[3], blas["count"]], axis=0)
    n = node_min.shape[0]
    child_aabb = np.full((n, 12), np.inf, np.float32)
    child_aabb[:, 3:6] = -np.inf
    child_aabb[:, 9:12] = -np.inf
    interior = node_count == 0
    left = np.where(interior, node_left, 0)
    child_aabb[interior, 0:3] = node_min[left[interior]]
    child_aabb[interior, 3:6] = node_max[left[interior]]
    child_aabb[interior, 6:9] = node_min[left[interior] + 1]
    child_aabb[interior, 9:12] = node_max[left[interior] + 1]
    return {"child_aabb_T": child_aabb.T.copy(),
            "left": node_left.astype(np.int32),
            "count": node_count.astype(np.int32)}


def _pack_instances(scene: Scene, geo: dict) -> dict:
    """{"rows": (I, 32) instance rows [fwd 12 | inv 12 | material id | tex
    id | tex lod | medium id | tex max mip | tex base off (int32 bits) | tex
    w0 | h0] for an untextured scene, "prev_rows": (I, 12) the previous
    frame's forward transforms, the component-major (12, I) "fwd_T" and
    "inv_T", "material_id" and "blas_root"} (JAX _pack_instances)."""
    I = len(scene.instances)
    transform = np.tile(np.eye(3, 4, dtype=np.float32), (I, 1, 1))
    transform_inv = np.tile(np.eye(3, 4, dtype=np.float32), (I, 1, 1))
    transform_prev = np.tile(np.eye(3, 4, dtype=np.float32), (I, 1, 1))
    material_id = np.zeros(I, np.int32)
    blas_root = np.zeros(I, np.int32)
    tex_id = np.full(I, -1.0, np.float32)
    medium_id = np.full(I, -1.0, np.float32)
    for i, inst in enumerate(scene.instances):
        transform[i] = inst.transform
        transform_inv[i] = inst.transform_inv
        transform_prev[i] = inst.transform_prev
        material_id[i] = inst.material_id
        blas_root[i] = geo["blas_root"][inst.mesh_data_id]
        m = scene.materials[inst.material_id]
        tex_id[i] = m.texture_id
        medium_id[i] = m.medium_id
    rows = np.concatenate(
        [transform.reshape(I, 12), transform_inv.reshape(I, 12),
         material_id[:, None].astype(np.float32), tex_id[:, None],
         np.zeros((I, 1), np.float32), medium_id[:, None],
         np.zeros((I, 1), np.float32),
         np.zeros((I, 1), np.int32).view(np.float32),
         np.ones((I, 1), np.float32), np.ones((I, 1), np.float32)], axis=-1)
    return {"rows": rows, "prev_rows": transform_prev.reshape(I, 12).copy(),
            "fwd_T": transform.reshape(I, 12).T.copy(),
            "inv_T": transform_inv.reshape(I, 12).T.copy(),
            "material_id": material_id, "blas_root": blas_root}


def _build_lights(scene: Scene, geo: dict) -> dict:
    """World-space power CDF over (instance, triangle) pairs (JAX
    _build_lights)."""
    light_tris, light_insts, weights = [], [], []
    for i, inst in enumerate(scene.instances):
        mat = scene.materials[inst.material_id]
        if not mat.is_light():
            continue
        base = geo["tri_base"][inst.mesh_data_id]
        slots = base + geo["canon_slots"][inst.mesh_data_id]
        e1 = geo["obj_e1"][slots]
        e2 = geo["obj_e2"][slots]
        lin = inst.transform[:, :3]
        area = 0.5 * np.linalg.norm(np.cross(e1 @ lin.T, e2 @ lin.T), axis=-1)
        lum = float(mat.emission @ LUMA)
        light_tris.append(slots.astype(np.int32))
        light_insts.append(np.full(len(slots), i, np.int32))
        weights.append(area * lum)
    if not light_tris:
        return {"tri": np.zeros(1, np.int32), "inst": np.zeros(1, np.int32),
                "cdf": np.ones(1, np.float32), "total_weight": np.float32(0.0)}
    weights = np.concatenate(weights)
    total = float(weights.sum())
    cdf = np.cumsum(weights) / max(total, 1e-20)
    cdf[-1] = 1.0
    return {"tri": np.concatenate(light_tris),
            "inst": np.concatenate(light_insts),
            "cdf": cdf.astype(np.float32),
            "total_weight": np.float32(total)}


def wide_layout(num_instances: int, num_prims: int,
                shared_bytes: int = 0) -> str:
    """MERGED or TWO_LEVEL: the layout the JAX package's `_pack_wide` packs
    first for a scene of these counts. `shared_bytes` is the estimated size
    of the two-level tables (bvh/wide.estimate_table_bytes): past
    2 * VMEM_LIMIT only merged tables are tried; else a multi-instance scene
    under the merged pre-gate tries merged tables first. Merged tables may
    come out streamed or not at all; `_pack_wide` then falls back as the JAX
    package does."""
    if shared_bytes > 2 * VMEM_LIMIT:
        return MERGED
    est_merged = (2 * (num_prims // 6) + 2) * wide_mod.ROW * 4
    if num_instances > 1 and est_merged <= 2 * VMEM_LIMIT:
        return MERGED
    return TWO_LEVEL


def _fits_wide_budget(num_nodes: int, num_rows: int) -> bool:
    """JAX pallas_wide.supports: packed tables within VMEM_LIMIT less the
    ray-state margin."""
    return (num_nodes + num_rows) * wide_mod.ROW * 4 <= VMEM_LIMIT - VMEM_MARGIN


def _pack_wide(scene: Scene, geo: dict, tri_geo: np.ndarray):
    """Wide tables as the JAX package's `_pack_wide` picks them: {"tables":
    (nodes, rows), "prim_map"} (merged or two-level), {"stream",
    "stream_prim"} (paged merged tables), or None (no wide tables fit: the
    binary tables serve every wave). A multi-instance scene whose merged
    tables would stream takes two-level tables when they fit."""
    I = len(scene.instances)
    P = int(sum(geo["tri_count"][inst.mesh_data_id] for inst in scene.instances))
    shared = wide_mod.estimate_table_bytes(
        sum(md.bvh.num_nodes for md in scene.mesh_datas), tri_geo.shape[0], I)
    if shared > 2 * VMEM_LIMIT:
        return _pack_wide_merged(scene, geo, tri_geo)
    stream_fallback = None
    if wide_layout(I, P, shared) == MERGED:
        merged = _pack_wide_merged(scene, geo, tri_geo)
        if merged is not None:
            if "stream" not in merged:
                return merged
            stream_fallback = merged
    two_level = _pack_wide_two_level(scene, geo, tri_geo)
    nodes, rows = two_level["tables"]
    if (not _fits_wide_budget(nodes.shape[0], rows.shape[0])
            or two_level["max_stack"] > STACK_DEPTH):
        return stream_fallback
    return two_level


def _pack_wide_two_level(scene: Scene, geo: dict, tri_geo: np.ndarray) -> dict:
    """TLAS over instance rows + one object-space BLAS per mesh (JAX
    _pack_wide, two-level branch)."""
    wides = [wide_mod.collapse_wide(md.bvh, wide_mod.WIDTH)
             for md in scene.mesh_datas]
    wmin, wmax = instance_world_aabbs(scene)
    tlas_bvh2 = SAHBuilder(4.0, 1.0, max_leaf_size=1).build(wmin, wmax)
    inv = np.stack([inst.transform_inv.reshape(12) for inst in scene.instances])
    mesh_of_inst = np.asarray([inst.mesh_data_id for inst in scene.instances],
                              np.int32)
    packed = wide_mod.pack_wide_scene(
        wides, geo["tri_base"], tlas_bvh2,
        {"inv": inv, "mesh_of_inst": mesh_of_inst}, tri_geo)
    return {"tables": (packed["nodes"], packed["rows"]), "prim_map": None,
            "max_stack": packed["max_stack"]}


def _pack_wide_merged(scene: Scene, geo: dict, tri_geo: np.ndarray):
    """ONE world-space 8-wide BVH over the whole static scene (JAX
    _pack_wide_merged). Leaf rows carry prim ids p. Returns resident merged
    tables with prim_map[p] = inst << 22 | leaf-order triangle id when they
    fit the budget and the prim map; else paged tables (bvh/stream.py) with
    the split (P,) decode arrays `stream_prim` = (prim_inst, prim_tri); else
    None."""
    I = len(scene.instances)
    counts = [geo["tri_count"][inst.mesh_data_id] for inst in scene.instances]
    P = int(sum(counts))
    fits_prim_map = I < MAX_INSTANCES and P < MAX_PRIMS
    if P >= MAX_STREAM_PRIMS:
        return None
    world = np.empty((P, 3, 3), np.float32)
    prim_inst = np.empty(P, np.int32)
    prim_tri = np.empty(P, np.int32)
    base_p = 0
    for i, inst in enumerate(scene.instances):
        mi = inst.mesh_data_id
        b = geo["tri_base"][mi]
        c = geo["tri_count"][mi]
        g = tri_geo[b:b + c]
        m = np.asarray(inst.transform, np.float32)
        p0 = g[:, 0:3] @ m[:, :3].T + m[:, 3]
        p1 = (g[:, 0:3] + g[:, 3:6]) @ m[:, :3].T + m[:, 3]
        p2 = (g[:, 0:3] + g[:, 6:9]) @ m[:, :3].T + m[:, 3]
        world[base_p:base_p + c] = np.stack([p0, p1, p2], axis=1)
        prim_inst[base_p:base_p + c] = i
        prim_tri[base_p:base_p + c] = np.arange(b, b + c, dtype=np.int32)
        base_p += c
    bvh = build_blas_cached(TriangleData(world), sah_cost_node=MERGED_SAH_NODE,
                            max_leaf_size=wide_mod.LEAF_CAP)
    wideb = wide_mod.collapse_wide(bvh, wide_mod.WIDTH)
    world_geo = np.concatenate(
        [world[:, 0], world[:, 1] - world[:, 0], world[:, 2] - world[:, 0]],
        axis=-1).astype(np.float32)
    leaf_geo = world_geo[bvh.indices]
    packed = (wide_mod.pack_wide_merged(wideb, bvh.indices, leaf_geo)
              if fits_prim_map else None)
    if (packed is not None
            and _fits_wide_budget(packed["nodes"].shape[0], packed["rows"].shape[0])
            and packed["max_stack"] <= STACK_DEPTH
            and packed["entry_stack"] <= STACK_DEPTH):
        return {"tables": (packed["nodes"], packed["rows"]),
                "prim_map": (prim_inst << 22) | prim_tri}
    paged = stream_mod.pack_wide_stream(wideb, bvh.indices, leaf_geo,
                                        page_rows=stream_mod.PAGE_ROWS)
    if (paged is None or paged["max_stack"] > STACK_DEPTH
            or paged["resident"].shape[0] * wide_mod.ROW * 4 > VMEM_LIMIT):
        return None
    return {"stream": {k: v for k, v in paged.items() if isinstance(v, np.ndarray)},
            "stream_prim": (prim_inst, prim_tri)}


def _mat_kc_tables(materials: dict):
    """(16, M) material table + (32, M) Kulla-Conty curves (JAX
    _mat_kc_tables). Only LIGHT/DIFFUSE materials are packable so far: their
    curve columns are zero and need no LUT bake."""
    mtype = np.asarray(materials["type"])
    needs_bake = sorted(set(int(t) for t in mtype)
                        - {int(MaterialType.LIGHT), int(MaterialType.DIFFUSE)})
    if needs_bake:
        names = ", ".join(MaterialType(t).name for t in needs_bake)
        raise NotImplementedError(
            f"{names} materials need the Kulla-Conty LUT bake, not ported yet "
            f"(ROADMAP queue A: mixed-BSDF bounce 0 with the LUT bake)")
    m = int(mtype.shape[0])
    mat_tbl = np.zeros((16, m), np.float32)
    mat_tbl[0] = mtype.astype(np.float32)
    mat_tbl[1:4] = materials["emission"].T
    mat_tbl[4:7] = materials["diffuse"].T
    mat_tbl[7] = materials["roughness"]
    mat_tbl[8] = materials["ior"]
    mat_tbl[9:12] = materials["eta"].T
    mat_tbl[12:15] = materials["k"].T
    return mat_tbl, np.zeros((32, m), np.float32)


def _pack_shade_gather(materials: dict, lights: dict, shade_rows: np.ndarray,
                       inst_rows: np.ndarray):
    """(mat_tbl, kc_tbl, lgt_tbl) with light geometry pre-transformed to
    world space (JAX _pack_shade_gather)."""
    mat_tbl, kc_tbl = _mat_kc_tables(materials)
    lt = lights["tri"]
    li = lights["inst"]
    p0 = shade_rows[lt, 0:3]
    e1 = shade_rows[lt, 3:6]
    e2 = shade_rows[lt, 6:9]
    f = inst_rows[:, 0:12].T[:, li]  # (12, L)

    def apt(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        return np.stack([f[0] * x + f[1] * y + f[2] * z + f[3],
                         f[4] * x + f[5] * y + f[6] * z + f[7],
                         f[8] * x + f[9] * y + f[10] * z + f[11]])

    def adr(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        return np.stack([f[0] * x + f[1] * y + f[2] * z,
                         f[4] * x + f[5] * y + f[6] * z,
                         f[8] * x + f[9] * y + f[10] * z])

    mat_id = inst_rows[li, 24].astype(np.int32)
    em = materials["emission"][mat_id]
    lgt_tbl = np.zeros((16, len(lt)), np.float32)
    lgt_tbl[0] = lights["cdf"]
    lgt_tbl[1:4] = apt(p0)
    lgt_tbl[4:7] = adr(e1)
    lgt_tbl[7:10] = adr(e2)
    lgt_tbl[10:13] = em.T
    return (mat_tbl, kc_tbl, lgt_tbl)


def _pack_pallas(nodes: dict, tris: dict, instances: dict):
    """The binary traversal tables under the kernel's gate, else None (JAX
    _pack_pallas)."""
    n = nodes["left"].shape[0]
    t = tris["geo_T"].shape[1]
    i = instances["blas_root"].shape[0]
    if not bt.supports(n, t, i):
        return None
    return bt.pack_tables(nodes, tris, instances)


def _pack_pallas_shade(pallas, materials: dict, tris: dict, instances: dict,
                       lights: dict, sky: np.ndarray):
    """The fused shade kernel's tables, or None outside its gate or without
    binary tables (JAX _pack_pallas_shade). Textures and media never reach
    here (check_supported)."""
    if pallas is None:
        return None
    t = tris["geo_T"].shape[1]
    i = instances["blas_root"].shape[0]
    l = lights["tri"].shape[0]
    if not fs.supports_shade(materials["type"], t, i, l, False, False, sky.shape):
        return None
    tri_nrm = np.zeros((16, t), np.float32)
    tri_nrm[0:9] = tris["n_T"]
    inst_a = np.zeros((16, i), np.float32)
    inst_a[0:12] = instances["fwd_T"]
    inst_a[12] = instances["material_id"].astype(np.float32)
    inst_b = np.zeros((16, i), np.float32)
    inst_b[0:12] = instances["inv_T"]
    mat_tbl, kc_tbl = _mat_kc_tables(materials)
    lgt_tbl = np.zeros((16, l), np.float32)
    lgt_tbl[0] = lights["cdf"]
    lgt_tbl[1] = lights["tri"].astype(np.float32)
    lgt_tbl[2] = lights["inst"].astype(np.float32)
    return (pallas[2], tri_nrm, inst_a, inst_b, mat_tbl, kc_tbl, lgt_tbl)


def pack_scene(scene: Scene, sah_cost_node: float = 4.0,
               sah_cost_leaf: float = 1.0, force_rebuild: bool = False) -> dict:
    """The main path's host tables (numpy), laid out like the JAX package's
    host pytree."""
    scene.finalize()
    scene.check_materials()
    check_supported(scene)
    geo, tris_leaf = _aggregate_blas(scene, sah_cost_node, sah_cost_leaf,
                                     force_rebuild)
    wmin, wmax = instance_world_aabbs(scene)
    tlas = build_tlas(wmin, wmax, sah_cost_node, sah_cost_leaf)

    pos = tris_leaf.positions
    packed_tris = np.concatenate(
        [pos[:, 0], pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]], axis=-1)
    T = len(packed_tris)
    normals = tris_leaf.normals
    shade_rows = np.concatenate(
        [packed_tris, normals.reshape(T, 9),
         tris_leaf.uvs.reshape(T, 6), np.zeros((T, 8), np.float32)],
        axis=-1).astype(np.float32)
    tris = {"shade_rows": shade_rows,
            "geo_T": packed_tris.astype(np.float32).T.copy(),
            "n_T": np.concatenate([normals[:, 0], normals[:, 1], normals[:, 2]],
                                  axis=-1).astype(np.float32).T.copy()}
    nodes = {"root_min": tlas[0][0].copy(), "root_max": tlas[1][0].copy(),
             **_binary_nodes(tlas, geo["blas"])}
    materials = pack_materials(scene)
    lights = _build_lights(scene, geo)
    instances = _pack_instances(scene, geo)
    inst_rows = instances["rows"]
    wide = (_pack_wide(scene, geo, packed_tris.astype(np.float32))
            if uses_wide_tables(scene) else None) or {}
    sky = np.asarray(scene.sky.data if scene.sky is not None
                     else np.zeros((1, 1, 3), np.float32), np.float32)
    pallas = _pack_pallas(nodes, tris, instances)
    return {
        "nodes": nodes,
        "tris": tris,
        "instances": instances,
        "materials": materials,
        "lights": lights,
        "sky": sky,
        "sky_scale": np.float32(scene.sky.scale if scene.sky else 1.0),
        "wide": wide.get("tables"),
        "wide_prim_map": wide.get("prim_map"),
        "wide_stream": wide.get("stream"),
        "stream_prim": wide.get("stream_prim"),
        "shade_gather": _pack_shade_gather(materials, lights, shade_rows,
                                           inst_rows),
        "pallas": pallas,
        "pallas_shade": _pack_pallas_shade(pallas, materials, tris, instances,
                                           lights, sky),
    }


def _max_stack_of(nodes: np.ndarray, rows: np.ndarray) -> int:
    """Worst-case traversal stack of merged or two-level tables, re-derived
    from the tables as bvh/wide.max_stack and pack_wide_scene count it: an
    instance row continues into RESTORE + its BLAS subtree. Child and BLAS
    root ids exceed their parents' (TLAS nodes come first), so one reverse
    sweep is a post-order."""
    refs = nodes[:, 48:56].astype(np.int64)
    blas_root = np.where(rows[:, 0] < 0, rows[:, 14], -1).astype(np.int64)
    g = np.zeros(nodes.shape[0], np.int64)
    for i in range(nodes.shape[0] - 1, -1, -1):
        child = []
        for r in refs[i]:
            if r >= 0:
                child.append(int(g[r]))
            elif r <= -2:
                root = blas_root[-r - 2]
                child.append(max(2, 1 + int(g[root])) if root >= 0 else 0)
        m = len(child)
        g[i] = max(m, (m - 1) + max(child)) if m else 0
    return 1 + int(g[0]) if nodes.shape[0] else 1


def _unified_stack(tables: np.ndarray, roots: np.ndarray) -> int:
    """Worst-case traversal stack over unified-index tables (bvh/stream.py):
    `tables` (G, n, 128), one traversal from each root (g, row). Node rows
    are those reachable from a root through refs >= 0; a leaf ref (-(row+2),
    above the portal refs) is pushed, a portal is recorded and not pushed.
    Child rows follow their parent's, so one reverse sweep over the rows is
    a post-order (as in _max_stack_of)."""
    G, n = tables.shape[:2]
    refs = tables[:, :, 48:56].astype(np.int64)
    pages = np.arange(G)[:, None]
    is_node = np.zeros((G, n), bool)
    is_node[roots[:, 0], roots[:, 1]] = True
    for i in range(n):
        ri = np.where(is_node[:, i, None] & (refs[:, i] >= 0), refs[:, i], -1)
        gi, ci = np.nonzero(ri >= 0)
        is_node[gi, ri[gi, ci]] = True
    g = np.zeros((G, n), np.int64)
    for i in range(n - 1, -1, -1):
        r = refs[:, i]
        node = r >= 0
        pushed = node | ((r <= -2) & (r > -(2 + stream_mod.PORTAL_BASE)))
        child = np.where(node, g[pages, np.clip(r, 0, n - 1)], 0)
        m = pushed.sum(axis=1)
        deepest = np.where(pushed, child, 0).max(axis=1)
        g[:, i] = np.where(is_node[:, i] & (m > 0),
                           np.maximum(m, m - 1 + deepest), 0)
    return 1 + int(g[roots[:, 0], roots[:, 1]].max(initial=0))


def stream_page_stack(stream: dict) -> int:
    """Worst-case stack of one page traversal, re-derived from the paged
    tables: the deepest walk from a portal's root row."""
    roots = np.stack([stream["portal_page"], stream["portal_root"]], axis=1)
    return _unified_stack(stream["pages"], roots.astype(np.int64))


def stream_max_stack(stream: dict) -> int:
    """Worst-case stack of the streamed traversal, re-derived from the paged
    tables: the resident pass from row 0 (portals recorded, not pushed) and
    each page traversal from its portal's root row."""
    resident = stream["resident"][None]
    return max(_unified_stack(resident, np.zeros((1, 2), np.int64)),
               stream_page_stack(stream))


def upload(host: dict, sampler: dict, device) -> dict:
    """Host tables (numpy) + sampler tables -> the device dict render_wave
    reads. `wide` holds merged or two-level wide tables, `stream` (with the
    decode arrays `stream_prim`) paged tables; at most one of them is set.
    `binary` holds the binary traversal tables: `pallas` under the
    small-scene gate, else, where there are neither wide nor paged tables
    (sah/sbvh, or a scene past every wide budget), the same tables packed
    here at any size. `fused_shade` holds the fused shade kernel's tables;
    each is None where there are none."""
    from gpu_raytracer_tpu_torch.ops.stream_traverse import make_stream_tables
    from gpu_raytracer_tpu_torch.ops.wide_traverse import make_tables

    dev = torch.device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    lights = host["lights"]
    mat_tbl, kc_tbl, lgt_tbl = host["shade_gather"]
    wide = None
    if host["wide"] is not None:
        nodes, rows = host["wide"]
        wide = make_tables(t(nodes), t(rows), _max_stack_of(nodes, rows),
                           two_level=host["wide_prim_map"] is None)
    stream = stream_prim = None
    if host.get("wide_stream") is not None:
        st = host["wide_stream"]
        stream = make_stream_tables(
            t(st["resident"]), t(st["pages"]), t(st["portal_page"], torch.int32),
            t(st["portal_root"], torch.int32), stream_max_stack(st), stream_page_stack(st))
        stream_prim = tuple(t(x, torch.int64) for x in host["stream_prim"])
    binary = host["pallas"]
    if binary is None and host["wide"] is None and stream is None:
        binary = bt.pack_tables(host["nodes"], host["tris"], host["instances"])
    return {
        "root_min": t(host["nodes"]["root_min"]),
        "root_max": t(host["nodes"]["root_max"]),
        "shade_rows": t(host["tris"]["shade_rows"]),
        "inst_rows": t(host["instances"]["rows"]),
        "inst_prev_rows": t(host["instances"]["prev_rows"]),
        "mat_rows": t(host["materials"]["rows"]),
        "mat_types": tuple(sorted(set(int(x) for x in host["materials"]["type"]))),
        "light_tri": t(lights["tri"], torch.int64),
        "light_inst": t(lights["inst"], torch.int64),
        "light_cdf": t(lights["cdf"]),
        "total_weight": float(lights["total_weight"]),
        "sky": t(host["sky"]),
        "sky_scale": float(host["sky_scale"]),
        "wide": wide,
        "prim_map": (None if host["wide_prim_map"] is None
                     else t(host["wide_prim_map"], torch.int64)),
        "stream": stream,
        "stream_prim": stream_prim,
        "shade_gather": (t(mat_tbl), t(kc_tbl), t(lgt_tbl)),
        "binary": (None if binary is None
                   else bt.make_tables(*(t(x) for x in binary))),
        "fused_shade": (None if host["pallas_shade"] is None
                        else fs.make_tables(tuple(t(x) for x in host["pallas_shade"]))),
        "sampler": {k: v.to(dev) for k, v in sampler.items()},
        # Host copies for the fused shade's per-bounce params (make_params):
        # the flat PMJ tables and the constant sky times its scale.
        "seq_host": (sampler["seq_x"].cpu().numpy(), sampler["seq_y"].cpu().numpy()),
        "sky_rgb": np.asarray(host["sky"], np.float32).reshape(-1, 3)[0]
        * np.float32(host["sky_scale"]),
    }


def build_scene_buffers(scene: Scene, device, sah_cost_node: float = 4.0,
                        sah_cost_leaf: float = 1.0,
                        force_rebuild: bool = False) -> dict:
    from gpu_raytracer_tpu_torch.ops.pmj import load_tables

    host = pack_scene(scene, sah_cost_node, sah_cost_leaf, force_rebuild)
    return upload(host, load_tables("cpu"), device)


def from_jax_buffers(host: dict, sampler: dict, device) -> dict:
    """The JAX package's host pytree (`scene._host_buffers`) and its sampler
    tables (`buffers["sampler"]`) -> the port's device dict, so both packages
    run on identical tables. The JAX tables must hold merged or two-level
    wide tables (`wide_prim_map` None for two-level), paged tables
    (`wide_stream`) or binary tables (`pallas`)."""
    if all(host.get(k) is None for k in ("wide", "wide_stream", "pallas")):
        raise ValueError("the JAX host tables hold no wide, paged or binary tables")

    def opt(x):
        return None if x is None else tuple(np.asarray(v) for v in x)

    picked = {
        "nodes": {k: np.asarray(host["nodes"][k]) for k in ("root_min", "root_max")},
        "tris": {"shade_rows": np.asarray(host["tris"]["shade_rows"])},
        "instances": {k: np.asarray(host["instances"][k])
                      for k in ("rows", "prev_rows")},
        "materials": {k: np.asarray(v) for k, v in host["materials"].items()},
        "lights": {k: np.asarray(v) for k, v in host["lights"].items()},
        "sky": np.asarray(host["sky"]),
        "sky_scale": np.asarray(host["sky_scale"]),
        "wide": opt(host["wide"]),
        "wide_prim_map": (None if host["wide_prim_map"] is None
                          else np.asarray(host["wide_prim_map"])),
        "wide_stream": (None if host.get("wide_stream") is None
                        else {k: np.asarray(v) for k, v in host["wide_stream"].items()}),
        "stream_prim": opt(host.get("stream_prim")),
        "shade_gather": opt(host["shade_gather"]),
        "pallas": opt(host.get("pallas")),
        "pallas_shade": opt(host.get("pallas_shade")),
    }
    tables = {k: torch.as_tensor(np.array(sampler[k])) for k in
              ("seq_x", "seq_y", "noise_all", "noise_x_rows", "noise_y_rows")}
    return upload(picked, tables, device)
