"""Two-level binary-BVH closest-hit and any-hit traversal for small scenes.

Counterpart of the JAX package's `ops/pallas_traverse.py` (`_trace_pallas`,
`trace_closest_pallas` / `trace_any_pallas`, TPU kernel `_kernel`). On a CUDA
tensor `trace_closest` / `trace_any` launch the hand-written kernel in
`csrc/binary_traverse.cu` (one load round a node, the next item in a
register, a 48-entry stack per thread; the closest hit one thread a ray,
the any hit on persistent warps that fetch rays from a counter) and raise
if they cannot; on a CPU tensor they run the plain PyTorch version,
`trace_plain`, which follows the TPU kernel's per-lane order step by step:

  * the root (node 0) pops first, with no pre-test;
  * a triangle leaf tests its `count` (<= LEAF_SIZE) triangles in order, each
    taken when it is nearer than the best hit so far;
  * an interior node slab-tests both children and pushes the far child
    before the near one (near: the smaller clamped entry t, left on a tie);
  * an instance leaf moves the WORLD ray into the instance's object space
    (the inverse transform, applied unnormalised) and pushes RESTORE, then
    the BLAS root; popping RESTORE brings the world ray back;
  * a push past STACK_DEPTH entries is dropped (the subtree is lost, never
    corrupted);
  * any-hit stops at the first accepted hit.

Tables (`pack_tables`, the JAX layout, (16, .) f32 column-major):

  node_mat (16, N): [0:12] child AABBs (lmin, lmax, rmin, rmax), [12] left,
                    [13] count (+k triangle leaf / 0 interior / -1 instance leaf)
  inst_mat (16, I): [0:12] inverse transform rows, [12] BLAS root node
  tri_mat  (16, T): [0:9] p0 | e1 | e2 (object space)

`make_tables` transposes them once, at upload, to 64-byte rows ((N, 16),
(I, 16), (T, 16)) that the kernel reads as four float4 loads; the plain
version reads the same rows. There is no SMEM budget on the card: the gate
`supports` only routes, so both packages pick the same route for a scene.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gpu_raytracer_tpu_torch.ops import _native

STACK_DEPTH = 48
LEAF_SIZE = 4
RESTORE = -1
DIV_EPS = 1e-12
RAY_EPS = 1e-4
# The JAX package's SMEM budget for the three tables (pallas_traverse
# MAX_TABLE_BYTES), kept as the small-scene route's gate.
MAX_TABLE_BYTES = 600_000

ROLES = ("binary_closest", "binary_any")
launches = {r: 0 for r in ROLES}
plain_calls = {r: 0 for r in ROLES}

# Float operations of the kernel per visit, counted from
# csrc/binary_traverse.cu: an interior node slab-tests two children (12
# sub/mul, 10 min/max, 1 clamp, 3 compares each, as wide_traverse counts a
# child) and orders them (1); a triangle test is 52 (Moller-Trumbore with
# its 8 compares); an instance leaf transforms the ray (33) and inverts the
# direction (9). `last_work` holds the visits of the latest plain call.
OPS_PER_NODE = 2 * 26 + 1
OPS_PER_TRI = 52
OPS_PER_INST = 42
last_work = {"nodes": 0, "triangles": 0, "instances": 0}
# What `kernel_info` returns (csrc/binary_traverse.cu bt_kernel_info).
INFO = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm", "sms")


class BinaryTables(NamedTuple):
    """Row-major binary tables (see `make_tables`)."""
    nodes: torch.Tensor  # (N, 16)
    insts: torch.Tensor  # (I, 16)
    tris: torch.Tensor   # (T, 16)


class Hit(NamedTuple):
    t: torch.Tensor     # (R,) f32, +inf on a miss
    tri: torch.Tensor   # (R,) i32 leaf-order triangle id, -1 on a miss
    inst: torch.Tensor  # (R,) i32 instance, -1 on a miss
    u: torch.Tensor     # (R,) f32 barycentrics, 0 on a miss
    v: torch.Tensor


def supports(num_nodes: int, num_tris: int, num_instances: int) -> bool:
    """The small-scene gate (JAX pallas_traverse.supports)."""
    return 64 * (num_nodes + num_tris + num_instances) <= MAX_TABLE_BYTES


def pack_tables(nodes: dict, tris: dict, instances: dict):
    """Host-side packing into the (16, .) column-major matrices (JAX
    pallas_traverse.pack_tables): nodes need child_aabb_T, left, count;
    tris geo_T; instances inv_T, blas_root."""
    n = np.asarray(nodes["left"]).shape[0]
    node_mat = np.zeros((16, n), np.float32)
    node_mat[0:12] = np.asarray(nodes["child_aabb_T"])
    node_mat[12] = np.asarray(nodes["left"], np.float32)
    node_mat[13] = np.asarray(nodes["count"], np.float32)
    i = np.asarray(instances["blas_root"]).shape[0]
    inst_mat = np.zeros((16, i), np.float32)
    inst_mat[0:12] = np.asarray(instances["inv_T"])
    inst_mat[12] = np.asarray(instances["blas_root"], np.float32)
    t = np.asarray(tris["geo_T"]).shape[1]
    tri_mat = np.zeros((16, t), np.float32)
    tri_mat[0:9] = np.asarray(tris["geo_T"])
    return node_mat, inst_mat, tri_mat


def make_tables(node_mat: torch.Tensor, inst_mat: torch.Tensor,
                tri_mat: torch.Tensor) -> BinaryTables:
    """(16, .) matrices -> contiguous 64-byte rows, checked."""
    for name, x in (("node_mat", node_mat), ("inst_mat", inst_mat),
                    ("tri_mat", tri_mat)):
        if x.dim() != 2 or x.shape[0] != 16 or x.shape[1] < 1:
            raise ValueError(f"{name} must be (16, n >= 1), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32")
    return BinaryTables(node_mat.t().contiguous(), inst_mat.t().contiguous(),
                        tri_mat.t().contiguous())


def _inv1(c: torch.Tensor) -> torch.Tensor:
    tiny = torch.where(c >= 0, DIV_EPS, -DIV_EPS).to(c.dtype)
    return 1.0 / torch.where(c.abs() < DIV_EPS, tiny, c)


def _affine(m: torch.Tensor, p: torch.Tensor, point: bool) -> torch.Tensor:
    """(K, 12) 3x4 rows applied to (K, 3) vectors in the kernel's term order
    (m0*x + m1*y + m2*z [+ m3])."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    out = []
    for r in range(3):
        c = m[:, 4 * r] * x + m[:, 4 * r + 1] * y + m[:, 4 * r + 2] * z
        out.append(c + m[:, 4 * r + 3] if point else c)
    return torch.stack(out, dim=1)


def _slab(box: torch.Tensor, o, inv):
    """Clamped entry t and the far t of (K, 6) boxes (min, max)."""
    t0 = (box[:, 0:3] - o) * inv
    t1 = (box[:, 3:6] - o) * inv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return tn, tf, tn.clamp(min=0.0)


def trace_plain(any_hit: bool, tables: BinaryTables, ray_o: torch.Tensor,
                ray_d: torch.Tensor, t_max: torch.Tensor):
    """Plain PyTorch version of the binary traversal kernel (any device):
    one stack pop per live lane per step, vectorised over the lanes."""
    plain_calls[ROLES[int(any_hit)]] += 1
    nodes, insts, tris = tables
    dev = ray_o.device
    R = ray_o.shape[0]
    T = tris.shape[0]
    wo, wd = ray_o.float(), ray_d.float()
    winv = _inv1(wd)
    o, d, inv = wo.clone(), wd.clone(), winv.clone()
    best_t = t_max.float().clone()
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    cur_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    stack = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    ptr = torch.ones(R, dtype=torch.int64, device=dev)  # the root pops first
    idx = torch.arange(R, device=dev)
    visits = torch.zeros(3, dtype=torch.int64, device=dev)  # nodes, tris, insts

    def push(ri, ok, ref):
        """Push `ref` on the stacks of rays ri[ok]; dropped when full."""
        p = ptr[ri]
        ok = ok & (p < STACK_DEPTH)
        stack[ri[ok], p[ok]] = ref[ok]
        ptr[ri] = p + ok.long()

    while idx.numel() > 0:
        p = ptr[idx] - 1
        ptr[idx] = p
        entry = stack[idx, p]

        rm = entry == RESTORE
        if bool(rm.any()):
            ri = idx[rm]
            o[ri], d[ri], inv[ri] = wo[ri], wd[ri], winv[ri]
            cur_inst[ri] = -1
        ni = idx[~rm]
        row = nodes[entry[~rm]]
        visits[0] += ni.numel()
        left = row[:, 12].to(torch.int64)
        count = row[:, 13].to(torch.int64)

        # ---- triangle leaves: up to LEAF_SIZE triangles, in order ----
        tm = count > 0
        if bool(tm.any()):
            li, lleft, lcount = ni[tm], left[tm], count[tm]
            visits[1] += lcount.sum()
            oo, dd = o[li], d[li]
            ox, oy, oz = oo[:, 0], oo[:, 1], oo[:, 2]
            dx, dy, dz = dd[:, 0], dd[:, 1], dd[:, 2]
            for j in range(LEAF_SIZE):
                ti = (lleft + j).clamp(0, T - 1)
                g = tris[ti]
                p0x, p0y, p0z = g[:, 0], g[:, 1], g[:, 2]
                e1x, e1y, e1z = g[:, 3], g[:, 4], g[:, 5]
                e2x, e2y, e2z = g[:, 6], g[:, 7], g[:, 8]
                hx = dy * e2z - dz * e2y
                hy = dz * e2x - dx * e2z
                hz = dx * e2y - dy * e2x
                a = e1x * hx + e1y * hy + e1z * hz
                f = 1.0 / torch.where(a.abs() < DIV_EPS, DIV_EPS, a)
                sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
                u = f * (sx * hx + sy * hy + sz * hz)
                qx = sy * e1z - sz * e1y
                qy = sz * e1x - sx * e1z
                qz = sx * e1y - sy * e1x
                v = f * (dx * qx + dy * qy + dz * qz)
                t = f * (e2x * qx + e2y * qy + e2z * qz)
                take = ((j < lcount) & (a.abs() >= DIV_EPS) & (u >= 0.0)
                        & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                        & (t > RAY_EPS) & (t < best_t[li]))
                hi = li[take]
                best_t[hi] = t[take]
                best_tri[hi] = ti[take].to(torch.int32)
                best_inst[hi] = cur_inst[hi]
                best_u[hi] = u[take]
                best_v[hi] = v[take]

        # ---- interior nodes: far child pushed first, near child on top ----
        im = count == 0
        if bool(im.any()):
            ii, il, irow = ni[im], left[im], row[im]
            oo, vv, bt = o[ii], inv[ii], best_t[ii]
            tn_l, tf_l, t_l = _slab(irow[:, 0:6], oo, vv)
            tn_r, tf_r, t_r = _slab(irow[:, 6:12], oo, vv)
            hit_l = (tn_l <= tf_l) & (tf_l > 0.0) & (t_l < bt)
            hit_r = (tn_r <= tf_r) & (tf_r > 0.0) & (t_r < bt)
            near_left = t_l <= t_r
            push(ii, torch.where(near_left, hit_r, hit_l),
                 torch.where(near_left, il + 1, il))
            push(ii, torch.where(near_left, hit_l, hit_r),
                 torch.where(near_left, il, il + 1))

        # ---- instance leaves: into object space, RESTORE then BLAS root ----
        em = count == -1
        if bool(em.any()):
            ei, inst = ni[em], left[em]
            visits[2] += ei.numel()
            m = insts[inst]
            o[ei] = _affine(m[:, :12], wo[ei], True)
            d[ei] = _affine(m[:, :12], wd[ei], False)
            inv[ei] = _inv1(d[ei])
            cur_inst[ei] = inst.to(torch.int32)
            yes = torch.ones_like(inst, dtype=torch.bool)
            push(ei, yes, torch.full_like(inst, RESTORE))
            push(ei, yes, m[:, 12].to(torch.int64))

        if any_hit:
            ptr[idx[best_tri[idx] >= 0]] = 0
        idx = idx[ptr[idx] > 0]

    last_work.update(zip(("nodes", "triangles", "instances"), visits.tolist()))
    if any_hit:
        return best_tri >= 0
    return Hit(torch.where(best_tri >= 0, best_t, torch.full_like(best_t, float("inf"))),
               best_tri, best_inst, best_u, best_v)


def _check(tables, ray_o, ray_d, t_max):
    if not isinstance(tables, BinaryTables):
        raise TypeError("pass tables built by make_tables()")
    R = ray_o.shape[0]
    if ray_o.shape != (R, 3) or ray_d.shape != (R, 3) or t_max.shape != (R,):
        raise ValueError("rays must be (R, 3), (R, 3), (R,)")
    for x in (ray_o, ray_d, t_max, *tables):
        if x.dtype != torch.float32:
            raise ValueError("traversal inputs must be float32")
        if x.device != ray_o.device:
            raise ValueError("traversal inputs must share one device")


def _launch(any_hit: bool, tables: BinaryTables, ray_o, ray_d, t_max):
    lib = _native.load()
    R = ray_o.shape[0]
    dev = ray_o.device
    ray_o, ray_d, t_max = (x.contiguous() for x in (ray_o, ray_d, t_max))
    t_out = tri_out = inst_out = u_out = v_out = occ = None
    if any_hit:
        occ = torch.empty(R, dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty(R, dtype=torch.float32, device=dev)
        tri_out = torch.empty(R, dtype=torch.int32, device=dev)
        inst_out = torch.empty(R, dtype=torch.int32, device=dev)
        u_out = torch.empty(R, dtype=torch.float32, device=dev)
        v_out = torch.empty(R, dtype=torch.float32, device=dev)

    # The persistent warps' ray counter (any hit), zeroed on the stream by
    # bt_trace.
    next_ray = torch.empty(1, dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else ctypes.c_void_p(x.data_ptr())

    stream = torch.cuda.current_stream(dev).cuda_stream
    role = ROLES[int(any_hit)]
    err = lib.bt_trace(int(any_hit), ptr(tables.nodes), ptr(tables.insts),
                       ptr(tables.tris), tables.tris.shape[0], ptr(ray_o),
                       ptr(ray_d), ptr(t_max), R, ptr(next_ray), ptr(t_out),
                       ptr(tri_out), ptr(inst_out), ptr(u_out), ptr(v_out), ptr(occ),
                       ctypes.c_void_p(stream))
    _native.check(err, f"binary_traverse.{role}")
    launches[role] += 1
    if any_hit:
        return occ
    return Hit(t_out, tri_out, inst_out, u_out, v_out)


def kernel_info(any_hit: bool) -> dict:
    """What the compiler and the occupancy API report for the role's kernel
    on the card (INFO: registers, stack frame and static shared bytes, the
    threads of a block, the blocks an SM holds, the SMs)."""
    lib = _native.load()
    out = (ctypes.c_int * len(INFO))()
    _native.check(lib.bt_kernel_info(int(any_hit), out),
                  f"binary_traverse.kernel_info({ROLES[int(any_hit)]})")
    return dict(zip(INFO, list(out)))


def _dispatch(any_hit, tables, ray_o, ray_d, t_max):
    _check(tables, ray_o, ray_d, t_max)
    if ray_o.device.type == "cuda":
        return _launch(any_hit, tables, ray_o, ray_d, t_max)
    if ray_o.device.type == "cpu":
        return trace_plain(any_hit, tables, ray_o, ray_d, t_max)
    raise RuntimeError(f"no binary traversal for device {ray_o.device}")


def trace_closest(tables, ray_o, ray_d, t_max) -> Hit:
    """Closest hit with barycentrics (JAX: trace_closest_pallas)."""
    return _dispatch(False, tables, ray_o, ray_d, t_max)


def trace_any(tables, ray_o, ray_d, t_max) -> torch.Tensor:
    """(R,) bool occlusion (JAX: trace_any_pallas)."""
    return _dispatch(True, tables, ray_o, ray_d, t_max)


def trace_closest_plain(tables, ray_o, ray_d, t_max) -> Hit:
    _check(tables, ray_o, ray_d, t_max)
    return trace_plain(False, tables, ray_o, ray_d, t_max)


def trace_any_plain(tables, ray_o, ray_d, t_max) -> torch.Tensor:
    _check(tables, ray_o, ray_d, t_max)
    return trace_plain(True, tables, ray_o, ray_d, t_max)
