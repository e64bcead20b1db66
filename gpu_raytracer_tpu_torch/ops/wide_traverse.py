"""Wide-BVH closest-hit and any-hit traversal over merged or two-level tables.

Counterpart of the TPU kernel roles of the JAX package:

  * `trace_primary`  <- ops/pallas_wide.py  trace_closest_wide (`_kernel`):
    closest hit with barycentrics, the primary wave, both layouts;
  * `trace_closest`  <- ops/pallas_gang.py  trace_closest_gang: merged tables
    `_gang_flat_kernel` (flat=True), two-level tables `_gang_kernel`
    (flat=False); closest hit, bounce waves;
  * `trace_any`      <- ops/pallas_gang.py  trace_any_gang, the same two
    kernels: occlusion, NEE shadow waves.

On a CUDA tensor each launches a hand-written kernel in
`csrc/wide_traverse.cu` and raises if it cannot: every role the
persistent-warp kernel (`wt_walk_kernel` of `csrc/wide_walk.cuh`: ray fetch
from a counter, the near child kept in registers, postponed leaves tested by
the whole warp; the primary role also returns the winning triangle's u, v
and, on two-level tables, tests its leaves in the lane's own order).
On a CPU tensor it runs `trace_plain`, the plain PyTorch version of the same
algorithm: the same tables, the same stable near-first child order, the same
pop-time cull, vectorised over the rays that still hold stack entries. The
persistent-warp kernel visits a ray's nodes and leaves in another order, so
its closest t equals the plain version's bit for bit and its tri / inst (and
u, v, the named triangle's) may differ at an exact tie in t
(parity.compare_closest holds it to that).

Tables (bvh/wide.py): nodes (N, 128), rows (L, 128) f32, in one of two
layouts, marked on `WideTables.two_level`:

  merged     pack_wide_merged: one world-space tree; `tri` is the leaf's
             f32-stored prim code (`rows[v, 1 + j]`), decoded with the prim
             map (`decode_prim`); `inst` is None.
  two-level  pack_wide_scene: a TLAS whose leaf rows are instance rows
             (`rows[v, 0] == -1`: [1] instance id, [2:14) inverse transform,
             [14] BLAS root node) over per-mesh BLAS trees in object space.
             An instance row moves the ray into object space and pushes
             RESTORE (-1, which brings the world ray back) and the BLAS root;
             `tri` is the leaf-order triangle id, `inst` the instance.

The affine inverse is applied to the direction unnormalised, so the ray
parameter t, the slab keys and the best hit stay comparable across spaces.
Dead lanes are those with t_max <= 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gpu_raytracer_tpu_torch.ops import _native

STACK_CAPACITY = 160  # csrc/wide_traverse.cu WT_STACK
LEAF_CAP = 12
DIV_EPS = 1e-12
RAY_EPS = 1e-4
RESTORE = -1  # stack entry: back to the world-space ray (pallas_wide.RESTORE)

PRIMARY, CLOSEST, ANY = 0, 1, 2
ROLES = ("primary", "closest", "any")
# Counted names: the role, with "_tl" for two-level tables.
NAMES = ROLES + tuple(r + "_tl" for r in ROLES)

# Launch counts: a kernel's count rises only where the kernel is launched; a
# plain version's only where the plain version runs.
launches = {r: 0 for r in NAMES}
plain_calls = {r: 0 for r in NAMES}

# Float operations of the kernel per visit, counted from csrc/wide_traverse.cu:
# a node slab-tests 8 children (12 sub/mul + 10 min/max + 1 clamp + 3 compares
# each) and sorts them (28 compare-swaps); a triangle test is 52 (edge-form
# Moller-Trumbore with its 8 compares); an instance row transforms the ray
# (33) and inverts the direction (9). `last_work` holds the visits of the
# latest plain call, from which the work of a wave is counted (leaf rows
# beside the triangles they hold); `last_pops` its per-ray visits (interior
# nodes, leaf rows and instance rows a ray pops and does not cull), which
# sum to nodes + leaves + instances.
OPS_PER_NODE = 8 * 26 + 28
OPS_PER_TRIANGLE = 52
OPS_PER_INSTANCE = 42
last_work = {"nodes": 0, "leaves": 0, "triangles": 0, "instances": 0}
last_pops: Optional[torch.Tensor] = None

WARP = 32
# Counters of the persistent-warp kernel's instrumented launch
# (`trace_stats`, stream_traverse.pass_stats; csrc/wide_walk.cuh WP_NODES ...
# WP_LEAF_ROUNDS).
STATS = ("nodes", "leaves", "instances", "triangles", "node_steps", "leaf_phases",
         "fetches", "leaf_rounds")
# What `kernel_info` returns (csrc/wide_walk.cuh wt_info_of).
INFO = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm", "sms")


class WideTables(NamedTuple):
    """Validated wide-BVH tables (see `make_tables`)."""
    nodes: torch.Tensor
    rows: torch.Tensor
    max_stack: int
    two_level: bool = False
    inst_rows: int = 0  # two-level: leaf rows [0, inst_rows) are the instance rows


class Hit(NamedTuple):
    t: torch.Tensor    # (R,) f32, +inf on a miss
    tri: torch.Tensor  # (R,) i32 prim code (merged) or triangle id, -1 on a miss
    inst: Optional[torch.Tensor] = None  # (R,) i32 instance (two-level), -1 on a miss
    u: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None


def name_of(mode: int, tables: WideTables) -> str:
    return ROLES[mode] + ("_tl" if tables.two_level else "")


def make_tables(nodes: torch.Tensor, rows: torch.Tensor, max_stack: int,
                two_level: bool = False) -> WideTables:
    """Check the tables' shapes and layout mark (instance rows only in
    two-level tables, and there ahead of the other leaf rows, so the
    persistent-warp kernel knows one by its id), and that the packer's stack
    bound, which counts RESTORE and BLAS root entries, fits the kernel's
    stack."""
    if nodes.dim() != 2 or nodes.shape[1] != 128 or rows.dim() != 2 \
            or rows.shape[1] != 128:
        raise ValueError(f"wide tables must be (N, 128) and (L, 128), got "
                         f"{tuple(nodes.shape)} and {tuple(rows.shape)}")
    if nodes.dtype != torch.float32 or rows.dtype != torch.float32:
        raise ValueError("wide tables must be float32")
    if not two_level and bool((rows[:, 0] < 0).any()):
        raise ValueError("tables labelled merged hold instance rows; pass "
                         "two_level=True for TLAS/BLAS tables")
    if int(max_stack) > STACK_CAPACITY:
        raise ValueError(f"wide tree needs a stack of {max_stack} entries; "
                         f"the traversal kernel holds {STACK_CAPACITY}")
    inst = rows[:, 0] < 0
    inst_rows = int(inst.sum())
    if not bool(inst[:inst_rows].all()):  # pack_wide_scene puts them first
        raise ValueError("two-level tables must hold their instance rows first")
    return WideTables(nodes.contiguous(), rows.contiguous(), int(max_stack),
                      bool(two_level), inst_rows)


def decode_prim(prim_map: torch.Tensor, tri: torch.Tensor):
    """Merged prim code -> (leaf-order triangle id, instance id), -1 on miss
    (prim_map[p] = inst << 22 | tri; JAX pathtracer._decode_wide_hit)."""
    ok = tri >= 0
    code = prim_map[tri.clamp(min=0).long()]
    return (torch.where(ok, code & 0x3FFFFF, tri),
            torch.where(ok, code >> 22, tri))


def _inv1(c: torch.Tensor) -> torch.Tensor:
    tiny = torch.where(c >= 0, DIV_EPS, -DIV_EPS).to(c.dtype)
    return 1.0 / torch.where(c.abs() < DIV_EPS, tiny, c)


def _affine_rows(m: torch.Tensor, p: torch.Tensor, point: bool) -> torch.Tensor:
    """Rows (K, 12) of 3x4 matrices applied to (K, 3) vectors in the TPU
    kernels' term order (m0*x + m1*y + m2*z [+ m3]), no matmul."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    out = []
    for r in range(3):
        c = m[:, 4 * r] * x + m[:, 4 * r + 1] * y + m[:, 4 * r + 2] * z
        out.append(c + m[:, 4 * r + 3] if point else c)
    return torch.stack(out, dim=1)


def child_keys(row: torch.Tensor, o: torch.Tensor, inv: torch.Tensor,
               cull: torch.Tensor):
    """Slab test of the 8 children of node rows `row` (K, 128) for rays
    (origins `o`, inverse directions `inv`, (K, 3)): the entry distance
    max(tn, 0) of each child that is non-empty, hit (tn <= tf, tf > 0) and
    entered before `cull` (K,), +inf for the others; and the (K, 8) child
    refs."""
    b = row[:, :48].reshape(-1, 8, 6)
    refs = row[:, 48:56].long()
    oo = o[:, None, :]
    ii = inv[:, None, :]
    t0 = (b[..., 0:3] - oo) * ii
    t1 = (b[..., 3:6] - oo) * ii
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    te = tn.clamp(min=0.0)
    take = (refs != -1) & (tn <= tf) & (tf > 0.0) & (te < cull[:, None])
    return torch.where(take, te, float("inf")), refs


def push_children(st_ref, st_t, sp, ni, key, refs) -> None:
    """Push the children with finite keys onto the stacks of rays `ni`,
    far to near, so the nearest pops first: a stable sort by key (the
    kernel's odd-even transposition sort keeps slot order on ties). Pushes
    past the stack's capacity are dropped, as in the kernel."""
    S = st_ref.shape[1]
    slots = torch.arange(8, device=key.device)
    key, order = torch.sort(key, dim=1, stable=True)
    ref_sorted = torch.gather(refs, 1, order)
    k = (key < float("inf")).sum(dim=1)
    base = sp[ni]
    slot = base[:, None] + (k[:, None] - 1 - slots[None, :])
    ok = (slots[None, :] < k[:, None]) & (slot < S)
    rr = ni[:, None].expand(-1, 8)[ok]
    st_ref[rr, slot[ok]] = ref_sorted[ok].to(torch.int32)
    st_t[rr, slot[ok]] = key[ok]
    sp[ni] = (base + k).clamp(max=S)


def leaf_hits(row: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
              limit: torch.Tensor):
    """Edge-form Moller-Trumbore tests of the up to LEAF_CAP triangles of
    leaf rows `row` (K, 128) against rays (K, 3) with hit bound `limit`
    (K,): (hit (K, LEAF_CAP) bool, t, u, w)."""
    lanes = torch.arange(LEAF_CAP, device=row.device)
    count = row[:, 0:1].long()
    g = row[:, 16:16 + 9 * LEAF_CAP].reshape(-1, LEAF_CAP, 9)
    p0x, p0y, p0z = g[..., 0], g[..., 1], g[..., 2]
    e1x, e1y, e1z = g[..., 3], g[..., 4], g[..., 5]
    e2x, e2y, e2z = g[..., 6], g[..., 7], g[..., 8]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
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
    w = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    hit = ((lanes[None, :] < count) & (a.abs() >= DIV_EPS)
           & (u >= 0.0) & (u <= 1.0) & (w >= 0.0) & (u + w <= 1.0)
           & (t > RAY_EPS) & (t < limit[:, None]))
    return hit, t, u, w


def trace_plain(mode: int, tables: WideTables, ray_o: torch.Tensor,
                ray_d: torch.Tensor, t_max: torch.Tensor):
    """Plain PyTorch version of the traversal kernel (any device)."""
    global last_pops
    plain_calls[name_of(mode, tables)] += 1
    nodes, rows, two_level = tables.nodes, tables.rows, tables.two_level
    dev = ray_o.device
    R = ray_o.shape[0]
    S = STACK_CAPACITY
    world_o = ray_o.float()
    world_d = ray_d.float()
    world_inv = _inv1(world_d)
    # The current ray: the world ray, or an instance's object-space ray.
    o, d, inv = world_o.clone(), world_d.clone(), world_inv.clone()
    tmax = t_max.float()
    best_t = tmax.clone()
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    cur_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(R, device=dev)
    best_v = torch.zeros(R, device=dev)
    occ = torch.zeros(R, dtype=torch.bool, device=dev)

    st_ref = torch.zeros((R, S), dtype=torch.int32, device=dev)
    st_t = torch.zeros((R, S), dtype=torch.float32, device=dev)
    sp = (tmax > 0).long()  # root node in slot 0; dead lanes start empty
    idx = torch.nonzero(sp > 0).flatten()
    inf = torch.tensor(float("inf"), device=dev)

    def push(ri, ref, key):
        """Push one entry on the stacks of rays `ri` (dropped at capacity,
        which make_tables rules out)."""
        s = sp[ri]
        ok = s < S
        st_ref[ri[ok], s[ok]] = ref[ok].to(torch.int32)
        st_t[ri[ok], s[ok]] = key[ok]
        sp[ri] = s + ok.long()

    visits = torch.zeros(4, dtype=torch.int64, device=dev)  # nodes, leaves, tris, insts
    pops = torch.zeros(R, dtype=torch.int64, device=dev)
    while idx.numel() > 0:
        s = sp[idx] - 1
        sp[idx] = s
        v = st_ref[idx, s].long()
        et = st_t[idx, s]
        # RESTORE carries the key -inf: the cull never drops it.
        keep = torch.ones_like(et, dtype=torch.bool) if mode == ANY \
            else et < best_t[idx]

        # ---- interior nodes: slab-test 8 children, push far -> near ----
        nm = keep & (v >= 0)
        visits[0] += nm.sum()
        pops[idx[keep & ((v >= 0) | (v <= -2))]] += 1
        if bool(nm.any()):
            ni = idx[nm]
            key, refs = child_keys(nodes[v[nm]], o[ni], inv[ni],
                                   (tmax if mode == ANY else best_t)[ni])
            push_children(st_ref, st_t, sp, ni, key, refs)

        if two_level:
            # ---- RESTORE: back to the world-space ray ----
            rm = v == RESTORE
            if bool(rm.any()):
                ri = idx[rm]
                o[ri], d[ri], inv[ri] = world_o[ri], world_d[ri], world_inv[ri]
                cur_inst[ri] = -1

        lm = keep & (v <= -2)
        li = idx[lm]
        row = rows[-v[lm] - 2]
        if two_level and li.numel() > 0:
            # ---- instance rows: enter the instance's BLAS ----
            im = row[:, 0] < 0
            visits[3] += im.sum()
            if bool(im.any()):
                ri = li[im]
                irow = row[im]
                m = irow[:, 2:14]
                o[ri] = _affine_rows(m, world_o[ri], True)
                d[ri] = _affine_rows(m, world_d[ri], False)
                inv[ri] = _inv1(d[ri])
                cur_inst[ri] = irow[:, 1].to(torch.int32)
                push(ri, torch.full_like(ri, RESTORE),
                     torch.full((ri.numel(),), float("-inf"), device=dev))
                # The BLAS root keeps the instance's entry key.
                push(ri, irow[:, 14].long(), et[lm][im])
                li, row = li[~im], row[~im]

        # ---- leaf rows: up to LEAF_CAP edge-form triangles ----
        if li.numel() > 0:
            visits[1] += li.numel()
            visits[2] += row[:, 0].long().sum()
            hit, t, u, w = leaf_hits(row, o[li], d[li],
                                     (tmax if mode == ANY else best_t)[li])
            found = hit.any(dim=1)
            if mode == ANY:
                hit_li = li[found]
                occ[hit_li] = True
                sp[hit_li] = 0
            else:
                # The kernel's sequential strict-< update keeps the FIRST
                # triangle of the row at the minimum t: torch.min does too.
                tbest, j = torch.where(hit, t, inf).min(dim=1)
                fl = li[found]
                jf = j[found][:, None]
                best_t[fl] = tbest[found]
                best_tri[fl] = torch.gather(row[found][:, 1:1 + LEAF_CAP], 1,
                                            jf).flatten().to(torch.int32)
                best_inst[fl] = cur_inst[fl]
                if mode == PRIMARY:
                    best_u[fl] = torch.gather(u[found], 1, jf).flatten()
                    best_v[fl] = torch.gather(w[found], 1, jf).flatten()

        idx = idx[sp[idx] > 0]

    last_work.update(zip(("nodes", "leaves", "triangles", "instances"), visits.tolist()))
    last_pops = pops
    if mode == ANY:
        return occ
    t_out = torch.where(best_tri >= 0, best_t, inf)
    inst_out = best_inst if two_level else None
    if mode == PRIMARY:
        return Hit(t_out, best_tri, inst_out, best_u, best_v)
    return Hit(t_out, best_tri, inst_out)


def _check_rays(tables: WideTables, ray_o, ray_d, t_max):
    if not isinstance(tables, WideTables):
        raise TypeError("pass tables built by make_tables()")
    R = ray_o.shape[0]
    if ray_o.shape != (R, 3) or ray_d.shape != (R, 3) or t_max.shape != (R,):
        raise ValueError("rays must be (R, 3), (R, 3), (R,)")
    for x in (ray_o, ray_d, t_max, tables.nodes, tables.rows):
        if x.dtype != torch.float32:
            raise ValueError("traversal inputs must be float32")
        if x.device != ray_o.device:
            raise ValueError("traversal inputs must share one device")


def _launch(mode: int, tables: WideTables, ray_o, ray_d, t_max, stats=None):
    lib = _native.load()
    R = ray_o.shape[0]
    dev = ray_o.device
    ray_o = ray_o.contiguous()
    ray_d = ray_d.contiguous()
    t_max = t_max.contiguous()
    t_out = tri_out = inst_out = u_out = v_out = occ = None
    if mode == ANY:
        occ = torch.empty(R, dtype=torch.bool, device=dev)
    else:
        t_out = torch.empty(R, dtype=torch.float32, device=dev)
        tri_out = torch.empty(R, dtype=torch.int32, device=dev)
        if tables.two_level:
            inst_out = torch.empty(R, dtype=torch.int32, device=dev)
        if mode == PRIMARY:
            u_out = torch.empty(R, dtype=torch.float32, device=dev)
            v_out = torch.empty(R, dtype=torch.float32, device=dev)
    # The persistent warps' ray counter, zeroed on the stream by wt_trace.
    next_ray = torch.empty(1, dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else ctypes.c_void_p(x.data_ptr())

    stream = torch.cuda.current_stream(dev).cuda_stream
    name = name_of(mode, tables)
    err = lib.wt_trace(mode, int(tables.two_level), ptr(tables.nodes),
                       ptr(tables.rows), tables.inst_rows, ptr(ray_o), ptr(ray_d),
                       ptr(t_max), R, ptr(next_ray), ptr(stats), ptr(t_out),
                       ptr(tri_out), ptr(inst_out), ptr(u_out), ptr(v_out), ptr(occ),
                       ctypes.c_void_p(stream))
    _native.check(err, f"wide_traverse.{name}")
    launches[name] += 1
    if mode == ANY:
        return occ
    return Hit(t_out, tri_out, inst_out, u_out, v_out)


def trace_stats(mode: int, tables: WideTables, ray_o, ray_d, t_max):
    """The persistent-warp kernel's instrumented launch (any role, on the
    card): (its result, {counter: count} over STATS). The counters are the
    visits it made (nodes, leaves, instances, triangles) and, summed over
    warps, the steps of its node phase, its leaf phases, its fetches and its
    rounds of inline leaf tests; `kernel_utilisation` turns them into the
    warp utilisation."""
    if mode not in (PRIMARY, CLOSEST, ANY):
        raise ValueError(f"no traversal role {mode}")
    if ray_o.device.type != "cuda":
        raise ValueError("trace_stats instruments the kernel: pass tensors on the card")
    _check_rays(tables, ray_o, ray_d, t_max)
    stats = torch.zeros(len(STATS), dtype=torch.int64, device=ray_o.device)
    out = _launch(mode, tables, ray_o, ray_d, t_max, stats=stats)
    return out, dict(zip(STATS, stats.tolist()))


def warp_utilisation(pops: torch.Tensor) -> float:
    """The warp utilisation of the one-thread-a-ray schedule from per-ray
    visit counts (`last_pops`; ray i in warp i // 32, the last warp padded
    with empty lanes): sum of visits / (32 x sum over warps of the most
    visits in the warp)."""
    R = pops.shape[0]
    lanes = torch.zeros(-(-R // WARP) * WARP, dtype=torch.int64, device=pops.device)
    lanes[:R] = pops
    steps = int(lanes.view(-1, WARP).amax(dim=1).sum())
    return float(lanes.sum()) / (WARP * steps) if steps else 1.0


def kernel_utilisation(stats: dict) -> float:
    """The warp utilisation of the persistent-warp kernel from its counters
    (`trace_stats`, stream_traverse.pass_stats): the node and leaf visits
    over 32 x its warp steps (node-phase steps, each one node a lane, leaf
    phases, each one leaf a lane, and, where a lane tests its leaves
    inline, the resident pass, the most leaf rows a lane tested in a node
    step). As `warp_utilisation`, whose warp steps are the most visits in a
    warp; the kernel takes instance rows and RESTORE inside its node steps,
    so they are not counted as visits here."""
    steps = stats["node_steps"] + stats["leaf_phases"] + stats.get("leaf_rounds", 0)
    visits = stats["nodes"] + stats["leaves"]
    return visits / (WARP * steps) if steps else 1.0


def kernel_info(mode: int, two_level: bool) -> dict:
    """What the compiler and the occupancy API report for the role's kernel
    on the card (INFO: registers, stack frame and static shared bytes, the
    threads of a block, the blocks an SM holds, the SMs)."""
    lib = _native.load()
    out = (ctypes.c_int * len(INFO))()
    _native.check(lib.wt_kernel_info(mode, int(two_level), out),
                  f"wide_traverse.kernel_info({ROLES[mode]})")
    return dict(zip(INFO, list(out)))


def _dispatch(mode, tables, ray_o, ray_d, t_max):
    _check_rays(tables, ray_o, ray_d, t_max)
    if ray_o.device.type == "cuda":
        return _launch(mode, tables, ray_o, ray_d, t_max)
    if ray_o.device.type == "cpu":
        return trace_plain(mode, tables, ray_o, ray_d, t_max)
    raise RuntimeError(f"no traversal for device {ray_o.device}")


def trace_primary(tables, ray_o, ray_d, t_max) -> Hit:
    """Closest hit with barycentrics (JAX: trace_closest_wide)."""
    return _dispatch(PRIMARY, tables, ray_o, ray_d, t_max)


def trace_closest(tables, ray_o, ray_d, t_max) -> Hit:
    """Closest hit, u/v left to the caller (JAX: trace_closest_gang)."""
    return _dispatch(CLOSEST, tables, ray_o, ray_d, t_max)


def trace_any(tables, ray_o, ray_d, t_max) -> torch.Tensor:
    """(R,) bool occlusion (JAX: trace_any_gang)."""
    return _dispatch(ANY, tables, ray_o, ray_d, t_max)


def trace_primary_plain(tables, ray_o, ray_d, t_max) -> Hit:
    _check_rays(tables, ray_o, ray_d, t_max)
    return trace_plain(PRIMARY, tables, ray_o, ray_d, t_max)


def trace_closest_plain(tables, ray_o, ray_d, t_max) -> Hit:
    _check_rays(tables, ray_o, ray_d, t_max)
    return trace_plain(CLOSEST, tables, ray_o, ray_d, t_max)


def trace_any_plain(tables, ray_o, ray_d, t_max) -> torch.Tensor:
    _check_rays(tables, ray_o, ray_d, t_max)
    return trace_plain(ANY, tables, ray_o, ray_d, t_max)
