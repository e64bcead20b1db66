"""Closest-hit and any-hit traversal over paged wide-BVH tables (the streamed
tables of bvh/stream.py), for scenes whose merged tables pass the routing
budget (ops/buffers.py).

Counterpart of the TPU kernel roles of the JAX package's
ops/pallas_stream.py (`trace_closest_stream`, `trace_any_stream`):

  * `resident_kernel` / `resident_plain` <- `_resident_kernel`: traversal of the resident top of
    the tree. A portal child the ray enters before its cull t is recorded,
    not descended: its (portal id, entry t) goes to the ray's list, in the
    ray's own enumeration order, when its index lies in the pass's window
    [skip, skip + K_PORTALS); past the window it only counts in `ovf`. Also
    the best resident hit.
  * `page_kernel` / `page_plain` <- `_page_kernel`: for each recorded portal, nearest entry
    first, while it is entered before the running best (closest) or the ray
    is not yet occluded (any), the traversal of the portal's subtree inside
    its page, from the portal's root row; the hits fold into the running best.

The portal lists are (R, K_PORTALS) tensors stored slot-major: the transposed
view of a contiguous (K_PORTALS, R) tensor, so the kernel's lanes store and
load one slot of consecutive rays contiguously. Both passes return and take
them so; `page_kernel` copies a list given in another layout.

`trace_closest` / `trace_any` drive the passes, keeping the JAX package's
loss-free contract (pallas_stream.py:596-644): every lane runs pass 0; a lane
that recorded more than K_PORTALS portals reruns the resident pass with its
original t_max and the window advanced by K_PORTALS (the enumeration is per
ray and deterministic, so the replay records the next portals), up to
MAX_PASSES passes. Lanes still pending after that are returned as `residual`:
a closest hit there may be truncated, and an any-hit counts as occluded.

On a CUDA tensor each pass launches the persistent-warp walk of
`csrc/wide_walk.cuh` (`csrc/stream_traverse.cu`) and raises if it cannot:
the resident pass tests its leaves inline, in each lane's own order, so its
enumeration and every output equal the plain version's; the page pass seeds
each lane's stack with its portals, nearest first, and walks them with
postponed leaves, so its closest t equals the plain version's bit for bit
and its tri may differ at an exact tie in t (parity.compare_stream_closest).
On a CPU tensor it runs the plain PyTorch version of the same per-ray
algorithm, vectorised over the rays: the same enumeration, the same child
order (the wide traversal's helpers), the same portal order and the same
fold.

The TPU kernel's schedule is not carried over: 128-ray gangs sharing a stack,
popularity-sorted page rounds with M_SUB portals a gang, the 2 MiB page DMA
into VMEM and the watchdog launch split exist because a TPU core cannot
gather per ray from device memory. A lane here reads any page row from
device memory through the L2 cache (ROADMAP C18). The per-ray portal lists
differ from the JAX package's gang-order lists, and so do the lanes that
overflow; the hits do not.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gpu_raytracer_tpu_torch.bvh.stream import PORTAL_BASE
from gpu_raytracer_tpu_torch.ops import _native
from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

K_PORTALS = 16     # pallas_stream.K_PORTALS: portal window of a pass
MAX_PASSES = 64    # pallas_stream.MAX_PASSES: 64 * K portals per lane
ROOT_BITS = 28     # csrc/wide_walk.cuh WT_ROOT_BITS: page rows in all < 2^28

# Counted names: pass and mode. A kernel's count rises only where it is
# launched; a plain version's only where the plain version runs.
NAMES = ("resident_closest", "resident_any", "page_closest", "page_any")
launches = {n: 0 for n in NAMES}
plain_calls = {n: 0 for n in NAMES}
# The work of the latest plain call of each pass: node and triangle visits
# (operations per visit as wide_traverse.OPS_PER_*) and what the kernel must
# read for it: the distinct table rows loaded ("rows"), and for the page pass
# the distinct portals walked, the list entries read (a lane's slots up to
# its first empty one) and the lanes that read their ray.
last_work = {n: {"nodes": 0, "triangles": 0, "rows": 0} for n in NAMES}
# The per-ray visits of the latest plain call of each pass ((R,) int64:
# interior nodes and leaf rows popped and not culled, over every portal of
# the page pass), from which wide_traverse.warp_utilisation gives the warp
# utilisation of a one-thread-a-ray schedule.
last_pops = {n: None for n in NAMES}
# Passes the latest trace took.
last_trace = {"passes": 0}


class StreamTables(NamedTuple):
    """Validated paged tables (see `make_stream_tables`)."""
    resident: torch.Tensor     # (Rr, 128) f32, unified local rows
    pages: torch.Tensor        # (G, page_rows, 128) f32
    portal_page: torch.Tensor  # (P,) i32
    portal_root: torch.Tensor  # (P,) i32, local root row in its page
    max_stack: int

    @property
    def page_rows(self) -> int:
        return self.pages.shape[1]


class StreamHit(NamedTuple):
    t: torch.Tensor    # (R,) f32, +inf on a miss
    tri: torch.Tensor  # (R,) i32 prim id, -1 on a miss


def make_stream_tables(resident, pages, portal_page, portal_root,
                       max_stack: int, page_stack: Optional[int] = None) -> StreamTables:
    """Check the tables' shapes and types, and that the stack bounds
    re-derived from them (buffers.stream_max_stack, stream_page_stack) fit
    the kernel's stack: the resident walk's, and the page walk's with the
    up to K_PORTALS - 1 portals the page pass seeds beneath its first
    subtree (`page_stack` defaults to `max_stack`, the larger bound)."""
    if resident.dim() != 2 or resident.shape[1] != 128 or pages.dim() != 3 \
            or pages.shape[2] != 128:
        raise ValueError(f"paged tables must be (Rr, 128) and (G, page_rows, 128), "
                         f"got {tuple(resident.shape)} and {tuple(pages.shape)}")
    if resident.dtype != torch.float32 or pages.dtype != torch.float32:
        raise ValueError("paged tables must be float32")
    if portal_page.dtype != torch.int32 or portal_root.dtype != torch.int32 \
            or portal_page.shape != portal_root.shape or portal_page.dim() != 1:
        raise ValueError("portal_page and portal_root must be (P,) int32")
    if pages.shape[0] * pages.shape[1] >= 1 << ROOT_BITS:
        raise ValueError(f"{pages.shape[0]} pages of {pages.shape[1]} rows pass the page "
                         f"pass's 2^{ROOT_BITS} global rows")
    cap = wt.STACK_CAPACITY
    if int(max_stack) > cap:
        raise ValueError(f"paged tree needs a stack of {max_stack} entries; "
                         f"the traversal kernel holds {cap}")
    seeded = int(max_stack if page_stack is None else page_stack) + K_PORTALS - 1
    if seeded > cap:
        raise ValueError(f"the page pass needs a stack of {seeded} entries (page subtrees "
                         f"{seeded - K_PORTALS + 1} + {K_PORTALS - 1} seeded portals); "
                         f"the traversal kernel holds {cap}")
    return StreamTables(resident.contiguous(), pages.contiguous(),
                        portal_page.contiguous(), portal_root.contiguous(),
                        int(max_stack))


def _walk(any_hit: bool, table, o, d, tmax, best_t, best_tri, st_ref, st_t, sp, seen,
          pops, page_rows=None, record=None):
    """Per-ray stack traversal of unified-index rows (`table` (N, 128)) from
    the stacks `st_ref`, `st_t` ((n, STACK_CAPACITY), `sp` entries a ray,
    popped from the top), vectorised over the rays; updates `best_t` /
    `best_tri` in place (any-hit: tri 0 and t 0 once occluded), marks in
    `seen` ((N,) bool) each row it loads and counts in `pops` ((n,) int64)
    each ray's rows popped and not culled. With `page_rows` the refs of a
    node row are local to its page: made rows of `table` by adding the
    page's base (leaf refs subtract it). With `record` = (skip, pid, pt,
    ovf, cnt), portal children are recorded as the module docstring says
    and not pushed. Returns (node visits, triangle visits)."""
    dev = o.device
    inv = wt._inv1(d)
    idx = torch.nonzero(sp > 0).flatten()
    visits = torch.zeros(2, dtype=torch.int64, device=dev)
    while idx.numel() > 0:
        s = sp[idx] - 1
        sp[idx] = s
        v = st_ref[idx, s].long()
        et = st_t[idx, s]
        keep = (torch.ones_like(et, dtype=torch.bool) if any_hit
                else et < best_t[idx])
        cull = tmax if any_hit else best_t
        pops[idx[keep]] += 1

        nm = keep & (v >= 0)
        visits[0] += nm.sum()
        if bool(nm.any()):
            ni = idx[nm]
            at = v[nm]
            seen[at] = True
            key, refs = wt.child_keys(table[at], o[ni], inv[ni], cull[ni])
            if page_rows is not None:
                base = (at - at % page_rows)[:, None]
                refs = torch.where(refs >= 0, refs + base,
                                   torch.where(refs <= -2, refs - base, refs))
            if record is not None:
                skip, pid, pt, ovf, cnt = record
                portal = (key < float("inf")) & (refs <= -(2 + PORTAL_BASE))
                # Enumeration index of each portal child: node order, then
                # child slot order.
                k = cnt[ni][:, None] + torch.cumsum(portal.long(), dim=1) - 1 - skip
                put = portal & (k >= 0) & (k < K_PORTALS)
                rows = ni[:, None].expand(-1, 8)[put]
                pid[rows, k[put]] = (-refs[put] - 2 - PORTAL_BASE).to(torch.int32)
                pt[rows, k[put]] = key[put]
                ovf[ni] += (portal & (k >= K_PORTALS)).sum(dim=1).to(torch.int32)
                cnt[ni] += portal.sum(dim=1)
                key = torch.where(portal, float("inf"), key)
            wt.push_children(st_ref, st_t, sp, ni, key, refs)

        lm = keep & (v <= -2)
        if bool(lm.any()):
            li = idx[lm]
            at = -v[lm] - 2
            seen[at] = True
            row = table[at]
            visits[1] += row[:, 0].long().sum()
            hit, t, _, _ = wt.leaf_hits(row, o[li], d[li], cull[li])
            found = hit.any(dim=1)
            fl = li[found]
            if any_hit:
                best_t[fl] = 0.0
                best_tri[fl] = 0
                sp[fl] = 0
            else:
                # The kernel's sequential strict-< update keeps the first
                # triangle of the row at the minimum t: torch.min does too.
                tbest, j = torch.where(hit, t, float("inf")).min(dim=1)
                best_t[fl] = tbest[found]
                best_tri[fl] = torch.gather(row[found][:, 1:1 + wt.LEAF_CAP], 1,
                                            j[found][:, None]).flatten().to(torch.int32)
        idx = idx[sp[idx] > 0]
    return visits


def _stacks(n: int, dev):
    S = wt.STACK_CAPACITY
    return (torch.zeros((n, S), dtype=torch.int32, device=dev),
            torch.zeros((n, S), dtype=torch.float32, device=dev))


def _name(kind: str, any_hit: bool) -> str:
    return f"{kind}_{'any' if any_hit else 'closest'}"


def resident_plain(any_hit: bool, tables: StreamTables, ray_o, ray_d, t_max,
                   skip: int = 0):
    """Plain version of the resident kernel -> (t, tri, pid (R, K), pt (R, K),
    ovf): the best resident hit (any-hit: t 0 and tri 0 where occluded, else
    +inf and -1), the window's portals (pid -1 and pt +inf past the ray's
    list; slot-major storage) and the count of portals past the window."""
    name = _name("resident", any_hit)
    plain_calls[name] += 1
    dev = ray_o.device
    R = ray_o.shape[0]
    tmax = t_max.float()
    best_t = tmax.clone()
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    # Empty lists, (R, K_PORTALS) views of slot-major storage.
    pid = torch.full((K_PORTALS, R), -1, dtype=torch.int32, device=dev).t()
    pt = torch.full((K_PORTALS, R), float("inf"), device=dev).t()
    ovf = torch.zeros(R, dtype=torch.int32, device=dev)
    cnt = torch.zeros(R, dtype=torch.int64, device=dev)
    seen = torch.zeros(tables.resident.shape[0], dtype=torch.bool, device=dev)
    pops = torch.zeros(R, dtype=torch.int64, device=dev)
    st_ref, st_t = _stacks(R, dev)  # the root, row 0, key 0 on live lanes
    visits = _walk(any_hit, tables.resident, ray_o.float(), ray_d.float(), tmax, best_t,
                   best_tri, st_ref, st_t, (tmax > 0).long(), seen, pops,
                   record=(int(skip), pid, pt, ovf, cnt))
    last_work[name] = {"nodes": int(visits[0]), "triangles": int(visits[1]),
                       "rows": int(seen.sum())}
    last_pops[name] = pops
    t = torch.where(best_tri >= 0, best_t, float("inf"))
    return t, best_tri, pid, pt, ovf


def page_plain(any_hit: bool, tables: StreamTables, ray_o, ray_d, t_max, pid, pt,
               best_t, best_tri):
    """Plain version of the page kernel -> the running best (t, tri) after
    the pending portals `pid`, `pt` (R, K) of each ray, as the kernel walks
    them: the ray's stack seeded with its portals, nearest entry on top (a
    stable sort), as global rows of the flat page array, then one walk, so
    a portal is entered while its entry lies before the running best
    (closest) or while the ray is not occluded (any-hit: tri >= 0); portal
    subtrees are disjoint, so this is the loop over the portals nearest
    first, each walked to its end."""
    name = _name("page", any_hit)
    plain_calls[name] += 1
    best_t = best_t.clone()
    best_tri = best_tri.clone()
    o, d, tmax = ray_o.float(), ray_d.float(), t_max.float()
    dev = o.device
    R = o.shape[0]
    key, order = torch.sort(torch.where(pid >= 0, pt, float("inf")), dim=1,
                            stable=True)
    ids = torch.gather(pid, 1, order).long()
    flat = tables.pages.reshape(-1, 128)
    seen = torch.zeros(flat.shape[0], dtype=torch.bool, device=dev)
    pops = torch.zeros(R, dtype=torch.int64, device=dev)
    # What the kernel reads of the lists: a lane not occluded on entry reads
    # its slots up to the first empty one (ids) and its recorded entries (t).
    n = (pid >= 0).sum(dim=1)
    reads = (best_tri < 0) if any_hit else torch.ones_like(n, dtype=torch.bool)
    entries = int((torch.clamp(n + 1, max=K_PORTALS) + n)[reads].sum())
    lanes = int((reads & (n > 0)).sum())
    # The seeded stacks: portal k of n at slot n - 1 - k, far to near.
    st_ref, st_t = _stacks(R, dev)
    slot = (n[:, None] - 1 - torch.arange(K_PORTALS, device=dev)[None, :]).clamp(min=0)
    valid = ids >= 0
    root = (tables.portal_page.long() * tables.page_rows
            + tables.portal_root.long())[ids.clamp(min=0)]
    rr = torch.arange(R, device=dev)[:, None].expand(-1, K_PORTALS)
    st_ref[rr[valid], slot[valid]] = root[valid].to(torch.int32)
    st_t[rr[valid], slot[valid]] = key[valid]
    sp = torch.where(reads, n, torch.zeros_like(n)).long()
    visits = _walk(any_hit, flat, o, d, tmax, best_t, best_tri, st_ref, st_t, sp, seen,
                   pops, page_rows=tables.page_rows)
    # The portals walked: those entered (a portal's root row is popped and
    # not culled exactly where its subtree is walked).
    walked = torch.zeros(tables.portal_page.shape[0], dtype=torch.bool, device=dev)
    root_of = torch.full((flat.shape[0],), -1, dtype=torch.int64, device=dev)
    root_of[(tables.portal_page.long() * tables.page_rows + tables.portal_root.long())] = \
        torch.arange(tables.portal_page.shape[0], device=dev)
    hit_roots = root_of[torch.nonzero(seen).flatten()]
    walked[hit_roots[hit_roots >= 0]] = True
    last_work[name] = {"nodes": int(visits[0]), "triangles": int(visits[1]),
                       "rows": int(seen.sum()), "portals": int(walked.sum()),
                       "entries": entries, "lanes": lanes}
    last_pops[name] = pops
    return best_t, best_tri


def _ptr(x):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check_cuda(tables: StreamTables, ray_o, ray_d, t_max):
    _check_rays(tables, ray_o, ray_d, t_max)
    if ray_o.device.type != "cuda":
        raise RuntimeError(f"the stream kernels take CUDA tensors, not {ray_o.device}")


def _resident_launch(any_hit: bool, tables: StreamTables, ray_o, ray_d, t_max, skip=0,
                     stats=None):
    _check_cuda(tables, ray_o, ray_d, t_max)
    lib = _native.load()
    R = ray_o.shape[0]
    dev = ray_o.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    pid = torch.empty((K_PORTALS, R), dtype=torch.int32, device=dev)
    pt = torch.empty((K_PORTALS, R), dtype=torch.float32, device=dev)
    ovf = torch.empty(R, dtype=torch.int32, device=dev)
    # The walk's ray counter, zeroed on the stream by st_resident.
    next_ray = torch.empty(1, dtype=torch.int32, device=dev)
    # Contiguous inputs held here until the launch is queued (a temporary
    # freed at once could hand its memory to the next one).
    o, d, tm = ray_o.contiguous(), ray_d.contiguous(), t_max.contiguous()
    name = _name("resident", any_hit)
    err = lib.st_resident(int(any_hit), _ptr(tables.resident), _ptr(o), _ptr(d), _ptr(tm),
                          R, int(skip), _ptr(next_ray), _ptr(stats), _ptr(t), _ptr(tri),
                          _ptr(pid), _ptr(pt), _ptr(ovf), _stream(dev))
    _native.check(err, f"stream_traverse.{name}")
    launches[name] += 1
    return t, tri, pid.t(), pt.t(), ovf


def _page_launch(any_hit: bool, tables: StreamTables, ray_o, ray_d, t_max, pid, pt,
                 best_t, best_tri, stats=None):
    _check_cuda(tables, ray_o, ray_d, t_max)
    lib = _native.load()
    R = ray_o.shape[0]
    dev = ray_o.device
    if pid.shape != (R, K_PORTALS) or pid.dtype != torch.int32 \
            or pt.shape != (R, K_PORTALS) or pt.dtype != torch.float32:
        raise ValueError(f"portal lists must be ({R}, {K_PORTALS}) int32 / float32")
    t = best_t.float().clone()
    tri = best_tri.to(torch.int32).clone()
    next_ray = torch.empty(1, dtype=torch.int32, device=dev)
    # Contiguous inputs held here until the launch is queued; slot-major
    # lists: no copy for those the resident pass returns.
    o, d, tm = ray_o.contiguous(), ray_d.contiguous(), t_max.contiguous()
    pid_k, pt_k = pid.t().contiguous(), pt.t().contiguous()
    name = _name("page", any_hit)
    err = lib.st_page(int(any_hit), _ptr(tables.pages), tables.page_rows,
                      _ptr(tables.portal_page), _ptr(tables.portal_root), _ptr(o), _ptr(d),
                      _ptr(tm), R, _ptr(pid_k), _ptr(pt_k), _ptr(next_ray), _ptr(stats),
                      _ptr(t), _ptr(tri), _stream(dev))
    _native.check(err, f"stream_traverse.{name}")
    launches[name] += 1
    return t, tri


def resident_kernel(any_hit: bool, tables: StreamTables, ray_o, ray_d, t_max,
                    skip: int = 0):
    """The resident kernel (csrc/stream_traverse.cu st_resident); outputs as
    `resident_plain`."""
    return _resident_launch(any_hit, tables, ray_o, ray_d, t_max, skip)


def page_kernel(any_hit: bool, tables: StreamTables, ray_o, ray_d, t_max, pid, pt,
                best_t, best_tri):
    """The page kernel (csrc/stream_traverse.cu st_page); outputs as
    `page_plain`."""
    return _page_launch(any_hit, tables, ray_o, ray_d, t_max, pid, pt, best_t, best_tri)


def pass_stats(kind: str, any_hit: bool, tables: StreamTables, *args):
    """A pass kernel's instrumented launch (`kind` "resident" or "page",
    arguments as `resident_kernel` or `page_kernel`, on the card): (its
    result, {counter: count} over wide_traverse.STATS);
    wide_traverse.kernel_utilisation turns them into the warp utilisation."""
    if kind not in ("resident", "page"):
        raise ValueError(f"no pass {kind!r}")
    stats = torch.zeros(len(wt.STATS), dtype=torch.int64, device=args[0].device)
    launch = _resident_launch if kind == "resident" else _page_launch
    out = launch(any_hit, tables, *args, stats=stats)
    return out, dict(zip(wt.STATS, stats.tolist()))


def kernel_info(kind: str, any_hit: bool) -> dict:
    """What the compiler and the occupancy API report for a pass's kernel on
    the card (wide_traverse.INFO)."""
    lib = _native.load()
    out = (ctypes.c_int * len(wt.INFO))()
    _native.check(lib.st_kernel_info(int(kind == "page"), int(any_hit), out),
                  f"stream_traverse.kernel_info({_name(kind, any_hit)})")
    return dict(zip(wt.INFO, list(out)))


def _check_rays(tables: StreamTables, ray_o, ray_d, t_max):
    if not isinstance(tables, StreamTables):
        raise TypeError("pass tables built by make_stream_tables()")
    R = ray_o.shape[0]
    if ray_o.shape != (R, 3) or ray_d.shape != (R, 3) or t_max.shape != (R,):
        raise ValueError("rays must be (R, 3), (R, 3), (R,)")
    for x in (ray_o, ray_d, t_max, tables.resident, tables.pages):
        if x.dtype != torch.float32:
            raise ValueError("traversal inputs must be float32")
        if x.device != ray_o.device:
            raise ValueError("traversal inputs must share one device")


def _passes(device):
    """(resident pass, page pass) for tensors on `device`: the kernels on a
    CUDA device, the plain versions on the CPU."""
    if device.type == "cuda":
        return resident_kernel, page_kernel
    if device.type == "cpu":
        return resident_plain, page_plain
    raise RuntimeError(f"no stream traversal for device {device}")


def _trace(any_hit: bool, tables: StreamTables, ray_o, ray_d, t_max, passes):
    """The pass loop (module docstring) -> (t, tri, residual)."""
    resident, page = passes
    dev = ray_o.device
    R = ray_o.shape[0]
    best_t = t_max.float().clone()
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    pending = t_max > 0
    lanes = None  # pass 0: every lane
    p = 0
    while p < MAX_PASSES:
        o, d, tm = ((ray_o, ray_d, t_max) if lanes is None
                    else (ray_o[lanes], ray_d[lanes], t_max[lanes]))
        t1, tri1, pid, pt, ovf = resident(any_hit, tables, o, d, tm, p * K_PORTALS)
        bt = best_t if lanes is None else best_t[lanes]
        btri = best_tri if lanes is None else best_tri[lanes]
        better = (tri1 >= 0) & ((btri < 0) if any_hit else (t1 < bt))
        bt = torch.where(better, t1, bt)
        btri = torch.where(better, tri1, btri)
        bt, btri = page(any_hit, tables, o, d, tm, pid, pt, bt, btri)
        still = ovf > 0
        if any_hit:
            still = still & (btri < 0)
        if lanes is None:
            best_t, best_tri = bt, btri
            pending = pending & still
        else:
            best_t[lanes], best_tri[lanes] = bt, btri
            pending[lanes] = still
        p += 1
        lanes = torch.nonzero(pending).flatten()
        if lanes.numel() == 0:
            break
    last_trace["passes"] = p
    t = torch.where(best_tri >= 0, best_t, float("inf"))
    return t, best_tri, pending


def trace_closest(tables, ray_o, ray_d, t_max):
    """Closest hit over the paged tables -> (StreamHit, residual (R,) bool:
    lanes whose portal enumeration outran MAX_PASSES * K_PORTALS, so their
    hit may be truncated) (JAX: trace_closest_stream(with_residual=True))."""
    _check_rays(tables, ray_o, ray_d, t_max)
    t, tri, residual = _trace(False, tables, ray_o, ray_d, t_max,
                              _passes(ray_o.device))
    return StreamHit(t, tri), residual


def trace_any(tables, ray_o, ray_d, t_max) -> torch.Tensor:
    """(R,) bool occlusion over the paged tables; residual lanes count as
    occluded (JAX: trace_any_stream)."""
    _check_rays(tables, ray_o, ray_d, t_max)
    _, tri, residual = _trace(True, tables, ray_o, ray_d, t_max,
                              _passes(ray_o.device))
    return (tri >= 0) | residual


def trace_closest_plain(tables, ray_o, ray_d, t_max):
    _check_rays(tables, ray_o, ray_d, t_max)
    t, tri, residual = _trace(False, tables, ray_o, ray_d, t_max,
                              (resident_plain, page_plain))
    return StreamHit(t, tri), residual


def trace_any_plain(tables, ray_o, ray_d, t_max) -> torch.Tensor:
    _check_rays(tables, ray_o, ray_d, t_max)
    _, tri, residual = _trace(True, tables, ray_o, ray_d, t_max,
                              (resident_plain, page_plain))
    return (tri >= 0) | residual
