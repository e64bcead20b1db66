"""The reference's own bounding-volume hierarchy, in plain PyTorch.

`build` makes a binary tree over a triangle soup with a binned surface-area
heuristic, one level of open nodes at a time (a node with at most `LEAF`
triangles closes; a node whose centroids fall in one bin splits at its
median). `trace` walks it for a batch of rays with a per-ray stack, one
node a ray per step (closest hit with barycentrics, or any hit), and can
count the node and triangle tests it makes. Both run on whatever device
the triangles are on, in the dtype the tree was made for. Nothing here
reads the port's tables: the tree follows from the triangles alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LEAF = 4       # triangles at most in a leaf
BINS = 16      # SAH bins a split
STACK = 64     # stack entries a ray


class Tree(NamedTuple):
    lo: torch.Tensor       # (N, 3) node bounds
    hi: torch.Tensor
    child: torch.Tensor    # (N, 2) int64, -1 on a leaf
    start: torch.Tensor    # (N,) int64 first triangle (leaf order) of a leaf
    count: torch.Tensor    # (N,) int64 triangles of a leaf, 0 inside
    prim: torch.Tensor     # (T,) int64 triangle id of each leaf-order slot
    v0: torch.Tensor       # (T, 3) triangles in leaf order
    e1: torch.Tensor
    e2: torch.Tensor
    depth: int


def _area(lo, hi):
    ext = (hi - lo).clamp(min=0.0)
    return 2.0 * (ext[..., 0] * ext[..., 1] + ext[..., 1] * ext[..., 2]
                  + ext[..., 2] * ext[..., 0])


def _seg_minmax(index, lo, hi, n):
    """Per-segment min of `lo` and max of `hi` rows, (n, 3) each."""
    idx = index[:, None].expand(-1, 3)
    out_lo = torch.full((n, 3), float("inf"), device=lo.device).scatter_reduce(
        0, idx, lo, "amin", include_self=True)
    out_hi = torch.full((n, 3), float("-inf"), device=lo.device).scatter_reduce(
        0, idx, hi, "amax", include_self=True)
    return out_lo, out_hi


def build(v0, v1, v2, dtype=torch.float32) -> Tree:
    """Binned-SAH tree over the triangles (v0, v1, v2), (T, 3) float32;
    the tree's bounds and triangles are cast to `dtype`."""
    dev = v0.device
    T = v0.shape[0]
    bmin = torch.minimum(torch.minimum(v0, v1), v2)
    bmax = torch.maximum(torch.maximum(v0, v1), v2)
    cen = 0.5 * (bmin + bmax)
    cap = 2 * T + 1
    lo = torch.zeros((cap, 3), device=dev)
    hi = torch.zeros((cap, 3), device=dev)
    child = torch.full((cap, 2), -1, dtype=torch.int64, device=dev)
    node_of = torch.zeros(T, dtype=torch.int64, device=dev)
    open_prims = torch.arange(T, device=dev)
    open_nodes = torch.zeros(1, dtype=torch.int64, device=dev)
    n_nodes, depth = 1, 0
    while open_nodes.numel():
        depth += 1
        N = open_nodes.numel()
        local = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
        local[open_nodes] = torch.arange(N, device=dev)
        p = open_prims
        li = local[node_of[p]]
        nlo, nhi = _seg_minmax(li, bmin[p], bmax[p], N)
        lo[open_nodes], hi[open_nodes] = nlo, nhi
        count = torch.bincount(li, minlength=N)
        clo, chi = _seg_minmax(li, cen[p], cen[p], N)
        ext = chi - clo
        axis = ext.argmax(dim=1)
        ext_ax = ext.gather(1, axis[:, None])[:, 0]
        c_ax = cen[p].gather(1, axis[li][:, None])[:, 0]
        scale = torch.where(ext_ax > 0, BINS / ext_ax.clamp(min=1e-30), 0.0)
        b = ((c_ax - clo.gather(1, axis[:, None])[:, 0][li]) * scale[li]).floor()
        b = b.clamp(0, BINS - 1).long()
        key = li * BINS + b
        bcnt = torch.bincount(key, minlength=N * BINS).view(N, BINS)
        blo, bhi = _seg_minmax(key, bmin[p], bmax[p], N * BINS)
        blo, bhi = blo.view(N, BINS, 3), bhi.view(N, BINS, 3)
        l_lo = torch.cummin(blo, dim=1).values
        l_hi = torch.cummax(bhi, dim=1).values
        r_lo = torch.cummin(blo.flip(1), dim=1).values.flip(1)
        r_hi = torch.cummax(bhi.flip(1), dim=1).values.flip(1)
        l_cnt = torch.cumsum(bcnt, dim=1)
        r_cnt = torch.cumsum(bcnt.flip(1), dim=1).flip(1)
        cost = (_area(l_lo[:, :-1], l_hi[:, :-1]) * l_cnt[:, :-1]
                + _area(r_lo[:, 1:], r_hi[:, 1:]) * r_cnt[:, 1:])
        cost = torch.where((l_cnt[:, :-1] > 0) & (r_cnt[:, 1:] > 0), cost, float("inf"))
        best_cost, best = cost.min(dim=1)
        split = count > LEAF
        binned = torch.isfinite(best_cost)
        right = b > best[li]
        median = split & ~binned
        if bool(median.any()):
            # Rank each triangle of a median node by its centroid on the axis.
            order = torch.sort(c_ax, stable=True).indices
            order = order[torch.sort(li[order], stable=True).indices]
            first = torch.cumsum(count, 0) - count
            rank = torch.empty_like(li)
            rank[order] = torch.arange(li.numel(), device=dev) - first[li[order]]
            right = torch.where(median[li], rank >= count[li] // 2, right)
        split_nodes = open_nodes[split]
        n_split = split_nodes.numel()
        kids = n_nodes + 2 * torch.arange(n_split, device=dev)
        child[split_nodes, 0], child[split_nodes, 1] = kids, kids + 1
        kid_of = torch.full((N,), -1, dtype=torch.int64, device=dev)
        kid_of[split] = kids
        moving = split[li]
        pm = p[moving]
        node_of[pm] = kid_of[li[moving]] + right[moving].long()
        n_nodes += 2 * n_split
        open_prims = pm
        open_nodes = torch.arange(n_nodes - 2 * n_split, n_nodes, device=dev)
    slot = torch.sort(node_of, stable=True).indices
    cnt = torch.bincount(node_of, minlength=n_nodes)
    start = torch.cumsum(cnt, 0) - cnt
    e1, e2 = v1 - v0, v2 - v0
    return Tree(lo[:n_nodes].to(dtype), hi[:n_nodes].to(dtype), child[:n_nodes],
                start, cnt, slot, v0[slot].to(dtype), e1[slot].to(dtype),
                e2[slot].to(dtype), depth)


def _slab(o, inv, lo, hi, tmax):
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    near = torch.fmin(t1, t2).amax(dim=1).clamp(min=0.0)
    far = torch.fmax(t1, t2).amin(dim=1)
    return near, (near <= far) & (near < tmax)


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def intersect(o, d, v0, e1, e2, tmax):
    """Moller-Trumbore: (t, u, v, hit) with 0 < t < tmax."""
    pvec = _cross(d, e2)
    det = (e1 * pvec).sum(1)
    inv_det = 1.0 / det
    tvec = o - v0
    u = (tvec * pvec).sum(1) * inv_det
    qvec = _cross(tvec, e1)
    v = (d * qvec).sum(1) * inv_det
    t = (e2 * qvec).sum(1) * inv_det
    hit = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < tmax)
    return t, u, v, hit


def trace(tree: Tree, o, d, tmax, any_hit: bool = False, stats: dict = None):
    """Walk `tree` for rays (o, d) up to `tmax` (all (R, 3) / (R,), in the
    tree's dtype). Closest hit -> (t, triangle id or -1, u, v); any hit ->
    occluded (R,) bool. `stats`, a dict, gets the "node" (box pairs
    tested) and "triangle" tests added."""
    dev = o.device
    R = o.shape[0]
    dt = tree.v0.dtype
    inv = 1.0 / d
    best = tmax.clone()
    prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    hu = torch.zeros(R, dtype=dt, device=dev)
    hv = torch.zeros(R, dtype=dt, device=dev)
    occluded = torch.zeros(R, dtype=torch.bool, device=dev)
    stack = torch.empty((R, STACK), dtype=torch.int32, device=dev)
    stack_t = torch.empty((R, STACK), dtype=dt, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    near, hit_root = _slab(o, inv, tree.lo[0].expand(R, 3), tree.hi[0].expand(R, 3), best)
    cur = torch.where(hit_root, 0, -1)
    cur_t = near
    nodes = tris = 0
    a = torch.nonzero(hit_root).flatten()
    while a.numel():
        n = cur[a]
        live = cur_t[a] < best[a]
        leaf = tree.child[n, 0] < 0
        ia, nn = a[live & ~leaf], n[live & ~leaf]
        if ia.numel():
            nodes += ia.numel()
            c0, c1 = tree.child[nn, 0], tree.child[nn, 1]
            oo, iv, tb = o[ia], inv[ia], best[ia]
            t0, h0 = _slab(oo, iv, tree.lo[c0], tree.hi[c0], tb)
            t1, h1 = _slab(oo, iv, tree.lo[c1], tree.hi[c1], tb)
            first0 = t0 <= t1
            both = h0 & h1
            nxt = torch.where(both, torch.where(first0, c0, c1),
                              torch.where(h0, c0, torch.where(h1, c1, -1)))
            nxt_t = torch.where(both, torch.where(first0, t0, t1), torch.where(h0, t0, t1))
            pb = ia[both]
            if pb.numel():
                far = torch.where(first0, c1, c0)[both]
                far_t = torch.where(first0, t1, t0)[both]
                if bool((sp[pb] >= STACK).any()):
                    raise RuntimeError("reference BVH stack overflow")
                stack[pb, sp[pb]] = far.to(torch.int32)
                stack_t[pb, sp[pb]] = far_t
                sp[pb] += 1
            cur[ia], cur_t[ia] = nxt, nxt_t
        la, ln = a[live & leaf], n[live & leaf]
        if la.numel():
            s, cn = tree.start[ln], tree.count[ln]
            for j in range(LEAF):
                m = cn > j
                lj, pj = la[m], s[m] + j
                if not lj.numel():
                    break
                tris += lj.numel()
                t, u, v, hit = intersect(o[lj], d[lj], tree.v0[pj], tree.e1[pj],
                                         tree.e2[pj], best[lj])
                if any_hit:
                    occluded[lj[hit]] = True
                    sp[lj[hit]] = 0
                else:
                    lh = lj[hit]
                    best[lh], prim[lh] = t[hit], tree.prim[pj[hit]]
                    hu[lh], hv[lh] = u[hit], v[hit]
            cur[la] = -1
        cur[a[~live]] = -1
        pa = a[cur[a] < 0]
        if pa.numel():
            has = sp[pa] > 0
            sp[pa] -= has.long()
            top = sp[pa].clamp(min=0)
            cur[pa] = torch.where(has, stack[pa, top].long(), -1)
            cur_t[pa] = torch.where(has, stack_t[pa, top], cur_t[pa])
        a = a[cur[a] >= 0]
    if stats is not None:
        stats["node"] = stats.get("node", 0) + nodes
        stats["triangle"] = stats.get("triangle", 0) + tris
    if any_hit:
        return occluded
    return torch.where(prim >= 0, best, float("inf")), prim, hu, hv
