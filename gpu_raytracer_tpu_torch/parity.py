"""Kernel-vs-plain comparisons with the port's parity bars, shared by
`chip_smoke.py` and the card-only tests (tests/test_torch_cuda.py).

The bars are those of the CPU parity tests (tests/test_torch_*.py), which
hold the plain versions to the JAX package:

  binary     (the binary traversal, K8) hit masks and (tri, inst) equal
             on every ray; t, u and v within rtol 1e-4 (atol 1e-7 for u, v
             near 0); any-hit exactly equal;
  traversal  (tie-aware) hit masks equal; t bit-equal on every hit (and
             within rtol 1e-4); tri (two-level: tri and inst) equality
             > 0.995 on coherent (primary) waves, > 0.98 on incoherent
             ones, and where the ids differ the kernel's triangle meets
             the ray at the same t (an exact tie, re-tested by the plain
             triangle test); u, v atol 1e-4 where the ids agree, and
             where they differ within 1e-4 of the re-tested triangle's;
             any-hit exactly equal;
  shade      >= 99.9% of lanes agree (masks equal, every consumed
             continuous output within rtol 1e-4, atol 1e-5), for both
             fused shade kernels (K3 and K7);
  image      rel-RMSE < 3e-3 (the JAX package's `fused_shade_rel_rmse`
             gate), ray counts within 0.5%;
  stencil    the SVGF kernels within rtol = atol = 2e-4 of their plain
             versions (the JAX package's own bar between its XLA forms and
             its stencil kernels, tests/test_pallas_svgf.py);
  paged      (the paged-table pass kernels, K6) resident pass: every
             output bit-equal (t, tri, portal lists, overflow counts); page
             pass and the whole paged closest-hit trace by the traversal
             bar: t bit-equal on every lane, hit masks equal, tri equal on
             > 0.98 of the hits and, where it differs, the kernel's
             triangle, read from the leaf rows of the paged tables, met at
             the same t (compare_stream_closest); any-hit exactly equal.
"""

from __future__ import annotations

import torch

T_RTOL = 1e-4
TRI_MATCH_COHERENT = 0.995
TRI_MATCH_INCOHERENT = 0.98
UV_ATOL = 1e-4
SHADE_RTOL, SHADE_ATOL = 1e-4, 1e-5
MASK_AGREE = 0.999
IMAGE_REL_RMSE = 3e-3
RAY_COUNT_REL = 5e-3
STENCIL_TOL = 2e-4


def retest(tables, o, d, tri, inst):
    """(t, u, v) at which the triangle `tri` (merged tables: prim code;
    two-level: leaf-order triangle id, in instance `inst`) meets each ray
    (o, d), by the plain triangle test (wide_traverse.leaf_hits, no upper
    bound; two-level: the ray in the instance's space by its inverse
    transform, in the kernels' term order); NaN where it misses or the
    tables do not hold it."""
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    rows = tables.rows
    cap = wt.LEAF_CAP
    K = tri.shape[0]
    nan = torch.full((K,), float("nan"), device=rows.device)
    slots = torch.arange(cap, device=rows.device)
    valid = ((rows[:, 0:1] >= 0) & (slots[None, :] < rows[:, 0:1].long())).flatten()
    pos = torch.nonzero(valid).flatten()
    inst_rows = torch.nonzero(rows[:, 0] < 0).flatten()
    if K == 0 or pos.numel() == 0 or (tables.two_level and inst_rows.numel() == 0):
        return nan, nan, nan
    ids, order = torch.sort(rows[:, 1:1 + cap].long().flatten()[pos])
    at = torch.searchsorted(ids, tri.long()).clamp(max=ids.numel() - 1)
    found = ids[at] == tri.long()
    where = pos[order[at]]
    row, slot = where // cap, where % cap
    if tables.two_level:
        inst_ids, inst_order = torch.sort(rows[inst_rows, 1].long())
        ia = torch.searchsorted(inst_ids, inst.long()).clamp(max=inst_ids.numel() - 1)
        found = found & (inst_ids[ia] == inst.long())
        m = rows[inst_rows[inst_order[ia]], 2:14]
        o, d = wt._affine_rows(m, o, True), wt._affine_rows(m, d, False)
    hit, t, u, v = wt.leaf_hits(rows[row], o, d, torch.full((K,), float("inf"),
                                                             device=rows.device))
    pick = slot[:, None]
    ok = found & torch.gather(hit, 1, pick).flatten()
    return tuple(torch.where(ok, torch.gather(x, 1, pick).flatten(), nan) for x in (t, u, v))


def compare_closest(a, b, tri_match: float, with_uv: bool, rays) -> float:
    """Kernel hit `a` vs plain hit `b` on the rays `rays` = (tables, o, d) by
    the tie-aware bar: hit masks equal; t bit-equal on every hit (the
    closest t is the minimum over the same triangle tests, whatever the
    order of the visits); tri (two-level: tri and inst) equal on more than
    `tri_match` of the hits; where they differ, the kernel's triangle,
    re-tested on that ray by the plain triangle test, meets it at the same
    t (an exact tie, which either order may resolve to either triangle); u,
    v within UV_ATOL where the ids agree, and where they differ within
    UV_ATOL of the re-tested triangle's (the kernel's u, v must be those of
    the triangle it names). Returns max |dt| on the hits."""
    hit_a, hit_b = a.tri >= 0, b.tri >= 0
    if not torch.equal(hit_a, hit_b):
        raise AssertionError(f"hit masks differ on {int((hit_a != hit_b).sum())} rays")
    both = hit_a
    if not bool(both.any()):
        return 0.0
    ta, tb = a.t[both], b.t[both]
    rel = ((ta - tb).abs() / tb.abs().clamp(min=1e-30)).max().item()
    if rel > T_RTOL:
        raise AssertionError(f"t rel err {rel} > {T_RTOL}")
    if not torch.equal(ta, tb):
        raise AssertionError(f"t not bit-equal on {int((ta != tb).sum())} of "
                             f"{ta.numel()} hits (max rel err {rel:.3g})")
    same = both & (a.tri == b.tri)
    if a.inst is not None or b.inst is not None:
        same = same & (a.inst == b.inst)
    match = same[both].float().mean().item()
    if match <= tri_match:
        raise AssertionError(f"tri match {match} <= {tri_match}")
    differ = torch.nonzero(both & ~same).flatten()
    uv = 0.0
    if differ.numel():
        tables, o, d = rays
        t_re, u_re, v_re = retest(tables, o[differ], d[differ], a.tri[differ],
                                  None if a.inst is None else a.inst[differ])
        false = int((t_re != a.t[differ]).sum())  # NaN: a miss
        if false:
            raise AssertionError(f"ids differ on {differ.numel()} hits, {false} of them "
                                 f"not at an exact tie in t")
        if with_uv:
            uv = max((a.u[differ] - u_re).abs().max().item(),
                     (a.v[differ] - v_re).abs().max().item())
            if not uv <= UV_ATOL:
                raise AssertionError(f"u/v err {uv} > {UV_ATOL} at the {differ.numel()} "
                                     f"tie-swapped ids")
    if with_uv:
        uv = max(uv, (a.u - b.u)[same].abs().max().item(),
                 (a.v - b.v)[same].abs().max().item())
        if uv > UV_ATOL:
            raise AssertionError(f"u/v err {uv} > {UV_ATOL}")
    return (a.t - b.t)[both].abs().max().item()


def stream_leaf_rows(tables) -> torch.Tensor:
    """The leaf rows of paged tables (stream_traverse.StreamTables): every
    row a leaf ref of the resident walk (from row 0) or of a page walk (from
    a portal's root row) reaches, as one (L, 128) tensor."""
    from gpu_raytracer_tpu_torch.ops.stream_traverse import PORTAL_BASE

    dev = tables.resident.device
    flat = tables.pages.reshape(-1, 128)
    found = []
    for table, front, base in (
            (tables.resident, torch.zeros(1, dtype=torch.int64, device=dev), None),
            (flat, (tables.portal_page.long() * tables.page_rows
                    + tables.portal_root.long()), tables.page_rows)):
        while front.numel():
            refs = table[front, 48:56].long()
            # Page refs are local to their page: made global by its base.
            off = (front - front % base)[:, None] if base else torch.zeros_like(refs)
            leaf = (refs <= -2) & (refs > -(2 + PORTAL_BASE))
            found.append(table[(-refs - 2 + off)[leaf]])
            front = (refs + off)[refs >= 0]
    return torch.cat(found) if found else flat[:0]


def compare_stream_closest(a, b, rays) -> float:
    """A paged closest-hit result `a` (the page pass's running best, or the
    whole trace's StreamHit) vs the plain version's `b`, both (t, tri), on
    the rays `rays` = (StreamTables, o, d): t bit-equal on every lane (a
    miss carries the running best through, or +inf), then
    compare_closest's tie-aware bar with the triangles re-tested from the
    paged tables' leaf rows. Returns max |dt| on the hits."""
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    ta, tb = a[0], b[0]
    if not torch.equal(ta, tb):
        raise AssertionError(f"t not bit-equal on {int((ta != tb).sum())} of "
                             f"{ta.numel()} lanes")
    tables, o, d = rays
    leaves = wt.WideTables(tables.resident[:0], stream_leaf_rows(tables), 0)
    return compare_closest(wt.Hit(ta, a[1]), wt.Hit(tb, b[1]), TRI_MATCH_INCOHERENT,
                           False, (leaves, o, d))


def compare_binary(a, b) -> float:
    """Binary-traversal kernel hit `a` vs plain hit `b` (equal ids); returns
    the max |dt| over the hits."""
    if not torch.equal(a.tri >= 0, b.tri >= 0):
        raise AssertionError(f"hit masks differ on {int(((a.tri >= 0) != (b.tri >= 0)).sum())} rays")
    for k in ("tri", "inst"):
        if not torch.equal(getattr(a, k), getattr(b, k)):
            raise AssertionError(f"{k} differs on {int((getattr(a, k) != getattr(b, k)).sum())} rays")
    hit = b.tri >= 0
    if not bool(hit.any()):
        return 0.0
    for k, atol in (("t", 0.0), ("u", 1e-7), ("v", 1e-7)):
        x, y = getattr(a, k)[hit], getattr(b, k)[hit]
        bad = int(((x - y).abs() > atol + T_RTOL * y.abs()).sum())
        if bad:
            raise AssertionError(f"{k} beyond rtol {T_RTOL} on {bad} rays")
    return (a.t - b.t)[hit].abs().max().item()


def compare_stream_pass(a, b, fields) -> float:
    """A paged-table pass kernel's outputs `a` vs its plain version's `b`
    (tuples named by `fields`) by the exact bar: every field (ids, portal
    lists, overflow counts, t, portal entry t) bit-equal. Returns 0.0."""
    for name, x, y in zip(fields, a, b):
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{name} differs on "
                                 f"{int((x != y).sum()) if x.shape == y.shape else 'all'} "
                                 f"entries")
    return 0.0


def compare_any(a, b) -> float:
    if not torch.equal(a, b):
        raise AssertionError(f"occlusion differs on {int((a != b).sum())} rays")
    return 0.0


# Each continuous shade output is compared where the caller consumes it:
# the next ray and its pdf on lanes alive in both, the shadow ray and its
# illumination on lanes that trace it in both, the rest on every lane.
SHADE_OUTPUT_LANES = {
    "radiance_add": "all", "throughput": "all", "shadow_tmax": "all",
    "ray_o": "alive", "ray_d": "alive", "last_pdf": "alive",
    "shadow_o": "shadow", "shadow_d": "shadow", "illumination": "shadow",
}


def compare_shade(a: dict, b: dict) -> float:
    """Kernel (or port) outputs `a` vs reference outputs `b`. A lane agrees
    when its masks (alive, prev_allow_nee, is_transmission, shadow_tmax > 0)
    agree and every continuous output it consumes is within rtol 1e-4,
    atol 1e-5; at least 99.9% of lanes must agree. The rare rest are
    flip-like: a mask threshold, or a grazing or near-critical-angle sample
    whose direction amplifies a one-ulp difference (a different
    multiply-add rounding) past the tolerance. Returns the max |diff| over
    the agreeing lanes."""
    R = a["alive"].shape[0]
    sa, sb = a["shadow_tmax"] > 0, b["shadow_tmax"] > 0
    ok = (sa == sb)
    for k in ("alive", "prev_allow_nee", "is_transmission"):
        if k in a or k in b:  # the fused shade (K7) has no is_transmission
            ok &= a[k] == b[k]
    lanes = {"all": torch.ones_like(ok), "alive": a["alive"] & b["alive"],
             "shadow": sa & sb}
    for k, which in SHADE_OUTPUT_LANES.items():
        close = (a[k] - b[k]).abs() <= SHADE_ATOL + SHADE_RTOL * b[k].abs()
        if close.dim() == 2:
            close = close.all(dim=1)
        ok &= close | ~lanes[which]
    agree = ok.float().mean().item()
    if agree < MASK_AGREE:
        raise AssertionError(f"shade outputs agree on {agree} of {R} lanes "
                             f"< {MASK_AGREE}")
    worst = 0.0
    for k, which in SHADE_OUTPUT_LANES.items():
        m = ok & lanes[which]
        if bool(m.any()):
            worst = max(worst, (a[k] - b[k])[m].abs().max().item())
    return worst


def shade_lanes_differ(a: dict, b: dict) -> int:
    """Lanes on which two shade kernels' outputs `a` and `b` differ by a bit
    where compare_shade reads them: the masks, and each continuous output on
    the lanes SHADE_OUTPUT_LANES names (taken from `b`). Used to hold a
    redesigned kernel to the kernel it replaces."""
    sb = b["shadow_tmax"] > 0
    differ = (a["shadow_tmax"] > 0) != sb
    for k in ("alive", "prev_allow_nee", "is_transmission"):
        if k in a or k in b:
            differ |= a[k] != b[k]
    lanes = {"all": torch.ones_like(differ), "alive": b["alive"], "shadow": sb}
    for k, which in SHADE_OUTPUT_LANES.items():
        # Bit patterns, so that NaN == NaN and -0.0 != 0.0.
        ne = a[k].view(torch.int32) != b[k].view(torch.int32)
        if ne.dim() == 2:
            ne = ne.any(dim=1)
        differ |= ne & lanes[which]
    return int(differ.sum())


def compare_images(a, b, rays_a: int, rays_b: int) -> float:
    """Two (H, W, 3) numpy frames and their ray counts by the image bar;
    returns the rel-RMSE."""
    import numpy as np

    rel_rmse = float(np.sqrt(np.mean((a - b) ** 2)) / max(float(a.mean()), 1e-6))
    if not rel_rmse < IMAGE_REL_RMSE:
        raise AssertionError(f"image rel-RMSE {rel_rmse} >= {IMAGE_REL_RMSE}")
    if abs(rays_a - rays_b) > RAY_COUNT_REL * max(rays_b, 1):
        raise AssertionError(f"ray counts {rays_a} vs {rays_b} differ by more "
                             f"than {RAY_COUNT_REL}")
    return rel_rmse


def compare_stencil(a, b) -> float:
    """Kernel vs plain (8, H, W) stencil outputs, |a - b| <= atol + rtol |b|
    everywhere; returns the max |a - b|."""
    bad = ((a - b).abs() > STENCIL_TOL + STENCIL_TOL * b.abs()).sum().item()
    if bad:
        raise AssertionError(f"stencil outputs differ beyond {STENCIL_TOL} at "
                             f"{bad} of {a.numel()} values")
    return (a - b).abs().max().item()


def synthetic_mixed_tables(device):
    """Material/KC/light tables covering all five material types, for the
    kernel-vs-plain comparison of every BSDF branch (any values do).
    Returns ((mat, kc, lgt), number of materials)."""
    g = torch.Generator().manual_seed(5)
    M, L = 6, 3
    mat = torch.zeros(16, M)
    mat[0] = torch.tensor([0, 1, 2, 3, 4, 1], dtype=torch.float32)
    mat[1:4, 0] = torch.tensor([8.0, 7.0, 6.0])
    mat[4:7] = torch.rand(3, M, generator=g) * 0.8 + 0.1
    mat[7] = torch.tensor([0.5, 0.5, 0.3, 0.35, 0.4, 0.02])
    mat[8] = 1.5
    mat[9:12] = torch.tensor([0.13, 0.45, 1.43])[:, None]
    mat[12:15] = torch.tensor([3.98, 2.38, 1.60])[:, None]
    kc = torch.zeros(32, M)
    for base in (0, 8, 16):  # E(cos) curves in [0.4, 0.95]: low-order polys
        kc[base + 6] = torch.rand(M, generator=g) * 0.2 + 0.1
        kc[base + 7] = torch.rand(M, generator=g) * 0.3 + 0.5
    kc[24:28] = torch.rand(4, M, generator=g) * 0.5 + 0.3
    kc[28:31] = torch.rand(3, M, generator=g) * 0.2
    kc[31] = torch.rand(M, generator=g) * 0.5 + 0.4
    lgt = torch.zeros(16, L)
    lgt[0] = torch.tensor([0.3, 0.7, 1.0])
    lgt[1:4] = torch.rand(3, L, generator=g) * 2 - 1
    lgt[4:10] = torch.rand(6, L, generator=g) * 0.5
    lgt[10:13] = 5.0
    return tuple(x.to(device) for x in (mat, kc, lgt)), M


def mixed_fused_args(args):
    """Fused shade (K7) arguments `args` with every BSDF: the material and
    curve tables replaced by synthetic_mixed_tables' and the scene's
    instances given its materials in turn (instance i takes material i mod
    M), the lanes and the light table kept."""
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs

    tables = list(fs.plain_tables(args[0]))
    dev = tables[0].device
    (mat, kc, _), M = synthetic_mixed_tables(dev)
    inst_a = tables[2].clone()
    inst_a[12] = (torch.arange(inst_a.shape[1], device=dev) % M).float()
    tables[2], tables[4], tables[5] = inst_a, mat, kc
    return (fs.make_tables(tuple(tables)),) + tuple(args[1:])


def deep_binary_tables(depth: int = 80, seed: int = 0):
    """Hand-made binary tables (node_mat, inst_mat, tri_mat: the (16, n)
    column-major layout of binary_traverse.pack_tables, numpy float32) whose
    BLAS is a chain `depth` interior nodes deep, deeper than the traversal's
    48-entry stack: node 0 is an instance leaf (identity transform, RESTORE
    pushed) over chain node 1; chain node k has a leaf child and the next
    chain node, in an order drawn from `seed`. Four of five leaves lie past
    the whole chain (z near 1000 - k, one triangle covering every ray of
    `deep_binary_rays`), so a +z ray pushes them and its stack fills: the
    pushes past 48 entries are dropped and their leaves lost. The other
    leaves lie just before their next chain node (z = k + 0.5) and hold a
    small triangle that some rays hit, which ends those rays' descent early.
    The chain ends in a leaf at z = 1500."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_nodes = 2 + 2 * depth
    node = np.zeros((16, n_nodes), np.float32)
    tri = np.zeros((16, depth + 1), np.float32)
    inst = np.zeros((16, 1), np.float32)
    inst[0:12, 0] = np.eye(3, 4, dtype=np.float32).reshape(12)
    inst[12, 0] = 1.0  # the BLAS root
    node[12, 0], node[13, 0] = 0.0, -1.0  # instance leaf of instance 0

    def leaf_box(z):
        return [-2.0, -2.0, z - 0.01, 2.0, 2.0, z + 0.01]

    chain = 1
    for k in range(depth):
        left = 2 + 2 * k
        far = rng.random() < 0.8
        if far:  # one triangle over every ray
            z = 1000.0 - k
            tri[0:9, k] = [-3.0, -3.0, z, 8.0, 0.0, 0.0, 0.0, 8.0, 0.0]
        else:  # a small triangle just before the next chain node
            z = k + 0.5
            x, y = rng.uniform(-1.0, 0.7, 2)
            tri[0:9, k] = [x, y, z, 0.3, 0.0, 0.0, 0.0, 0.3, 0.0]
        leaf_first = rng.random() < 0.5
        leaf, nxt = (left, left + 1) if leaf_first else (left + 1, left)
        boxes = {leaf: leaf_box(z), nxt: [-2.0, -2.0, k + 1.0, 2.0, 2.0, 2000.0]}
        node[0:6, chain] = boxes[left]
        node[6:12, chain] = boxes[left + 1]
        node[12, chain], node[13, chain] = left, 0.0
        node[12, leaf], node[13, leaf] = k, 1.0
        chain = nxt
    tri[0:9, depth] = [-3.0, -3.0, 1500.0, 8.0, 0.0, 0.0, 0.0, 8.0, 0.0]
    node[12, chain], node[13, chain] = depth, 1.0
    return node, inst, tri


def deep_binary_rays(n: int = 1024, seed: int = 0):
    """(o, d, t_max) numpy float32 for `deep_binary_tables`: +z rays (tilted
    by up to 0.002) from z = -1 over x, y in [-1, 1]; a tenth dead (t_max
    0), a fifth with a finite t_max in (2, 1200)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-1.0, 1.0, (n, 2)), np.full((n, 1), -1.0)], 1)
    d = np.concatenate([rng.uniform(-0.002, 0.002, (n, 2)), np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, np.inf)
    finite = rng.random(n) < 0.2
    t_max[finite] = rng.uniform(2.0, 1200.0, int(finite.sum()))
    t_max[rng.random(n) < 0.1] = 0.0
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


def capture_wave(pt, wave: int, with_aovs: bool = False, route: str = "wide",
                 sample: int = 0, every: bool = False) -> dict:
    """Run the first `wave` pixels (tile order) of sample `sample` through
    `render_wave` on `route` (one of pathtracer.ROUTE_ROLES) with
    recording wrappers around the dispatching kernels of `pt` (a
    `Pathtracer` with its tables built; on the wide route merged or
    two-level: the captured tables carry the layout, so the same capture
    serves the two-level roles). Returns {role: (args, kwargs)} of each
    role's first call (closest hit and K3 shade: bounce 1; any hit: the
    bounce-0 shadow wave; fused shade and paged closest hit: bounce 0), or
    with `every` a list of
    every call. `with_aovs` traces as the denoised path does: under
    enable_svgf the shade call then demodulates (demod=True, rr_albedo)."""
    from gpu_raytracer_tpu_torch.integrators import pathtracer as ptm
    from gpu_raytracer_tpu_torch.ops.camera_rays import camera_tensors, tile_order

    got = {}

    def rec(role):
        fn = getattr(ptm.DISPATCH, role)

        def wrapped(*args, **kw):
            got.setdefault(role, []).append((args, kw))
            return fn(*args, **kw)
        return wrapped

    ks = ptm.KernelSet(*(rec(r) for r in ptm.KernelSet._fields))
    dev = pt.device
    order = torch.as_tensor(tile_order(pt.width, pt.height)[:wave].astype("int64"),
                            device=dev)
    ptm.render_wave(pt.buffers, camera_tensors(pt.scene.camera.params(), dev),
                    order, sample, pt.gpu_config, pt.width, pt.cpu_config.seed,
                    pt.scene.has_lights, kernels=ks, with_aovs=with_aovs,
                    route=route)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    missing = [r for r in ptm.ROUTE_ROLES[route] if r not in got]
    if missing:
        raise AssertionError(f"roles never called in the captured wave: {missing}")
    return got if every else {k: v[0] for k, v in got.items()}


def capture_svgf(pt, frames: int) -> dict:
    """Render `frames` denoised frames with `pt` (a `Pathtracer` with
    enable_svgf, history carried on), recording the last frame's calls of
    the two SVGF roles. Returns {"svgf_variance": [(args, kwargs)],
    "svgf_atrous": [(args, kwargs), ...]} (one a-trous call per iteration)
    and the history lengths the last frame saw, under "length"."""
    from gpu_raytracer_tpu_torch.integrators import pathtracer as ptm

    got = {"svgf_variance": [], "svgf_atrous": []}

    def rec(role):
        fn = getattr(ptm.DISPATCH, role)

        def wrapped(*args, **kw):
            got[role].append((args, kw))
            return fn(*args, **kw)
        return wrapped

    for _ in range(frames - 1):
        pt.render_frame_denoised()
    kernels = pt.kernels
    pt.kernels = kernels._replace(svgf_variance=rec("svgf_variance"),
                                  svgf_atrous=rec("svgf_atrous"))
    try:
        pt.render_frame_denoised()
    finally:
        pt.kernels = kernels
    got["length"] = pt.svgf_history.length
    return got
