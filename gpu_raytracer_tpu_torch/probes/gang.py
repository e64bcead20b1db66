"""Gang-traversal probes: the Hopper counterparts of two TPU probes.

  ablate  <- tools/exp_gang_ablate.py `_kernel`: a fixed-iteration copy of
             ops/pallas_gang.py `_gang_flat_kernel` (K2 on merged tables),
             with ten ablation variants that price each part of one
             iteration (`ABLATE_VARIANTS`);
  micro   <- tools/exp_gang_micro.py `_kernel`: the same iteration built up
             stage by stage on synthetic rays (`MICRO_STAGES`).

The gang design: a 1024-ray tile is 8 gangs of 128 lanes (ray
`tile * 1024 + g * 128 + l` is gang g, lane l), each gang keeps ONE stack
and one leaf queue. A node's child is pushed when any live lane of the gang
enters it before its own best hit, keyed by the minimum entry distance over
the gang, and the gang's children are sorted by that key with a Batcher
network. Leaves are queued, and a tile runs a triangle phase (every gang
pops one queued leaf row and each lane tests its triangles) once any gang
holds QTRIG queued leaves or has an empty stack with leaves queued; else a
node phase. The port's render path keeps one stack per ray (K2,
`csrc/wide_traverse.cu`); this probe prices the shared stack on the H100.

Variants (`ablate`): full; node-only / tri-only (phase forced); nosort;
nopush (no pushes: each node phase grows the stack pointer by 2, so later
pops read entries nobody pushed); nopushst (pushes computed, every entry
stored to the scrap slot); noload (every gang loads row 0); nored (child key
from lane 0 instead of the gang minimum); pushbase (all 8 refs stored at
consecutive slots, the pointer advanced by the count of nodes); sorthalf
(the first 9 of the 19 swaps). The scratch stack and queue start zeroed,
so the variants that pop entries nobody wrote (nopush, nopushst) are
deterministic here; the TPU kernel pops uninitialised scratch.

Stages (`micro`): loop (fixed node ids), pop (stack pops), load (the popped
row, accumulated), slab (child keys: slab test and gang minimum), sort (the
19-swap network), push (conditional pushes, the stack pointer capped at 8).

On a CUDA tensor `ablate` / `micro` launch `csrc/probe_gang.cu`
(`pg_ablate<VARIANT>`: one block of 8 warps a tile, a warp a gang, 4 rays a
thread, the 19 swaps as the six compare-swap layers of `LAYERS`, the
pushes lane-parallel; `pg_micro<STAGE>`: the same warp a gang, stage by
stage, one 32-thread block a gang, the capped pushes one ballot) and raise
if they cannot; on a CPU tensor they run `ablate_plain` / `micro_plain`,
the plain PyTorch versions: the same arithmetic in the same order,
vectorised over tiles, gangs and lanes, the fixed-iteration loop in
Python, the per-gang pushes as 8 scatter steps. Min/max are NaN-ignoring (torch.fmin/fmax, the kernel's
fminf/fmaxf); float-to-int conversions truncate and saturate as the
kernel's casts do (`trunc_i32`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gpu_raytracer_tpu_torch.ops import _native
from gpu_raytracer_tpu_torch.probes import c_ptr, c_stream
from gpu_raytracer_tpu_torch.ops.wide_traverse import INFO, OPS_PER_TRIANGLE, _inv1

# The JAX probes' constants (ops/pallas_gang.py, ops/pallas_wide.py and the
# two tools), copied: the port imports nothing of the JAX package.
GANGS = 8
LANES = 128
BLOCK = GANGS * LANES        # rays per tile
QTRIG = 8                    # queued leaves that trigger a triangle phase
LEAFQ_DEPTH = QTRIG + 7      # node phases run only while every gang < QTRIG
STACK_DEPTH = 160
LEAF_CAP = 12
IDLE = -2_000_000_000        # popped by a gang whose stack is empty
_DIV_EPS = 1e-12
_RAY_EPS = 1e-4
SCRAP = STACK_DEPTH          # one trash slot per gang at the end of each stack
QSCRAP = LEAFQ_DEPTH
K_ITERS = 256                # exp_gang_ablate.py
N_ITERS = 512                # exp_gang_micro.py
TILES = 64
MICRO_ROWS = 14265           # exp_gang_micro.py cuts the unified table here
MICRO_CAP = 8                # the micro push stage caps the stack pointer

ABLATE_VARIANTS = ("full", "node-only", "tri-only", "nosort", "nopush",
                   "nopushst", "noload", "nored", "pushbase", "sorthalf")
MICRO_STAGES = ("loop", "pop", "load", "slab", "sort", "push")

SWAPS = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
         (1, 2), (3, 4), (5, 6))
SWAPS_HALF = SWAPS[:9]
# The same swaps as layers of disjoint pairs, each run at once by pg_ablate
# (one shuffle exchange among 8 lanes a layer): SWAPS in order, (1, 2) and
# (5, 6) merged; sorthalf stops after (1, 2).
LAYERS = (((0, 1), (2, 3), (4, 5), (6, 7)), ((0, 2), (1, 3), (4, 6), (5, 7)),
          ((1, 2), (5, 6)), ((0, 4), (1, 5), (2, 6), (3, 7)), ((2, 4), (3, 5)),
          ((1, 2), (3, 4), (5, 6)))
LAYERS_HALF = LAYERS[:2] + (((1, 2),),)
TILE_THREADS = GANGS * 32    # pg_ablate: one warp a gang


def layer_map(layer) -> int:
    """A layer as csrc/probe_gang.cu encodes it: nibble c holds child c's
    partner (c itself where it sits out)."""
    partner = list(range(8))
    for a, b in layer:
        partner[a], partner[b] = b, a
    return sum(p << (4 * c) for c, p in enumerate(partner))

# Launch counts: a kernel's count rises only where the kernel is launched; a
# plain version's only where the plain version runs.
launches = {"pg_ablate": 0, "pg_micro": 0}
plain_calls = {"pg_ablate": 0, "pg_micro": 0}

# `last_work` holds the latest plain ablate call's visits: gang node visits,
# gang leaf visits, triangles tested by a gang (each by its 128 lanes) and
# the distinct table rows loaded (`ablation_bytes_ops` counts from them).
last_work = {"node_visits": 0, "leaf_visits": 0, "triangles": 0, "rows": 0}


class GangTable(NamedTuple):
    """The unified table the gang kernel reads: [nodes; leaf rows]."""
    table: torch.Tensor  # (N + L, 128) f32
    num_nodes: int


class GangHit(NamedTuple):
    t: torch.Tensor      # (R,) f32, +inf on a miss
    tri: torch.Tensor    # (R,) i32 prim code, -1 on a miss
    iters: torch.Tensor  # (G,) i32 iterations each tile ran


def gang_table(tables) -> GangTable:
    """Unified table of merged wide tables (`wide_traverse.WideTables`), as
    the JAX probe concatenates `[nodes; rows]`."""
    if getattr(tables, "two_level", False):
        raise ValueError("the gang probe takes merged wide tables")
    return GangTable(torch.cat([tables.nodes, tables.rows]).contiguous(),
                     int(tables.nodes.shape[0]))


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 truncating toward zero and saturating, NaN -> 0: the
    kernel's (int) cast (cvt.rzi.s32.f32)."""
    lo, hi = -2147483648.0, 2147483520.0  # 2^31 - 128: the largest f32 < 2^31
    y = torch.nan_to_num(x, nan=0.0).clamp(lo, hi).to(torch.int32)
    return torch.where(x >= 2147483648.0, torch.tensor(2147483647, dtype=torch.int32,
                                                        device=x.device), y)


def pad_wave(wave):
    """The rays padded to whole tiles with dead lanes (t_max 0), contiguous
    (returned as they are when they fill whole tiles already)."""
    ray_o, ray_d, t_max = wave
    pad = -t_max.shape[0] % BLOCK
    if pad == 0 and t_max.shape[0]:
        return ray_o.contiguous(), ray_d.contiguous(), t_max.contiguous()
    pad = pad or BLOCK
    return (F.pad(ray_o, (0, 0, 0, pad)).contiguous(), F.pad(ray_d, (0, 0, 0, pad)).contiguous(),
            F.pad(t_max, (0, pad)).contiguous())


def _tiles(wave):
    """Rays padded to whole tiles with dead lanes (t_max 0), as (G, 8, 128)
    planes: ox, oy, oz, dx, dy, dz, t_max; and R, G."""
    R = wave[2].shape[0]
    o, d, tm = pad_wave(tuple(x.float() for x in wave))
    G = tm.shape[0] // BLOCK
    planes = [x.reshape(G, GANGS, LANES) for x in (*o.unbind(1), *d.unbind(1), tm)]
    return planes, R, G


def _slab(row, ox, oy, oz, ix, iy, iz):
    """Entry and exit distances (tn, tf) of the 8 child boxes of each gang's
    row (G, 8, 128) for every lane: (G, 8, 128, 8) each."""
    b = row[..., :48].reshape(*row.shape[:-1], 1, 8, 6)
    ox, oy, oz, ix, iy, iz = (x[..., None] for x in (ox, oy, oz, ix, iy, iz))
    tx0 = (b[..., 0] - ox) * ix
    tx1 = (b[..., 3] - ox) * ix
    ty0 = (b[..., 1] - oy) * iy
    ty1 = (b[..., 4] - oy) * iy
    tz0 = (b[..., 2] - oz) * iz
    tz1 = (b[..., 5] - oz) * iz
    tn = torch.fmax(torch.fmax(torch.fmin(tx0, tx1), torch.fmin(ty0, ty1)),
                    torch.fmin(tz0, tz1))
    tf = torch.fmin(torch.fmin(torch.fmax(tx0, tx1), torch.fmax(ty0, ty1)),
                    torch.fmax(tz0, tz1))
    return tn, tf


def _sort(keys, refs, swaps):
    """Compare-swap network on (.., 8) keys and refs (lists of columns)."""
    keys, refs = list(keys.unbind(-1)), list(refs.unbind(-1))
    for a, b in swaps:
        swap = keys[a] > keys[b]
        keys[a], keys[b] = (torch.where(swap, keys[b], keys[a]),
                            torch.where(swap, keys[a], keys[b]))
        refs[a], refs[b] = (torch.where(swap, refs[b], refs[a]),
                            torch.where(swap, refs[a], refs[b]))
    return torch.stack(keys, -1), torch.stack(refs, -1)


def _tri_phase(row, rays, alive, best_t, best_tri):
    """Every lane tests the LEAF_CAP triangles of its gang's leaf row
    (G, 8, 128) in slot order, strict t < best: (best_t, best_tri)."""
    ox, oy, oz, dx, dy, dz = (x[..., None] for x in rays)
    shape = row.shape[:-1]
    g = row[..., 16:16 + 9 * LEAF_CAP].reshape(*shape, 1, LEAF_CAP, 9)
    p0x, p0y, p0z = g[..., 0], g[..., 1], g[..., 2]
    e1x, e1y, e1z = g[..., 3], g[..., 4], g[..., 5]
    e2x, e2y, e2z = g[..., 6], g[..., 7], g[..., 8]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(a.abs() < _DIV_EPS, _DIV_EPS, a)
    sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    w = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    slots = torch.arange(LEAF_CAP, dtype=torch.float32, device=row.device)
    hit = (alive[..., None] & (slots < row[..., 0:1])[..., None, :]
           & (a.abs() >= _DIV_EPS) & (u >= 0.0) & (u <= 1.0) & (w >= 0.0)
           & (u + w <= 1.0) & (t > _RAY_EPS) & (t < best_t[..., None]))
    # The sequential strict-< update keeps the FIRST slot at the minimum t:
    # torch.min does too.
    tbest, j = torch.where(hit, t, float("inf")).min(dim=-1)
    tid = trunc_i32(row[..., 1:1 + LEAF_CAP])[..., None, :].expand(*t.shape)
    found = hit.any(dim=-1)
    return (torch.where(found, tbest, best_t),
            torch.where(found, torch.gather(tid, -1, j[..., None])[..., 0], best_tri))


def ablate_plain(gt: GangTable, wave, variant: str = "full", k_iters: int = K_ITERS,
                 converge: bool = False) -> GangHit:
    """Plain PyTorch version of `pg_ablate` (any device). `converge` ends a
    tile once every gang's stack and queue are empty (k_iters is then a
    cap); the iterations each tile ran come back in `iters`."""
    if variant not in ABLATE_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {ABLATE_VARIANTS}")
    plain_calls["pg_ablate"] += 1
    table, N = gt.table, gt.num_nodes
    L = table.shape[0] - N
    dev = table.device
    (ox, oy, oz, dx, dy, dz, tm), R, G = _tiles(wave)
    rays = (ox, oy, oz, dx, dy, dz)
    ix, iy, iz = _inv1(dx), _inv1(dy), _inv1(dz)
    dead = tm <= 0.0
    inf = torch.tensor(float("inf"), device=dev)
    best_t = tm.clone()
    best_tri = torch.full((G, GANGS, LANES), -1, dtype=torch.int32, device=dev)
    sps = torch.ones((G, GANGS), dtype=torch.int64, device=dev)
    lqs = torch.zeros((G, GANGS), dtype=torch.int64, device=dev)
    stack = torch.zeros((G, GANGS, STACK_DEPTH + 1), dtype=torch.int32, device=dev)
    leafq = torch.zeros((G, GANGS, LEAFQ_DEPTH + 1), dtype=torch.int32, device=dev)
    iters = torch.zeros(G, dtype=torch.int32, device=dev)
    loaded = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    work = torch.zeros(3, dtype=torch.int64, device=dev)  # node, leaf visits, tris
    swaps = () if variant == "nosort" else SWAPS_HALF if variant == "sorthalf" else SWAPS

    for _ in range(k_iters):
        if converge:
            busy = ((sps > 0) | (lqs > 0)).any(dim=1)
            if not bool(busy.any()):
                break
            iters += busy.to(torch.int32)
        else:
            iters += 1
        if variant == "node-only":
            trig = torch.zeros(G, dtype=torch.bool, device=dev)
        elif variant == "tri-only":
            trig = torch.ones(G, dtype=torch.bool, device=dev)
        else:
            trig = ((lqs >= QTRIG) | ((sps == 0) & (lqs > 0))).any(dim=1)
        node_g = ~trig[:, None].expand(G, GANGS)

        # ---- triangle phase (committed on the tiles with trig) ----
        has = lqs > 0
        qm = torch.where(has, lqs - 1, 0)
        rid = torch.where(has, leafq.gather(2, qm[..., None])[..., 0], -1)
        lrow = table[N + rid.clamp(0, L - 1).long()]
        tri_t, tri_tri = _tri_phase(lrow, rays, (rid >= 0)[..., None] & ~dead,
                                    best_t, best_tri)
        tri_tiles = trig[:, None, None]
        best_t = torch.where(tri_tiles, tri_t, best_t)
        best_tri = torch.where(tri_tiles, tri_tri, best_tri)
        leaf_g = trig[:, None] & (rid >= 0)
        loaded[(N + rid.clamp(0, L - 1))[leaf_g]] = True
        work[1] += leaf_g.sum()
        work[2] += (lrow[..., 0] * leaf_g).sum().long()
        lqs = torch.where(trig[:, None], qm, lqs)

        # ---- node phase (committed on the other tiles) ----
        has = sps > 0
        spm = torch.where(has, sps - 1, 0)
        v = torch.where(has, stack.gather(2, spm[..., None])[..., 0], IDLE)
        sps = torch.where(node_g, spm, sps)
        if variant == "noload":
            row = table[0].expand(G, GANGS, 128)
        else:
            row = table[v.clamp(0, N - 1).long()]
        node_v = v >= 0
        loaded[v.clamp(0, N - 1)[node_g & node_v]] = True
        work[0] += (node_g & node_v).sum()
        tn, tf = _slab(row, ox, oy, oz, ix, iy, iz)
        te = torch.fmax(tn, torch.zeros((), device=dev))
        hit = (tn <= tf) & (tf > 0.0) & (te < best_t[..., None])
        if variant == "nored":
            tmin = torch.where(hit[:, :, 0] & node_v[..., None], te[:, :, 0], inf)
        else:
            tmin = torch.where(hit & node_v[:, :, None, None] & ~dead[..., None],
                               te, inf).amin(dim=2)
        ref = trunc_i32(row[..., 48:56])
        take = (ref != -1) & (tmin < inf)
        keys, refs = _sort(torch.where(take, tmin, inf), torch.where(take, ref, -1), swaps)

        if variant == "nopush":
            sps = torch.where(node_g, (sps + 2).clamp(max=STACK_DEPTH - 1), sps)
        elif variant == "pushbase":
            s0, l0 = sps, lqs
            for c in range(8):
                r = refs[..., c]
                pos = torch.where(node_g, (s0 + c).clamp(max=SCRAP), SCRAP)
                stack.scatter_(2, pos[..., None], r[..., None])
                pos = torch.where(node_g, (l0 + c).clamp(max=QSCRAP), QSCRAP)
                leafq.scatter_(2, pos[..., None], (-r - 2)[..., None])
            nn = (refs >= 0).sum(dim=-1)
            nl = (refs <= -2).sum(dim=-1)
            sps = torch.where(node_g, (s0 + nn).clamp(max=STACK_DEPTH - 1), sps)
            lqs = torch.where(node_g, (l0 + nl).clamp(max=LEAFQ_DEPTH - 1), lqs)
        else:
            scrap_only = variant == "nopushst"
            for c in range(7, -1, -1):
                r = refs[..., c]
                take_n = node_g & (r >= 0) & (sps < STACK_DEPTH)
                pos = torch.full_like(sps, SCRAP) if scrap_only else \
                    torch.where(take_n, sps, SCRAP)
                stack.scatter_(2, pos[..., None], r[..., None])
                sps = sps + take_n.long()
                take_l = node_g & (r <= -2) & (lqs < LEAFQ_DEPTH)
                pos = torch.full_like(lqs, QSCRAP) if scrap_only else \
                    torch.where(take_l, lqs, QSCRAP)
                leafq.scatter_(2, pos[..., None], (-r - 2)[..., None])
                lqs = lqs + take_l.long()

    last_work.update(zip(("node_visits", "leaf_visits", "triangles"), work.tolist()))
    last_work["rows"] = int(loaded.sum())
    t = torch.where(best_tri >= 0, best_t, inf).reshape(-1)[:R]
    return GangHit(t, best_tri.reshape(-1)[:R], iters)


def micro_plain(table: torch.Tensor, rays: torch.Tensor, stage: str = "push",
                n_iters: int = N_ITERS) -> torch.Tensor:
    """Plain PyTorch version of `pg_micro` (any device): table (M, 128) f32,
    rays (T, 8, 128) f32 origins' x -> acc (T, 8, 128) f32."""
    if stage not in MICRO_STAGES:
        raise ValueError(f"stage {stage!r} not in {MICRO_STAGES}")
    plain_calls["pg_micro"] += 1
    dev = table.device
    N = table.shape[0]
    T = rays.shape[0]
    ox = rays.float()
    oy = ox * torch.tensor(1.01, device=dev)
    oz = ox * torch.tensor(0.99, device=dev)
    ix = 1.0 / (ox + torch.tensor(0.5, device=dev))
    iy = 1.0 / (ox + torch.tensor(0.6, device=dev))
    iz = 1.0 / (ox + torch.tensor(0.7, device=dev))
    inf = torch.tensor(float("inf"), device=dev)
    gang = torch.arange(GANGS, device=dev)
    stack = torch.zeros((T, GANGS, STACK_DEPTH + 1), dtype=torch.int32, device=dev)
    stack[:, :, 0] = ((gang * 7919) % N).to(torch.int32)
    sps = torch.ones((T, GANGS), dtype=torch.int64, device=dev)
    acc = torch.zeros((T, GANGS, LANES), device=dev)
    for it in range(n_iters):
        fallback = ((it * 31 + gang * 7919) % N).expand(T, GANGS)
        if stage == "loop":
            vs = fallback
        else:
            has = sps > 0
            spm = torch.where(has, sps - 1, 0)
            vs = torch.where(has, stack.gather(2, spm[..., None])[..., 0].long(), fallback)
            sps = spm
        if stage in ("loop", "pop"):
            acc = acc + vs[:, 0].float()[:, None, None]
            continue
        row = table[vs.clamp(0, N - 1)]
        if stage == "load":
            acc = acc + row
            continue
        tn, tf = _slab(row, ox, oy, oz, ix, iy, iz)
        hit = (tn <= tf) & (tf > 0.0)
        tmin = torch.where(hit, torch.fmax(tn, torch.zeros((), device=dev)), inf).amin(dim=2)
        ref = trunc_i32(row[..., 48:56])
        take = (ref != -1) & (tmin < inf)
        keys, refs = torch.where(take, tmin, inf), torch.where(take, ref, -1)
        if stage in ("sort", "push"):
            keys, refs = _sort(keys, refs, SWAPS)
        if stage == "push":
            for c in range(7, -1, -1):
                r = refs[..., c]
                take = (r != -1) & (sps < STACK_DEPTH)
                stack.scatter_(2, torch.where(take, sps, SCRAP)[..., None], r[..., None])
                sps = torch.where(take, (sps + 1).clamp(max=MICRO_CAP), sps)
        acc = acc + keys[..., 0:1]
    return acc


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_table(table: torch.Tensor):
    if table.dim() != 2 or table.shape[1] != 128 or table.dtype != torch.float32:
        raise ValueError(f"the gang table must be (M, 128) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")


def ablate_kernel(gt: GangTable, wave, variant: str = "full", k_iters: int = K_ITERS,
                  converge: bool = False) -> GangHit:
    """Launch `pg_ablate<variant>` on CUDA tensors (raises otherwise)."""
    if variant not in ABLATE_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {ABLATE_VARIANTS}")
    _check_table(gt.table)
    ray_o, ray_d, t_max = wave
    R = t_max.shape[0]
    if ray_o.shape != (R, 3) or ray_d.shape != (R, 3) or t_max.shape != (R,):
        raise ValueError("rays must be (R, 3), (R, 3), (R,)")
    for x in (ray_o, ray_d, t_max):
        if x.dtype != torch.float32 or x.device != gt.table.device:
            raise ValueError("rays must be float32 on the table's device")
    if gt.table.device.type != "cuda":
        raise RuntimeError("ablate_kernel needs CUDA tensors")
    lib = _native.load()
    dev = gt.table.device
    G = max(1, -(-R // BLOCK))
    o, d, tm = pad_wave(wave)
    t = torch.empty(G * BLOCK, dtype=torch.float32, device=dev)
    tri = torch.empty(G * BLOCK, dtype=torch.int32, device=dev)
    iters = torch.empty(G, dtype=torch.int32, device=dev)
    L = gt.table.shape[0] - gt.num_nodes
    err = lib.pg_ablate(ABLATE_VARIANTS.index(variant), c_ptr(gt.table), gt.num_nodes, L,
                        c_ptr(o), c_ptr(d), c_ptr(tm), G, int(k_iters), int(converge),
                        c_ptr(t), c_ptr(tri), c_ptr(iters), c_stream(dev))
    _native.check(err, f"probe_gang.pg_ablate<{variant}>")
    launches["pg_ablate"] += 1
    return GangHit(t[:R], tri[:R], iters)


def kernel_info(variant: str = "full") -> dict:
    """What the compiler and the occupancy API report for
    `pg_ablate<variant>` on the card (INFO: registers, stack frame and
    static shared bytes, the threads of a block, the blocks an SM holds, the
    SMs)."""
    import ctypes

    lib = _native.load()
    out = (ctypes.c_int * len(INFO))()
    _native.check(lib.pg_kernel_info(ABLATE_VARIANTS.index(variant), out),
                  f"probe_gang.kernel_info({variant})")
    return dict(zip(INFO, list(out)))


def micro_kernel(table: torch.Tensor, rays: torch.Tensor, stage: str = "push",
                 n_iters: int = N_ITERS) -> torch.Tensor:
    """Launch `pg_micro<stage>` on CUDA tensors (raises otherwise)."""
    if stage not in MICRO_STAGES:
        raise ValueError(f"stage {stage!r} not in {MICRO_STAGES}")
    _check_table(table)
    if rays.dim() != 3 or rays.shape[1:] != (GANGS, LANES) or rays.dtype != torch.float32:
        raise ValueError("rays must be (T, 8, 128) float32")
    if table.device.type != "cuda" or rays.device != table.device:
        raise RuntimeError("micro_kernel needs CUDA tensors on one device")
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    lib = _native.load()
    rays = rays.contiguous()
    acc = torch.empty_like(rays)
    err = lib.pg_micro(MICRO_STAGES.index(stage), c_ptr(table), table.shape[0],
                       c_ptr(rays), rays.shape[0], int(n_iters), c_ptr(acc),
                       c_stream(table.device))
    _native.check(err, f"probe_gang.pg_micro<{stage}>")
    launches["pg_micro"] += 1
    return acc


def micro_kernel_info(stage: str = "push") -> dict:
    """What the compiler and the occupancy API report for
    `pg_micro<stage>` (INFO), and its cluster size (1: no cluster)."""
    import ctypes

    lib = _native.load()
    out = (ctypes.c_int * len(INFO))()
    _native.check(lib.pg_micro_info(MICRO_STAGES.index(stage), out),
                  f"probe_gang.micro_kernel_info({stage})")
    return {**dict(zip(INFO, list(out))), "cluster": 1}


def ablate(gt: GangTable, wave, variant: str = "full", k_iters: int = K_ITERS,
           converge: bool = False) -> GangHit:
    """The kernel on a CUDA table, the plain version on a CPU one."""
    if gt.table.device.type == "cuda":
        return ablate_kernel(gt, wave, variant, k_iters, converge)
    if gt.table.device.type == "cpu":
        return ablate_plain(gt, wave, variant, k_iters, converge)
    raise RuntimeError(f"no gang probe for device {gt.table.device}")


def micro(table: torch.Tensor, rays: torch.Tensor, stage: str = "push",
          n_iters: int = N_ITERS) -> torch.Tensor:
    """The kernel on a CUDA table, the plain version on a CPU one."""
    if table.device.type == "cuda":
        return micro_kernel(table, rays, stage, n_iters)
    if table.device.type == "cpu":
        return micro_plain(table, rays, stage, n_iters)
    raise RuntimeError(f"no gang probe for device {table.device}")


# ---------------------------------------------------------------------------
# The probe runs (tools/torch_exp_gang_ablate.py, torch_exp_gang_micro.py and
# chip_smoke.py phase 3pr)
# ---------------------------------------------------------------------------

def _head(wave, tiles: int):
    return tuple(x[:tiles * BLOCK] for x in pad_wave(wave))


def _check_equal(a: GangHit, b: GangHit, what: str) -> None:
    """Kernel `a` vs plain `b`: tri equal, t bit-equal (inf on misses), each
    tile's iterations equal."""
    if not torch.equal(a.tri, b.tri):
        raise AssertionError(f"{what}: tri differs on {int((a.tri != b.tri).sum())} rays")
    if not torch.equal(a.t, b.t):
        raise AssertionError(f"{what}: t differs on {int((a.t != b.t).sum())} rays")
    if not torch.equal(a.iters, b.iters):
        raise AssertionError(f"{what}: iterations differ on {int((a.iters != b.iters).sum())} "
                             f"tiles")


def ablation_bytes_ops(work: dict, rays: int) -> tuple:
    """(bytes, operations) the gang traversal needs for `work` (the plain
    version's `last_work` over `rays` padded rays): the distinct table rows
    read once, 7 ray floats in and t, tri out a lane; every lane of a gang
    slab-tests the popped node's 8 children (26 operations a child; the
    gang's 19-swap key sort once a visit) and every queued triangle (52)."""
    ops = (work["node_visits"] * (LANES * 8 * 26 + len(SWAPS))
           + work["triangles"] * LANES * OPS_PER_TRIANGLE)
    return work["rows"] * 512 + rays * (7 + 2) * 4, ops


def ablation(gt: GangTable, wave, k_iters: int = K_ITERS, head_tiles: int = 64,
             variants=ABLATE_VARIANTS, timer=None) -> list:
    """One result a variant, run for `k_iters` iterations on every tile of
    `wave`. On a CUDA table: the kernel on the whole wave against its plain
    version (on all tiles for `full`, on the first `head_tiles` for the
    others): tri equal, t bit-equal, iterations equal; ms per launch from
    `timer(fn)` (a list of device ms, its median taken), us per
    tile-iteration and the delta against `full`. On a CPU table: the plain
    version, no times."""
    o, d, tm = pad_wave(wave)
    G = tm.shape[0] // BLOCK
    cuda = gt.table.device.type == "cuda"
    out = []
    for v in variants:
        row = {"probe": "exp_gang_ablate", "variant": v, "device": gt.table.device.type,
               "tiles": G, "k_iters": k_iters, "ms": None, "us_per_tile_iter": None}
        if cuda:
            hit = ablate_kernel(gt, (o, d, tm), v, k_iters)
            n = G if v == "full" else min(G, head_tiles)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ref = ablate_plain(gt, _head((o, d, tm), n), v, k_iters)
            stop.record()
            torch.cuda.synchronize()
            _check_equal(GangHit(hit.t[:n * BLOCK], hit.tri[:n * BLOCK], hit.iters[:n]), ref,
                         f"pg_ablate<{v}>")
            ms = sorted(timer(lambda: ablate_kernel(gt, (o, d, tm), v, k_iters)))
            row.update(ms=ms[len(ms) // 2], ms_spread=[ms[0], ms[-1]],
                       us_per_tile_iter=1e3 * ms[len(ms) // 2] / (G * k_iters),
                       parity_tiles=n, plain_ms=start.elapsed_time(stop))
        else:
            hit = ablate_plain(gt, (o, d, tm), v, k_iters)
        row["hits"] = int((hit.tri >= 0).sum())
        if v == "full" and (not cuda or row.get("parity_tiles") == G):
            row["work"] = dict(last_work)
            row["bytes"], row["ops"] = ablation_bytes_ops(last_work, G * BLOCK)
        out.append(row)
    base = next((r["us_per_tile_iter"] for r in out if r["variant"] == "full"), None)
    for r in out:
        r["delta_us_vs_full"] = (None if base is None or r["us_per_tile_iter"] is None
                                 else r["us_per_tile_iter"] - base)
    return out


def converged_vs_closest(gt: GangTable, tables, wave, closest, cap: int = 1 << 16,
                         timer=None) -> dict:
    """The `full` gang traversal run until every tile's stacks and leaf
    queues are empty (at most `cap` iterations) against `closest(tables, o,
    d, tm)` (the wide closest hit, K2 on the card) on the same wave by
    parity.compare_closest's tie-aware bar, tri equal on >= 99.9% of hits
    (an exact tie at equal t may resolve to either triangle). With `timer`,
    both timed."""
    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    o, d, tm = pad_wave(wave)
    hit = ablate(gt, (o, d, tm), "full", cap, converge=True)
    if int(hit.iters.max()) >= cap:
        raise AssertionError(f"the gang traversal did not end within {cap} iterations")
    ref = closest(tables, o, d, tm)
    parity.compare_closest(wt.Hit(hit.t, hit.tri), wt.Hit(ref.t, ref.tri), 0.999, False,
                           (tables, o, d))
    match = float(((hit.tri == ref.tri) & (ref.tri >= 0)).sum()) / max(1, int((ref.tri >= 0).sum()))
    row = {"probe": "gang_vs_K2", "device": gt.table.device.type, "rays": int(tm.shape[0]),
           "hits": int((ref.tri >= 0).sum()), "tri_match": match,
           "iters_max": int(hit.iters.max()), "iters_mean": float(hit.iters.float().mean()),
           "gang_ms": None, "k2_ms": None}
    if timer is not None:
        g = sorted(timer(lambda: ablate(gt, (o, d, tm), "full", cap, converge=True)))
        k = sorted(timer(lambda: closest(tables, o, d, tm)))
        row.update(gang_ms=g[len(g) // 2], k2_ms=k[len(k) // 2])
    return row


def micro_bytes_ops(stage: str, table: torch.Tensor, tiles: int, n_iters: int) -> tuple:
    """(bytes, operations) of a micro stage: the table and the rays read
    once, acc written once; per lane and iteration one add, and from `slab`
    on the 8 children's slab tests (26 each) and the gang minimum, from
    `sort` on the gang's 19 compare-swaps (once a gang)."""
    lane = 1 + (8 * 26 + 8 if MICRO_STAGES.index(stage) >= MICRO_STAGES.index("slab") else 0)
    gang_ops = len(SWAPS) if stage in ("sort", "push") else 0
    ops = tiles * n_iters * (BLOCK * lane + GANGS * gang_ops)
    return table.numel() * 4 + 2 * tiles * BLOCK * 4, ops


def micro_stages(table: torch.Tensor, rays: torch.Tensor, n_iters: int = N_ITERS,
                 timer=None) -> list:
    """One result a stage, in order. On a CUDA table: the kernel against its
    plain version (acc bit-equal), ms per launch from `timer`, ns per
    tile-iteration and the increment over the stage before, as the JAX tool
    prints them. On a CPU table: the plain version, no times."""
    out, prev = [], None
    T = rays.shape[0]
    for s in MICRO_STAGES:
        row = {"probe": "exp_gang_micro", "variant": s, "device": table.device.type,
               "tiles": T, "n_iters": n_iters, "ms": None, "ns_per_tile_iter": None}
        if table.device.type == "cuda":
            acc = micro_kernel(table, rays, s, n_iters)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ref = micro_plain(table, rays, s, n_iters)
            stop.record()
            torch.cuda.synchronize()
            row["plain_ms"] = start.elapsed_time(stop)
            if not torch.equal(acc, ref):
                raise AssertionError(f"pg_micro<{s}>: acc differs on "
                                     f"{int((acc != ref).sum())} lanes")
            ms = sorted(timer(lambda: micro_kernel(table, rays, s, n_iters)))
            ns = 1e6 * ms[len(ms) // 2] / (n_iters * T)
            row.update(ms=ms[len(ms) // 2], ms_spread=[ms[0], ms[-1]], ns_per_tile_iter=ns,
                       delta_ns=None if prev is None else ns - prev)
            prev = ns
        else:
            acc = micro_plain(table, rays, s, n_iters)
        row["acc_mean"] = float(acc.mean())
        out.append(row)
    return out


def micro_inputs(gt: GangTable, wave, tiles: int = TILES) -> tuple:
    """The micro probe's inputs from a wave, as the JAX tool takes them from
    its cached one: the unified table cut at MICRO_ROWS rows and the x
    origins of the first `tiles` tiles as (tiles, 8, 128) rays."""
    o = pad_wave(wave)[0][:tiles * BLOCK, 0]
    return gt.table[:MICRO_ROWS].contiguous(), o.reshape(-1, GANGS, LANES).contiguous()
