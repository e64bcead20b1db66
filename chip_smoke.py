#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths (batch render on merged, two-level,
small-scene binary and paged tables, SVGF + TAA denoised frames, mixed BSDFs
with textures, homogeneous media, ambient occlusion, AOV export, scene
updates of moving instances, `--bvh qbvh`, `--checkpoint`, `--perf`,
pixel-sharded ranks and the terminal viewer) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, or a few; any failure raises and the exit code is
nonzero):
  1. device: `nvidia-smi` name and power limit; no CUDA -> exit 1, no result.
  2. build: compile gpu_raytracer_tpu_torch/csrc/*.cu with nvcc (timed),
     while the scenes below are built; the ptxas report (registers, spills,
     stack frame) and the occupancy API's blocks an SM of each wide, paged
     and binary traversal kernel, of the SVGF kernels (the variance
     kernel's two instances), of the fused shade and of K3's nine
     instances (from the hits; with the walk's u, v; textured; both; the
     last bounce; and the four with the medium hand-over, SG_MEDIA); and of
     the probes pg_ablate, pr_read, pg_micro<push> and pb_pop (with its
     cluster size).
  scene: the procedural 1920x1080 configuration (cube room, area light,
     three subdivision-6 icospheres, 245,774 triangles, merged tables) and
     the instanced one (441 instances of one subdivision-4 icosphere, room,
     light: 443 instances, 2,257,934 triangles from 5,134, two-level
     tables) and the small one (the Cornell stand-in at 512x512, 36
     triangles, binary tables under both small-scene gates) and the streamed
     one (the room with ONE subdivision-8 icosphere instanced three times:
     3,932,174 triangles, past every wide budget, so paged tables, route
     "stream", nothing patched); tables built (timed), their sizes and the
     gates printed; for the streamed scene also the merged wide tables of
     the same world tree (~316 MB), the yardstick of phase 3st. Then the
     mixed scene (`scenes.mixed_scene(1920, 1080, 6, True)`: the room as six
     rectangles, the three spheres smooth glass, rough glass and gold, a
     textured plastic floor, textured diffuse walls; 245,774 triangles,
     merged tables of its own, the spheres' BVHs from the merged cell's
     cache): the Kulla-Conty bake on the card
     timed cold and warm, the tables, the curve bake alone, the texture
     pool's bytes and slot sides; and the mixed Cornell stand-in
     (`scenes.mixed_cornell`, conductor and dielectric boxes) at 512x512 on
     route (a), its fused-shade instance rows carrying the port's curves.
     Then the media scenes: `scenes.media_scene(1920, 1080, 6)` (the merged
     cell's geometry, so its tree from the cache; the spheres smooth glass
     holding an ink, a forward scatterer and a thick isotropic medium;
     merged tables, 6 bounces) and `scenes.media_cornell(512, 512)` (a rough
     glass short box holding a scattering medium; route (b): the fused
     shade refuses media), their media tables printed. Then the merged and
     the instanced cells again under `--bvh qbvh` (4-wide trees in the
     8-slot rows; the instanced cell's TLAS stays 8-wide, as in the JAX
     package): their tables and children a node.
  3. per-kernel parity: every kernel against its plain PyTorch version on
     one full 777,600-ray wave captured from the main path (the merged roles
     and shade on the procedural scene, the two-level roles and shade on the
     instanced scene), compared on the whole wave (and the shade, besides,
     on every BSDF over a 65,536-lane head with synthetic materials; the
     closest roles by parity.compare_closest's tie-aware bar); both timed,
     and the least time the card could take (bound) counted from the wave's
     inputs; beside each traversal role, the warp utilisation of a
     one-thread-a-ray schedule (from the plain version's per-ray visits)
     and the persistent-warp kernel's own (its instrumented launch's
     counters). K3 (phase_shade) is held so on its bounce-1 wave and its
     last bounce's wave on every route that runs it (here, 3sv, 3sm, 3st,
     3mx); and the merged scene's bounce loop on the card calls no
     pre-stage helper after bounce 0, draws nothing on the last bounce and
     traces no shadow wave there (parity.loop_glue_calls).
  3qb. phase 3's traversal roles (K1, K2 / K4) on the qbvh tables of the
     merged and instanced cells, the same bars, timed beside cwbvh with
     their bounds.
  3sv. the SVGF kernels: the guide and dyn images of the fifth 1080p denoised
     frame of the merged scene (the share of pixels with history < 4 there
     printed: ROADMAP C5's measure; where it is 0, a sixth frame after a
     ~3 px pan gives both sides of the length < 4 select); the variance kernel and each a-trous step
     against its plain version at full frame (rtol = atol = 2e-4), timed as
     phase 3 times kernels, with bounds; the variance kernel's run-time
     instance (sigma_n 8 and 12.5; the path's 16 runs the static one) on
     the same frame against its plain version; and K3 with demod on the
     denoised path's bounce-1 and last-bounce waves.
  3sm. the small-scene kernels: binary closest hit (bounce 1), binary any
     hit (its shadow wave) and the fused shade (bounce 1; and every BSDF on
     synthetic mixed-material tables, timed too; bounce 4 of the same
     sample, most lanes dead; bounce 1 with every lane dead) against their
     plain versions on a captured full 262,144-ray wave of the 512x512
     slice, timed, with bounds;
     and K8 closest and any on hand-made tables 80 nodes deep
     (parity.deep_binary_tables), where the 48-entry stack drops pushes;
     K3 with the walk's u, v on route (b)'s 1080p waves.
  3st. the paged-table kernels: resident and page passes, closest and any,
     against their plain versions on captured full 777,600-ray waves of the
     streamed scene (the primary wave, the bounce-1 wave and its shadow
     wave; the resident pass bit-equal, the page pass's closest hit by the
     tie-aware bar, any hit exact), timed, with bounds (the page pass's
     bytes: the distinct page rows its plain version loads) and the warp
     utilisation of a one-thread-a-ray schedule (plain visits) beside the
     walk's (its instrumented launch); the passes a wave took and the
     portals a lane enumerated; and the whole paged trace of each wave
     against the plain trace (the same bars) and against the merged wide
     kernels (K1 primary, K2 closest and any) over the merged tables of the
     same tree, both timed (K1 held there to the plain primary by the
     primary bar, u, v included); K3 on the paged route's waves. The scene
     line gives the page pass's stack: the deepest page walk plus the K - 1
     portals seeded beneath it.
  3pr. the probe kernels (the Hopper counterparts of the JAX package's TPU
     probes tools/exp_gang_ablate.py, exp_gang_micro.py, exp_gather.py and
     exp_gather2.py) on the merged scene's tables and its captured full
     777,600-ray bounce-1 wave: every ablation variant of pg_ablate at 256
     fixed iterations and every stage of pg_micro at 512 (64 tiles) against
     its plain version (tri equal, t bit-equal; acc bit-equal; the plain
     ablation on the first 64 tiles but for `full`), timed; the gang
     traversal run to its end against K2 on the same wave and on the primary
     wave (equal hits, ties aside), both timed; pf_lane and pf_window in
     every mode at the probes' sizes (seeded numpy; 1 tile and 760 tiles)
     and on fetch.EDGE_CASES against their plain versions, exactly, each
     with the path its launcher took (pf_lane staged, in place or quad;
     what a window stages and its ring depths), timed beside one `index_select` of the same
     values (gather only) and, for pf_lane col0 and rowsum, one
     `embedding_bag` (the same sums), with the share of the bound; and the
     glue's `fetch_rows(shade_rows, hit_tri)` on
     the wave as pf_lane rows against `index_select` (the library time of
     pf_lane; int64 `index_select` and `shade_rows[idx]` timed beside). Then
     the single-block probes (tools/exp_blocksync.py, exp_scalar_read.py,
     exp_vmem2.py, exp_gang_prims*.py, exp_dma*.py) at their own sizes,
     inputs from seeded numpy, each against its plain version (bit-equal;
     copies exact) and timed: pb_pop on the own and the 1e29-scaled table;
     pr_read, every body (the roll read in place and staged in shared
     memory) beside one `index_select` (the gather alone) and one
     `embedding_bag` of the values read as one summed bag (the kernels
     line's library call); the shared-memory ceiling, which
     must equal cudaDevAttrMaxSharedMemoryPerBlockOptin with 16 bytes more
     refused; pp_gang, 11 bodies at the probes' iteration counts on the own
     and a chase table, `full` also on the own table times 1e4 (parity
     at 256 iterations; full, smem, v1, v2 at 2,051), v1, v2 and smem
     beside one `index_select` and `torch.sum` of the values read;
     pd_copy, 20 bodies with cp.async and the TMA bulk copy (the window
     ones through a ring of copies in flight, the whole-table ones on a
     2-block cluster), the 16 KB-window ones also at 132 blocks. No probe is on a
     render path: their launches in the slices below are 0.
  3mx. K3 on the mixed scene's captured 777,600-lane bounce-1 and
     last-bounce waves (the port's curves, the texture taps in the kernel)
     and K7 on the mixed Cornell stand-in's bounce-1 wave, each against its
     plain version, timed, with bounds (beside phase 3's and 3sm's
     diffuse-only times).
  3md. K3's SG_MEDIA instances against the plain version: on the media
     1080p scene's bounce-1 wave (instance media, the wide route) and the
     media Cornell stand-in's (media_uv, route (b)), the shade bar and
     medium_id equal on every lane, timed 7 x 10 launches behind a device
     spin beside the instance without SG_MEDIA on the same lanes (whose
     other outputs must be bit-equal), with bounds, registers and stack
     frames; every later call of the same samples held too; media_tex and
     media_uv_tex on the mixed scene's bounce-1 wave with seeded medium ids.
  4. the merged slice: 1920x1080, 3 bounces, NEE+MIS+RR, a warm-up sample
     and 4 timed spp through Pathtracer(device="cuda"); every kernel of the
     path must launch (K3's last-bounce instance too: "shade_last") and no
     plain version may run.
  4tl. the two-level slice: the instanced scene at 1920x1080, 4 bounces,
     NEE+MIS+RR, the same way.
  4sv. the denoised slice: the merged scene at 1920x1080, 3 bounces, SVGF +
     TAA, a warm-up frame and 8 timed frames with the history carried; in
     the last 4 the camera moves sideways ~3 px a frame. ms/frame split into
     trace and SVGF + TAA; every kernel of the path (shade with demod
     included) must launch and no plain version may run.
  4sm. the small-scene slice, route (a): the Cornell stand-in at 512x512,
     6 bounces, NEE+MIS+RR (bench.py's cornell512 probe), a warm-up sample
     and 4 timed spp; the binary kernels and the fused shade must launch, no
     wide kernel, no K3 and no plain version may run.
  4sm1080. route (b): the same scene at 1920x1080 (not a multiple of 32),
     3 bounces; the binary kernels and K3 launch, the fused shade does not.
  4st. the streamed slice: 1920x1080, 3 bounces, on the paged kernels and K3
     only (no wide or binary kernel, no plain version, no magenta pixel).
  4mx. the mixed, textured slice at 1920x1080, 3 bounces: K1, K2 and K3
     launch, nothing else and no plain version.
  4smx. the mixed Cornell stand-in at 512x512, 6 bounces, route (a): K8 and
     K7 only.
  4md. the media slice: the media scene at 1920x1080, 6 bounces, NEE + MIS
     + RR: K1, K2 and K3 with SG_MEDIA ("shade_media") launch, nothing off
     the wide route and no plain version; then one more sample under
     torch.profiler (device busy ms, idle share, host launches, the largest
     kernels).
  4mdc. the media Cornell stand-in at 512x512, 6 bounces, route (b): K8
     and K3 with SG_MEDIA, no fused shade.
  4cp. the late-bounce compaction at the default depth: the merged 1080p
     cell at `GPUConfig()` (b10) and the instanced 1080p b4 cell, one
     sample with the tiers `Pathtracer` passes and one with (2, 4, 16),
     which narrow both cells, each against one with none: max |d| <= 1e-6
     (expected 0), equal rays, every kernel of the route launched and no
     plain version; the live lanes and width of each bounce of the first
     wave; warm ms/sample each way (median of 3) and one profiled sample
     each way: device busy ms, launches, and the compaction's own launches
     and device ms.
  4ao. ambient occlusion (integrators/ao.py) at 1920x1080 on the merged
     scene's tables: K1 primary and the wide any walk only, ms/sample and
     Mrays/s; 2 spp kernels vs plain, visibility equal on >= 99.9% of the
     pixels.
  4qb, 4qbtl. the merged and two-level slices on their qbvh tables.
  4up. the instanced cell moving: a render alone timed, one synchronous
     refresh (`Pathtracer.update`) of every 7th sphere moved and turned,
     then 8 frames each moving them again, `update_async`, `render`: the
     submit, the join's wait and the frame timed; K1, K4 and K3 launch, no
     plain version; then every transform-derived device table bit-equal to
     a fresh `init_device` of the moved scene's and one sample bit-equal.
  4upm. the merged cell with one sphere moved once: the world-space tree
     rebuilt, its seconds and the bytes it adds to the BVH cache; the route
     after; the fresh-build check.
  4ups. the small cell on route (a) with a box moving, 4 frames: K8 and K7
     on refreshed binary and fused-shade tables; the fresh-build check.
     Then utils/perftest.run on it with its own two POVs.
  4usv. the instanced cell denoised, 8 frames, three spheres moving through
     update_async: no reset (the sample index runs on), K5 every frame, the
     share of pixels with history < 4 at the end.
  4mp. pixel-sharded rendering (parallel/): ranks spawned as processes,
     each building the merged 1080p cell from the caches on the card; 1
     rank over nccl, then 2 ranks over gloo sharing the card:
     `shard_render_wave` on the first 777,600 tile-order ids against the
     one-device `render_wave` (>= 99% of rays within 1e-4; bit-equal
     expected, the largest difference printed), 3 frames of
     `shard_denoised_step` on 2 ranks against the same steps on one device
     (rel-RMSE < 3e-3); each rank's set-up s, wave ms, all-gather ms.
  4vw. the terminal viewer (utils/viewer.py) in-process through
     `apply_keys`: the pixel query on the card (one-ray launches of the
     route's primary kernel) held to the plain walk on the merged,
     instanced and small cells; the merged 1080p cell with w, j, p (overlay),
     f, t (stage_times, printed with the card and the kernels that ran
     them), render, framebuffer copy and terminal encode timed apart,
     FrameTimer's stats; g + z on a merged sphere with the BVH cache
     unchanged (ROADMAP C39); g + z on the instanced cell (update_async);
     `]` on the small cell (a material rebuild).
  5. image parity: 256x256, 8 spp, kernels vs plain versions on the card,
     on the four scenes (5, 5tl, 5sm, 5st), the two mixed ones (5mx,
     5smx) and the two media ones (5md on the wide route, 5mdc on route
     (b) at 4 spp: its plain binary walk is the slowest plain path); 5sv: 4
     denoised 256x256 frames, kernels vs plain; 5qb, 5qbtl: the qbvh
     tables.
  6. CLI: `python -m gpu_raytracer_tpu_torch` on a Mitsuba XML (a small
     scene), plain and with `--svgf on`, and the mixed Mitsuba scene
     (`scenes.write_mitsuba_mixed_scene`: textured roughplastic and diffuse,
     rough conductor and dielectric), the three runs at once; the `[paths]`
     line must name the binary kernel, with the fused shade in the plain
     run and K3 under `--svgf on` and for the textured scene; and the media
     Mitsuba scene (`scenes.write_mitsuba_media_scene`: two glass spheres
     holding media, route (b) on K8 + K3), plain, `-I ao` (the binary walk
     alone) and `--aovs` (the albedo, normal and position EXRs beside the
     output), the six runs at once; with them `--checkpoint` (a 3-sample
     run stopped after its second sample, snapshots every sample, resumed by
     a second run: the PNG equals a straight run's, the snapshot is
     removed) and `--perf` (perf.txt written in its own directory); 6vw:
     `--viewer -N 4` with stdin from /dev/null prints one status line a
     frame, 4 frames, and exits 0.
  7. the independent anchor (validate/anchor.py): the gold-panel box,
     64x64, 3 bounces, 768 spp on the card's kernel path against the port's
     numpy_pt at 768 spp (rendered on the host from the start), under
     per-pixel RMSE < 4e-2, region RMSE < 1e-2 and channel means within 1%.
Each line carries the seconds since the start. The line before the last is
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SUB = 65_536            # lanes of the synthetic mixed-material shade check
FULL_W, FULL_H = 1920, 1080
SPP = 4
BOUNCES = 3
BOUNCES_TL = 4          # the JAX package's instancing probe (bench.py)
SMALL = 512             # the JAX package's small-scene probe (bench.py:665-671)
BOUNCES_SM = 6
SPHERE_SUBDIV = 6
STREAM_SUBDIV = 8       # 1,310,720 triangles a sphere, instanced three times
BOUNCES_MD = 6          # the media scenes' depth: paths scatter inside the spheres
SVGF_FRAMES = 8         # timed denoised frames, after one warm-up
SVGF_MOVING = 4         # of which the last ones pan the camera
PAN_PX = 3.0            # image shift per moving frame, beyond the +-2 px window
COMPACT_FORCED = (2, 4, 16)  # phase 4cp's tiers that narrow both cells

WT_SRC = "gpu_raytracer_tpu_torch/csrc/wide_traverse.cu"
SV_SRC = "gpu_raytracer_tpu_torch/csrc/svgf_stencil.cu"
BT_SRC = "gpu_raytracer_tpu_torch/csrc/binary_traverse.cu"
ST_SRC = "gpu_raytracer_tpu_torch/csrc/stream_traverse.cu"
PG_SRC = "gpu_raytracer_tpu_torch/csrc/probe_gang.cu"
PF_SRC = "gpu_raytracer_tpu_torch/csrc/probe_fetch.cu"
PB_SRC = "gpu_raytracer_tpu_torch/csrc/probe_block.cu"
PR_SRC = "gpu_raytracer_tpu_torch/csrc/probe_read.cu"
PP_SRC = "gpu_raytracer_tpu_torch/csrc/probe_prims.cu"
PD_SRC = "gpu_raytracer_tpu_torch/csrc/probe_dma.cu"
SG_SRC = "gpu_raytracer_tpu_torch/csrc/shade_gather.cu"
SG_TPU = "gpu_raytracer_tpu/ops/pallas_shade_gather.py:95"
ST_RESIDENT = "gpu_raytracer_tpu/ops/pallas_stream.py:235"
ST_PAGE = "gpu_raytracer_tpu/ops/pallas_stream.py:310"
KERNELS = {  # name -> (kernel name, source, TPU kernel it replaces)
    "primary": ("wide_traverse.primary", WT_SRC, "gpu_raytracer_tpu/ops/pallas_wide.py:80"),
    "closest": ("wide_traverse.closest", WT_SRC, "gpu_raytracer_tpu/ops/pallas_gang.py:350"),
    "any": ("wide_traverse.any", WT_SRC, "gpu_raytracer_tpu/ops/pallas_gang.py:350"),
    "shade": ("shade_gather", SG_SRC, SG_TPU),
    "shade_media": ("shade_gather.media", SG_SRC, SG_TPU),
    "shade_media_uv": ("shade_gather.media_uv", SG_SRC, SG_TPU),
    "primary_tl": ("wide_traverse.primary_tl", WT_SRC,
                   "gpu_raytracer_tpu/ops/pallas_wide.py:80"),
    "closest_tl": ("wide_traverse.closest_tl", WT_SRC,
                   "gpu_raytracer_tpu/ops/pallas_gang.py:90"),
    "any_tl": ("wide_traverse.any_tl", WT_SRC, "gpu_raytracer_tpu/ops/pallas_gang.py:90"),
    "svgf_variance": ("svgf_stencil.variance", SV_SRC,
                      "gpu_raytracer_tpu/ops/pallas_svgf.py:208"),
    "svgf_atrous": ("svgf_stencil.atrous", SV_SRC,
                    "gpu_raytracer_tpu/ops/pallas_svgf.py:140"),
    "binary_closest": ("binary_traverse.closest", BT_SRC,
                       "gpu_raytracer_tpu/ops/pallas_traverse.py:89"),
    "binary_any": ("binary_traverse.any", BT_SRC,
                   "gpu_raytracer_tpu/ops/pallas_traverse.py:89"),
    "fused_shade": ("fused_shade", "gpu_raytracer_tpu_torch/csrc/fused_shade.cu",
                    "gpu_raytracer_tpu/ops/pallas_shade.py:659"),
    "resident_closest": ("stream_traverse.resident_closest", ST_SRC, ST_RESIDENT),
    "resident_any": ("stream_traverse.resident_any", ST_SRC, ST_RESIDENT),
    "page_closest": ("stream_traverse.page_closest", ST_SRC, ST_PAGE),
    "page_any": ("stream_traverse.page_any", ST_SRC, ST_PAGE),
    "pg_ablate": ("probe_gang.pg_ablate", PG_SRC, "tools/exp_gang_ablate.py:56"),
    "pg_micro": ("probe_gang.pg_micro", PG_SRC, "tools/exp_gang_micro.py:34"),
    "pf_lane": ("probe_fetch.pf_lane", PF_SRC, "tools/exp_gather.py:52"),
    "pf_window": ("probe_fetch.pf_window", PF_SRC, "tools/exp_gather.py:100"),
    "pb_pop": ("probe_block.pb_pop", PB_SRC, "tools/exp_blocksync.py:110"),
    "pr_read": ("probe_read.pr_read", PR_SRC, "tools/exp_scalar_read.py:38"),
    "pp_gang": ("probe_prims.pp_gang", PP_SRC, "tools/exp_gang_prims.py:82"),
    "pd_copy": ("probe_dma.pd_copy", PD_SRC, "tools/exp_dma.py:58"),
}
PROBE_TILES = 760       # the wave's 777,600 rays in 1024-lane tiles
# K3's instances (shade_gather.MODES) by name.
SHADE_MODES = {0: "hits", 2: "hits_uv", 4: "hits_tex", 6: "hits_uv_tex", 1: "last",
               8: "media", 10: "media_uv", 12: "media_tex", 14: "media_uv_tex"}
# Kernels of the wide route (and K3), which the fused-shade route must not run.
WIDE_NAMES = ("primary", "closest", "any", "primary_tl", "closest_tl", "any_tl")
STREAM_NAMES = ("resident_closest", "resident_any", "page_closest", "page_any")


T_START = time.perf_counter()


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] ({time.perf_counter() - T_START:.1f} s) {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, repeats: int) -> list:
    """Device ms per call (`probes.device_ms`: CUDA events behind a device
    spin, after one warm-up call)."""
    from gpu_raytracer_tpu_torch.probes import device_ms

    return device_ms(fn, reps, repeats)


def time_pair(kernel_fn, plain_fn) -> tuple:
    """(kernel ms, plain ms, text): medians of 7 x 10 kernel calls and of 3
    single plain calls, with the spread of the repeats."""
    ks = sorted(cuda_ms(kernel_fn, 10, 7))
    ps = sorted(cuda_ms(plain_fn, 1, 3))
    text = (f"kernel {ks[len(ks) // 2]:.4f} ms (7 x 10 calls: {ks[0]:.4f}-"
            f"{ks[-1]:.4f}), plain {ps[1]:.2f} ms (3 calls: {ps[0]:.2f}-{ps[-1]:.2f})")
    return ks[len(ks) // 2], ps[1], text


def count_dicts() -> tuple:
    """(launch counts, plain-call counts) of every kernel wrapper."""
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    from gpu_raytracer_tpu_torch.probes import block, dma, fetch, gang, prims, read

    mods = (wt, sg, sv, bt, fs, st, gang, fetch, block, read, prims, dma)
    return (tuple(m.launches for m in mods), tuple(m.plain_calls for m in mods))


def counts():
    launched, plain = count_dicts()
    return ({k: v for d in launched for k, v in d.items()},
            {k: v for d in plain for k, v in d.items()})


def nbytes(*xs) -> int:
    """Bytes of the tensors in `xs` (dicts and tuples walked; None skipped)."""
    import torch

    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif torch.is_tensor(x):
            total += x.numel() * x.element_size()
    return total


def bound(num_bytes: int, ops: int) -> tuple:
    """(bound ms, "bytes" | "operations"): the larger of the bytes over the
    H100's memory rate and the operations over its fp32 rate."""
    from gpu_raytracer_tpu_torch import probes

    return probes.bound(num_bytes, ops)


def pointwise_ops(fn) -> int:
    """Elements produced by pointwise PyTorch operations while `fn` runs:
    the plain shade's and stencils' operation count."""
    from gpu_raytracer_tpu_torch.probes import pointwise_ops as count

    return count(fn)


def reset_counts() -> None:
    for group in count_dicts():
        for d in group:
            for k in d:
                d[k] = 0


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_kernels(pt, results: dict, with_shade: bool, phase: str = "3") -> None:
    """Phase 3 (3qb on qbvh tables) on the tables of `pt`: the traversal
    roles (named with "_tl" on two-level tables) and, with `with_shade`,
    the shade kernel (phase_shade) and the bounce loop's glue calls on the
    card."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    wave = pt.cpu_config.batch_size
    got = parity.capture_wave(pt, wave)

    for role, tri_match in (("primary", parity.TRI_MATCH_COHERENT),
                            ("closest", parity.TRI_MATCH_INCOHERENT),
                            ("any", None)):
        (tables, o, d, tm), _ = got[role]
        name = wt.name_of(wt.ROLES.index(role), tables)
        ka = getattr(DISPATCH, role)(tables, o, d, tm)
        pa = getattr(PLAIN, role)(tables, o, d, tm)
        torch.cuda.synchronize()
        err = (parity.compare_any(ka, pa) if role == "any"
               else parity.compare_closest(ka, pa, tri_match, role == "primary",
                                           (tables, o, d)))
        ms, plain_ms, text = time_pair(
            lambda: getattr(DISPATCH, role)(tables, o, d, tm),
            lambda: getattr(PLAIN, role)(tables, o, d, tm))
        # Work of the full wave: the last timed plain call's visits; bytes:
        # tables and rays read once, outputs written once.
        work = dict(wt.last_work)
        util = wt.warp_utilisation(wt.last_pops)
        ops = (work["nodes"] * wt.OPS_PER_NODE + work["triangles"] * wt.OPS_PER_TRIANGLE
               + work["instances"] * wt.OPS_PER_INSTANCE)
        out = getattr(DISPATCH, role)(tables, o, d, tm)
        b_ms, b_by = bound(nbytes(tables.nodes, tables.rows, o, d, tm, out), ops)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        # The persistent-warp kernel's instrumented launch (not timed).
        _, stats = wt.trace_stats(wt.ROLES.index(role), tables, o, d, tm)
        warps = (f"one-thread-a-ray warp utilisation {util:.4f} (plain visits); kernel "
                 f"warp utilisation {wt.kernel_utilisation(stats):.4f}, its counters {stats}")
        say(phase, f"{KERNELS[name][0]}: parity ok on the {o.shape[0]}-ray wave (max |dt| "
                 f"{err:.3g}); {text}; {warps}; work {work}, {ops} ops; bound "
                 f"{b_ms:.4f} ms ({b_by})")
    if with_shade:
        phase_shade(pt, "3", "merged 1080p", results=results)
        base, calls = parity.loop_glue_calls(pt, 1), parity.loop_glue_calls(pt, BOUNCES)
        helpers = ("rederive_uv", "interpolate_hit", "iso_texture_tap", "fetch_rows")
        if (any(calls[k] != base[k] for k in helpers) or calls["last_bounce_draws"]
                or calls["roles"].get("any") != BOUNCES - 1):
            raise AssertionError(f"the bounce loop's glue: b1 {base}, b{BOUNCES} {calls}")
        say("3", f"bounce loop glue on the card, one wave at b1 and b{BOUNCES}: pre-stage "
                 f"helper calls {[calls[k] for k in helpers]} both times (bounce 0's own), "
                 f"no draw on the last bounce, roles {calls['roles']}")


def phase_shade(pt, phase: str, label: str, route: str = "wide", with_aovs: bool = False,
                results: dict = None) -> dict:
    """K3 from the hits against its plain version on one captured sample of
    `pt` on `route` (with `with_aovs` as the denoised path runs it: demod):
    its bounce-1 wave and its last bounce's wave, both timed, with bounds
    (shade_gather.moved_bytes: lane inputs and outputs once, the distinct
    table rows the lanes read); the last-bounce instance's radiance_add
    bit-equal to the full one's on the bounce-1 wave. With `results`, also
    every BSDF (the instances given synthetic materials in turn, over the
    wave's first SUB lanes), and the kernels line takes the bounce-1 numbers.
    Returns ({"b1": (ms, plain ms, bound ms), "last": ...}, the captured
    shade calls)."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg

    calls = parity.capture_wave(pt, pt.cpu_config.batch_size, route=route,
                                with_aovs=with_aovs, every=True)["shade"]
    waves = (("b1", calls[0]), ("last", calls[-1]))
    if calls[0][1]["last"] or not calls[-1][1]["last"]:
        raise AssertionError(f"{label}: the sample has no bounce-1 and last-bounce waves")
    if with_aovs and not (calls[0][1]["demod"] and "rr_albedo" in calls[0][0][2]):
        raise AssertionError("the denoised wave did not shade with demod")
    texts, out = [], {}
    for name, (args, kw) in waves:
        ka, pa = DISPATCH.shade(*args, **kw), PLAIN.shade(*args, **kw)
        torch.cuda.synchronize()
        err = (parity.compare_shade_last if kw["last"] else parity.compare_shade)(ka, pa)
        ms, plain_ms, text = time_pair(lambda: DISPATCH.shade(*args, **kw),
                                       lambda: PLAIN.shade(*args, **kw))
        ops = pointwise_ops(lambda: PLAIN.shade(*args, **kw))
        moved = sg.moved_bytes(args, kw, ka)
        b_ms, b_by = bound(moved, ops)
        out[name] = (ms, plain_ms, b_ms)
        lanes = args[2]
        texts.append(f"{'bounce ' + str(int(args[1][0]))} (instance "
                     f"{sg.mode_of(lanes, kw['textured'], kw['last'])}, "
                     f"{int(lanes['alive'].sum())} live of {lanes['t'].shape[0]}): parity ok "
                     f"(max abs err {err:.3g}); {text}; {ops} pointwise ops of the plain "
                     f"version; bound {b_ms:.4f} ms ({b_by}: {moved} bytes)")
        if name == "b1":
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None}
            last = DISPATCH.shade(*args, **dict(kw, last=True))["radiance_add"]
            if not torch.equal(last.view(torch.int32), ka["radiance_add"].view(torch.int32)):
                raise AssertionError(f"{label}: the last-bounce instance's radiance_add "
                                     f"differs from the full one's")
    if results is not None:
        args, kw = calls[0]
        mixed = parity.mixed_shade_args(args, head=SUB)
        row["max_abs_err"] = max(row["max_abs_err"], parity.compare_shade(
            DISPATCH.shade(*mixed, **kw), PLAIN.shade(*mixed, **kw)))
        results["shade"] = row
        texts.append(f"all 4 BSDFs over {SUB} lanes: parity ok")
    say(phase, f"shade_gather on the {label} waves: " + "; ".join(texts))
    return out, calls


def phase_small_kernels(pt, results: dict) -> None:
    """Phase 3sm on the small scene's full 512x512 wave (route (a)): the
    binary closest hit on bounce 1, the binary any hit on its shadow wave,
    and the fused shade on bounce 1 (and on synthetic mixed-material tables,
    every BSDF; on bounce 4; on bounce 1 with every lane dead), each against
    its plain version, timed, with bounds."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs

    got = parity.capture_wave(pt, pt.width * pt.height, route="binary_shade", every=True)
    for role in ("binary_closest", "binary_any"):
        (tables, o, d, tm), _ = got[role][1]
        kernel, plain = getattr(DISPATCH, role), getattr(PLAIN, role)
        ka, pa = kernel(tables, o, d, tm), plain(tables, o, d, tm)
        torch.cuda.synchronize()
        err = (parity.compare_any(ka, pa) if role == "binary_any"
               else parity.compare_binary(ka, pa))
        ms, plain_ms, text = time_pair(lambda: kernel(tables, o, d, tm),
                                       lambda: plain(tables, o, d, tm))
        work = dict(bt.last_work)  # the last timed plain call's visits
        ops = (work["nodes"] * bt.OPS_PER_NODE + work["triangles"] * bt.OPS_PER_TRI
               + work["instances"] * bt.OPS_PER_INST)
        b_ms, b_by = bound(nbytes(tables, o, d, tm, kernel(tables, o, d, tm)), ops)
        results[role] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        hits = int((ka.tri >= 0).sum()) if role == "binary_closest" else int(ka.sum())
        say("3sm", f"{KERNELS[role][0]}: parity ok on {o.shape[0]} rays of the "
                   f"bounce-1 {'wave' if role == 'binary_closest' else 'shadow wave'} "
                   f"({hits} {'hits' if role == 'binary_closest' else 'occluded'}, max "
                   f"|dt| {err:.3g}); {text}; work {work}, {ops} ops; bound {b_ms:.4f} ms "
                   f"({b_by})")

    # The drop rule at the stack's real depth: a chain deeper than 48.
    tables = bt.make_tables(*(torch.as_tensor(x, device=pt.device)
                              for x in parity.deep_binary_tables()))
    o, d, tm = (torch.as_tensor(x, device=pt.device) for x in parity.deep_binary_rays(65_536))
    err = parity.compare_binary(DISPATCH.binary_closest(tables, o, d, tm),
                                PLAIN.binary_closest(tables, o, d, tm))
    parity.compare_any(DISPATCH.binary_any(tables, o, d, tm), PLAIN.binary_any(tables, o, d, tm))
    depth = int((tables.nodes[:, 13] == 0).sum())
    say("3sm", f"binary_traverse closest and any: parity ok on {o.shape[0]} rays over a chain "
               f"{depth} interior nodes deep (pushes past the 48-entry stack dropped; max "
               f"|dt| {err:.3g})")

    calls = got["fused_shade"]
    if len(calls) < 5:
        raise RuntimeError(f"the small cell's sample ended after {len(calls)} bounces")
    args, kw = calls[1]
    err = parity.compare_shade(DISPATCH.fused_shade(*args, **kw),
                               PLAIN.fused_shade(*args, **kw))
    # Every BSDF: the mixed tables' materials on the scene's instances.
    mixed = parity.mixed_fused_args(args)
    err = max(err, parity.compare_shade(DISPATCH.fused_shade(*mixed, **kw),
                                        PLAIN.fused_shade(*mixed, **kw)))
    # Bounce 4 of the same sample (most lanes dead), and bounce 1 with every
    # lane dead; the lanes whose masks differ from the plain version's are
    # counted (compare_shade allows 0.1%).
    late, late_kw = calls[4]
    dead = list(args)
    dead[7] = torch.zeros_like(dead[7])
    report = []
    for name, (a, k) in (("bounce 4", (late, late_kw)), ("all dead", (tuple(dead), kw))):
        ka, pa = DISPATCH.fused_shade(*a, **k), PLAIN.fused_shade(*a, **k)
        err = max(err, parity.compare_shade(ka, pa))
        differ = ((ka["alive"] != pa["alive"]) | (ka["prev_allow_nee"] != pa["prev_allow_nee"])
                  | ((ka["shadow_tmax"] > 0) != (pa["shadow_tmax"] > 0)))
        report.append(f"{name} ({int(a[7].sum())} live, masks differ on "
                      f"{int(differ.sum())} lanes)")
    if (bool(ka["alive"].any()) or bool((ka["shadow_tmax"] != 0).any())
            or not torch.equal(ka["ray_o"], dead[4]) or not torch.equal(ka["ray_d"], dead[5])
            or bool((ka["radiance_add"] != 0).any())):
        raise AssertionError("fused_shade: the all-dead wave left a lane alive, traced a "
                             "shadow ray, added radiance or moved a ray")
    mixed_ms = sorted(cuda_ms(lambda: DISPATCH.fused_shade(*mixed, **kw), 10, 7))[3]
    ms, plain_ms, text = time_pair(lambda: DISPATCH.fused_shade(*args, **kw),
                                   lambda: PLAIN.fused_shade(*args, **kw))
    ops = pointwise_ops(lambda: PLAIN.fused_shade(*args, **kw))
    out = DISPATCH.fused_shade(*args, **kw)
    b_ms, b_by = bound(fs.moved_bytes(args, out), ops)
    results["fused_shade"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    hit, alive = args[3], args[7]
    say("3sm", f"fused_shade: parity ok on {hit.t.shape[0]} bounce-1 lanes "
               f"({int(alive.sum())} live), on all 4 BSDFs, on {' and '.join(report)} "
               f"(max abs err {err:.3g}); "
               f"{text}; the mixed-BSDF wave {mixed_ms:.4f} ms; {ops} pointwise ops of "
               f"the plain version; bound {b_ms:.4f} ms ({b_by}: "
               f"{fs.moved_bytes(args, out)} bytes)")


def phase_stream_kernels(pt, merged, results: dict) -> None:
    """Phase 3st on the streamed scene's paged tables: each pass kernel
    (resident, page; closest, any) against its plain version on three
    captured full waves (primary, bounce 1, the bounce-1 shadow wave), timed,
    with bounds; then the whole paged
    trace of each wave against the merged wide kernels on `merged`, the
    merged wide tables of the same tree. The kernels line takes the bounce-1
    waves' numbers."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt

    got = parity.capture_wave(pt, pt.cpu_config.batch_size, route="stream", every=True)
    waves = (("primary", False, got["stream_closest"][0][0]),
             ("bounce-1", False, got["stream_closest"][1][0]),
             ("bounce-1 shadow", True, got["stream_any"][1][0]))
    errs = {n: 0.0 for n in STREAM_NAMES}
    for label, any_hit, (tables, o, d, tm) in waves:
        mode = "any" if any_hit else "closest"
        res_k = st.resident_kernel(any_hit, tables, o, d, tm)
        errs["resident_" + mode] = max(errs["resident_" + mode], parity.compare_stream_pass(
            res_k, st.resident_plain(any_hit, tables, o, d, tm),
            ("t", "tri", "pid", "pt", "ovf")))
        # The page pass after pass 0's fold (a first pass finds best = t_max):
        # any hit exact, closest hit by the tie-aware bar.
        t1, tri1, pid, pt_, ovf = res_k
        page_in = (pid, pt_, torch.where(tri1 >= 0, t1, tm), tri1)
        page_k = st.page_kernel(any_hit, tables, o, d, tm, *page_in)
        page_p = st.page_plain(any_hit, tables, o, d, tm, *page_in)
        errs["page_" + mode] = max(errs["page_" + mode], (
            parity.compare_stream_pass(page_k, page_p, ("t", "tri")) if any_hit
            else parity.compare_stream_closest(page_k, page_p, (tables, o, d))))
        page_ties = int((page_k[1] != page_p[1]).sum())
        torch.cuda.synchronize()
        live = tm > 0
        portals = ((pid >= 0).sum(dim=1) + ovf)[live].float()
        named = torch.unique(tables.portal_page[pid[pid >= 0].long()])
        for kind, kernel, plain, args in (
                ("resident", st.resident_kernel, st.resident_plain, (o, d, tm)),
                ("page", st.page_kernel, st.page_plain, (o, d, tm, *page_in))):
            name = f"{kind}_{mode}"
            ms, plain_ms, text = time_pair(lambda: kernel(any_hit, tables, *args),
                                           lambda: plain(any_hit, tables, *args))
            work = dict(st.last_work[name])  # the last timed plain call's visits
            ops = work["nodes"] * wt.OPS_PER_NODE + work["triangles"] * wt.OPS_PER_TRIANGLE
            out = kernel(any_hit, tables, *args)
            # Bytes: the distinct table rows the plain version loads, read
            # once. The resident pass reads every ray and writes whole lists;
            # the page pass reads the walked portals' page and root, the list
            # entries up to each lane's first empty slot, the rays of the
            # lanes with a pending portal, and the running best in and out.
            if kind == "resident":
                need = work["rows"] * 512 + nbytes(args, out)
            else:
                need = (work["rows"] * 512 + 8 * work["portals"] + 4 * work["entries"]
                        + 28 * work["lanes"] + nbytes(page_in[2:], out))
            b_ms, b_by = bound(need, ops)
            if label.startswith("bounce-1"):
                results[name] = {"max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            # Warp utilisation: a one-thread-a-ray schedule's (the plain
            # version's per-ray visits), the walk's (its instrumented launch).
            util_old = wt.warp_utilisation(st.last_pops[name])
            _, stats = st.pass_stats(kind, any_hit, tables, *args)
            ties = f"; ids differ at {page_ties} exact ties" if kind == "page" and not any_hit \
                else ""
            say("3st", f"{KERNELS[name][0]} on the {label} wave: parity ok on "
                       f"{o.shape[0]} rays{ties}; {text}; work {work}, {ops} ops; {need} bytes; "
                       f"bound {b_ms:.4f} ms ({b_by}); warp utilisation one thread a ray "
                       f"{util_old:.4f}, walk {wt.kernel_utilisation(stats):.4f}, its "
                       f"counters {stats}")
        # The whole paged trace against the merged wide kernels (K1 on the
        # primary wave, K2 on the others) over the same tree's merged tables.
        role = "any" if any_hit else ("primary" if label == "primary" else "closest")
        fn6 = DISPATCH.stream_any if any_hit else DISPATCH.stream_closest
        out6 = fn6(tables, o, d, tm)
        passes = st.last_trace["passes"]
        out12 = getattr(DISPATCH, role)(merged, o, d, tm)
        if role == "primary":  # K1 on this tree by the primary bar (u, v too)
            parity.compare_closest(out12, PLAIN.primary(merged, o, d, tm),
                                   parity.TRI_MATCH_COHERENT, True, (merged, o, d))
        # The whole paged trace against the plain one (closest hit by the
        # tie-aware bar, any hit exact), then against the merged kernels.
        if any_hit:
            parity.compare_any(out6, PLAIN.stream_any(tables, o, d, tm))
        else:
            (hit_p, residual_p) = PLAIN.stream_closest(tables, o, d, tm)
            if not torch.equal(out6[1], residual_p):
                raise AssertionError("residual lanes differ from the plain trace's")
            parity.compare_stream_closest(out6[0], hit_p, (tables, o, d))
        if any_hit:
            parity.compare_any(out6, out12)
            match = 1.0
        else:
            (hit6, residual), hit12 = out6, out12
            if bool(residual.any()):
                raise AssertionError(f"{int(residual.sum())} truncated lanes")
            if not torch.equal(hit6.tri >= 0, hit12.tri >= 0):
                raise AssertionError(f"hit masks differ from {role} on "
                                     f"{int(((hit6.tri >= 0) != (hit12.tri >= 0)).sum())} rays")
            both = hit6.tri >= 0
            match = (hit6.tri == hit12.tri)[both].float().mean().item()
            if match <= parity.TRI_MATCH_COHERENT:
                raise AssertionError(f"tri match with {role} {match}")
        ms6 = sorted(cuda_ms(lambda: fn6(tables, o, d, tm), 3, 3))[1]
        ms12 = sorted(cuda_ms(lambda: getattr(DISPATCH, role)(merged, o, d, tm), 10, 7))[3]
        say("3st", f"{label} wave ({int(live.sum())} live rays): {passes} passes; portals "
                   f"a lane enumerated: max {int(portals.max())}, mean "
                   f"{float(portals.mean()):.2f}; {named.numel()} of "
                   f"{tables.pages.shape[0]} pages named; paged trace {ms6:.4f} ms "
                   f"(resident + page launches and the host's pass loop) vs merged "
                   f"{KERNELS[role][0]} {ms12:.4f} ms on {nbytes(merged.nodes, merged.rows)} "
                   f"bytes of merged tables; hit masks equal, tri equal on {match:.5f}")
    for name, err in errs.items():
        results[name]["max_abs_err"] = err


def _probe_text(row: dict) -> str:
    return ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in row.items() if k not in ("probe", "device", "path"))


def phase_probes(pt, results: dict) -> None:
    """Phase 3pr on the merged scene's tables and its bounce-1 wave: the gang
    probes (ablation variants, the run to the end against K2, the micro
    stages) and the fetch probes (every case at 1 and PROBE_TILES tiles, the
    edge cases, the glue's row gather), each kernel against its plain
    version, timed, with bounds and the path each launch took. The kernels
    line takes `full` (pg_ablate), `push` (pg_micro), the glue's row gather
    (pf_lane, with `index_select` as its library call) and exp_gather.py B
    f32 at 512 rows on PROBE_TILES tiles (pf_window)."""
    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH
    from gpu_raytracer_tpu_torch.probes import fetch, gang

    def timer(fn):
        return cuda_ms(fn, 10, 7)

    got = probes.bounce1(pt)
    gt, wave = got["gt"], got["wave"]
    rows = gang.ablation(gt, wave, gang.K_ITERS, timer=timer)
    for r in rows:
        say("3pr", f"pg_ablate<{r['variant']}>: parity ok (tri, t bit-equal on "
                   f"{r['parity_tiles']} tiles); {_probe_text(r)}")
    full = rows[0]
    b_ms, b_by = bound(full["bytes"], full["ops"])
    results["pg_ablate"] = {"max_abs_err": 0.0, "ms": full["ms"], "plain_ms": full["plain_ms"],
                            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    say("3pr", f"pg_ablate<full> bound {b_ms:.4f} ms ({b_by}): {full['bytes']} bytes, "
               f"{full['ops']} ops")
    for label, rays in (("bounce-1", wave), ("primary", got["primary"])):
        k2 = gang.converged_vs_closest(gt, got["tables"], rays, DISPATCH.closest, timer=timer)
        say("3pr", f"gang traversal to the end vs K2 (wide_traverse.closest) on the {label} "
                   f"wave: hits equal; {_probe_text(k2)}")

    table, rays = gang.micro_inputs(gt, wave)
    for r in gang.micro_stages(table, rays, gang.N_ITERS, timer=timer):
        say("3pr", f"pg_micro<{r['variant']}>: parity ok (acc bit-equal); {_probe_text(r)}")
    m_ms, m_by = bound(*gang.micro_bytes_ops("push", table, rays.shape[0], gang.N_ITERS))
    results["pg_micro"] = {"max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
                           "bound_ms": m_ms, "bound_by": m_by, "library_ms": None}

    for tiles in (1, PROBE_TILES):
        for r in fetch.probe_fetches("cuda", fetch.ITERS, tiles, timer=timer):
            r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"])
            r["bound_share"] = r["bound_ms"] / r["ms"]
            say("3pr", f"{r['kernel']}<{r['mode']}> {r['probe']}, {r['indices']} indices, "
                       f"{tiles} tile(s), path {r['path']}: parity ok (exact); "
                       f"{_probe_text(r)}")
            if (tiles == PROBE_TILES and r["probe"] == "exp_gather.py:100 B f32"
                    and r["indices"] == "coherent"):
                results["pf_window"] = {"max_abs_err": 0.0, "ms": r["ms"],
                                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                                        "bound_by": r["bound_by"], "library_ms": None}
    for r in fetch.edge_fetches("cuda"):
        say("3pr", f"{r['kernel']}<{r['mode']}> {r['probe']}, {r['lanes']} lanes, {r['iters']} "
                   f"iterations, path {r['path']} {r['launch']}: parity ok (exact)")
    g = fetch.glue_fetch(got["shade_rows"], got["hit_tri"], timer=timer)
    g["bound_ms"], g["bound_by"] = bound(g["bytes"], g["ops"])
    results["pf_lane"] = {"max_abs_err": 0.0, "ms": g["ms"], "plain_ms": g["plain_ms"],
                          "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                          "library_ms": g["library_ms"]}
    say("3pr", f"pf_lane<rows> {g['probe']} on the bounce-1 wave: equal to index_select; "
               f"{_probe_text(g)}")
    phase_probes_small(results)


def _kernel_row(r: dict, library_ms=None) -> dict:
    b_ms, b_by = bound(r["bytes"], r["ops"])
    r["bound_ms"], r["bound_by"] = b_ms, b_by
    return {"max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def phase_probes_small(results: dict) -> None:
    """Phase 3pr, the single-block probes (the Hopper counterparts of
    tools/exp_blocksync.py, exp_scalar_read.py, exp_vmem2.py,
    exp_gang_prims.py, exp_gang_prims2.py and exp_dma*.py) at the probes'
    own sizes, inputs from seeded numpy, each launch against its plain
    version (bit-equal; copies exact) and timed: the pop loop on the own and
    the scaled table; every scalar-read body (the roll in both spaces) beside
    one `index_select` of its values and one `embedding_bag` summing them (the
    kernels line's library call); the shared-memory ceiling against the
    device attribute; every gang-primitive body at the probes' iteration
    counts on the own and the chase tables, `full` on the table times 1e4
    (parity at 256 iterations; full, smem, v1 and v2, which have kernels of
    their own, at 2,051: past two of v1's and v2's chunks and past smem's
    fixed point at 62), v1, v2 and smem beside one `index_select` and one
    `torch.sum` of the values they read; every
    copy body with both mechanisms at one block, and the 16 KB-window bodies
    at one block an SM. The kernels line takes the pop loop on the own
    table, read body A, `stack` on the chase table and exp_dma.py k_smem
    with the bulk copy at one block."""
    import torch

    from gpu_raytracer_tpu_torch import probes
    from gpu_raytracer_tpu_torch.probes import block, dma, prims, read

    def timer(fn):
        return cuda_ms(fn, 10, 7)

    for r in block.probe_pops("cuda", timer=timer):
        row = _kernel_row(r)
        say("3pr", f"pb_pop on the {r['table']} table: parity ok (bit-equal); {_probe_text(r)}")
        if r["table"] == "own":
            results["pb_pop"] = row
    for r in read.probe_reads("cuda", timer=timer):
        row = _kernel_row(r, r["embedding_bag_ms"])
        say("3pr", f"pr_read<{r['body']}, {r['space']}> {r['probe']}: parity ok (bit-equal); "
                   f"{_probe_text(r)}")
        if r["body"] == "A":
            results["pr_read"] = row
    ceiling = read.smem_ceiling(torch.rand(read.SHAPE, device="cuda"), timer=timer)
    if not (ceiling["ceiling_bytes"] == ceiling["attribute_bytes"]
            and ceiling["above_error"] == read.REFUSED):
        raise AssertionError(f"shared-memory ceiling {ceiling}")
    say("3pr", f"pr_read<ceiling>: the largest dynamic shared memory a launch gets is "
               f"{ceiling['ceiling_bytes']} bytes = cudaDevAttrMaxSharedMemoryPerBlockOptin "
               f"{ceiling['attribute_bytes']}; {ceiling['ceiling_bytes'] + 16} bytes refused "
               f"(cudaError_t {ceiling['above_error']}); {len(ceiling['ladder'])} launches; "
               f"the launch at the ceiling {ceiling['ms']:.6f} ms, the plain fill "
               f"{ceiling['plain_ms']:.6f} ms; bound {bound(ceiling['bytes'], 0)[0]:.3g} ms")
    for r in prims.probe_prims("cuda", timer=probes.probe_ms):
        row = _kernel_row(r)
        say("3pr", f"pp_gang<{r['body']}> {r['probe']} on the {r['table']} table: parity ok "
                   f"(bit-equal at {r.get('parity_iters')} iterations); {_probe_text(r)}")
        if r["body"] == "stack" and r["table"] == "chase":
            results["pp_gang"] = row
    rows = dma.probe_copies("cuda", timer=timer)
    rows += dma.probe_copies("cuda", blocks=132, timer=timer, bodies=dma.WINDOW_BODIES)
    for r in rows:
        row = _kernel_row(r)
        say("3pr", f"pd_copy<{r['body']}, {r['mech']}> {r['probe']}, {r['blocks']} block(s): "
                   f"parity ok (exact); {_probe_text(r)}")
        if (r["body"], r["mech"], r["blocks"]) == ("dma.smem", "bulk", 1):
            results["pd_copy"] = row


def phase_slice(pt, phase: str, names: tuple, forbid: tuple = ()) -> dict:
    """Phases 4, 4tl, 4sm, 4sm1080 and 4st: one warm-up sample, then SPP timed
    samples, with every count set to 0 just before and read just after.
    Every kernel in `names` must launch, none in `forbid`, no plain version
    may run, and the frame must be finite, free of NaN samples and not
    black. Returns the launch counts."""
    import numpy as np
    import torch

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.render()
    torch.cuda.synchronize()
    first_ms = 1000.0 * (time.perf_counter() - t0)
    pt.reset_accumulation()
    per_sample = []
    for _ in range(SPP):
        t0 = time.perf_counter()
        pt.render()
        torch.cuda.synchronize()
        per_sample.append(1000.0 * (time.perf_counter() - t0))
    launched, plain = counts()
    for name in names:
        if launched[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the {phase} run")
    ran = {n: launched[n] for n in forbid if launched[n]}
    if ran:
        raise AssertionError(f"kernels off the {phase} route launched: {ran}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran in the {phase} run: {plain}")
    frame = pt.framebuffer()
    if not np.isfinite(frame).all():
        raise AssertionError(f"non-finite pixels in the {phase} frame")
    if pt.magenta_pixels:
        raise AssertionError(f"{pt.magenta_pixels} magenta (NaN) pixel samples")
    mean = float(frame.mean())
    if not mean > 0:
        raise AssertionError(f"frame mean {mean} is not > 0")
    dt = sum(per_sample) / 1000.0
    per = {n: launched[n] / (SPP + 1) for n in names}
    say(phase, f"{pt.width}x{pt.height} b{pt.gpu_config.num_bounces}: warm-up sample "
               f"{first_ms:.1f} ms; {SPP} spp: {1000.0 * dt / SPP:.1f} ms/sample (each: "
               f"{', '.join(f'{x:.1f}' for x in per_sample)}), {pt.rays_traced} rays, "
               f"{pt.rays_traced / dt / 1e6:.2f} Mrays/s, mean {mean:.4f}; "
               f"launches {launched} ({per} per sample); route {pt.route()}; "
               f"paths {pt.paths}")
    return launched


def phase_image(scene, pt, phase: str, route: str = "wide", spp: int = 8) -> None:
    """Phase 5: 256x256, `spp` spp, kernels vs plain versions on the card,
    both on `route`."""
    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN, Pathtracer

    scene.film_width = scene.film_height = 256
    scene.camera.resize(256, 256)
    imgs, rays = [], []
    for kernels in (None, PLAIN):
        p = Pathtracer(scene, pt.cpu_config, pt.gpu_config, device=pt.device,
                       **({} if kernels is None else {"kernels": kernels}))
        p.buffers = pt.buffers
        p.reset_accumulation()
        if p.route() != route:
            raise AssertionError(f"{phase}: route {p.route()}, want {route}")
        imgs.append(p.render_samples(spp))
        rays.append(p.rays_traced)
    rel_rmse = parity.compare_images(*imgs, *rays)
    say(phase, f"256x256 {spp} spp kernels vs plain on the {route} route: rel-RMSE "
               f"{rel_rmse:.3g}, rays {rays[0]} vs {rays[1]}")


def denoised_pathtracer(scene, pt):
    """A Pathtracer of the denoised path (SVGF + TAA, the GPUConfig
    defaults) on the tables of `pt`, with a history of its own."""
    import dataclasses

    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer

    p = Pathtracer(scene, pt.cpu_config,
                   dataclasses.replace(pt.gpu_config, enable_svgf=True,
                                       enable_taa=True),
                   device=pt.device)
    p.share_tables(pt)
    return p


def phase_svgf_kernels(scene, pt, results: dict) -> None:
    """Phase 3sv: both SVGF kernels against their plain versions on the
    inputs of the fifth 1080p denoised frame, timed, with bounds; the shade
    kernel with demod on a captured wave of the denoised path."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv

    pts = denoised_pathtracer(scene, pt)
    got = parity.capture_svgf(pts, 5)
    short = static_short = float((got["length"] < 4).float().mean())
    say("3sv", f"C5: history length < 4 on {static_short:.4f} of the pixels at the fifth "
               f"static frame (static instances keep their history)")
    if not 0.0 < short < 1.0:
        # Every pixel on one side of the select: a sixth frame after a pan,
        # whose border pixels are new, gives the kernels both sides.
        cam = scene.camera
        saved = cam.position.copy()
        cam.position = cam.position + pan_step(pts) * cam.x_axis_rotated.astype("float32")
        cam.update(0.0)
        try:
            got = parity.capture_svgf(pts, 1)
        finally:
            cam.position = saved
            cam.update(0.0)
        short = float((got["length"] < 4).float().mean())
    if not 0.0 < short < 1.0:
        raise AssertionError(f"share of pixels with history < 4 is {short}: "
                             f"one side of the select is missing")
    for role in ("svgf_variance", "svgf_atrous"):
        rows = []
        for args, kw in got[role]:
            kernel = getattr(DISPATCH, role)
            plain = getattr(PLAIN, role)
            out = kernel(*args, **kw)
            err = parity.compare_stencil(out, plain(*args, **kw))
            ms, plain_ms, text = time_pair(lambda: kernel(*args, **kw),
                                           lambda: plain(*args, **kw))
            ops = pointwise_ops(lambda: plain(*args, **kw))
            guide, dyn = args[0], args[1]
            b_ms, b_by = bound(nbytes(guide, dyn, out), ops)
            rows.append((err, ms, plain_ms, b_ms, b_by))
            step = f" step {args[2]}" if role == "svgf_atrous" else ""
            say("3sv", f"{KERNELS[role][0]}{step}: parity ok on {tuple(dyn.shape)} "
                       f"(max abs err {err:.3g}); {text}; {ops} pointwise ops of the "
                       f"plain version; bound {b_ms:.4f} ms ({b_by})")
        n = len(rows)  # a-trous: means over the steps (same bytes and ops)
        results[role] = {"max_abs_err": max(r[0] for r in rows),
                         "ms": sum(r[1] for r in rows) / n,
                         "plain_ms": sum(r[2] for r in rows) / n,
                         "bound_ms": sum(r[3] for r in rows) / n,
                         "bound_by": rows[0][4], "library_ms": None}
    say("3sv", f"history length < 4 on {short:.3f} of the pixels; svgf_atrous "
               f"numbers are means over its {len(got['svgf_atrous'])} steps")
    # The variance kernel's run-time instance (the path runs the static one).
    (guide, dyn, sigma_z, _, sigma_l), _ = got["svgf_variance"][0]
    before = dict(sv.variance_instances)
    for sigma_n in (8.0, 12.5):
        args = (guide, dyn, sigma_z, sigma_n, sigma_l)
        err = parity.compare_stencil(sv.svgf_variance(*args), sv.variance_plain(*args))
        say("3sv", f"svgf_stencil.variance sigma_n {sigma_n}: parity ok on "
                   f"{tuple(dyn.shape)} (max abs err {err:.3g})")
    if sv.variance_instances["runtime"] != before["runtime"] + 2:
        raise AssertionError(f"the run-time variance instance did not run: "
                             f"{sv.variance_instances} (before {before})")

    phase_shade(pts, "3sv", "denoised 1080p (demod)", with_aovs=True)


def pan_step(pts) -> float:
    """The sideways camera step that shifts the image ~PAN_PX pixels at the
    median depth of the last denoised frame of `pts`."""
    import math

    depth = pts.svgf_history.depth
    z = float(depth[depth < 1e29].median())
    return PAN_PX * z / (0.5 * pts.width / math.tan(0.5 * pts.scene.camera.fov))


def phase_denoised(scene, pt, phase: str) -> dict:
    """Phase 4sv: the denoised slice at full size. A warm-up frame, then
    SVGF_FRAMES timed frames with the history carried, the last SVGF_MOVING
    of them after a sideways camera step of ~PAN_PX pixels; every count set
    to 0 just before and read just after. Returns the launch counts."""
    import numpy as np
    import torch

    pts = denoised_pathtracer(scene, pt)
    cam = scene.camera
    saved = (cam.position.copy(), cam.rotation.copy())
    names = ("primary", "closest", "any", "shade", "shade_demod", "svgf_variance",
             "svgf_atrous")
    events = {"trace": [], "denoise": []}

    def timed(fn, key):
        def wrapped(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            events[key].append((start, stop))
            return out
        return wrapped

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts.render_frame_denoised()
    torch.cuda.synchronize()
    first_ms = 1000.0 * (time.perf_counter() - t0)
    depth = pts.svgf_history.depth
    z = float(depth[depth < 1e29].median())
    step = pan_step(pts)
    lengths = [float(pts.svgf_history.length.mean())]
    pts.trace_aovs = timed(pts.trace_aovs, "trace")
    pts.denoise = timed(pts.denoise, "denoise")
    frame_ms = []
    try:
        for f in range(SVGF_FRAMES):
            if f >= SVGF_FRAMES - SVGF_MOVING:
                cam.position = cam.position + step * cam.x_axis_rotated.astype(np.float32)
                cam.update(0.0)
            t0 = time.perf_counter()
            colour = pts.render_frame_denoised()
            torch.cuda.synchronize()
            frame_ms.append(1000.0 * (time.perf_counter() - t0))
            lengths.append(float(pts.svgf_history.length.mean()))
            if not bool(torch.isfinite(colour).all()):
                raise AssertionError(f"non-finite pixels in denoised frame {f}")
    finally:
        cam.position, cam.rotation = saved
        cam.update(0.0)
    launched, plain = counts()
    for name in names:
        if launched[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the {phase} run")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran in the {phase} run: {plain}")
    frames = SVGF_FRAMES + 1
    iters = pts.gpu_config.svgf_atrous_iterations
    if (launched["svgf_variance"], launched["svgf_atrous"]) != (frames, iters * frames):
        raise AssertionError(f"SVGF launches {launched['svgf_variance']} / "
                             f"{launched['svgf_atrous']} for {frames} frames")
    if pts.magenta_pixels:
        raise AssertionError(f"{pts.magenta_pixels} magenta (NaN) pixel samples")
    static = lengths[:SVGF_FRAMES - SVGF_MOVING + 1]
    if not all(b > a for a, b in zip(static, static[1:])):
        raise AssertionError(f"mean history length does not rise over the static "
                             f"frames: {static}")
    if not lengths[-1] > 1.5:
        raise AssertionError(f"the pan reset the history: mean length {lengths[-1]}")
    image = pts.framebuffer()
    mean = float(image.mean())
    if not (np.isfinite(image).all() and mean > 0):
        raise AssertionError(f"denoised frame mean {mean} is not finite and > 0")
    trace = [a.elapsed_time(b) for a, b in events["trace"]]
    den = [a.elapsed_time(b) for a, b in events["denoise"]]
    per = {n: launched[n] / frames for n in names}
    say(phase, f"{pts.width}x{pts.height} b{pts.gpu_config.num_bounces} SVGF + TAA "
               f"({iters} a-trous iterations): warm-up frame {first_ms:.1f} ms; "
               f"{SVGF_FRAMES} frames: {sum(frame_ms) / SVGF_FRAMES:.1f} ms/frame (each: "
               f"{', '.join(f'{x:.1f}' for x in frame_ms)}); device ms per frame: trace "
               f"{sum(trace) / len(trace):.2f}, SVGF + TAA {sum(den) / len(den):.2f} "
               f"(trace {', '.join(f'{x:.1f}' for x in trace)}; SVGF + TAA "
               f"{', '.join(f'{x:.2f}' for x in den)}); camera step {step:.5f} per "
               f"moving frame (median depth {z:.3f}); mean history length "
               f"{', '.join(f'{x:.3f}' for x in lengths)}; {pts.rays_traced} rays; "
               f"frame mean {mean:.4f}; launches {launched} ({per} per frame); "
               f"paths {pts.paths}")
    return launched


def phase_denoised_image(scene, pt, phase: str) -> None:
    """Phase 5sv: 256x256, 4 denoised frames, kernels vs plain versions."""
    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN

    scene.film_width = scene.film_height = 256
    scene.camera.resize(256, 256)
    runs = []
    for kernels in (None, PLAIN):
        p = denoised_pathtracer(scene, pt)
        if kernels is not None:
            p.kernels = kernels
        runs.append(([p.render_frame_denoised().cpu().numpy() for _ in range(4)],
                     p.rays_traced))
    (fa, ra), (fb, rb) = runs
    errs = [parity.compare_images(a, b, ra, rb) for a, b in zip(fa, fb)]
    say(phase, f"256x256 4 denoised frames kernels vs plain: rel-RMSE "
               f"{', '.join(f'{e:.3g}' for e in errs)}; rays {ra} vs {rb}")


def phase_mixed_kernels(pt, pt_small) -> None:
    """Phase 3mx: K3 on the mixed, textured 1080p scene's bounce-1 and
    last-bounce waves (the port's own Kulla-Conty curves, the texture taps
    in the kernel) and K7 on the mixed Cornell stand-in's bounce-1 wave (its
    curves in the instance rows), each against its plain version, timed,
    with bounds: the times beside phase 3's and 3sm's diffuse-only waves."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs

    _, calls = phase_shade(pt, "3mx", "mixed, textured 1080p")
    (tables, params, lanes), kw = calls[0]
    ok = lanes["tri"] >= 0
    mat_of = torch.where(ok, tables.inst_rows[lanes["inst"].clamp(min=0).long(), 24].long(), 0)
    types = tables.mat_tbl[0].long()[mat_of]
    live = lanes["alive"] & ok
    mix = {n: int((live & (types == t)).sum()) for n, t in
           (("diffuse", 1), ("plastic", 2), ("dielectric", 3), ("conductor", 4))}
    textured = int((live & (tables.inst_rows[lanes["inst"].clamp(min=0).long(), 25] >= 0)).sum())
    say("3mx", f"the mixed bounce-1 wave's live lanes by BSDF {mix}, {textured} on a textured "
               f"instance")

    args, kw = parity.capture_wave(pt_small, pt_small.width * pt_small.height,
                                   route="binary_shade", every=True)["fused_shade"][1]
    ka, pa = DISPATCH.fused_shade(*args, **kw), PLAIN.fused_shade(*args, **kw)
    torch.cuda.synchronize()
    err = parity.compare_shade(ka, pa)
    ms, plain_ms, text = time_pair(lambda: DISPATCH.fused_shade(*args, **kw),
                                   lambda: PLAIN.fused_shade(*args, **kw))
    ops = pointwise_ops(lambda: PLAIN.fused_shade(*args, **kw))
    b_ms, b_by = bound(fs.moved_bytes(args, ka), ops)
    say("3mx", f"fused_shade on the mixed Cornell {pt_small.width}x{pt_small.height} "
               f"bounce-1 wave: parity ok on {args[3].t.shape[0]} lanes "
               f"({int(args[7].sum())} live; max abs err {err:.3g}); {text}; {ops} "
               f"pointwise ops of the plain version; bound {b_ms:.4f} ms ({b_by})")


def build_media_scenes():
    """Phase "scene" for the media scenes: `scenes.media_scene` at 1920x1080
    (the merged cell's room, light and subdivision-6 spheres, so its merged
    tree comes from the merged cell's cache; the spheres smooth glass
    holding an ink, a forward scatterer and a thick isotropic medium) on the
    wide route, and `scenes.media_cornell` at 512x512 on route (b) (the
    fused shade refuses media). Both BOUNCES_MD bounces. Returns ((scene,
    Pathtracer), (scene, Pathtracer))."""
    from gpu_raytracer_tpu_torch import GPUConfig
    from gpu_raytracer_tpu_torch.ops import buffers as tb
    from gpu_raytracer_tpu_torch.scenes import media_cornell, media_scene

    out = []
    for key, make, route in (
            ("media", lambda: media_scene(FULL_W, FULL_H, SPHERE_SUBDIV), "wide"),
            ("media Cornell", lambda: media_cornell(SMALL, SMALL), "binary")):
        scene, pt, t_geo, t_tab = build_pathtracer(make, GPUConfig(num_bounces=BOUNCES_MD))
        if pt.route() != route or not pt.has_media or pt.buffers["fused_shade"] is not None:
            raise AssertionError(f"the {key} scene takes the {pt.route()} route")
        med = tb.pack_mediums(scene)
        wide = pt.buffers["wide"]
        say("scene", f"{key}: {scene.triangle_count()} triangles, {len(scene.instances)} "
                     f"instances; media (sigma_a, sigma_s, g) "
                     f"{[(a.tolist(), b.tolist(), float(g)) for a, b, g in zip(med['sigma_a'], med['sigma_s'], med['g'])]}; "
                     f"tessellation {t_geo:.2f} s; tables {t_tab:.2f} s; "
                     + (f"wide tables {wide.nodes.shape[0]} nodes + {wide.rows.shape[0]} leaf "
                        f"rows; " if wide is not None else "")
                     + f"route {pt.route()} (the fused shade's gate refuses media)")
        out.append((scene, pt))
    return out


def phase_media_kernels(pt, pt_small, pt_mixed, results: dict) -> None:
    """Phase 3md: K3's SG_MEDIA instances against the plain version on the
    bounce-1 wave of a captured sample: the media 1080p scene's (instance
    media, the wide route) and the media Cornell stand-in's (media_uv, route
    (b)); the shade bar and medium_id equal on every lane; timed 7 x 10
    launches behind a device spin beside the instance without SG_MEDIA on
    the same lanes, with bounds. Every later media call of each sample held
    the same way (not timed), the last bounce's by its own bar. And the
    textured instances (media_tex, media_uv_tex) on the mixed scene's
    bounce-1 wave with seeded medium ids (u, v re-derived for the latter)."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import DISPATCH, PLAIN
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg

    for p, route, key, label in ((pt, "wide", "shade_media", "media 1080p"),
                                 (pt_small, "binary", "shade_media_uv",
                                  "media Cornell 512x512, route (b)")):
        calls = parity.capture_wave(p, min(p.cpu_config.batch_size, p.width * p.height),
                                    route=route, every=True)["shade"]
        (tables, params, lanes), kw = calls[0]
        mode = sg.mode_of(lanes, kw["textured"], kw["last"])
        if not mode & sg.SG_MEDIA or int(params[0]) != 1:
            raise AssertionError(f"{label}: the bounce-1 call runs instance {mode}")
        ka, pa = DISPATCH.shade(tables, params, lanes, **kw), PLAIN.shade(tables, params, lanes, **kw)
        torch.cuda.synchronize()
        err = parity.compare_shade(ka, pa)
        # The bar is relative: paths through the media carry throughputs far
        # above 1 (T / pdf of the spectral pick), so the absolute error is
        # read beside the largest output.
        scale = max(float(pa[k].abs().max()) for k in parity.SHADE_OUTPUT_LANES)
        handed = parity.compare_medium(ka, pa, lanes["medium_id"])
        ms, plain_ms, text = time_pair(lambda: DISPATCH.shade(tables, params, lanes, **kw),
                                       lambda: PLAIN.shade(tables, params, lanes, **kw))
        base = {k: v for k, v in lanes.items() if k != "medium_id"}
        base_ms = sorted(cuda_ms(lambda: DISPATCH.shade(tables, params, base, **kw), 10, 7))
        ops = pointwise_ops(lambda: PLAIN.shade(tables, params, lanes, **kw))
        moved = sg.moved_bytes((tables, params, lanes), kw, ka)
        b_ms, b_by = bound(moved, ops)
        base_out = DISPATCH.shade(tables, params, base, **kw)
        base_moved = sg.moved_bytes((tables, params, base), kw, base_out)
        base_b, _ = bound(base_moved, ops)
        if parity.shade_lanes_differ(ka, base_out):
            raise AssertionError(f"{label}: SG_MEDIA changed the shade outputs")
        results[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None}
        later = 0
        for (a, k) in calls[1:]:
            ka2, pa2 = DISPATCH.shade(*a, **k), PLAIN.shade(*a, **k)
            if k["last"]:
                parity.compare_shade_last(ka2, pa2)
            else:
                parity.compare_shade(ka2, pa2)
                later += parity.compare_medium(ka2, pa2, a[2]["medium_id"])
        info, base_info = sg.kernel_info(mode), sg.kernel_info(mode & ~sg.SG_MEDIA)
        say("3md", f"shade_gather.{SHADE_MODES[mode]} (instance {mode}) on the {label} bounce-1 "
                   f"wave ({int(lanes['alive'].sum())} live of {lanes['t'].shape[0]}, "
                   f"{int((lanes['medium_id'] >= 0).sum())} in a medium): parity ok (max abs "
                   f"err {err:.3g} on outputs up to {scale:.3g}), medium_id equal on every "
                   f"lane ({handed} handed over); "
                   f"{text}; instance {mode & ~sg.SG_MEDIA} on the same lanes "
                   f"{base_ms[3]:.4f} ms ({base_ms[0]:.4f}-{base_ms[-1]:.4f}), SG_MEDIA "
                   f"{100.0 * (ms / base_ms[3] - 1.0):+.2f}%, its other outputs bit-equal; "
                   f"{ops} pointwise ops of the plain version; bound {b_ms:.4f} ms ({b_by}: "
                   f"{moved} bytes; without SG_MEDIA {base_moved} bytes, {base_b:.4f} ms); "
                   f"registers {info['registers']} / {base_info['registers']}, stack frame "
                   f"{info['local_bytes']} / {base_info['local_bytes']} bytes, blocks an SM "
                   f"{info['blocks_per_sm']} / {base_info['blocks_per_sm']}; the sample's "
                   f"{len(calls) - 1} later calls held too ({later} lanes handed over)")

    (tables, params, lanes), kw = parity.capture_wave(pt_mixed, pt_mixed.cpu_config.batch_size)[
        "shade"]
    gen = torch.Generator(device="cuda").manual_seed(15)
    medium = torch.randint(-1, 3, lanes["t"].shape, device="cuda", generator=gen,
                           dtype=torch.int32)
    ok = lanes["tri"] >= 0
    irow = tables.inst_rows[lanes["inst"].clamp(min=0).long()]
    srow = tables.shade_rows[lanes["tri"].clamp(min=0).long()]
    u, v = sg.rederive_uv(srow, irow, lanes["ray_o"], lanes["ray_d"], lanes["t"], ok)
    for extra in ({}, {"u": u, "v": v}):
        tl = dict(lanes, medium_id=medium, **extra)
        mode = sg.mode_of(tl, kw["textured"], False)
        ka, pa = DISPATCH.shade(tables, params, tl, **kw), PLAIN.shade(tables, params, tl, **kw)
        torch.cuda.synchronize()
        err = parity.compare_shade(ka, pa)
        handed = parity.compare_medium(ka, pa, medium)
        ms = sorted(cuda_ms(lambda: DISPATCH.shade(tables, params, tl, **kw), 10, 7))[3]
        say("3md", f"shade_gather.{SHADE_MODES[mode]} (instance {mode}) on the mixed, textured "
                   f"1080p bounce-1 wave with seeded medium ids: parity ok (max abs err "
                   f"{err:.3g}), medium_id equal on every lane ({handed} handed over); kernel "
                   f"{ms:.4f} ms")


def phase_media_profile(pt) -> None:
    """Phase 4md's profile: one more warm 1080p sample of the media scene
    under torch.profiler (tools/torch_profile_sample.py `profile_sample`
    after one unprofiled warm sample): wall, device busy ms and idle share,
    host launches, and the device time of the port's kernels and the
    largest other kernels."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_profile_sample as prof

    prof.WARM = 1
    r = prof.profile_sample(pt.render)
    top = "; ".join(f"{t['name'][:48]} {t['ms']:.2f} ms x{t['count']}" for t in r["top"][:8])
    say("4md", f"profiled {pt.width}x{pt.height} b{pt.gpu_config.num_bounces} media sample: wall "
               f"{r['wall_ms']:.2f} ms, device busy {r['device_busy_ms']:.2f} ms, idle share "
               f"{r['idle_share']:.3f}, {r['device_events']} device events, "
               f"{r['host_launches']} cudaLaunchKernel calls ({r['host_launch_ms']:.2f} ms "
               f"host); largest: {top}")


def phase_compaction(scenes: dict, card: str) -> None:
    """Phase 4cp: the late-bounce compaction (render_wave `compact_tiers`)
    at the default depth, on the merged 1080p cell at `GPUConfig()` (b10)
    and the instanced 1080p b4 cell, each a Pathtracer sharing its cell's
    tables, three ways: full width (no tiers), the tiers `Pathtracer`
    passes (`default_compact_tiers`, reported by `compaction`) and
    COMPACT_FORCED, which narrows both cells (the gate patched to give each
    way's tiers). One sample each way, counts set to 0 before the compacted
    ones and read after them: every kernel of the cell's route launched, no
    plain version; each compacted image against the full-width one, max |d|
    <= 1e-6 (expected 0), and equal rays; the live lanes and width of each
    bounce of the first wave and the waves that narrowed (COMPACT_FORCED
    must narrow one). Then warm ms/sample each way (median of 3, in
    turns) and one sample each way under torch.profiler
    (tools/torch_profile_sample.py, after a warm one): wall, device busy
    ms, launches, and the compaction's own launches and device ms (the
    kernels under its profiler range, `pathtracer.COMPACT_RANGE`, over
    every wave)."""
    from unittest import mock

    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch import GPUConfig
    from gpu_raytracer_tpu_torch.integrators import pathtracer as ptm

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_profile_sample as prof

    prof.WARM = 1
    cells = (("merged", GPUConfig(), ("primary", "closest", "any", "shade", "shade_last")),
             ("two_level", GPUConfig(num_bounces=BOUNCES_TL),
              ("primary_tl", "closest_tl", "any_tl", "shade", "shade_last")))
    for key, gpu, names in cells:
        scene, base = scenes[key]
        pt = ptm.Pathtracer(scene, base.cpu_config, gpu, device="cuda")
        pt.share_tables(base)
        report = pt.compaction
        if not report["tiers"]:
            raise AssertionError(f"4cp {key}: no compaction tiers at b{gpu.num_bounces}")
        wave = pt._wave_size()
        ways = {"full width": (), "default": report["tiers"], "forced": COMPACT_FORCED}

        def render(tiers):
            with mock.patch.object(ptm, "default_compact_tiers", lambda R, config: tiers):
                pt.render()
            torch.cuda.synchronize()

        got = {}
        for way, tiers in ways.items():
            pt.reset_accumulation()
            if way == "default":
                reset_counts()
            render(tiers)
            got[way] = (pt.framebuffer(), pt.rays_traced, pt.compaction)
        launched, plain = counts()
        missing = [n for n in names if launched[n] <= 0]
        if missing or any(plain.values()):
            raise AssertionError(f"4cp {key}: kernels {missing} never launched or plain "
                                 f"versions ran: {plain}")
        full, rays_full, _ = got["full width"]
        diffs = {}
        for way in ("default", "forced"):
            img, rays, _ = got[way]
            diffs[way] = float(np.abs(img - full).max())
            if not np.isfinite(img).all() or diffs[way] > 1e-6 or rays != rays_full:
                raise AssertionError(f"4cp {key}, {way} tiers: compacted vs full width max "
                                     f"|d| {diffs[way]}, rays {rays} vs {rays_full}")
        if not got["forced"][2]["waves_narrowed"]:
            raise AssertionError(f"4cp {key}: tiers {COMPACT_FORCED} ran no bounce narrow")
        ms = {way: [] for way in ways}
        for _ in range(3):
            for way, tiers in ways.items():
                t0 = time.perf_counter()
                render(tiers)
                ms[way].append(1000.0 * (time.perf_counter() - t0))
        parts = []
        for way, tiers in ways.items():
            r = prof.profile_sample(lambda t=tiers: render(t), ranges=(ptm.COMPACT_RANGE,))
            own = r["ranges"][ptm.COMPACT_RANGE]
            check = ("" if not tiers else
                     f"max |d| {diffs[way]:.3g} against full width, rays {got[way][1]}; ")
            parts.append(
                f"{way} {tiers}: {check}first wave (bounce, live, width) "
                f"{got[way][2]['bounces']}, {got[way][2]['waves_narrowed']} waves narrowed; "
                f"{np.median(ms[way]):.2f} ms/sample (each "
                f"{', '.join(f'{x:.2f}' for x in ms[way])}); profiled: wall "
                f"{r['wall_ms']:.2f} ms, device busy {r['device_busy_ms']:.2f} ms, idle "
                f"share {r['idle_share']:.3f}, {r['host_launches']} launches, of them the "
                f"compaction's {own['launches']} ({own['device_ms']:.3f} ms device, "
                f"{own['calls']} packings and write-backs)")
        say("4cp", f"{key} {pt.width}x{pt.height} b{gpu.num_bounces} on {card}, "
                   f"{wave}-ray waves, rays {rays_full}: " + " | ".join(parts))


def phase_ao(scene, pt) -> dict:
    """Phase 4ao: the AO integrator (integrators/ao.py) at 1920x1080 on the
    merged cell's tables, route wide: one warm-up sample, SPP timed samples
    with every count set to 0 just before and read just after (K1 primary
    and the wide walk's any mode must launch, nothing else, no plain
    version); then 2 samples on the kernels against 2 on the plain versions
    from a fresh accumulator: visibility equal on >= 99.9% of the pixels.
    Returns the launch counts."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.integrators.ao import AO
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN

    def make(kernels=None):
        ao = AO(scene, pt.cpu_config, pt.gpu_config, device="cuda",
                **({} if kernels is None else {"kernels": kernels}))
        ao.buffers = pt.buffers
        ao.reset_accumulation()
        if ao.route() != "wide":
            raise AssertionError(f"AO takes the {ao.route()} route")
        return ao

    ao = make()
    reset_counts()
    ao.render()
    torch.cuda.synchronize()
    ao.reset_accumulation()
    per = []
    for _ in range(SPP):
        t0 = time.perf_counter()
        ao.render()
        torch.cuda.synchronize()
        per.append(1000.0 * (time.perf_counter() - t0))
    launched, plain = counts()
    ran = {k: v for k, v in launched.items() if v}
    if set(ran) != {"primary", "any"} or any(plain.values()):
        raise AssertionError(f"AO launches {ran}, plain {plain}")
    dt = sum(per) / 1000.0
    frames = []
    for kernels in (None, PLAIN):
        frames.append(make(kernels).render_samples(2))
    agree = float((frames[0] == frames[1]).all(axis=-1).mean())
    if agree < 0.999 or not np.isfinite(frames[0]).all():
        raise AssertionError(f"AO kernels vs plain: visibility agrees on {agree} of the pixels")
    say("4ao", f"AO {ao.width}x{ao.height} (radius {pt.gpu_config.ao_radius}): {SPP} spp "
               f"{1000.0 * dt / SPP:.1f} ms/sample (each: {', '.join(f'{x:.1f}' for x in per)}), "
               f"{ao.rays_traced} rays, {ao.rays_traced / dt / 1e6:.2f} Mrays/s, mean "
               f"visibility {float(ao.framebuffer().mean()):.4f}; launches {ran}; paths "
               f"{ao.paths}; 2 spp kernels vs plain: visibility equal on {agree:.6f} of the "
               f"pixels")
    return launched


def build_mixed_scene(gpu):
    """Phase "scene" for the mixed, textured 1080p scene: the Kulla-Conty
    bake timed cold and warm (first and second bake in the process, no disk
    cache), the scene built (its merged tree of its own: the room is six
    rectangles, not the merged cell's cube), the curve bake timed alone, the
    texture pool's bytes and mip-slot sides. Returns (scene, Pathtracer)."""
    import torch

    from gpu_raytracer_tpu_torch.ops import buffers as tb
    from gpu_raytracer_tpu_torch.ops import kulla_conty as kc
    from gpu_raytracer_tpu_torch.scenes import mixed_scene

    import numpy as np

    bake_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        luts = kc.bake_luts(kc.DEFAULT_SAMPLES, "cuda", cache=False)
        torch.cuda.synchronize()
        bake_s.append(time.perf_counter() - t0)
    if any(luts[k].device.type != "cuda" for k in kc.TABLES):
        raise AssertionError("the Kulla-Conty bake left the card")
    scene, pt, t_geo, t_tab = build_pathtracer(
        lambda: mixed_scene(FULL_W, FULL_H, SPHERE_SUBDIV, True), gpu)
    t0 = time.perf_counter()
    curves = kc.bake_material_curves(pt.buffers["luts"], tb.pack_materials(scene))
    t_curves = time.perf_counter() - t0
    kc_tbl = pt.buffers["shade_gather"][1].cpu().numpy()
    if not (np.array_equal(curves, kc_tbl) and np.abs(kc_tbl).sum() > 0):
        raise AssertionError("K3's curve table is not the port's own bake")
    tex = pt.buffers["textures"]
    wide = pt.buffers["wide"]
    if pt.route() != "wide" or wide is None or wide.two_level:
        raise AssertionError(f"the mixed scene takes the {pt.route()} route")
    say("scene", f"mixed: {scene.triangle_count()} triangles, {len(scene.instances)} "
                 f"instances, materials {sorted({m.type.name for m in scene.materials})}; "
                 f"Kulla-Conty bake ({kc.DEFAULT_SAMPLES} samples on the card) cold "
                 f"{bake_s[0]:.3f} s, warm {bake_s[1]:.3f} s; tessellation {t_geo:.2f} s; "
                 f"tables {t_tab:.2f} s (its merged BVH, LUTs, curves, texture mips and "
                 f"pool included); curve bake alone {t_curves:.4f} s for "
                 f"{len(scene.materials)} materials; texture pool {tex['pool_bytes']} bytes "
                 f"for textures {list(zip(tex['w0_np'].tolist(), tex['h0_np'].tolist()))} "
                 f"(V {tex['side_np'].tolist()}); wide tables {wide.nodes.shape[0]} nodes + "
                 f"{wide.rows.shape[0]} leaf rows; route {pt.route()}")
    return scene, pt


def phase_anchor(pending) -> None:
    """Phase 7: the independent anchor on the card. The box
    (validate.anchor.box_scene, 64x64, 3 bounces, no Russian roulette) at
    768 spp through Pathtracer(device="cuda") on the kernel path against the
    port's copy of numpy_pt at 768 spp (rendered on the host meanwhile,
    `pending`), under the three bars; every kernel of the route launches and
    no plain version runs."""
    from gpu_raytracer_tpu_torch import CPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.validate import anchor

    scene, _ = anchor.box_scene(anchor.W)
    pt = Pathtracer(scene, CPUConfig(batch_size=anchor.W * anchor.W), anchor.config(),
                    device="cuda")
    pt.init_device()
    reset_counts()
    t0 = time.perf_counter()
    img = anchor.render_port(pt)
    t_port = time.perf_counter() - t0
    launched, plain = counts()
    route = pt.route()
    names = {"binary_shade": ("binary_closest", "binary_any", "fused_shade"),
             "binary": ("binary_closest", "binary_any", "shade"),
             "wide": ("primary", "closest", "any", "shade")}[route]
    if any(launched[n] <= 0 for n in names) or any(plain.values()):
        raise AssertionError(f"anchor on {route}: launches {launched}, plain {plain}")
    t0 = time.perf_counter()
    img_np, t_np = pending.result()
    m = anchor.check(img, img_np)
    say("7", f"independent anchor {anchor.W}x{anchor.W} b{anchor.BOUNCES}, {anchor.SPP} spp "
             f"on the {route} route ({', '.join(f'{n} {launched[n]}' for n in names)} "
             f"launches; {t_port:.1f} s) vs numpy_pt {anchor.SPP} spp ({t_np:.1f} s on the "
             f"host): per-pixel RMSE {m['pixel_rmse']:.5f} < {anchor.PIXEL_RMSE}, region "
             f"RMSE {m['region_rmse']:.5f} < {anchor.REGION_RMSE}, channel means "
             f"{[round(x, 5) for x in m['mean']]} vs {[round(x, 5) for x in m['mean_numpy']]}")


def render_anchor_numpy():
    """(numpy_pt frame of the anchor box at 768 spp, seconds), on the host."""
    from gpu_raytracer_tpu_torch.validate import anchor

    t0 = time.perf_counter()
    scene, npsc = anchor.box_scene(anchor.W)
    return anchor.render_numpy(scene, npsc), time.perf_counter() - t0


def build_stream_scene(gpu):
    """Phase "scene" for the streamed scene: (scene, Pathtracer on its paged
    tables, the merged wide tables of the same world tree on the card). The
    route must be "stream" with no constant patched. Prints the build times,
    the paged tables and the routing gates' numbers."""
    import torch

    from gpu_raytracer_tpu_torch.bvh import wide as wide_mod
    from gpu_raytracer_tpu_torch.ops import buffers as tb
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    spent = {"build_blas_cached": 0.0, "pack_wide_stream": 0.0}

    def timed(fn):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[fn.__name__] += time.perf_counter() - t0
        return wrapped

    saved = tb.build_blas_cached, tb.stream_mod.pack_wide_stream
    tb.build_blas_cached = timed(saved[0])
    tb.stream_mod.pack_wide_stream = timed(saved[1])
    try:
        scene, pt, t_geo, t_tab = build_pathtracer(
            lambda: procedural_scene(FULL_W, FULL_H, STREAM_SUBDIV, shared_sphere=True), gpu)
    finally:
        tb.build_blas_cached, tb.stream_mod.pack_wide_stream = saved
    stream = pt.buffers["stream"]
    if pt.route() != "stream" or pt.buffers["wide"] is not None or stream is None:
        raise AssertionError(f"the streamed scene takes the {pt.route()} route")
    # The yardstick: the merged wide tables of the same world tree, packed
    # with the budget lifted (the tree comes from the disk cache).
    t0 = time.perf_counter()
    budget = tb.VMEM_LIMIT
    tb.VMEM_LIMIT = 1 << 40
    try:
        host = tb.pack_scene(scene)
    finally:
        tb.VMEM_LIMIT = budget
    nodes, rows = host["wide"]
    dev = torch.device("cuda")
    merged = wt.make_tables(torch.as_tensor(nodes, device=dev),
                            torch.as_tensor(rows, device=dev), tb._max_stack_of(nodes, rows))
    t_merged = time.perf_counter() - t0
    merged_bytes = (nodes.shape[0] + rows.shape[0]) * 512
    # The page pass's stack: its deepest page walk with the up to K - 1
    # portals seeded beneath it (stream_traverse.make_stream_tables).
    page_stack = tb.stream_page_stack({k: getattr(stream, k).cpu().numpy() for k in (
        "pages", "portal_page", "portal_root")})
    shared = wide_mod.estimate_table_bytes(
        sum(md.bvh.num_nodes for md in scene.mesh_datas),
        host["tris"]["shade_rows"].shape[0], len(scene.instances))
    say("scene", f"stream: {scene.triangle_count()} triangles ({scene.unique_triangle_count()} "
                 f"unique), {len(scene.instances)} instances; tessellation {t_geo:.2f} s; "
                 f"tables {t_tab:.2f} s, of which BVH builds {spent['build_blas_cached']:.2f} s "
                 f"and the page packing {spent['pack_wide_stream']:.2f} s; paged tables: "
                 f"resident {stream.resident.shape[0]} rows, {stream.pages.shape[0]} pages x "
                 f"{stream.page_rows * 512} bytes, {stream.portal_page.shape[0]} portals, "
                 f"stack bound {stream.max_stack}, page walk {page_stack} + "
                 f"{st.K_PORTALS - 1} seeded portals = {page_stack + st.K_PORTALS - 1} of the "
                 f"kernel's {wt.STACK_CAPACITY}; gates: merged tables {merged_bytes} bytes "
                 f"> {tb.VMEM_LIMIT - tb.VMEM_MARGIN} (VMEM_LIMIT - margin), two-level "
                 f"estimate {shared} > {2 * tb.VMEM_LIMIT}; route {pt.route()}; the merged "
                 f"yardstick ({nodes.shape[0]} nodes + {rows.shape[0]} leaf rows, stack "
                 f"{merged.max_stack}) packed in {t_merged:.2f} s")
    return scene, pt, merged


def move_instance(inst, step: int) -> None:
    """Move an instance by a small step and turn it about the vertical axis
    (its transform updated, as an edit of the scene graph does)."""
    import numpy as np

    from gpu_raytracer_tpu_torch.core import transform as xf

    inst.position = inst.position + np.array([0.004, 0.0, -0.003], np.float32)
    inst.rotation = xf.quat_axis_angle([0.0, 1.0, 0.0], 0.3 * step)
    inst.update()


def fresh_equal(scene, pt, phase: str) -> str:
    """After refreshes: a fresh Pathtracer built on the moved scene must
    hold bit-equal transform-derived tables (inst_prev_rows aside: it holds
    the last rendered frame's transforms), take the same route, and render
    a bit-equal sample. Returns the text of the check."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.ops import buffers as tb

    t0 = time.perf_counter()
    fresh = Pathtracer(scene, pt.cpu_config, pt.gpu_config, device="cuda")
    fresh.init_device()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    keys = [k for k in tb.TRANSFORMED_KEYS if k != "inst_prev_rows"]
    differ = parity.tables_differ(pt.buffers, fresh.buffers, keys)
    if differ or fresh.route() != pt.route():
        raise AssertionError(f"{phase}: refreshed tables differ from a fresh build's in "
                             f"{differ} (routes {pt.route()}, {fresh.route()})")
    pt.reset_accumulation()
    a, b = pt.render_samples(1), fresh.render_samples(1)
    if not np.array_equal(a, b):
        raise AssertionError(f"{phase}: a sample on the refreshed tables differs from one "
                             f"on a fresh build's (max {float(np.abs(a - b).max())})")
    return (f"every transform-derived table bit-equal to a fresh build's ({build_s:.2f} s), "
            f"route {pt.route()}, one sample bit-equal")


def phase_moving(scene, pt, phase: str, movers: list, frames: int, names: tuple,
                 forbid: tuple = ()) -> dict:
    """Phases 4up and 4ups: `frames` frames, each moving and turning the
    instances `movers`, marking `invalidated.scene`, then `update_async`
    and `render`, every count set to 0 just before and read just after (the
    route's kernels must launch, none in `forbid`, no plain version may
    run). Timed: a render alone, one synchronous refresh (`update`), and in
    the loop the submit, the join's wait at the top of render and each
    frame's wall time. Then fresh_equal. Returns the launch counts."""
    import torch

    def ms_since(t0):
        return 1000.0 * (time.perf_counter() - t0)

    pt.reset_accumulation()
    alone = []
    for _ in range(3):
        t0 = time.perf_counter()
        pt.render()
        torch.cuda.synchronize()
        alone.append(ms_since(t0))
    for k in movers:
        move_instance(scene.instances[k], 1)
    pt.invalidated.scene = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.update()
    torch.cuda.synchronize()
    sync_ms = ms_since(t0)
    waits = []
    join = pt._join_pending

    def timed_join():
        t0, pending = time.perf_counter(), pt._pending is not None
        join()
        if pending:
            waits.append(ms_since(t0))
    pt._join_pending = timed_join
    reset_counts()
    torch.cuda.synchronize()
    submit, wall = [], []
    try:
        for f in range(frames):
            for k in movers:
                move_instance(scene.instances[k], f + 2)
            pt.invalidated.scene = True
            t0 = time.perf_counter()
            pt.update_async()
            submit.append(ms_since(t0))
            pt.render()
            torch.cuda.synchronize()
            wall.append(ms_since(t0))
    finally:
        del pt._join_pending
    launched, plain = counts()
    missing = [n for n in names if launched[n] <= 0]
    ran = {n: launched[n] for n in forbid if launched[n]}
    if missing or ran or any(plain.values()):
        raise AssertionError(f"{phase}: kernels {missing} never launched, off-route {ran}, "
                             f"plain versions {plain}")
    if len(waits) != frames:
        raise AssertionError(f"{phase}: {len(waits)} joins for {frames} refreshes")
    check = fresh_equal(scene, pt, phase)

    def mean(xs):
        return sum(xs) / len(xs)
    say(phase, f"{pt.width}x{pt.height} b{pt.gpu_config.num_bounces}, {len(scene.instances)} "
               f"instances, {len(movers)} moved and turned a frame: render alone "
               f"{mean(alone):.1f} ms ({', '.join(f'{x:.1f}' for x in alone)}); synchronous "
               f"refresh (update) {sync_ms:.1f} ms; {frames} frames of update_async + render "
               f"{mean(wall):.1f} ms (each {', '.join(f'{x:.1f}' for x in wall)}); submit "
               f"{mean(submit):.2f} ms, the join's wait at the top of render {mean(waits):.1f} "
               f"ms (each {', '.join(f'{x:.1f}' for x in waits)}); update_async hides "
               f"{sync_ms - mean(submit) - mean(waits):.1f} ms of the {sync_ms:.1f}; "
               f"launches {launched}; {check}")
    return launched


def phase_moving_merged(scene, pt) -> None:
    """Phase 4upm: one sphere of the merged cell moved and turned once:
    the world-space tree is rebuilt (a new entry of the BVH cache). The
    refresh's seconds and the bytes it adds to the cache; the route after
    the move; fresh_equal."""
    import torch

    from gpu_raytracer_tpu_torch import bvh_builder
    from gpu_raytracer_tpu_torch.bvh import cache

    def listing():
        d = cache._DEFAULT_DIR
        return {f: os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                } if os.path.isdir(d) else {}

    before = listing()
    move_instance(scene.instances[2], 1)
    pt.invalidated.scene = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.update()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = listing()
    new = {f: n for f, n in after.items() if f not in before}
    wide = pt.buffers["wide"]
    if pt.route() != "wide" or wide is None or wide.two_level:
        raise AssertionError(f"4upm: the moved merged scene takes the {pt.route()} route")
    check = fresh_equal(scene, pt, "4upm")
    say("4upm", f"one sphere moved and turned: refresh {dt:.2f} s (a world-space SAH build of "
                f"{scene.triangle_count()} triangles, {bvh_builder()} builder), BVH cache "
                f"+{sum(new.values())} bytes in {len(new)} new file(s) ({len(after)} files, "
                f"{sum(after.values())} bytes in all); merged tables {wide.nodes.shape[0]} "
                f"nodes + {wide.rows.shape[0]} rows; {check}")


def phase_moving_denoised(scene, pt, movers: list) -> dict:
    """Phase 4usv: the instanced cell denoised (SVGF + TAA) over a warm-up
    and SVGF_FRAMES frames, the instances `movers` moved and turned before
    each through update_async: the accumulation is not reset (sample index
    runs on), K5 runs every frame, no plain version; the share of pixels
    with history < 4 at the last frame."""
    import torch

    pts = denoised_pathtracer(scene, pt)
    reset_counts()
    pts.render_frame_denoised()
    lengths, frame_ms = [], []
    for f in range(SVGF_FRAMES):
        for k in movers:
            move_instance(scene.instances[k], f + 1)
        pts.invalidated.scene = True
        t0 = time.perf_counter()
        pts.update_async()
        colour = pts.render_frame_denoised()
        torch.cuda.synchronize()
        frame_ms.append(1000.0 * (time.perf_counter() - t0))
        lengths.append(float(pts.svgf_history.length.mean()))
        if not bool(torch.isfinite(colour).all()):
            raise AssertionError(f"4usv: non-finite pixels in frame {f}")
    launched, plain = counts()
    frames = SVGF_FRAMES + 1
    iters = pts.gpu_config.svgf_atrous_iterations
    names = ("primary_tl", "closest_tl", "any_tl", "shade", "shade_demod")
    if (any(launched[n] <= 0 for n in names) or any(plain.values())
            or (launched["svgf_variance"], launched["svgf_atrous"]) != (frames, iters * frames)):
        raise AssertionError(f"4usv: launches {launched}, plain versions {plain}")
    if pts.sample_index != frames:
        raise AssertionError(f"4usv: sample index {pts.sample_index} after {frames} frames: "
                             f"a transform edit reset the accumulation")
    short = float((pts.svgf_history.length < 4).float().mean())
    if not lengths[-1] > 3.0:
        raise AssertionError(f"4usv: mean history length {lengths[-1]} after {frames} frames")
    say("4usv", f"{pts.width}x{pts.height} b{pts.gpu_config.num_bounces} SVGF + TAA, "
                f"{len(movers)} instances moved and turned a frame (update_async): "
                f"{sum(frame_ms) / len(frame_ms):.1f} ms a frame with its refresh (each "
                f"{', '.join(f'{x:.1f}' for x in frame_ms)}); mean history length "
                f"{', '.join(f'{x:.3f}' for x in lengths)}; history < 4 on {short:.4f} of "
                f"the pixels at frame {frames}; launches {launched}")
    return launched


def build_qbvh_scenes() -> dict:
    """The merged and the instanced 1080p cells again under `--bvh qbvh`
    (scene.config bvh_type BVH4): 4-wide trees in the 8-slot rows (the
    merged world tree and the sphere BLAS from the cache)."""
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.config import BVHType
    from gpu_raytracer_tpu_torch.scenes import instanced_scene, procedural_scene

    out = {}
    for key, make, bounces in (
            ("merged", lambda: procedural_scene(FULL_W, FULL_H, SPHERE_SUBDIV), BOUNCES),
            ("two_level", lambda: instanced_scene(FULL_W, FULL_H), BOUNCES_TL)):
        def qbvh(make=make):
            scene = make()
            scene.config = CPUConfig(bvh_type=BVHType.BVH4)
            return scene
        scene, pt, t_geo, t_tab = build_pathtracer(qbvh, GPUConfig(num_bounces=bounces))
        wide = pt.buffers["wide"]
        refs = wide.nodes[:, 48:56].cpu()
        if wide.two_level != (key == "two_level") or pt.route() != "wide":
            raise AssertionError(f"qbvh {key}: route {pt.route()}, two_level {wide.two_level}")
        say("scene", f"qbvh {key}: tables {t_tab:.2f} s; {wide.nodes.shape[0]} nodes + "
                     f"{wide.rows.shape[0]} leaf rows = {nbytes(wide.nodes, wide.rows)} bytes, "
                     f"max stack {wide.max_stack}; children a node "
                     f"{(refs != -1).sum(dim=1).bincount().tolist()}")
        out[key] = (scene, pt)
    return out


# The CLI with Pathtracer.render stopped once 2 samples are done (exit 3):
# an interrupted run, for the --checkpoint check of phase 6.
STOP_AFTER_TWO = """
import sys
from gpu_raytracer_tpu_torch.__main__ import main
from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
render = Pathtracer.render
def stopping(self):
    if self.sample_index == 2:
        raise SystemExit(3)
    render(self)
Pathtracer.render = stopping
sys.exit(main(sys.argv[1:]))
"""


def phase_cli_checkpoint_perf(procs: dict, cli: list, tmp: str, ck: str,
                              perf_dir: str) -> None:
    """Phase 6's --checkpoint, --perf and --viewer runs: the stopped run
    left a snapshot at sample 2, which a second run resumes, removes, and
    whose PNG equals the straight run's; --perf wrote perf.txt, one line a
    POV (Sponza's POVs: the scene's name matches no table) and the
    timings; --viewer -N 4 (phase 6vw) printed the [paths] line and one
    status line a frame, 4 frames."""
    import numpy as np
    from PIL import Image

    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        want = 3 if name == "stopped" else 0
        if proc.returncode != want:
            raise AssertionError(f"CLI {name} exited {proc.returncode}, not {want}:\n"
                                 f"{stdout}\n{stderr}")
        out[name] = stdout
    snap = np.load(ck)
    if int(snap["sample_index"]) != 2:
        raise AssertionError(f"the stopped run's snapshot is at sample {snap['sample_index']}")
    resumed = subprocess.run(cli + ["-N", "3", "--checkpoint", ck, "-o",
                                    os.path.join(tmp, "resumed.png")],
                             cwd=REPO, capture_output=True, text=True, timeout=600)
    if resumed.returncode != 0 or "resumed" not in resumed.stdout or os.path.exists(ck):
        raise AssertionError(f"the resumed run ({resumed.returncode}):\n{resumed.stdout}\n"
                             f"{resumed.stderr}")
    a, b = (np.asarray(Image.open(os.path.join(tmp, f))) for f in ("straight.png",
                                                                    "resumed.png"))
    if a.shape != (256, 256, 3) or not np.array_equal(a, b):
        raise AssertionError(f"the resumed PNG differs from the straight run's "
                             f"({int((a != b).sum())} values)")
    lines = out["viewer"].splitlines()
    status = [ln for ln in lines if ln.startswith("spp ") and "ms/frame" in ln]
    paths = [ln for ln in lines if ln.startswith("[paths] ")]
    if [ln.split()[1] for ln in status] != ["1", "2", "3", "4"] or len(paths) != 1:
        raise AssertionError(f"CLI --viewer -N 4: status lines {status}, {paths}")
    say("6vw", f"CLI --viewer -N 4, stdin /dev/null: exit 0, {len(status)} frames; last status "
               f"{status[-1][:60]!r}; {paths[0]}")
    lines = open(os.path.join(perf_dir, "perf.txt")).read().splitlines()
    povs = [ln for ln in lines if ln.startswith("POV") and "avg=" in ln]
    if len(povs) != 9 or len(lines) != 9 + 1 + 9 * 33:
        raise AssertionError(f"perf.txt: {len(povs)} POV lines, {len(lines)} lines")
    say("6", f"CLI --checkpoint: stopped after 2 of 3 samples, resumed ("
             f"{[ln for ln in resumed.stdout.splitlines() if 'resumed' in ln][0]}), the "
             f"snapshot removed, the PNG equal to the straight run's; --perf wrote perf.txt: "
             f"{'; '.join(povs[:3])}; ...")


def phase_perftest_own_povs(scene, pt) -> None:
    """utils/perftest.run on the small cell with its own two POVs (the
    repository has no Sponza), 32 timed frames each, on the card."""
    import numpy as np

    from gpu_raytracer_tpu_torch.utils import perftest

    cam = scene.camera
    saved = (cam.position.copy(), cam.rotation.copy())
    povs = [(tuple(saved[0]), tuple(saved[1])),
            (tuple(saved[0] + np.float32([0.3, 0.0, -0.5])), tuple(saved[1]))]
    with tempfile.TemporaryDirectory() as tmp:
        results = perftest.run(pt, povs, output_file=os.path.join(tmp, "perf.txt"))
        lines = open(os.path.join(tmp, "perf.txt")).read().splitlines()
    cam.position, cam.rotation = saved
    cam.update(0.0)
    if len(lines) != 2 + 1 + 2 * 33 or any(len(r.timings_ms) != 32 for r in results):
        raise AssertionError(f"perftest.run wrote {len(lines)} lines")
    say("6", f"perftest.run on the {pt.width}x{pt.height} small cell, its own 2 POVs: " +
             "; ".join(f"POV {r.index} avg {r.avg_ms:.3f} ms, stddev {r.stddev_ms:.3f}, "
                       f"{r.mrays_per_s:.1f} Mrays/s" for r in results))


def grid_rays(pt, nx: int, ny: int) -> tuple:
    """(pixel ids, ray origins, directions): an nx x ny grid of pixels over
    the film of `pt` and their primary rays (box filter, sample 0), as
    `utils.viewer.query_pixel` makes them."""
    import torch

    from gpu_raytracer_tpu_torch.config import ReconstructionFilter
    from gpu_raytracer_tpu_torch.ops.camera_rays import camera_tensors, generate_primary_rays

    xs = torch.linspace(0, pt.width - 1, nx).long()
    ys = torch.linspace(0, pt.height - 1, ny).long()
    ids = (ys[:, None] * pt.width + xs[None, :]).flatten().to(pt.device)
    o, d = generate_primary_rays(camera_tensors(pt.scene.camera.params(), pt.device), ids,
                                 pt.width, 0, ReconstructionFilter.BOX)
    return ids, o, d


def query_parity(pt, phase: str, label: str, side: int = 16) -> str:
    """The viewer's pixel query on the card: a `side` x `side` grid of
    primary rays, each in a one-ray launch of the route's primary kernel,
    against the plain walk on the whole grid (merged and two-level tables:
    parity.compare_closest's tie-aware bar with u, v; binary: equal ids);
    then one launch over the whole grid held the same way (the one-ray
    launches leave the walk's state sane), and `query_pixel` at three of
    the pixels naming the kernel's hit. Returns the text of the check."""
    import torch

    from gpu_raytracer_tpu_torch import parity
    from gpu_raytracer_tpu_torch.integrators.pathtracer import PLAIN
    from gpu_raytracer_tpu_torch.utils import viewer

    dev = pt.device
    ids, o, d = grid_rays(pt, side, side)
    wide = pt.route() == "wide"
    role, tables = ("primary", pt.buffers["wide"]) if wide else ("binary_closest",
                                                                 pt.buffers["binary"])
    kernel, plain = getattr(pt.kernels, role), getattr(PLAIN, role)
    one = torch.full((1,), float("inf"), device=dev)
    hits = [kernel(tables, o[i:i + 1], d[i:i + 1], one) for i in range(ids.shape[0])]
    a = type(hits[0])(*(None if getattr(hits[0], f) is None
                         else torch.cat([getattr(h, f) for h in hits]) for f in hits[0]._fields))
    tm = torch.full((ids.shape[0],), float("inf"), device=dev)
    b = plain(tables, o, d, tm)
    whole = kernel(tables, o, d, tm)
    torch.cuda.synchronize()

    def held(x):
        return (parity.compare_closest(x, b, parity.TRI_MATCH_COHERENT, True, (tables, o, d))
                if wide else parity.compare_binary(x, b))
    err, err_whole = held(a), held(whole)
    for i in (0, ids.shape[0] // 2 + side // 2, ids.shape[0] - 1):
        x, y = int(ids[i]) % pt.width, int(ids[i]) // pt.width
        info = viewer.query_pixel(pt, x, y)
        if (info is None) != bool(a.tri[i] < 0) or (info and info["t"] != float(a.t[i])):
            raise AssertionError(f"{phase} {label}: query_pixel({x}, {y}) gave {info and info['t']}, "
                                 f"the one-ray launch t {float(a.t[i])}")
    return (f"query on {role}: {ids.shape[0]} one-ray launches vs the plain walk max |dt| "
            f"{err:.3g}, then one {ids.shape[0]}-ray launch {err_whole:.3g} "
            f"({int((a.tri >= 0).sum())} hits); query_pixel names the kernel's hits")


def aim(pt, want) -> tuple:
    """A pixel (x, y) near the middle of the film whose primary hit is an
    instance `want(instance)` accepts (the route's primary walk on a 32 x 18
    grid)."""
    from gpu_raytracer_tpu_torch.utils import viewer

    ids, o, d = grid_rays(pt, 32, 18)
    _, _, inst = viewer.primary_hit(pt, o, d)
    best = None
    for i, k in enumerate(inst.tolist()):
        if k >= 0 and want(pt.scene.instances[k]):
            x, y = int(ids[i]) % pt.width, int(ids[i]) // pt.width
            dist = abs(x - pt.width // 2) + abs(y - pt.height // 2)
            if best is None or dist < best[0]:
                best = (dist, x, y)
    if best is None:
        raise AssertionError("no pixel of the grid hits the instance wanted")
    return best[1], best[2]


def viewer_frames(pt, state, timer, frames: list, phase: str, label: str,
                  svgf: bool = False) -> list:
    """Drive the viewer as run_viewer does, one string of keys a frame
    (`utils.viewer.apply_keys`, its status lines caught), then the frame:
    render (or a denoised frame; a pending refresh joins at its top), the
    framebuffer copy, the overlay and the terminal encode, each timed, and
    `timer.tick()`. Returns (keys, render ms, framebuffer ms, encode ms,
    status lines) a frame."""
    import contextlib
    import io

    import torch

    from gpu_raytracer_tpu_torch.utils import viewer

    rows = []
    for keys in frames:
        delta = max(timer.times[-1] if timer.times else 0.05, 1e-3)
        caught = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(caught):
            if not viewer.apply_keys(state, pt, keys, delta):
                raise AssertionError(f"{phase}: keys {keys!r} quit the viewer")
        t1 = time.perf_counter()
        (pt.render_frame_denoised if svgf else pt.render)()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        frame = pt.framebuffer()
        t3 = time.perf_counter()
        shown = frame
        if state.overlay is not None:
            shown = viewer.draw_query_overlay(frame, pt.scene.camera, state.overlay)
        text = viewer.render_to_terminal(shown, 120)
        t4 = time.perf_counter()
        timer.tick()
        marked = int((shown != frame).any(axis=-1).sum())
        if (state.overlay is not None) != (marked >= 8):
            raise AssertionError(f"{phase}: the query overlay marks {marked} pixels")
        status = [ln.replace("\x1b[H", "").replace("\x1b[K", "").strip()
                  for ln in caught.getvalue().splitlines()]
        status = [ln for ln in status if ln]
        if not bool(torch.isfinite(pt.accumulator).all()):
            raise AssertionError(f"{phase}: non-finite pixels after keys {keys!r}")
        say(phase, f"{label} keys {keys!r}: keys {1000 * (t1 - t0):.1f} ms, render "
                   f"{1000 * (t2 - t1):.1f} ms, framebuffer copy {1000 * (t3 - t2):.1f} ms, "
                   f"overlay + terminal encode {1000 * (t4 - t3):.1f} ms ({len(text)} "
                   f"chars); spp {pt.sample_index}; status {status[:6]}; [paths] {pt.paths}")
        rows.append((keys, 1000 * (t2 - t1), 1000 * (t3 - t2), 1000 * (t4 - t3), status))
    return rows


def phase_viewer(scenes: dict, card: str) -> None:
    """Phase 4vw: the terminal viewer (utils/viewer.py) driven in-process
    through `apply_keys` on the card, each frame as run_viewer draws it.
    The merged 1080p cell: `w`, `j`, `p` (query and overlay on a sphere),
    `f`, `t` (stage_times, printed with the card and the kernels that ran
    them); then `g` + `z` on a sphere (the world-space rebuild), with the
    BVH cache's files and bytes unchanged (ROADMAP C39). The instanced cell:
    `g` + `z` (two-level refresh through update_async). The small cell: `]`
    (a material rebuild). The query held to the plain walk on each; the
    route's kernels launch and no plain version runs."""
    import torch

    from gpu_raytracer_tpu_torch.bvh import cache
    from gpu_raytracer_tpu_torch.utils import viewer
    from gpu_raytracer_tpu_torch.utils.profiling import FrameTimer, format_stage_times, stage_times

    def sphere(inst):
        return inst.name not in ("room", "light")

    def listing():
        d = cache._DEFAULT_DIR
        return {f: os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                } if os.path.isdir(d) else {}

    def check(label, names, forbid=()):
        launched, plain = counts()
        missing = [n for n in names if launched[n] <= 0]
        ran = {n: launched[n] for n in forbid if launched[n]}
        if missing or ran or any(plain.values()):
            raise AssertionError(f"4vw {label}: kernels {missing} never launched, off-route "
                                 f"{ran}, plain versions {plain}")

    # The merged cell.
    scene, pt = scenes["merged"]
    say("4vw", f"merged {query_parity(pt, '4vw', 'merged')}")
    state = viewer.ViewerState(*aim(pt, sphere))
    timer = FrameTimer()
    reset_counts()
    rows = viewer_frames(pt, state, timer, ["", "w", "j", "p", "f", "t"], "4vw",
                         f"merged {pt.width}x{pt.height}")
    check("merged", ("primary", "closest", "any", "shade", "shade_last"),
          WIDE_NAMES[3:] + ("binary_closest", "fused_shade"))
    if not any(ln.startswith("pixel query: {") for ln in rows[3][4]):
        raise AssertionError(f"4vw: the `p` query printed {rows[3][4]}")
    stats = timer.stats()
    warm = rows[1:]
    times = stage_times(pt, repeats=3)
    say("4vw", f"merged FrameTimer {stats}; render {min(r[1] for r in warm):.1f}-"
               f"{max(r[1] for r in warm):.1f} ms, framebuffer copy "
               f"{min(r[2] for r in warm):.1f}-{max(r[2] for r in warm):.1f} ms, overlay + "
               f"terminal encode {min(r[3] for r in warm):.1f}-{max(r[3] for r in warm):.1f} "
               f"ms (frames 2-{len(rows)})")
    say("4vw", f"stage_times on {card}: " + "; ".join(
        line.strip() for line in format_stage_times(times).splitlines())
        + f"; paths {pt.paths}")
    state.qx, state.qy = aim(pt, sphere)
    before = listing()
    t0 = time.perf_counter()
    rows = viewer_frames(pt, state, timer, ["g", "z"], "4vw", "merged")
    move_s = rows[1][1] / 1000.0
    after = listing()
    if after != before or pt.route() != "wide" or pt.buffers["wide"].two_level:
        raise AssertionError(f"4vw: a merged move changed the BVH cache ({len(before)} -> "
                             f"{len(after)} files) or the route ({pt.route()})")
    say("4vw", f"merged g + z: {rows[0][4]} {rows[1][4]}; the frame with the world-space "
               f"rebuild {move_s:.2f} s ({time.perf_counter() - t0:.2f} s with the grab); "
               f"BVH cache {len(after)} files, {sum(after.values())} bytes, unchanged")

    # The instanced cell: a two-level refresh through update_async.
    scene, pt = scenes["two_level"]
    say("4vw", f"instanced {query_parity(pt, '4vw', 'instanced')}")
    state = viewer.ViewerState(*aim(pt, sphere))
    reset_counts()
    rows = viewer_frames(pt, state, FrameTimer(), ["g", "z", ""], "4vw",
                         f"instanced {pt.width}x{pt.height}")
    check("instanced", ("primary_tl", "closest_tl", "any_tl", "shade"), WIDE_NAMES[:3])
    if not rows[1][4] or not rows[1][4][0].startswith("instance '"):
        raise AssertionError(f"4vw: the instanced `z` printed {rows[1][4]}")

    # The small cell: a material rebuild on route (a).
    scene, pt = scenes["small"]
    say("4vw", f"small {query_parity(pt, '4vw', 'small')}")
    state = viewer.ViewerState(*aim(pt, lambda inst: inst.name != "light"))
    rough = [m.linear_roughness for m in scene.materials]
    reset_counts()
    rows = viewer_frames(pt, state, FrameTimer(), ["]", ""], "4vw",
                         f"small {pt.width}x{pt.height}")
    check("small", ("binary_closest", "binary_any", "fused_shade"), WIDE_NAMES + ("shade",))
    if rough == [m.linear_roughness for m in scene.materials] or pt.route() != "binary_shade":
        raise AssertionError(f"4vw: `]` left the materials as they were ({rows[0][4]})")


def single_denoised(pt, buffers, frames: int) -> list:
    """The denoised step on one device: render_wave over every pixel id
    (row-major) with AOVs, svgf_step and taa_step, `frames` frames with the
    history carried. Returns the colours on the host and each frame's wall
    ms (to its device sync)."""
    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch import GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import FRAME_AOVS, render_wave
    from gpu_raytracer_tpu_torch.ops import svgf as svgf_ops
    from gpu_raytracer_tpu_torch.ops import taa as taa_ops
    from gpu_raytracer_tpu_torch.ops.camera_rays import camera_tensors

    W, H, dev = pt.width, pt.height, pt.device
    config = GPUConfig(num_bounces=pt.gpu_config.num_bounces, enable_svgf=True)
    camera = camera_tensors(pt.scene.camera.params(), dev)
    idx = torch.arange(W * H, device=dev)
    vp = torch.as_tensor(np.asarray(pt.scene.camera.view_projection, np.float32), device=dev)
    history, taa_prev, out, walls = svgf_ops.init_history(H, W, dev), None, [], []
    for s in range(frames):
        t0 = time.perf_counter()
        aovs = render_wave(buffers, camera, idx, s, config, W, pt.cpu_config.seed,
                           pt.scene.has_lights, with_aovs=True)
        frame = {k: aovs[k].reshape((H, W) + aovs[k].shape[1:]) for k in FRAME_AOVS}
        colour, history = svgf_ops.svgf_step(frame, history, vp, config)
        taa_in = taa_ops.to_taa_space(colour.clamp(min=0.0))
        screen_prev = svgf_ops.project_to_screen(frame["position_prev"], vp, W, H)
        taa_prev = taa_ops.taa_step(taa_in, taa_in if s == 0 else taa_prev, screen_prev)
        colour = taa_ops.from_taa_space(taa_prev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.append(1000.0 * (time.perf_counter() - t0))
        out.append(colour.cpu().numpy())
    return out, walls


SHARD_FRAMES = 3


def sharded_rank(rank: int, world: int, backend: str, init_file: str, out_dir: str,
                 device: str, size: tuple, t_spawn: float) -> None:
    """One rank of phase 4mp (a spawned process): the merged cell
    (`procedural_scene(*size)`) built from the caches on `device`,
    `shard_render_wave` on the first wave of tile-order ids (a warm-up, then
    timed), the all-gather of its slice timed alone; with 2 ranks also
    SHARD_FRAMES frames of `shard_denoised_step`. Each rank writes its
    timings (set-up: from `t_spawn`, the parent's clock when it spawned
    the rank), rank 0 the results, to `out_dir`."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from gpu_raytracer_tpu_torch import CPUConfig, GPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.ops import svgf as svgf_ops
    from gpu_raytracer_tpu_torch.ops.camera_rays import camera_tensors, tile_order
    from gpu_raytracer_tpu_torch.parallel import make_mesh, shard_render_wave
    from gpu_raytracer_tpu_torch.parallel.denoise import shard_denoised_step
    from gpu_raytracer_tpu_torch.parallel.mesh import all_gather_rows
    from gpu_raytracer_tpu_torch.scenes import procedural_scene

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    dist.init_process_group(backend, init_method="file://" + init_file, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(device)
        scene = procedural_scene(*size)
        pt = Pathtracer(scene, CPUConfig(), GPUConfig(num_bounces=BOUNCES), device=mesh.device)
        pt.init_device()
        sync()
        setup_s = time.time() - t_spawn
        buffers = {**pt.buffers, "inst_prev_rows": pt.buffers["inst_rows"][:, :12].contiguous()}
        camera = camera_tensors(scene.camera.params(), mesh.device)
        wave = min(pt.cpu_config.batch_size, pt.width * pt.height)
        ids = torch.as_tensor(tile_order(pt.width, pt.height)[:wave].astype(np.int64))
        fn = shard_render_wave(mesh, pt.gpu_config, pt.width, pt.cpu_config.seed,
                               scene.has_lights)
        t0 = time.perf_counter()
        fn(buffers, camera, ids, 0)
        sync()
        first_ms = 1000.0 * (time.perf_counter() - t0)
        walls = []
        for _ in range(3):
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            radiance = fn(buffers, camera, ids, 0)
            sync()
            walls.append(1000.0 * (time.perf_counter() - t0))
        local = radiance[:wave // world].contiguous()
        gathers = []
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            all_gather_rows(mesh, local)
            sync()
            gathers.append(1000.0 * (time.perf_counter() - t0))
        out = {"radiance": radiance.cpu().numpy()}
        info = {"rank": rank, "setup_s": setup_s, "first_ms": first_ms, "wave_ms": walls,
                "gather_ms": gathers,
                "device": str(mesh.device), "backend": mesh.backend}
        if world > 1:
            step = shard_denoised_step(mesh, GPUConfig(num_bounces=BOUNCES, enable_svgf=True),
                                       pt.width, pt.height, pt.cpu_config.seed,
                                       scene.has_lights)
            history = svgf_ops.init_history(pt.height, pt.width, mesh.device)
            taa_prev = torch.zeros((pt.height, pt.width, 3), device=mesh.device)
            vp = torch.as_tensor(np.asarray(scene.camera.view_projection, np.float32))
            idx = torch.arange(pt.width * pt.height)
            frame_ms = []
            for s in range(SHARD_FRAMES):
                sync()
                dist.barrier()
                t0 = time.perf_counter()
                colour, history, taa_prev = step(buffers, camera, idx, s, history, vp,
                                                 taa_prev, s == 0)
                sync()
                frame_ms.append(1000.0 * (time.perf_counter() - t0))
                out[f"frame{s}"] = colour.cpu().numpy()
            info["frame_ms"] = frame_ms
        with open(os.path.join(out_dir, f"rank{rank}_{world}.json"), "w") as f:
            json.dump(info, f)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"world{world}.npz"), **out)
    finally:
        dist.destroy_process_group()


def phase_sharded(pt, size: tuple, groups=((1, "nccl"), (2, "gloo"))) -> None:
    """Phase 4mp: pixel-sharded rendering (parallel/) on the merged 1080p
    cell, ranks spawned as processes that build their tables from the
    caches: 1 rank over nccl, then 2 ranks over gloo sharing the card. Each
    group's `shard_render_wave` on the first 777,600 tile-order ids against
    the one-device `render_wave` on the same ids here (`pt`, built from
    `procedural_scene(*size)` as the ranks build theirs; bit-equal expected:
    a ray's walk and its sampler draws depend on the ray and the pixel
    alone; the largest difference reported; the bar: >= 99% of rays within
    1e-4); with 2 ranks, SHARD_FRAMES frames of `shard_denoised_step`
    against the same steps on one device (rel-RMSE < 3e-3, the largest
    difference reported). Each rank's set-up seconds, the sharded wave's
    wall ms, the all-gather's ms."""
    import multiprocessing

    import numpy as np
    import torch

    from gpu_raytracer_tpu_torch.integrators.pathtracer import render_wave
    from gpu_raytracer_tpu_torch.ops.camera_rays import camera_tensors, tile_order
    from gpu_raytracer_tpu_torch.parity import IMAGE_REL_RMSE

    buffers = {**pt.buffers, "inst_prev_rows": pt.buffers["inst_rows"][:, :12].contiguous()}
    camera = camera_tensors(pt.scene.camera.params(), pt.device)
    wave = min(pt.cpu_config.batch_size, pt.width * pt.height)
    ids = torch.as_tensor(tile_order(pt.width, pt.height)[:wave].astype(np.int64),
                          device=pt.device)

    def one_device():
        out = render_wave(buffers, camera, ids, 0, pt.gpu_config, pt.width,
                          pt.cpu_config.seed, pt.scene.has_lights)
        if pt.device.type == "cuda":
            torch.cuda.synchronize()
        return out
    one_device()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        ref = one_device()
        walls.append(1000.0 * (time.perf_counter() - t0))
    ref = ref.cpu().numpy()
    denoised, frame_ms = single_denoised(pt, buffers, SHARD_FRAMES)
    say("4mp", f"one device: the {ids.shape[0]}-ray wave {', '.join(f'{x:.1f}' for x in walls)} "
               f"ms; the denoised step over every pixel, frame ms "
               f"{', '.join(f'{x:.1f}' for x in frame_ms)}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        for world, backend in groups:
            t0 = time.perf_counter()
            init = os.path.join(tmp, f"init{world}")
            device = "cuda:0" if pt.device.type == "cuda" else "cpu"
            procs = [ctx.Process(target=sharded_rank,
                                 args=(r, world, backend, init, tmp, device, size,
                                       time.time()))
                     for r in range(world)]
            for p in procs:
                p.start()
            try:
                for p in procs:
                    p.join(timeout=600)
            finally:
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                        p.join()
            if any(p.exitcode != 0 for p in procs):
                raise AssertionError(f"4mp: {world} {backend} rank(s) exited "
                                     f"{[p.exitcode for p in procs]}")
            got = np.load(os.path.join(tmp, f"world{world}.npz"))
            infos = [json.load(open(os.path.join(tmp, f"rank{r}_{world}.json")))
                     for r in range(world)]
            diff = np.abs(got["radiance"] - ref).max(axis=1)
            share = float(np.mean(diff <= 1e-4))
            if got["radiance"].shape != ref.shape or share < 0.99:
                raise AssertionError(f"4mp: {world} {backend} rank(s) against one device: "
                                     f"{share:.4f} of rays within 1e-4")
            text = ""
            if world > 1:
                errs = []
                for s in range(SHARD_FRAMES):
                    a, b = denoised[s], got[f"frame{s}"]
                    rel = float(np.sqrt(np.mean((a - b) ** 2)) / a.mean())
                    if not np.isfinite(b).all() or rel >= IMAGE_REL_RMSE:
                        raise AssertionError(f"4mp: sharded denoised frame {s} rel-RMSE {rel}")
                    errs.append((rel, float(np.abs(a - b).max())))
                text = ("; shard_denoised_step, " + ", ".join(
                    f"frame {s}: rel-RMSE {r:.3g}, max |d| {m:.3g}" for s, (r, m) in
                    enumerate(errs)) + "; frame ms " + "; ".join(
                    f"rank {i['rank']} " + ", ".join(f"{x:.1f}" for x in i["frame_ms"])
                    for i in infos))
            say("4mp", f"{world} rank(s) over {backend} on one device ({time.perf_counter() - t0:.1f} s "
                       f"with spawning): shard_render_wave vs one device on the {ids.shape[0]} "
                       f"ids: max |d| {float(diff.max()):.3g}, bit-equal on "
                       f"{float(np.mean(diff == 0)):.6f} of rays; " + "; ".join(
                           f"rank {i['rank']} ({i['device']}) set-up {i['setup_s']:.1f} s from "
                           f"the spawn, first wave (the kernels' load) {i['first_ms']:.1f} ms, "
                           f"wave {', '.join(f'{x:.1f}' for x in i['wave_ms'])} ms, all_gather "
                           f"{', '.join(f'{x:.2f}' for x in i['gather_ms'])} ms"
                           for i in infos) + text)


def build_pathtracer(make_scene, gpu):
    """(scene, Pathtracer with its tables built, tessellation s, tables s)."""
    import torch

    from gpu_raytracer_tpu_torch import CPUConfig
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer

    t0 = time.perf_counter()
    scene = make_scene()
    t_geo = time.perf_counter() - t0
    pt = Pathtracer(scene, CPUConfig(), gpu, device="cuda")
    t0 = time.perf_counter()
    pt.init_device()
    torch.cuda.synchronize()
    return scene, pt, t_geo, time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from gpu_raytracer_tpu_torch import GPUConfig, bvh_builder, read_exr
    from gpu_raytracer_tpu_torch.ops import _native
    from gpu_raytracer_tpu_torch.integrators.pathtracer import Pathtracer
    from gpu_raytracer_tpu_torch.ops import binary_traverse as bt
    from gpu_raytracer_tpu_torch.ops import fused_shade as fs
    from gpu_raytracer_tpu_torch.ops import shade_gather as sg
    from gpu_raytracer_tpu_torch.ops import stream_traverse as st
    from gpu_raytracer_tpu_torch.ops import svgf_stencil as sv
    from gpu_raytracer_tpu_torch.ops import wide_traverse as wt
    from gpu_raytracer_tpu_torch.probes import block, dma, gang, prims, read
    from gpu_raytracer_tpu_torch.scenes import (
        cornell_scene,
        instanced_scene,
        mixed_cornell,
        procedural_scene,
        write_mitsuba_media_scene,
        write_mitsuba_mixed_scene,
        write_mitsuba_scene,
    )

    # ---- 1. device ----
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say("1", f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2. build (nvcc processes), while the scenes are built ----
    pool = ThreadPoolExecutor(2)
    building = pool.submit(_native.build, force=True, ptxas_verbose=True)
    # Phase 7's numpy reference renders on the host meanwhile.
    anchor_numpy = pool.submit(render_anchor_numpy)

    # ---- scenes + tables ----
    scenes = {}
    for key, make, bounces in (
            ("merged", lambda: procedural_scene(FULL_W, FULL_H, SPHERE_SUBDIV), BOUNCES),
            ("two_level", lambda: instanced_scene(FULL_W, FULL_H), BOUNCES_TL)):
        scene, pt, t_geo, t_tab = build_pathtracer(make, GPUConfig(num_bounces=bounces))
        wide = pt.buffers["wide"]
        if wide.two_level != (key == "two_level"):
            raise AssertionError(f"{key} scene packed with two_level={wide.two_level}")
        table_bytes = nbytes(wide.nodes, wide.rows)
        say("scene", f"{key}: {scene.triangle_count()} triangles ({scene.unique_triangle_count()} "
                     f"unique), {len(scene.instances)} instances; tessellation {t_geo:.2f} s; "
                     f"BVH build + tables {t_tab:.2f} s ({bvh_builder()} builder); wide "
                     f"tables {wide.nodes.shape[0]} nodes + {wide.rows.shape[0]} leaf rows = "
                     f"{table_bytes} bytes, max stack {wide.max_stack}")
        scenes[key] = (scene, pt)
    scene, pt, t_geo, t_tab = build_pathtracer(lambda: cornell_scene(SMALL, SMALL),
                                               GPUConfig(num_bounces=BOUNCES_SM))
    binary, fused = pt.buffers["binary"], pt.buffers["fused_shade"]
    if binary is None or fused is None or pt.route() != "binary_shade":
        raise AssertionError(f"the small scene takes the {pt.route()} route")
    n, i, t = (x.shape[0] for x in binary)
    light_n = fused[6].shape[1]
    say("scene", f"small: {scene.triangle_count()} triangles, {len(scene.instances)} "
                 f"instances, {light_n} light triangles; tables {t_tab:.2f} s; binary "
                 f"tables {n} nodes + {i} instances + {t} triangles = {nbytes(*binary)} "
                 f"bytes (gate 64 (N+T+I) = {64 * (n + t + i)} <= {bt.MAX_TABLE_BYTES}: "
                 f"{bt.supports(n, t, i)}); fused shade tables {nbytes(*fused)} bytes "
                 f"(gate 64 (2T+2I+L+16) = {64 * (2 * t + 2 * i + light_n + 16)} <= "
                 f"{fs.MAX_SHADE_TABLE_BYTES}: {fs.supports_shade(pt.buffers['mat_types'], t, i, light_n, False, False, (1, 1))}); "
                 f"route {pt.route()}")
    scenes["small"] = (scene, pt)
    scene, pt, merged_yardstick = build_stream_scene(GPUConfig(num_bounces=BOUNCES))
    scenes["stream"] = (scene, pt)
    scenes["mixed"] = build_mixed_scene(GPUConfig(num_bounces=BOUNCES))
    scene, pt, t_geo, t_tab = build_pathtracer(lambda: mixed_cornell(SMALL, SMALL),
                                               GPUConfig(num_bounces=BOUNCES_SM))
    inst_rows = pt.buffers["fused_shade"].inst_rows if pt.buffers["fused_shade"] else None
    if pt.route() != "binary_shade" or inst_rows is None:
        raise AssertionError(f"the mixed Cornell scene takes the {pt.route()} route")
    curves = pt.buffers["shade_gather"][1].cpu()
    say("scene", f"mixed Cornell: {scene.triangle_count()} triangles, materials "
                 f"{sorted({m.type.name for m in scene.materials})}; tables {t_tab:.2f} s; "
                 f"route {pt.route()}; the fused shade's instance rows carry "
                 f"{int((inst_rows[:, 48:80] != 0).any(dim=1).sum())} instances' curves "
                 f"(the port's bake: {int((curves != 0).any(dim=0).sum())} materials "
                 f"with curves)")
    scenes["mixed_small"] = (scene, pt)
    scenes["media"], scenes["media_small"] = build_media_scenes()
    qbvh = build_qbvh_scenes()
    info = building.result()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    say("2", f"built {_native.library_path()} from {len(_native.SOURCES)} "
             f"sources in {info['seconds']:.2f} s")
    for ln in regs:
        say("2", f"ptxas: {ln}")
    for prefix in ("wt_", "bt_", "sv_", "fs_", "sg_", "pg_ablate", "pg_micro", "pb_pop",
                   "pr_read", "pp_", "pd_"):
        for name, lines in _native.ptxas_report(info["log"], prefix).items():
            say("2", f"ptxas {name}: {'; '.join(lines)}")
    infos = [(role + ("_tl" if two_level else ""), wt.kernel_info(mode, two_level))
             for two_level in (False, True) for mode, role in enumerate(wt.ROLES)]
    infos += [(f"{kind}_{mode}", st.kernel_info(kind, mode == "any"))
              for kind in ("resident", "page") for mode in ("closest", "any")]
    infos = [(KERNELS[name][0], k) for name, k in infos]
    infos += [(KERNELS[role][0], bt.kernel_info(role == "binary_any")) for role in bt.ROLES]
    infos += [(KERNELS.get(name, ("svgf_stencil.variance_runtime",))[0], sv.kernel_info(name))
              for name in sv.INFO_KERNELS]
    infos += [(KERNELS["fused_shade"][0], fs.kernel_info())]
    infos += [(f"shade_gather.{SHADE_MODES[mode]}", sg.kernel_info(mode)) for mode in sg.MODES]
    infos += [(f"probe_gang.pg_ablate<{v}>", gang.kernel_info(v)) for v in gang.ABLATE_VARIANTS]
    infos += [(f"probe_read.pr_read<{b}, {sp}>", read.kernel_info(b, sp))
              for b in read.READ_BODIES[:-1] for sp in read.SPACES]
    infos += [("probe_gang.pg_micro<push>", gang.micro_kernel_info("push")),
              ("probe_block.pb_pop", block.kernel_info())]
    infos += [(f"probe_prims.pp_gang<{b}>", prims.kernel_info(b)) for b in prims.OWN_KERNELS]
    infos += [(f"probe_dma.pd_copy<{m}, array>, {dma.ITERS} copies", dma.kernel_info(m))
              for m in dma.MECHS]
    for name, k in infos:
        say("2", f"{name}: {k['registers']} registers, {k['local_bytes']} bytes "
                 f"stack frame, {k['shared_bytes']} bytes shared a block of {k['threads']}; "
                 f"occupancy API: {k['blocks_per_sm']} blocks = "
                 f"{k['blocks_per_sm'] * k['threads'] // 32} warps an SM, {k['sms']} SMs"
                 + (f"; cluster of {k['cluster']} block(s)" if "cluster" in k else "")
                 + (f"; a ring of {k['ring']} copies" if "ring" in k else ""))

    # ---- 3. per-kernel parity ----
    scene_1080 = cornell_scene(FULL_W, FULL_H)
    pt_1080 = Pathtracer(scene_1080, scenes["small"][1].cpu_config,
                         GPUConfig(num_bounces=BOUNCES), device="cuda")
    pt_1080.buffers = scenes["small"][1].buffers
    pt_1080.reset_accumulation()
    if pt_1080.route() != "binary":
        raise AssertionError(f"the 1080p small scene takes the {pt_1080.route()} route")
    results: dict = {}
    phase_kernels(scenes["merged"][1], results, with_shade=True)
    phase_kernels(scenes["two_level"][1], results, with_shade=False)
    phase_shade(scenes["two_level"][1], "3", "two-level 1080p")
    results_qb: dict = {}
    for key in ("merged", "two_level"):
        phase_kernels(qbvh[key][1], results_qb, with_shade=False, phase="3qb")
    say("3qb", "qbvh against cwbvh, kernel ms (bound ms): " + "; ".join(
        f"{KERNELS[n][0]} {r['ms']:.4f} ({r['bound_ms']:.4f}) vs {results[n]['ms']:.4f} "
        f"({results[n]['bound_ms']:.4f})" for n, r in results_qb.items()))
    phase_svgf_kernels(*scenes["merged"], results)
    phase_small_kernels(scenes["small"][1], results)
    phase_shade(pt_1080, "3sm", "route (b) 1080p", route="binary")
    phase_stream_kernels(scenes["stream"][1], merged_yardstick, results)
    phase_shade(scenes["stream"][1], "3st", "streamed 1080p", route="stream")
    phase_mixed_kernels(scenes["mixed"][1], scenes["mixed_small"][1])
    phase_media_kernels(scenes["media"][1], scenes["media_small"][1], scenes["mixed"][1], results)
    del merged_yardstick
    phase_probes(scenes["merged"][1], results)

    # ---- 4. the slices at full size ----
    launched = phase_slice(scenes["merged"][1], "4",
                           ("primary", "closest", "any", "shade", "shade_last"))
    launched_tl = phase_slice(scenes["two_level"][1], "4tl",
                              ("primary_tl", "closest_tl", "any_tl", "shade", "shade_last"))
    launched_sv = phase_denoised(*scenes["merged"], "4sv")
    launched_sm = phase_slice(scenes["small"][1], "4sm",
                              ("binary_closest", "binary_any", "fused_shade"),
                              forbid=WIDE_NAMES + ("shade",))
    phase_slice(pt_1080, "4sm1080", ("binary_closest", "binary_any", "shade", "shade_last"),
                forbid=WIDE_NAMES + ("fused_shade",))
    launched_st = phase_slice(scenes["stream"][1], "4st", STREAM_NAMES + ("shade", "shade_last"),
                              forbid=WIDE_NAMES + ("binary_closest", "binary_any",
                                                   "fused_shade"))
    phase_slice(scenes["mixed"][1], "4mx", ("primary", "closest", "any", "shade", "shade_last"),
                forbid=WIDE_NAMES[3:] + STREAM_NAMES + ("binary_closest", "binary_any",
                                                         "fused_shade"))
    phase_slice(scenes["mixed_small"][1], "4smx",
                ("binary_closest", "binary_any", "fused_shade"),
                forbid=WIDE_NAMES + STREAM_NAMES + ("shade",))
    launched_md = phase_slice(scenes["media"][1], "4md",
                              ("primary", "closest", "any", "shade", "shade_last", "shade_media"),
                              forbid=WIDE_NAMES[3:] + STREAM_NAMES + ("binary_closest",
                                                                       "binary_any",
                                                                       "fused_shade"))
    phase_media_profile(scenes["media"][1])
    phase_compaction(scenes, f"{kind} ({smi})")
    launched_mdc = phase_slice(scenes["media_small"][1], "4mdc",
                               ("binary_closest", "binary_any", "shade", "shade_last",
                                "shade_media"),
                               forbid=WIDE_NAMES + STREAM_NAMES + ("fused_shade",))
    phase_ao(*scenes["merged"])
    for key, names in (("merged", ("primary", "closest", "any", "shade", "shade_last")),
                       ("two_level", ("primary_tl", "closest_tl", "any_tl", "shade",
                                      "shade_last"))):
        phase_slice(qbvh[key][1], "4qb" + ("tl" if key == "two_level" else ""), names)
    phase_sharded(scenes["merged"][1], (FULL_W, FULL_H, SPHERE_SUBDIV))

    # ---- 4u. moving instances: refreshed tables ----
    field = list(range(1, len(scenes["two_level"][0].instances) - 1, 7))
    phase_moving(*scenes["two_level"], "4up", field, 8,
                 ("primary_tl", "closest_tl", "any_tl", "shade", "shade_last"),
                 forbid=WIDE_NAMES[:3] + STREAM_NAMES + ("binary_closest", "binary_any",
                                                         "fused_shade"))
    phase_moving_merged(*scenes["merged"])
    phase_moving(*scenes["small"], "4ups", [3], 4,
                 ("binary_closest", "binary_any", "fused_shade"),
                 forbid=WIDE_NAMES + STREAM_NAMES + ("shade",))
    phase_perftest_own_povs(*scenes["small"])
    phase_moving_denoised(*scenes["two_level"], [201, 221, 241])
    phase_viewer(scenes, f"{kind} ({smi})")
    main_launches = {n: (launched_tl if n.endswith("_tl") else
                         launched_sv if n.startswith("svgf") else
                         launched_sm if n.startswith(("binary", "fused")) else
                         launched_st if n in STREAM_NAMES else
                         launched)[n]
                     for n in KERNELS if not n.startswith("shade_media")}
    # Each media instance's launches: its own slice's SG_MEDIA calls.
    main_launches["shade_media"] = launched_md["shade_media"]
    main_launches["shade_media_uv"] = launched_mdc["shade_media"]

    # ---- 5. image parity, kernels vs plain versions ----
    phase_image(*scenes["merged"], "5")
    phase_image(*scenes["two_level"], "5tl")
    phase_image(*scenes["small"], "5sm", route="binary_shade")
    phase_image(*scenes["stream"], "5st", route="stream")
    phase_denoised_image(*scenes["merged"], "5sv")
    phase_image(*scenes["mixed"], "5mx")
    phase_image(*scenes["mixed_small"], "5smx", route="binary_shade")
    phase_image(*scenes["media"], "5md")
    # 4 spp: the plain binary walk takes ~4 s a 256x256 b6 sample on the card.
    phase_image(*scenes["media_small"], "5mdc", route="binary", spp=4)
    phase_image(*qbvh["merged"], "5qb")
    phase_image(*qbvh["two_level"], "5qbtl")
    del qbvh

    # ---- 6. CLI ----
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "scene.xml")
        write_mitsuba_scene(xml)
        mixed_xml = os.path.join(tmp, "mixed", "scene.xml")
        os.makedirs(os.path.dirname(mixed_xml))
        write_mitsuba_mixed_scene(mixed_xml)
        media_xml = os.path.join(tmp, "media.xml")
        write_mitsuba_media_scene(media_xml)
        # (scene, flags, label, what the [paths] line must name, must not
        # name). The textured mixed scene and the media scene leave the
        # fused shade (its gate refuses textures and media) for K3, as the
        # JAX package routes them; -I ao runs the binary walk alone.
        bt_src, sg_src, fs_src = "binary_traverse.cu", "shade_gather.cu", "fused_shade.cu"
        plan = ((xml, ["-N", "2"], "", (bt_src, fs_src), ("wide_traverse.cu",)),
                (xml, ["-N", "4", "--svgf", "on"], "", (bt_src, sg_src), ("wide_traverse.cu",)),
                (mixed_xml, ["-N", "2"], "(mixed)", (bt_src, sg_src), ("wide_traverse.cu",)),
                (media_xml, ["-N", "2"], "(media)", (bt_src, sg_src),
                 ("wide_traverse.cu", fs_src)),
                (media_xml, ["-N", "2", "-I", "ao"], "(media)", (bt_src,),
                 ("wide_traverse.cu", sg_src, fs_src)),
                (media_xml, ["-N", "1", "--aovs"], "(media)", (bt_src, sg_src),
                 ("wide_traverse.cu", fs_src)))
        # --checkpoint: a straight 3-sample run, and one stopped after its
        # second sample (snapshots every sample) that a second run resumes;
        # --perf in a directory of its own (it writes perf.txt there).
        cli = [sys.executable, "-m", "gpu_raytracer_tpu_torch", xml, "-W", "256", "-H",
               "256", "--device", "cuda"]
        ck = os.path.join(tmp, "ck.npz")
        perf_dir = os.path.join(tmp, "perf")
        os.makedirs(perf_dir)
        env = dict(os.environ, PYTHONPATH=REPO)
        extra_runs = {
            "straight": subprocess.Popen(
                cli + ["-N", "3", "-o", os.path.join(tmp, "straight.png")], cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            "stopped": subprocess.Popen(
                [sys.executable, "-c", STOP_AFTER_TWO, *cli[3:], "-N", "3", "--checkpoint", ck,
                 "--checkpoint-every", "0", "-o", os.path.join(tmp, "resumed.png")],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            "perf": subprocess.Popen(cli + ["--perf"], cwd=perf_dir, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True),
            # 6vw: the terminal viewer with stdin not a terminal.
            "viewer": subprocess.Popen(cli + ["--viewer", "-N", "4"], cwd=REPO,
                                       stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)}
        runs = []
        for i, (path, extra, label, want, refuse) in enumerate(plan):
            out = os.path.join(tmp, f"out{i}.exr")
            runs.append((extra + ([label] if label else []), out, want, refuse,
                         subprocess.Popen(
                [sys.executable, "-m", "gpu_raytracer_tpu_torch", path, "-W", "256",
                 "-H", "256", *extra, "-o", out, "--device", "cuda"],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        try:
            for extra, out, want, refuse, proc in runs:
                stdout, stderr = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"CLI {extra} failed ({proc.returncode}):\n"
                                         f"{stdout}\n{stderr}")
                img = read_exr(out)
                if img.shape[:2] != (256, 256) or not np.isfinite(img).all():
                    raise AssertionError(f"CLI image {img.shape} not finite 256x256")
                paths = [ln for ln in stdout.splitlines() if ln.startswith("[paths]")]
                if len(paths) != 1 or any(w not in paths[0] for w in want) \
                        or any(r in paths[0] for r in refuse):
                    raise AssertionError(f"CLI {extra}: the [paths] line does not name "
                                         f"{want} (and none of {refuse}): {paths}")
                more = ""
                if "-I" in extra and not 0.0 <= float(img[..., :3].min()) <= float(
                        img[..., :3].max()) <= 1.0:
                    raise AssertionError(f"CLI {extra}: AO outside [0, 1]")
                if "--aovs" in extra:
                    base = os.path.splitext(out)[0]
                    aovs = {k: read_exr(f"{base}_{k}.exr")
                            for k in ("albedo", "normal", "position")}
                    if any(a.shape[:2] != (256, 256) or not np.isfinite(a).all()
                           or not np.abs(a).sum() > 0 for a in aovs.values()):
                        raise AssertionError(f"CLI {extra}: the AOV files are not finite, "
                                             f"non-zero 256x256 images")
                    more = "; AOVs " + ", ".join(
                        f"{k} mean {float(a[..., :3].mean()):.4f}" for k, a in aovs.items())
                say("6", f"CLI {' '.join(extra)} wrote {img.shape[1]}x{img.shape[0]} "
                         f"EXR, mean {float(img[..., :3].mean()):.4f}{more}; {paths[0]}")
            phase_cli_checkpoint_perf(extra_runs, cli, tmp, ck, perf_dir)
        finally:
            for proc in [r[-1] for r in runs] + list(extra_runs.values()):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    # ---- 7. the independent anchor ----
    phase_anchor(anchor_numpy)
    pool.shutdown()

    jax_mods = sorted(m for m in sys.modules if m.startswith("jax")
                      or m == "gpu_raytracer_tpu" or m.startswith("gpu_raytracer_tpu."))
    if jax_mods:
        raise AssertionError(f"the port loaded JAX or the JAX package: {jax_mods[:5]}")

    say("done", "every phase passed")
    print(json.dumps({"kernels": [
        {"name": KERNELS[r][0], "route": "cuda", "source": KERNELS[r][1],
         "replaces": KERNELS[r][2], "launches": main_launches[r], **results[r]}
        for r in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
