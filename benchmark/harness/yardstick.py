"""The benchmark's fixed arithmetic: the H100's peaks, a kernel's bound,
the statistics of a window, the union of device intervals and the
operation counts of the roofline shares. Later changes to the
port cannot move any of it.

Frozen copies: `bound` of `gpu_raytracer_tpu_torch/probes/__init__.py`
(:32-33 the peaks, :140-144; `chip_smoke.py` :408-414 calls it),
`busy_union` of `tools/torch_profile_sample.py` (:73-79). The roofline's bytes are counted from
the shapes, so `chip_smoke.py`'s `nbytes` (:393-405) has no caller here.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM (data sheet, dense, 700 W): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

# fp32 operations of one test in the reference's walk: a ray against one
# box (6 subtractions, 6 multiplies, 6 per-axis min/max, 4 reductions,
# 2 compares) and against one triangle (Moller-Trumbore: two cross
# products, four dot products, a reciprocal, three scales and the
# compares; PERF.md's table counts 52).
BOX_TEST_OPS = 24
TRIANGLE_TEST_OPS = 52

# fp32 operations a pixel of the SVGF stencils, counted from the plain
# versions (benchmark/reference/svgf.py), each exp, division and square
# root as one: a tap's edge-stopping weights 46 (normal dot 5, the 16th
# power 4 and a clamp, depth term 8, two luminances 10, two luminance
# terms 10, three products 3, rounding down), the variance stage's
# accumulation 24 a tap over 7 x 7 taps and a 20-operation epilogue; the
# a-trous pass 66 a tap over 8 taps, the 3 x 3 pre-blur (4 a tap) and
# two denominators (3 each).
VARIANCE_OPS_PER_PIXEL = 49 * (46 + 24) + 20
ATROUS_OPS_PER_PIXEL = 8 * 66 + 9 * 4 + 6
# float32 channels of the stencils' images: guide 5, dyn 8 in and 8 out.
STENCIL_FLOATS_PER_PIXEL = 5 + 8 + 8


def bound(num_bytes: float, ops: float) -> tuple:
    """(bound ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over the fp32 rate."""
    b_ms, o_ms = 1e3 * num_bytes / PEAK_BYTES_S, 1e3 * ops / PEAK_FP32_S
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def busy_union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def per_unit_ms(window_s: float, units: int) -> float:
    """The window's wall time over the units (samples, frames) completed."""
    if units <= 0:
        raise ValueError("no unit completed in the window")
    return 1e3 * window_s / units


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all `values`, linear between ranks
    (numpy's default)."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def walk_ops(node_visits: int, triangle_tests: int) -> int:
    """Operations of a walk that opened `node_visits` binary nodes (two box
    tests each) and made `triangle_tests` triangle tests."""
    return 2 * BOX_TEST_OPS * node_visits + TRIANGLE_TEST_OPS * triangle_tests


def svgf_bound_ms(height: int, width: int, atrous_iterations: int) -> float:
    """The least time of one frame's stencil launches: each launch's
    images read and written once, or its operations, whichever is more."""
    px = height * width
    moved = 4 * STENCIL_FLOATS_PER_PIXEL * px
    return (bound(moved, VARIANCE_OPS_PER_PIXEL * px)[0]
            + atrous_iterations * bound(moved, ATROUS_OPS_PER_PIXEL * px)[0])
