"""The traced slice: a few warm samples or frames under `torch.profiler`,
reduced to what the per-layer readers and the result's `device` and
`breakdown` need. The reduction follows `tools/torch_profile_sample.py`
(`profile_sample`, :52-105): the device intervals, their union, device time
by kernel name and the kernels under a host range.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

from benchmark.harness.yardstick import busy_union

TOP = 10
_COPY = ("Memcpy", "Memset", "memcpy", "memset")
_IDENT = re.compile(r"(?:void\s+)?([A-Za-z_][A-Za-z0-9_:]*)")


def kernel_id(name: str) -> str:
    """A device event's function name without `void`, template arguments
    and parameters (`void wt_walk_kernel<0, 0, false>(WtArgs)` ->
    `wt_walk_kernel`); a mangled name's identifier (`_Z14wt_walk_kernel...`)."""
    m = re.match(r"_Z(?:N\d*)?(\d+)([A-Za-z_]\w*)", name)
    if m:
        return m.group(2)[: int(m.group(1))]
    m = _IDENT.match(name.strip())
    return m.group(1).split("::")[-1] if m else name


def template_args(name: str) -> list:
    """The template arguments of a demangled kernel name as strings, or of
    a mangled one's leading integer arguments."""
    m = re.search(r"<([^<>]*)>", name)
    if m:
        return [a.strip() for a in m.group(1).split(",")]
    return re.findall(r"Li(-?\d+)E", name)


def _kernels_under(event) -> list:
    return list(event.kernels) + [k for ch in event.cpu_children for k in _kernels_under(ch)]


def trace_slice(step, units: int, ranges=()) -> dict:
    """Profile `units` calls of `step` (each ends in a device sync).
    Returns the device events (name, start us, end us), the traced window's
    wall seconds, the busy seconds (union of the device intervals), for
    each range name the device seconds of the kernels under it, the
    breakdown (device time by name, the longest idle gaps by the host op
    running in them) and `units`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(units):
            step()
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = list(prof.events())
    on_device = torch.autograd.DeviceType.CUDA
    # A profiler range also leaves a device-side span of its own name: no kernel.
    device = [(e.name, float(e.time_range.start), float(e.time_range.end))
              for e in events if e.device_type == on_device and e.name not in ranges]
    host = [e for e in events if e.device_type != on_device]
    range_s = {}
    for name in ranges:
        ks = [k for e in host if e.name == name for k in _kernels_under(e) if k.name != name]
        range_s[name] = sum(k.duration for k in ks) / 1e6
    by_name = defaultdict(float)
    for n, a, b in device:
        by_name[n] += (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device": device, "wall_s": wall_s,
            "busy_s": busy_union([(a, b) for _, a, b in device]) / 1e6,
            "ranges": range_s, "units": units,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": _idle_gaps(device, host)}}


def _idle_gaps(device, host) -> list:
    """The gaps between device intervals, summed by the innermost host op
    running at each gap's middle, longest first."""
    spans = sorted((a, b) for _, a, b in device)
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    ops = sorted(((float(e.time_range.start), float(e.time_range.end), e.name) for e in host),
                 key=lambda x: x[0])
    total = defaultdict(float)
    stack, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(ops) and ops[i][0] <= mid:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        total[stack[-1][2] if stack else "(no host op)"] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def kernel_seconds(trace: dict, pick) -> float:
    """Device seconds of the events whose name `pick(name)` accepts."""
    return sum(b - a for n, a, b in trace["device"] if pick(n)) / 1e6


def launches(trace: dict) -> int:
    """Device kernels in the slice (copies and sets left out)."""
    return sum(1 for n, _, _ in trace["device"] if not n.startswith(_COPY))
