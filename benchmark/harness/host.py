"""What the host did over a window, read from /proc and the process's own
counters, for the line that `run.py` prints on standard error: the
process's CPU seconds and context switches, the CPU time that the
hypervisor took from the machine (steal), the load and the cores' clock.
The cells are paced by the host's launches, so these say why a run's time
moved. Linux only; missing files give no reading."""

from __future__ import annotations

import os
import resource


def _proc(path: str):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _cpu_mhz():
    text = _proc("/proc/cpuinfo")
    if not text:
        return None
    mhz = [float(line.split(":")[1]) for line in text.splitlines() if line.startswith("cpu MHz")]
    return sum(mhz) / len(mhz) if mhz else None


def _steal_s():
    text = _proc("/proc/stat")
    if not text:
        return None
    fields = text.splitlines()[0].split()
    return int(fields[8]) / os.sysconf("SC_CLK_TCK") if len(fields) > 8 else None


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "vcsw": ru.ru_nvcsw, "ivcsw": ru.ru_nivcsw,
            "steal_s": _steal_s(), "mhz": _cpu_mhz()}


def over(a: dict, b: dict, units: int) -> str:
    """One line on the host between snapshots `a` and `b` around `units`
    units of work."""
    def d(k):
        return None if a[k] is None or b[k] is None else b[k] - a[k]
    load = (_proc("/proc/loadavg") or "").split()[:3]
    steal = d("steal_s")
    return (f"host: {units} units; process CPU {d('cpu_s'):.3f} s "
            f"({1e3 * d('cpu_s') / max(units, 1):.3f} ms a unit); "
            f"context switches {d('vcsw')} voluntary, {d('ivcsw')} involuntary; "
            f"steal {'n/a' if steal is None else f'{steal:.2f} s'} (all cores); "
            f"cores' clock {a['mhz']} -> {b['mhz']} MHz; load {' '.join(load)}; "
            f"{os.cpu_count()} cores, affinity {len(os.sched_getaffinity(0))}")
