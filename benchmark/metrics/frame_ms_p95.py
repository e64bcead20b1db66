"""frame_ms_p95: the 95th percentile of all the window's frames, each
timed from its call to its device sync (denoised mixes)."""

from benchmark.harness.yardstick import percentile


def read(ctx):
    if ctx["mode"] != "denoised":
        return None
    return 1e3 * percentile(ctx["unit_times_s"], 95.0)
