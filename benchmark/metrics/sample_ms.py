"""sample_ms: the window's wall time over the samples completed in it, the
window ending at the last sample's device sync (batch mixes)."""

from benchmark.harness.yardstick import per_unit_ms


def read(ctx):
    if ctx["mode"] != "batch":
        return None
    return per_unit_ms(ctx["window_s"], ctx["units"])
