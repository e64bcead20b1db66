"""frame_ms: the window's wall time over the frames completed in it
(denoised mixes)."""

from benchmark.harness.yardstick import per_unit_ms


def read(ctx):
    if ctx["mode"] != "denoised":
        return None
    return per_unit_ms(ctx["window_s"], ctx["units"])
