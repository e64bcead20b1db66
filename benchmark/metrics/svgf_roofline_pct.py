"""svgf_roofline_pct: the least time of a frame's SVGF stencil launches
(the variance pass and every a-trous pass, each reading its images and
writing its output once, or its operations counted from the shapes,
whichever is more; benchmark/harness/yardstick.py) over the K5 kernels'
device time a frame (`sv_variance_kernel`, `sv_atrous_kernel`)."""

from benchmark.harness.profile import kernel_id, kernel_seconds
from benchmark.harness.yardstick import svgf_bound_ms


def read(ctx):
    t = ctx["trace"]
    if ctx["mode"] != "denoised" or t is None:
        return None
    s = kernel_seconds(t, lambda n: kernel_id(n).startswith("sv_")) / t["units"]
    if s <= 0:
        return None
    H, W = ctx["film"]
    least_ms = svgf_bound_ms(H, W, int(ctx["gpu"].get("svgf_atrous_iterations", 6)))
    return 100.0 * least_ms / (1e3 * s)
