"""shade_ms.batch: device ms a sample of the shade kernels (K3, `sg_`),
in the traced slice."""

from benchmark.harness.profile import kernel_id, kernel_seconds


def read(ctx):
    if ctx["mode"] != "batch" or ctx["trace"] is None:
        return None
    s = kernel_seconds(ctx["trace"], lambda n: kernel_id(n).startswith("sg_"))
    return 1e3 * s / ctx["trace"]["units"] if s > 0 else None
