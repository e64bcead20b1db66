"""walk_ms.batch: device ms a sample of the traversal kernels
(`wt_walk_kernel`: K1, K2, K4), in the traced slice."""

from benchmark.harness.profile import kernel_id, kernel_seconds


def read(ctx):
    if ctx["mode"] != "batch" or ctx["trace"] is None:
        return None
    s = kernel_seconds(ctx["trace"], lambda n: kernel_id(n) == "wt_walk_kernel")
    return 1e3 * s / ctx["trace"]["units"] if s > 0 else None
