"""glue_ms.batch: device ms a sample of everything but the port's own
kernels (`wt_`, `bt_`, `st_`, `sg_`, `fs_`, `sv_`): the PyTorch glue's
kernels and copies, in the traced slice."""

from benchmark.harness.profile import kernel_id, kernel_seconds

LIBRARY = ("wt_", "bt_", "st_", "sg_", "fs_", "sv_")


def read(ctx):
    if ctx["mode"] != "batch" or ctx["trace"] is None:
        return None
    s = kernel_seconds(ctx["trace"], lambda n: not kernel_id(n).startswith(LIBRARY))
    return 1e3 * s / ctx["trace"]["units"]
