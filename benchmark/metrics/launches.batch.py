"""launches.batch: device kernels (copies and sets left out) a sample in the
traced slice."""

from benchmark.harness.profile import launches


def read(ctx):
    if ctx["mode"] != "batch" or ctx["trace"] is None:
        return None
    return launches(ctx["trace"]) / ctx["trace"]["units"]
