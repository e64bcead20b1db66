"""idle_pct.batch: 100 less the union of the device intervals over the
traced slice's wall time."""


def read(ctx):
    if ctx["mode"] != "batch" or ctx["trace"] is None:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
