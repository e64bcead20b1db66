"""walk_roofline_pct.batch: the least time of the primary walk over K1's
device time a sample (`wt_walk_kernel` with MODE 0, WT_PRIMARY).

The least time is the larger of the wave's rays read and hits written
once (7 + 4 floats a ray) over the memory rate, and the operations of the
node and triangle tests that the benchmark's own walk over its own tree
(benchmark/reference/bvh.py) makes for a primary ray of every pixel, over
the fp32 rate (benchmark/harness/yardstick.py). Nothing read from the
port's tables enters it."""

from benchmark.harness.profile import kernel_id, kernel_seconds, template_args
from benchmark.harness.yardstick import bound, walk_ops

RAY_BYTES = 4 * (7 + 4)


def _primary(name):
    if kernel_id(name) != "wt_walk_kernel":
        return False
    args = template_args(name)
    return bool(args) and args[0] in ("0", "WT_PRIMARY")


def read(ctx):
    walk, trace = ctx.get("walk"), ctx["trace"]
    if ctx["mode"] != "batch" or trace is None or not walk:
        return None
    k1_s = kernel_seconds(trace, _primary) / trace["units"]
    if k1_s <= 0:
        return None
    least_ms, _ = bound(RAY_BYTES * walk["rays"], walk_ops(walk["node"], walk["triangle"]))
    return 100.0 * least_ms / (1e3 * k1_s)
