"""denoise_ms: device ms a frame of the kernels under the benchmark's own
profiler range around `Pathtracer.denoise` (SVGF + TAA: the denoise glue
and the K5 kernels)."""


def read(ctx):
    t = ctx["trace"]
    if ctx["mode"] != "denoised" or t is None:
        return None
    s = t["ranges"].get("bench.denoise", 0.0)
    return 1e3 * s / t["units"] if s > 0 else None
