"""setup_s: seconds from the process's start to the first timed call
(imports, the scene, the port's tables, the kernels' build where the
checkout has none yet, the warm-up)."""


def read(ctx):
    return ctx["setup_s"]
