"""tables_s: host seconds of `Pathtracer.init_device()` to a device sync
(the host tables: the trees, their packing and upload)."""


def read(ctx):
    return ctx["tables_s"]
