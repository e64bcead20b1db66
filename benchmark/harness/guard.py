"""What the benchmark's process may hold: never JAX nor the JAX package.
Module names are compared by their whole top-level name (the part before
the first dot), so `gpu_raytracer_tpu_torch` is not `gpu_raytracer_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_raytracer_tpu")


def forbidden_modules(names=None) -> list:
    """Top-level names among `names` (default: `sys.modules`) that are
    forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
