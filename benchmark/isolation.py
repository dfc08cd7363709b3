"""The JAX side must not load into a run: whole top-level module names."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "elbencho_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in sys.modules (the part before the first dot,
    compared whole, so elbencho_tpu_torch is not elbencho_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
