"""The modules a run may not load: JAX, and the JAX package and its tools
beside the port. Compared by whole top-level names, since the port's own
name, ``gblastn_tpu_torch``, begins with the JAX package's."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gblastn_tpu", "bench",
                       "chip_smoke"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module this process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
