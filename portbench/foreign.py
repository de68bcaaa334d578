"""The modules a run must not load: JAX and the JAX package beside the
port, compared by whole top-level names (``repro_torch`` is not
``repro``)."""
from __future__ import annotations

import sys

FOREIGN = ("jax", "jaxlib", "flax", "repro")


def loaded() -> list:
    """The foreign top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))
