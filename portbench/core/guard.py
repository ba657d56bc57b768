"""The import guard: a run of the port may not load JAX or the JAX
package. Names are compared whole, by the part before the first dot, so
``siriltpu_torch`` is not ``siriltpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "siriltpu"})


def forbidden_modules(names=None) -> list:
    """The sorted top-level names among ``names`` (default: every module
    loaded in this process) that are forbidden."""
    if names is None:
        names = list(sys.modules)
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


__all__ = ["FORBIDDEN", "forbidden_modules"]
