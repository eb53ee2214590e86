"""The check that a run loaded neither JAX nor the JAX package: names are
compared by their top-level part whole, so ``sparsetpu_torch`` is not
taken for ``sparsetpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sparsetpu"})


def forbidden_loaded(modules=None) -> list:
    """Sorted names in ``modules`` (default ``sys.modules``) whose
    top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
