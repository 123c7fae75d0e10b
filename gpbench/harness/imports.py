"""The check that a run of the port loaded nothing of the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot): ``stheno_torch`` begins with ``stheno``, but it is not
``stheno_tpu``."""

import sys

__all__ = ["FORBIDDEN", "forbidden_loaded"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "stheno_tpu"})


def forbidden_loaded(modules=None):
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
