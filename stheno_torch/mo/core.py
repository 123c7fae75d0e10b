"""Input sizes for Gram matrices.

Counterpart of the subset of ``stheno_tpu/mo/core.py`` the exact-GP path
needs: ``num_elements``, ``dimensionality`` and ``infer_size``. The
multi-output kernels and means (``MultiOutputKernel``,
``MultiOutputMean``, ``AmbiguousDimensionalityKernel``) are not ported
yet, so every kernel here has dimensionality 1.
"""

from ..kernels.kernel import Kernel
from ..kernels.util import num_elements_arr

__all__ = ["infer_size", "dimensionality", "num_elements"]


def _fdd_type():
    from ..model.fdd import FDD

    return FDD


def num_elements(x):
    """Number of elements an input contributes to a Gram matrix row/col."""
    if isinstance(x, tuple):
        return sum(num_elements(xi) for xi in x)
    if isinstance(x, _fdd_type()):
        return num_elements(x.x)
    return num_elements_arr(x)


def dimensionality(k):
    """Output dimensionality of a kernel expression."""
    if isinstance(k, Kernel):
        return 1
    raise TypeError(f"Cannot infer dimensionality of {type(k).__name__}.")


def infer_size(k, x):
    """Size of the Gram matrix of ``k`` evaluated at ``x``."""
    if isinstance(x, tuple):
        return sum(infer_size(k, xi) for xi in x)
    if isinstance(x, _fdd_type()):
        return num_elements(x)
    return num_elements(x) * dimensionality(k)
