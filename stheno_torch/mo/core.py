"""Multi-output kernels and means, and the sizes of Gram matrices.

Counterpart of ``stheno_tpu/mo/core.py``: ``MultiOutputKernel`` (the
kernel of the Cartesian product of processes: plain inputs fan out to
every process, FDD-tagged inputs select one block),
``MultiOutputMean``, ``AmbiguousDimensionalityKernel``, and the
``num_elements``/``dimensionality``/``infer_size`` tree walk. The block
assembly of tuple inputs is in the generic dispatcher
(:mod:`stheno_torch.kernels.eval`).
"""

import torch

from ..kernels.kernel import (
    Kernel,
    ProductKernel,
    ScaledKernel,
    SumKernel,
    _InputWrappedKernel,
    _SwappedKernel,
)
from ..kernels.mean import Mean
from ..kernels.posterior import PosteriorKernel, SubspaceKernel
from ..kernels.util import num_elements_arr

__all__ = [
    "MultiOutputKernel",
    "MultiOutputMean",
    "AmbiguousDimensionalityKernel",
    "infer_size",
    "dimensionality",
    "num_elements",
]


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


class MultiOutputKernel(Kernel):
    """Kernel of the Cartesian product of processes: plain inputs fan out to
    all sub-processes; FDD-tagged inputs select the corresponding
    cross-kernel block."""

    def __init__(self, measure, *ps):
        self.measure = measure
        self.ps = ps

    def _fan_out(self, x):
        return tuple(p(x) for p in self.ps)

    def _pairwise(self, x, y):
        from ..kernels.eval import pairwise

        FDD = _fdd_type()
        x_fdd, y_fdd = isinstance(x, FDD), isinstance(y, FDD)
        if x_fdd and y_fdd:
            return pairwise(self.measure.kernels[x.p, y.p], x.x, y.x)
        if x_fdd:
            return pairwise(self, (x,), self._fan_out(y))
        if y_fdd:
            return pairwise(self, self._fan_out(x), (y,))
        return pairwise(self, self._fan_out(x), self._fan_out(y))

    def _elwise(self, x, y):
        from ..kernels.eval import elwise

        FDD = _fdd_type()
        x_fdd, y_fdd = isinstance(x, FDD), isinstance(y, FDD)
        if x_fdd and y_fdd:
            return elwise(self.measure.kernels[x.p, y.p], x.x, y.x)
        if x_fdd or y_fdd:
            raise ValueError('Unclear combination of arguments given to "elwise".')
        return elwise(self, self._fan_out(x), self._fan_out(y))

    @property
    def stationary(self):
        return False

    def _render(self, formatter):
        ks = [str(self.measure.kernels[p]) for p in self.ps]
        return "MultiOutputKernel({})".format(", ".join(ks))


class MultiOutputMean(Mean):
    """Mean of the Cartesian product of processes."""

    def __init__(self, measure, *ps):
        self.measure = measure
        self.ps = ps

    def _eval(self, x):
        from ..kernels.eval import mean_eval

        if isinstance(x, _fdd_type()):
            return mean_eval(self.measure.means[x.p], x.x)
        return torch.cat([mean_eval(self.measure.means[p], x) for p in self.ps], dim=-2)

    def _render(self, formatter):
        ms = [str(self.measure.means[p]) for p in self.ps]
        return "MultiOutputMean({})".format(", ".join(ms))


class AmbiguousDimensionalityKernel(Kernel):
    """Marks a kernel whose output dimensionality cannot be inferred (the
    cross process's projection, whose input transform hides the shape).
    Forwards all computation to the wrapped kernel."""

    def __init__(self, k):
        self.k = k

    def _pairwise(self, x, y):
        return self.k._pairwise(x, y)

    def _elwise(self, x, y):
        return self.k._elwise(x, y)

    @property
    def stationary(self):
        return self.k.stationary

    def _render(self, formatter):
        return self.k.display(formatter)

    def __eq__(self, other):
        return isinstance(other, AmbiguousDimensionalityKernel) and self.k == other.k

    __hash__ = Kernel.__hash__


def dimensionality(k):
    """Output dimensionality of a kernel expression; ``None`` if it cannot be
    inferred. Children of joins must agree."""
    if isinstance(k, (MultiOutputKernel, MultiOutputMean)):
        return len(k.ps)
    if isinstance(k, AmbiguousDimensionalityKernel):
        return None
    if isinstance(k, (SumKernel, ProductKernel)):
        return _check_and_merge(k, dimensionality(k.k1), dimensionality(k.k2))
    if isinstance(k, (ScaledKernel, _InputWrappedKernel, _SwappedKernel)):
        # A transposed cross-kernel has the dimensionality of what it wraps.
        return dimensionality(k.k)
    if isinstance(k, PosteriorKernel):
        return _check_and_merge(
            k, dimensionality(k.k_ij), dimensionality(k.k_zi), dimensionality(k.k_zj)
        )
    if isinstance(k, SubspaceKernel):
        return _check_and_merge(k, dimensionality(k.k_zi), dimensionality(k.k_zj))
    if isinstance(k, Kernel):
        return 1
    raise TypeError(f"Cannot infer dimensionality of {type(k).__name__}.")


def _check_and_merge(k, *ds):
    ds = [d for d in ds if d is not None]
    if not ds:
        return None
    if not all(d == ds[0] for d in ds[1:]):
        raise RuntimeError(f"Inferred dimensionalities for kernel {k} do not match.")
    return ds[0]


def infer_size(k, x):
    """Size of the Gram matrix of ``k`` evaluated at ``x``."""
    if isinstance(x, tuple):
        return sum(infer_size(k, xi) for xi in x)
    if isinstance(x, _fdd_type()):
        return num_elements(x)
    d = dimensionality(k)
    if d is None:
        raise RuntimeError(f"Could not infer dimensionality of {k}.")
    return num_elements(x) * d
