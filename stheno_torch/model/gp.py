"""GP process symbols.

Counterpart of ``stheno_tpu/model/gp.py``. A ``GP`` owns no mean or
kernel: it is a symbol whose statistics live in the measures it belongs
to. Sums and products apply to every measure in the intersection group;
``cross`` makes the Cartesian product of processes. The input transforms
(shift, stretch, select, transform) and the derivatives (``diff``, and
``diff_approx`` by central finite differences) apply likewise.
"""

import math

import numpy as np

from ..dist import RandomProcess
from ..kernels import OneKernel, OneMean, ZeroMean
from ..kernels.kernel import Kernel
from ..kernels.mean import Mean
from .fdd import FDD

__all__ = ["GP", "cross", "assert_same_measure", "intersection_measure_group"]


def assert_same_measure(*ps):
    """Assert that processes share their primary measure."""
    for p in ps[1:]:
        if ps[0].measure is not p.measure:
            raise AssertionError(
                f"Processes {ps[0]} and {p} are associated to different measures."
            )


def intersection_measure_group(*ps):
    """Measures common to all of ``ps``."""
    assert_same_measure(*ps)
    intersection = set(ps[0]._measures)
    for p in ps[1:]:
        intersection &= set(p._measures)
    return intersection


def cross(*ps):
    """Cartesian product of processes, registered in every common measure."""
    p_cross = GP()
    for measure in intersection_measure_group(*ps):
        measure.cross(p_cross, *ps)
    return p_cross


class GP(RandomProcess):
    """Gaussian process symbol.

    ``GP(kernel)`` / ``GP(mean, kernel)`` with optional ``measure=`` /
    ``name=`` keywords; a bare ``GP()`` is an unregistered symbol filled in
    by measure operations."""

    def __init__(self, mean=None, kernel=None, *, measure=None, name=None):
        self._measures = []
        if mean is None and kernel is None:
            return
        if kernel is None:
            mean, kernel = ZeroMean(), mean

        from .measure import Measure

        if measure is None:
            measure = Measure.default if Measure.default is not None else Measure()
        if not isinstance(mean, Mean):
            mean = mean * OneMean()
        if not isinstance(kernel, Kernel):
            kernel = kernel * OneKernel()
        measure.add_independent_gp(self, mean, kernel)
        if name:
            measure.name(self, name)

    @property
    def measure(self):
        """The measure the GP was constructed under."""
        if not self._measures:
            raise RuntimeError("GP is not associated to a measure.")
        return self._measures[0]

    @property
    def kernel(self):
        return self.measure.kernels[self]

    @property
    def mean(self):
        return self.measure.means[self]

    @property
    def name(self):
        return self.measure[self]

    @name.setter
    def name(self, name):
        for measure in self._measures:
            measure.name(self, name)

    def __call__(self, x, noise=None):
        """Finite-dimensional distribution at inputs ``x``."""
        return FDD(self, x, noise)

    def condition(self, *args):
        """Condition the GP's measure and project this GP into the posterior."""
        return self.measure.condition(*args)(self)

    def __or__(self, other):
        """``f | (f(x), y)`` conditioning sugar."""
        if isinstance(other, tuple):
            return self.condition(*other)
        return self.condition(other)

    def __add__(self, other):
        res = GP()
        measures = (
            intersection_measure_group(self, other) if isinstance(other, GP) else self._measures
        )
        for measure in measures:
            measure.sum(res, self, other)
        return res

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, other):
        res = GP()
        measures = (
            intersection_measure_group(self, other) if isinstance(other, GP) else self._measures
        )
        for measure in measures:
            measure.mul(res, self, other)
        return res

    def __rmul__(self, other):
        return self.__mul__(other)

    def shift(self, shift):
        res = GP()
        for measure in self._measures:
            measure.shift(res, self, shift)
        return res

    def stretch(self, stretch):
        res = GP()
        for measure in self._measures:
            measure.stretch(res, self, stretch)
        return res

    def transform(self, f):
        res = GP()
        for measure in self._measures:
            measure.transform(res, self, f)
        return res

    def select(self, *dims):
        res = GP()
        for measure in self._measures:
            measure.select(res, self, *dims)
        return res

    def diff(self, dim=0):
        res = GP()
        for measure in self._measures:
            measure.diff(res, self, dim)
        return res

    def diff_approx(self, deriv=1, order=6):
        """The ``deriv``-th derivative by central finite differences on an
        ``order``-point stencil."""
        grid, coefs, step = _central_fdm(order, deriv)
        df = 0
        for g, c in zip(grid, coefs):
            df += float(c) * self.shift(-g * step)
        return df / step**deriv

    @property
    def stationary(self):
        return self.kernel.stationary

    def display(self, formatter=lambda x: x):
        if self._measures:
            return f"GP({self.mean.display(formatter)}, {self.kernel.display(formatter)})"
        return "GP()"

    def __str__(self):
        return self.display()

    __repr__ = __str__


def _central_fdm(order, deriv):
    """Symmetric finite-difference grid, coefficients and step size for the
    ``deriv``-th derivative with an ``order``-point stencil."""
    n = max(order, deriv + 1)
    grid = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    # Solve sum_i c_i g_i^k / k! = delta_{k, deriv}.
    V = np.stack([grid**k / math.factorial(k) for k in range(n)])
    rhs = np.zeros(n)
    rhs[deriv] = 1.0
    coefs = np.linalg.solve(V, rhs)
    # The step that balances truncation against round-off.
    step = (np.finfo(np.float64).eps * 1e8) ** (1.0 / n)
    return grid, coefs, step
