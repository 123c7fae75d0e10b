"""Mean-function expression algebra.

Counterpart of ``stheno_tpu/kernels/mean.py``, ported for the exact-GP
path: the ``Mean`` base and its algebra, Zero/One, tensor-product (a user
function), Scaled, Sum and Product. The input transforms of means and
derivative means are not ported yet.
"""

from .kernel import _param_eq
from .util import as_fn_output

__all__ = [
    "Mean",
    "ZeroMean",
    "OneMean",
    "TensorProductMean",
    "SumMean",
    "ProductMean",
    "ScaledMean",
]


class Mean:
    """Base mean function: calling returns a column ``(..., n, 1)``."""

    def __call__(self, x):
        from .eval import mean_eval

        return mean_eval(self, x)

    def _eval(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def __add__(self, other):
        if isinstance(other, Mean):
            if isinstance(other, ZeroMean):
                return self
            if isinstance(self, ZeroMean):
                return other
            return SumMean(self, other)
        if callable(other):
            return self + TensorProductMean(other)
        if _param_eq(other, 0):
            return self
        return self + ScaledMean(OneMean(), other)

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, other):
        if isinstance(other, Mean):
            if isinstance(other, ZeroMean) or isinstance(self, ZeroMean):
                return ZeroMean()
            if isinstance(other, OneMean):
                return self
            if isinstance(self, OneMean):
                return other
            return ProductMean(self, other)
        if callable(other):
            return ProductMean(self, TensorProductMean(other))
        if isinstance(self, ZeroMean) or _param_eq(other, 1):
            return self
        if _param_eq(other, 0):
            return ZeroMean()
        return ScaledMean(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return ScaledMean(self, -1)

    def __sub__(self, other):
        return self + (-other)

    def display(self, formatter=lambda x: x):
        return self._render(formatter)

    def _render(self, formatter):
        return type(self).__name__

    def __str__(self):
        return self.display()

    def __repr__(self):
        return self.display()

    def __eq__(self, other):
        return NotImplemented if not isinstance(other, Mean) else self is other

    def __hash__(self):
        return id(self)


class ZeroMean(Mean):
    def _eval(self, x):
        return x.new_zeros(x.shape[:-1] + (1,))

    def _render(self, formatter):
        return "0"

    def __eq__(self, other):
        return isinstance(other, ZeroMean)

    __hash__ = Mean.__hash__


class OneMean(Mean):
    def _eval(self, x):
        return x.new_ones(x.shape[:-1] + (1,))

    def _render(self, formatter):
        return "1"

    def __eq__(self, other):
        return isinstance(other, OneMean)

    __hash__ = Mean.__hash__


class TensorProductMean(Mean):
    """A user function as a mean: ``m(x) = f(x)``."""

    def __init__(self, f):
        self.f = f

    def _eval(self, x):
        return as_fn_output(self.f(x), x.shape[-2])

    def _render(self, formatter):
        return getattr(self.f, "__name__", "<f>")

    def __eq__(self, other):
        return isinstance(other, TensorProductMean) and self.f is other.f

    __hash__ = Mean.__hash__


class SumMean(Mean):
    def __init__(self, m1, m2):
        self.m1 = m1
        self.m2 = m2

    def _eval(self, x):
        return self.m1._eval(x) + self.m2._eval(x)

    def _render(self, formatter):
        return f"{self.m1.display(formatter)} + {self.m2.display(formatter)}"


class ProductMean(Mean):
    def __init__(self, m1, m2):
        self.m1 = m1
        self.m2 = m2

    def _eval(self, x):
        return self.m1._eval(x) * self.m2._eval(x)

    def _render(self, formatter):
        return f"{self.m1.display(formatter)} * {self.m2.display(formatter)}"


class ScaledMean(Mean):
    def __init__(self, m, scale):
        self.m = m
        self.scale = scale

    def _eval(self, x):
        return self.m._eval(x) * self.scale

    def _render(self, formatter):
        return f"{formatter(self.scale)} * {self.m.display(formatter)}"
