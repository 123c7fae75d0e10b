"""Mean-function expression algebra.

Counterpart of ``stheno_tpu/kernels/mean.py``: the ``Mean`` base and its
algebra, Zero/One, tensor-product (a user function), Scaled, Sum and
Product, the input transforms that mirror the kernels' (stretch, shift,
select, transform, periodic) and derivatives (:class:`DerivativeMean`,
``m.diff``), which differentiate a mean's one-point form ``_scalar`` with
``torch.func`` where the JAX package uses ``jax.grad``.
"""

import math

import torch

from .kernel import _fn_scalar, _normalise_dims, _param, _param_eq
from .util import as_fn_output

__all__ = [
    "Mean",
    "ZeroMean",
    "OneMean",
    "TensorProductMean",
    "SumMean",
    "ProductMean",
    "ScaledMean",
    "StretchedMean",
    "ShiftedMean",
    "SelectedMean",
    "InputTransformedMean",
    "PeriodicMean",
    "DerivativeMean",
]


class Mean:
    """Base mean function: calling returns a column ``(..., n, 1)``."""

    def __call__(self, x):
        from .eval import mean_eval

        return mean_eval(self, x)

    def _eval(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def _scalar(self, x):  # pragma: no cover - abstract
        """Evaluate at one input vector ``(d,)``: the form that
        :class:`DerivativeMean` differentiates."""
        raise NotImplementedError(
            f"scalar evaluation not implemented for {type(self).__name__}."
        )

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

    # -- transforms -------------------------------------------------------

    def stretch(self, s):
        return StretchedMean(self, s)

    def shift(self, s):
        return ShiftedMean(self, s)

    def select(self, dims):
        return SelectedMean(self, dims)

    def transform(self, f):
        return InputTransformedMean(self, f)

    def periodic(self, period=1):
        return PeriodicMean(self, period)

    def diff(self, dim=0):
        return DerivativeMean(self, dim)

    # -- display ----------------------------------------------------------

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

    def _scalar(self, x):
        return x.new_zeros(())

    def _render(self, formatter):
        return "0"

    def __eq__(self, other):
        return isinstance(other, ZeroMean)

    __hash__ = Mean.__hash__

    @property
    def is_zero(self):
        return True


class OneMean(Mean):
    def _eval(self, x):
        return x.new_ones(x.shape[:-1] + (1,))

    def _scalar(self, x):
        return x.new_ones(())

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

    def _scalar(self, x):
        return _fn_scalar(self.f, x)

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

    def _scalar(self, x):
        return self.m1._scalar(x) + self.m2._scalar(x)

    def _render(self, formatter):
        return f"{self.m1.display(formatter)} + {self.m2.display(formatter)}"

    def __eq__(self, other):
        if not isinstance(other, SumMean):
            return False
        return (self.m1 == other.m1 and self.m2 == other.m2) or (
            self.m1 == other.m2 and self.m2 == other.m1
        )

    __hash__ = Mean.__hash__


class ProductMean(Mean):
    def __init__(self, m1, m2):
        self.m1 = m1
        self.m2 = m2

    def _eval(self, x):
        return self.m1._eval(x) * self.m2._eval(x)

    def _scalar(self, x):
        return self.m1._scalar(x) * self.m2._scalar(x)

    def _render(self, formatter):
        p1, p2 = self.m1.display(formatter), self.m2.display(formatter)
        if isinstance(self.m1, SumMean):
            p1 = f"({p1})"
        if isinstance(self.m2, SumMean):
            p2 = f"({p2})"
        return f"{p1} * {p2}"

    def __eq__(self, other):
        if not isinstance(other, ProductMean):
            return False
        return (self.m1 == other.m1 and self.m2 == other.m2) or (
            self.m1 == other.m2 and self.m2 == other.m1
        )

    __hash__ = Mean.__hash__


class ScaledMean(Mean):
    def __init__(self, m, scale):
        self.m = m
        self.scale = scale

    def _eval(self, x):
        return self.m._eval(x) * self.scale

    def _scalar(self, x):
        return self.m._scalar(x) * self.scale

    def _render(self, formatter):
        inner = self.m.display(formatter)
        if isinstance(self.m, (SumMean, ProductMean)):
            inner = f"({inner})"
        return f"{formatter(self.scale)} * {inner}"

    def __eq__(self, other):
        return (
            isinstance(other, ScaledMean)
            and self.m == other.m
            and _param_eq(self.scale, other.scale)
        )

    __hash__ = Mean.__hash__


class _WrappedMean(Mean):
    """A mean of warped inputs; subclasses implement ``_warp(x)``."""

    def __init__(self, m):
        self.m = m

    def _warp(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def _eval(self, x):
        from .eval import mean_eval

        return mean_eval(self.m, self._warp(x))

    def _scalar(self, x):
        return self.m._scalar(self._warp(x[None, :])[0])


class StretchedMean(_WrappedMean):
    def __init__(self, m, s):
        super().__init__(m)
        self.s = s

    def _warp(self, x):
        return x / _param(self.s, x)

    def _render(self, formatter):
        return f"{self.m.display(formatter)} > {formatter(self.s)}"

    def __eq__(self, other):
        return isinstance(other, StretchedMean) and self.m == other.m and _param_eq(
            self.s, other.s)

    __hash__ = Mean.__hash__


class ShiftedMean(_WrappedMean):
    def __init__(self, m, s):
        super().__init__(m)
        self.s = s

    def _warp(self, x):
        return x - _param(self.s, x)

    def _render(self, formatter):
        return f"{self.m.display(formatter)} shift {formatter(self.s)}"

    def __eq__(self, other):
        return isinstance(other, ShiftedMean) and self.m == other.m and _param_eq(
            self.s, other.s)

    __hash__ = Mean.__hash__


class SelectedMean(_WrappedMean):
    def __init__(self, m, dims):
        super().__init__(m)
        self.dims = _normalise_dims(dims)

    def _warp(self, x):
        return x if self.dims is None else x[..., list(self.dims)]

    def _render(self, formatter):
        return f"{self.m.display(formatter)} : {list(self.dims)}"

    def __eq__(self, other):
        return isinstance(other, SelectedMean) and self.m == other.m and self.dims == other.dims

    __hash__ = Mean.__hash__


class InputTransformedMean(_WrappedMean):
    def __init__(self, m, f):
        super().__init__(m)
        self.f = f

    def _warp(self, x):
        return x if self.f is None else self.f(x)

    def _render(self, formatter):
        return f"{self.m.display(formatter)} transform {getattr(self.f, '__name__', str(self.f))}"

    def __eq__(self, other):
        return isinstance(other, InputTransformedMean) and self.m == other.m and self.f is other.f

    __hash__ = Mean.__hash__


class PeriodicMean(_WrappedMean):
    def __init__(self, m, period):
        super().__init__(m)
        self.period = period

    def _warp(self, x):
        angle = 2 * math.pi * x / _param(self.period, x)
        return torch.cat([torch.cos(angle), torch.sin(angle)], dim=-1)

    def _render(self, formatter):
        return f"{self.m.display(formatter)} per {formatter(self.period)}"

    def __eq__(self, other):
        return isinstance(other, PeriodicMean) and self.m == other.m and _param_eq(
            self.period, other.period)

    __hash__ = Mean.__hash__


class DerivativeMean(Mean):
    """Derivative of a mean function with respect to input dimension
    ``dim``, by ``torch.func.grad`` of its ``_scalar`` under
    ``torch.func.vmap``."""

    def __init__(self, m, dim):
        self.m = m
        self.dim = dim

    def _eval(self, x):
        from torch.func import vmap

        from .kernel import prime_scalar

        if x.ndim > 2:
            raise NotImplementedError("Batched inputs are not supported for derivative means.")
        with prime_scalar(self.m):
            return vmap(self._scalar)(x)[:, None]

    def _scalar(self, x):
        from torch.func import grad

        return grad(self.m._scalar)(x)[self.dim]

    def _render(self, formatter):
        return f"d({self.dim}) {self.m.display(formatter)}"

    def __eq__(self, other):
        return isinstance(other, DerivativeMean) and self.m == other.m and self.dim == other.dim

    __hash__ = Mean.__hash__
