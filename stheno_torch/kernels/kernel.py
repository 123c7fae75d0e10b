"""Kernel expression algebra.

Counterpart of ``stheno_tpu/kernels/kernel.py``, ported for the exact-GP
path: the ``Kernel`` base and its algebra, Zero/One, EQ, RQ,
Matérn-1/2, 3/2 and 5/2, Linear, tensor-product, Scaled/Sum/Product, and
the input-wrapped kernels (Stretched, Shifted, Selected,
InputTransformed, Periodic). Derivative kernels, Delta, Coregion and the
other mlkernels kernels are not ported yet.

``pairwise(k, x, y)`` returns a *structured* matrix (Linear -> LowRank,
One -> Constant, Zero -> Zero), so the linear algebra downstream can take
closed forms. EQ, RQ and Matérn Grams of 2-D CUDA inputs go through the
fused Gram kernel K1 (:func:`_fused_gram`); CPU inputs take
:func:`pw_dists2`, as the JAX package does off the TPU.

Kernel parameters that are tensors are treated like traced values in the
JAX package: they are never compared by value (that would synchronise
with the card, and ``s2 == 1`` would drop the scaling and with it the
gradient with respect to ``s2``).
"""

import math
import numbers

import numpy as np
import torch

from .. import config
from ..matrix import (
    Constant,
    Dense,
    LowRank,
    Zero,
    add as mat_add,
    multiply as mat_multiply,
    scale as mat_scale,
    transpose as mat_transpose,
)
from ..ops.gram import gram
from .util import as_fn_output

__all__ = [
    "Kernel",
    "ZeroKernel",
    "OneKernel",
    "EQ",
    "RQ",
    "Exp",
    "Matern12",
    "Matern32",
    "Matern52",
    "Linear",
    "TensorProductKernel",
    "SumKernel",
    "ProductKernel",
    "ScaledKernel",
    "StretchedKernel",
    "ShiftedKernel",
    "SelectedKernel",
    "InputTransformedKernel",
    "PeriodicKernel",
    "pw_dists2",
    "ew_dists2",
]


# ---------------------------------------------------------------------------
# Distance helpers.
# ---------------------------------------------------------------------------


def pw_dists2(x, y):
    """Pairwise squared distances ``(..., n, m)`` between rows of
    ``x (..., n, d)`` and ``y (..., m, d)`` via the matmul identity, or by
    direct differencing under ``config.accurate_dists()``."""
    if config.accurate_dists_enabled():
        d2 = None
        for di in range(x.shape[-1]):
            dd = x[..., :, None, di] - y[..., None, :, di]
            d2 = dd * dd if d2 is None else d2 + dd * dd
        return d2
    xn = torch.sum(x * x, dim=-1)
    yn = xn if x is y else torch.sum(y * y, dim=-1)
    inner = x @ y.transpose(-1, -2)
    return torch.clamp_min(xn[..., :, None] + yn[..., None, :] - 2 * inner, 0)


def ew_dists2(x, y):
    """Elementwise squared distances ``(..., n, 1)``."""
    if x is y:
        return x.new_zeros(x.shape[:-1] + (1,))
    d = x - y
    return torch.sum(d * d, dim=-1, keepdim=True)


def _safe_sqrt(d2):
    """sqrt with a well-defined (zero) gradient at 0."""
    return torch.sqrt(d2 + 1e-36)


def _fused_gram(kind, x, y, alpha=1.0):
    """The fused Gram kernel K1 for 2-D CUDA inputs; ``None`` otherwise
    (batched or CPU inputs, or the cancellation-free distance mode, which
    the kernel's matmul identity cannot honour)."""
    if config.accurate_dists_enabled():
        return None
    if x.ndim == 2 and y.ndim == 2 and x.is_cuda:
        return gram(kind, x, y, alpha)
    return None


def _is_function(obj):
    return callable(obj) and not isinstance(obj, Kernel)


def _param_eq(a, b):
    """Value equality of parameters; tensors compare by identity only."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a is b
    if isinstance(a, numbers.Number) and isinstance(b, numbers.Number):
        return a == b
    return a is b


def _param(p, like):
    """A parameter ready to combine with the tensor ``like``: a 0-d array
    is filled in on ``like``'s device (no host copy)."""
    if isinstance(p, (torch.Tensor, numbers.Number)):
        return p
    if np.ndim(p) == 0:
        return config.as_scalar(p, like.dtype, like.device)
    return torch.as_tensor(p, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Base class.
# ---------------------------------------------------------------------------


class Kernel:
    """Base kernel. ``k(x)``/``k(x, y)`` -> structured Gram matrix;
    ``k.elwise(x, y)`` -> column."""

    def __call__(self, x, y=None):
        from .eval import pairwise

        return pairwise(self, x, y)

    def elwise(self, x, y=None):
        from .eval import elwise

        return elwise(self, x, y)

    def _pairwise(self, x, y):  # pragma: no cover - abstract
        raise NotImplementedError(f"pairwise not implemented for {type(self).__name__}.")

    def _elwise(self, x, y):  # pragma: no cover - abstract
        raise NotImplementedError(f"elwise not implemented for {type(self).__name__}.")

    # -- algebra ----------------------------------------------------------

    def __add__(self, other):
        if isinstance(other, Kernel):
            if isinstance(other, ZeroKernel):
                return self
            if isinstance(self, ZeroKernel):
                return other
            return SumKernel(self, other)
        if _is_function(other):
            return self + TensorProductKernel(other)
        if _param_eq(other, 0):
            return self
        return self + ScaledKernel(OneKernel(), other)

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, other):
        if isinstance(other, Kernel):
            if isinstance(other, ZeroKernel) or isinstance(self, ZeroKernel):
                return ZeroKernel()
            if isinstance(other, OneKernel):
                return self
            if isinstance(self, OneKernel):
                return other
            return ProductKernel(self, other)
        if _is_function(other):
            return ProductKernel(self, TensorProductKernel(other))
        if _param_eq(other, 1):
            return self
        if _param_eq(other, 0):
            return ZeroKernel()
        if isinstance(self, ZeroKernel):
            return self
        return ScaledKernel(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return ScaledKernel(self, -1)

    def __sub__(self, other):
        return self + (-1 * other if isinstance(other, Kernel) else -other)

    # -- transforms (1 arg: both sides; 2 args: per-argument) -------------

    def stretch(self, *stretches):
        return StretchedKernel(self, *_expand_two(stretches))

    def shift(self, *shifts):
        return ShiftedKernel(self, *_expand_two(shifts))

    def select(self, *dims):
        return SelectedKernel(self, *_expand_two(dims))

    def transform(self, *fs):
        return InputTransformedKernel(self, *_expand_two(fs))

    def diff(self, *dims):
        raise NotImplementedError("Derivative kernels are not ported to stheno_torch yet.")

    def periodic(self, period=1):
        return PeriodicKernel(self, period)

    @property
    def stationary(self):
        return False

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
        return NotImplemented if not isinstance(other, Kernel) else self is other

    def __hash__(self):
        return id(self)


def _expand_two(args):
    if len(args) == 1:
        if args[0] is None:
            raise ValueError("Transform argument cannot be None.")
        return args[0], args[0]
    if len(args) == 2:
        return args
    raise ValueError(f"Expected 1 or 2 transform arguments, got {len(args)}.")


# ---------------------------------------------------------------------------
# Leaf kernels.
# ---------------------------------------------------------------------------


class ZeroKernel(Kernel):
    """k(x, y) = 0."""

    def _pairwise(self, x, y):
        return Zero(x.dtype, x.shape[-2], y.shape[-2], device=x.device)

    def _elwise(self, x, y):
        return x.new_zeros(x.shape[:-1] + (1,))

    @property
    def stationary(self):
        return True

    def _render(self, formatter):
        return "0"

    def __eq__(self, other):
        return isinstance(other, ZeroKernel)

    __hash__ = Kernel.__hash__


class OneKernel(Kernel):
    """k(x, y) = 1."""

    def _pairwise(self, x, y):
        batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
        return Constant(x.new_ones(batch), x.shape[-2], y.shape[-2])

    def _elwise(self, x, y):
        return x.new_ones(x.shape[:-1] + (1,))

    @property
    def stationary(self):
        return True

    def _render(self, formatter):
        return "1"

    def __eq__(self, other):
        return isinstance(other, OneKernel)

    __hash__ = Kernel.__hash__


class _Stationary(Kernel):
    """A kernel ``g(||x - y||^2)`` with a fused-Gram kind; subclasses define
    ``kind`` and ``_g(d2)``."""

    kind = None

    def _alpha(self):
        return 1.0

    def _pairwise(self, x, y):
        fused = _fused_gram(self.kind, x, y, self._alpha())
        if fused is not None:
            return Dense(fused)
        return Dense(self._g(pw_dists2(x, y)))

    def _elwise(self, x, y):
        return self._g(ew_dists2(x, y))

    @property
    def stationary(self):
        return True

    def __eq__(self, other):
        return type(other) is type(self)

    __hash__ = Kernel.__hash__


class EQ(_Stationary):
    """Exponentiated-quadratic kernel ``exp(-||x - y||^2 / 2)``."""

    kind = "eq"

    def _g(self, d2):
        return torch.exp(-0.5 * d2)

    def _render(self, formatter):
        return "EQ()"


class RQ(_Stationary):
    """Rational-quadratic kernel ``(1 + ||x-y||^2 / (2 alpha))^(-alpha)``."""

    kind = "rq"

    def __init__(self, alpha):
        self.alpha = alpha

    def _alpha(self):
        return self.alpha

    def _g(self, d2):
        return (1 + d2 / (2 * self.alpha)) ** (-self.alpha)

    def _render(self, formatter):
        return f"RQ({formatter(self.alpha)})"

    def __eq__(self, other):
        return isinstance(other, RQ) and _param_eq(self.alpha, other.alpha)

    __hash__ = Kernel.__hash__


class Matern12(_Stationary):
    """Matérn-1/2 (exponential) kernel ``exp(-||x - y||)``."""

    kind = "matern12"

    def _g(self, d2):
        return torch.exp(-_safe_sqrt(d2))

    def _render(self, formatter):
        return "Exp()"


Exp = Matern12


class Matern32(_Stationary):
    """Matérn-3/2 kernel."""

    kind = "matern32"

    def _g(self, d2):
        r = math.sqrt(3) * _safe_sqrt(d2)
        return (1 + r) * torch.exp(-r)

    def _render(self, formatter):
        return "Matern32()"


class Matern52(_Stationary):
    """Matérn-5/2 kernel."""

    kind = "matern52"

    def _g(self, d2):
        r = math.sqrt(5) * _safe_sqrt(d2)
        return (1 + r + r * r / 3) * torch.exp(-r)

    def _render(self, formatter):
        return "Matern52()"


class Linear(Kernel):
    """Linear kernel ``x^T y``: the Gram is exactly low-rank, so it is
    returned as :class:`LowRank`."""

    def _pairwise(self, x, y):
        return LowRank(x) if x is y else LowRank(x, y)

    def _elwise(self, x, y):
        return torch.sum(x * y, dim=-1, keepdim=True)

    def _render(self, formatter):
        return "Linear()"

    def __eq__(self, other):
        return isinstance(other, Linear)

    __hash__ = Kernel.__hash__


class TensorProductKernel(Kernel):
    """``k(x, y) = f(x) g(y)`` for functions ``f``, ``g`` (default
    ``g = f``): a rank-1 Gram, returned as :class:`LowRank`."""

    def __init__(self, f, g=None):
        self.f = f
        self.g = g

    @property
    def _g(self):
        return self.f if self.g is None else self.g

    def _pairwise(self, x, y):
        fx = as_fn_output(self.f(x), x.shape[-2])
        if x is y and self.g is None:
            return LowRank(fx)
        return LowRank(fx, as_fn_output(self._g(y), y.shape[-2]))

    def _elwise(self, x, y):
        return as_fn_output(self.f(x), x.shape[-2]) * as_fn_output(self._g(y), y.shape[-2])

    def _render(self, formatter):
        name = getattr(self.f, "__name__", "<f>")
        if self.g is None:
            return f"TensorProductKernel({name})"
        return f"TensorProductKernel({name}, {getattr(self._g, '__name__', '<g>')})"

    def __eq__(self, other):
        return (
            isinstance(other, TensorProductKernel)
            and self.f is other.f
            and self.g is other.g
        )

    __hash__ = Kernel.__hash__


# ---------------------------------------------------------------------------
# Combinators.
# ---------------------------------------------------------------------------


class _SwappedKernel(Kernel):
    """``k`` with its arguments swapped: the default cross-kernel right rule."""

    def __init__(self, k):
        self.k = k

    def _pairwise(self, x, y):
        return mat_transpose(self.k._pairwise(y, x))

    def _elwise(self, x, y):
        return self.k._elwise(y, x)

    @property
    def stationary(self):
        return self.k.stationary

    def _render(self, formatter):
        return f"swap({self.k.display(formatter)})"

    def __eq__(self, other):
        return isinstance(other, _SwappedKernel) and self.k == other.k

    __hash__ = Kernel.__hash__


class SumKernel(Kernel):
    def __init__(self, k1, k2):
        self.k1 = k1
        self.k2 = k2

    def _pairwise(self, x, y):
        return mat_add(self.k1._pairwise(x, y), self.k2._pairwise(x, y))

    def _elwise(self, x, y):
        return self.k1._elwise(x, y) + self.k2._elwise(x, y)

    @property
    def stationary(self):
        return self.k1.stationary and self.k2.stationary

    def _render(self, formatter):
        return f"{self.k1.display(formatter)} + {self.k2.display(formatter)}"

    def __eq__(self, other):
        if not isinstance(other, SumKernel):
            return False
        return (self.k1 == other.k1 and self.k2 == other.k2) or (
            self.k1 == other.k2 and self.k2 == other.k1
        )

    __hash__ = Kernel.__hash__


class ProductKernel(Kernel):
    def __init__(self, k1, k2):
        self.k1 = k1
        self.k2 = k2

    def _pairwise(self, x, y):
        return mat_multiply(self.k1._pairwise(x, y), self.k2._pairwise(x, y))

    def _elwise(self, x, y):
        return self.k1._elwise(x, y) * self.k2._elwise(x, y)

    @property
    def stationary(self):
        return self.k1.stationary and self.k2.stationary

    def _render(self, formatter):
        p1, p2 = self.k1.display(formatter), self.k2.display(formatter)
        if isinstance(self.k1, SumKernel):
            p1 = f"({p1})"
        if isinstance(self.k2, SumKernel):
            p2 = f"({p2})"
        return f"{p1} * {p2}"

    def __eq__(self, other):
        if not isinstance(other, ProductKernel):
            return False
        return (self.k1 == other.k1 and self.k2 == other.k2) or (
            self.k1 == other.k2 and self.k2 == other.k1
        )

    __hash__ = Kernel.__hash__


class ScaledKernel(Kernel):
    def __init__(self, k, scale):
        self.k = k
        self.scale = scale

    def _pairwise(self, x, y):
        return mat_scale(self.k._pairwise(x, y), self.scale)

    def _elwise(self, x, y):
        return self.k._elwise(x, y) * self.scale

    @property
    def stationary(self):
        return self.k.stationary

    def _render(self, formatter):
        inner = self.k.display(formatter)
        if isinstance(self.k, (SumKernel, ProductKernel)):
            inner = f"({inner})"
        return f"{formatter(self.scale)} * {inner}"

    def __eq__(self, other):
        return (
            isinstance(other, ScaledKernel)
            and self.k == other.k
            and _param_eq(self.scale, other.scale)
        )

    __hash__ = Kernel.__hash__


class _InputWrappedKernel(Kernel):
    """Base for kernels that warp each argument before delegating to a base
    kernel. Subclasses implement ``_warp(x, which)`` with ``which in (1, 2)``."""

    def __init__(self, k):
        self.k = k

    def _warp(self, x, which):  # pragma: no cover - abstract
        raise NotImplementedError

    def _warp_pair(self, x, y):
        wx = self._warp(x, 1)
        return wx, wx if (x is y and self._sym) else self._warp(y, 2)

    def _pairwise(self, x, y):
        return self.k._pairwise(*self._warp_pair(x, y))

    def _elwise(self, x, y):
        return self.k._elwise(*self._warp_pair(x, y))

    @property
    def _sym(self):  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def stationary(self):
        return False


class StretchedKernel(_InputWrappedKernel):
    def __init__(self, k, s1, s2):
        super().__init__(k)
        self.s1 = s1
        self.s2 = s2

    def _warp(self, x, which):
        return x / _param(self.s1 if which == 1 else self.s2, x)

    @property
    def _sym(self):
        return self.s1 is self.s2

    @property
    def stationary(self):
        return self.k.stationary and self._sym

    def _render(self, formatter):
        if self._sym:
            return f"{self.k.display(formatter)} > {formatter(self.s1)}"
        return f"{self.k.display(formatter)} > ({formatter(self.s1)}, {formatter(self.s2)})"

    def __eq__(self, other):
        return (
            isinstance(other, StretchedKernel)
            and self.k == other.k
            and _param_eq(self.s1, other.s1)
            and _param_eq(self.s2, other.s2)
        )

    __hash__ = Kernel.__hash__


class ShiftedKernel(_InputWrappedKernel):
    def __init__(self, k, s1, s2):
        super().__init__(k)
        self.s1 = s1
        self.s2 = s2

    def _warp(self, x, which):
        return x - _param(self.s1 if which == 1 else self.s2, x)

    @property
    def _sym(self):
        return self.s1 is self.s2

    @property
    def stationary(self):
        return self.k.stationary and self._sym

    def _render(self, formatter):
        if self._sym:
            return f"{self.k.display(formatter)} shift {formatter(self.s1)}"
        return (
            f"{self.k.display(formatter)} shift "
            f"({formatter(self.s1)}, {formatter(self.s2)})"
        )

    def __eq__(self, other):
        return (
            isinstance(other, ShiftedKernel)
            and self.k == other.k
            and _param_eq(self.s1, other.s1)
            and _param_eq(self.s2, other.s2)
        )

    __hash__ = Kernel.__hash__


def _normalise_dims(d):
    if d is None:
        return None
    if isinstance(d, numbers.Integral):
        return (int(d),)
    return tuple(int(i) for i in d)


class SelectedKernel(_InputWrappedKernel):
    """Select input dimensions (``None`` keeps all)."""

    def __init__(self, k, d1, d2):
        super().__init__(k)
        self.d1 = _normalise_dims(d1)
        self.d2 = _normalise_dims(d2)

    def _warp(self, x, which):
        d = self.d1 if which == 1 else self.d2
        return x if d is None else x[..., list(d)]

    @property
    def _sym(self):
        return self.d1 == self.d2

    @property
    def stationary(self):
        return self.k.stationary and self._sym

    def _render(self, formatter):
        if self._sym:
            return f"{self.k.display(formatter)} : {list(self.d1)}"
        return f"{self.k.display(formatter)} : ({self.d1}, {self.d2})"

    def __eq__(self, other):
        return (
            isinstance(other, SelectedKernel)
            and self.k == other.k
            and self.d1 == other.d1
            and self.d2 == other.d2
        )

    __hash__ = Kernel.__hash__


class InputTransformedKernel(_InputWrappedKernel):
    """Transform each argument through a function before evaluation
    (``None`` = identity); the result re-enters the generic dispatcher."""

    def __init__(self, k, f1, f2):
        super().__init__(k)
        self.f1 = f1
        self.f2 = f2

    def _warp(self, x, which):
        f = self.f1 if which == 1 else self.f2
        return x if f is None else f(x)

    def _pairwise(self, x, y):
        from .eval import pairwise

        return pairwise(self.k, *self._warp_pair(x, y))

    def _elwise(self, x, y):
        from .eval import elwise

        return elwise(self.k, *self._warp_pair(x, y))

    @property
    def _sym(self):
        return self.f1 is self.f2

    def _render(self, formatter):
        n1 = getattr(self.f1, "__name__", str(self.f1))
        n2 = getattr(self.f2, "__name__", str(self.f2))
        return f"{self.k.display(formatter)} transform ({n1}, {n2})"

    def __eq__(self, other):
        return (
            isinstance(other, InputTransformedKernel)
            and self.k == other.k
            and self.f1 is other.f1
            and self.f2 is other.f2
        )

    __hash__ = Kernel.__hash__


class PeriodicKernel(_InputWrappedKernel):
    """Periodic warping: inputs are embedded on the torus
    ``x -> (cos 2 pi x / p, sin 2 pi x / p)`` per dimension."""

    def __init__(self, k, period):
        super().__init__(k)
        self.period = period

    def _warp(self, x, which):
        angle = 2 * math.pi * x / _param(self.period, x)
        return torch.cat([torch.cos(angle), torch.sin(angle)], dim=-1)

    @property
    def _sym(self):
        return True

    @property
    def stationary(self):
        return self.k.stationary

    def _render(self, formatter):
        return f"{self.k.display(formatter)} per {formatter(self.period)}"

    def __eq__(self, other):
        return (
            isinstance(other, PeriodicKernel)
            and self.k == other.k
            and _param_eq(self.period, other.period)
        )

    __hash__ = Kernel.__hash__
