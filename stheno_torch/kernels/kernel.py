"""Kernel expression algebra.

Counterpart of ``stheno_tpu/kernels/kernel.py``: the ``Kernel`` base and
its algebra, Zero/One, EQ, RQ, Matérn-1/2, 3/2 and 5/2, Linear, Delta,
FixedDelta, Coregion, DecayingKernel, LogKernel, tensor-product,
Scaled/Sum/Product, the input-wrapped kernels (Stretched, Shifted,
Selected, InputTransformed, Periodic) and derivatives
(:class:`DerivativeKernel`, ``k.diff``).

``pairwise(k, x, y)`` returns a *structured* matrix (Linear -> LowRank,
Delta of one input object -> Diagonal, One -> Constant, Zero -> Zero), so
the linear algebra downstream can take closed forms. EQ, RQ and Matérn
Grams of 2-D CUDA inputs go through the fused Gram kernel K1
(:func:`_fused_gram`); CPU inputs take :func:`pw_dists2`, as the JAX
package does off the TPU.

Every kernel also evaluates one pair of input vectors (``_scalar``), the
form that :class:`DerivativeKernel` differentiates with ``torch.func``
where the JAX package uses ``jax.grad``; ``_scalar`` is written without
in-place operations, host reads or branches on tensor values, so that
``torch.func.grad`` and ``vmap`` can trace it. A derivative of a scaled or
stretched EQ takes a closed form instead: factors times the base Gram,
which K1 makes for CUDA inputs.

Kernel parameters that are tensors are treated like traced values in the
JAX package: they are never compared by value (that would synchronise
with the card, and ``s2 == 1`` would drop the scaling and with it the
gradient with respect to ``s2``).
"""

import contextlib
import math
import numbers

import numpy as np
import torch

from .. import config
from ..matrix import (
    Constant,
    Dense,
    Diagonal,
    LowRank,
    Zero,
    add as mat_add,
    dense as mat_dense,
    multiply as mat_multiply,
    scale as mat_scale,
    transpose as mat_transpose,
)
from ..matrix.ops import _ndim
from ..ops.gram import gram
from .util import as_fn_output

__all__ = [
    "Kernel",
    "ZeroKernel",
    "OneKernel",
    "Coregion",
    "EQ",
    "RQ",
    "Exp",
    "Matern12",
    "Matern32",
    "Matern52",
    "Linear",
    "Delta",
    "FixedDelta",
    "DecayingKernel",
    "LogKernel",
    "TensorProductKernel",
    "SumKernel",
    "ProductKernel",
    "ScaledKernel",
    "StretchedKernel",
    "ShiftedKernel",
    "SelectedKernel",
    "InputTransformedKernel",
    "PeriodicKernel",
    "DerivativeKernel",
    "pw_dists2",
    "ew_dists2",
    "pw_sums2",
    "ew_sums2",
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


def pw_sums2(x, y):
    """Pairwise squared norms of sums ``||x_i + y_j||^2`` ``(..., n, m)``,
    via the matmul identity with ``+2 x . y``."""
    xn = torch.sum(x * x, dim=-1)
    yn = torch.sum(y * y, dim=-1)
    inner = x @ y.transpose(-1, -2)
    return torch.clamp_min(xn[..., :, None] + yn[..., None, :] + 2 * inner, 0)


def ew_sums2(x, y):
    """Elementwise squared norms of sums ``(..., n, 1)``."""
    s = x + y
    return torch.sum(s * s, dim=-1, keepdim=True)


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


def _param_tensor(p, like):
    """A parameter as a tensor of ``like``'s dtype on its device (a tensor
    is cast, keeping its graph)."""
    if isinstance(p, torch.Tensor):
        return p.to(dtype=like.dtype, device=like.device)
    if np.ndim(p) == 0:
        return config.as_scalar(p, like.dtype, like.device)
    return torch.as_tensor(np.asarray(p), dtype=like.dtype, device=like.device)


def _fn_scalar(f, v):
    """A user function of inputs ``(n, d)`` at the one point ``v`` as a 0-d
    tensor."""
    out = f(v[None, :])
    if not isinstance(out, torch.Tensor):
        out = torch.as_tensor(out, dtype=v.dtype, device=v.device)
    return out.reshape(())


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

    def _scalar(self, x, y):  # pragma: no cover - abstract
        """Evaluate on one pair of input vectors ``(d,)``: the form that
        :class:`DerivativeKernel` differentiates."""
        raise NotImplementedError(
            f"scalar evaluation not implemented for {type(self).__name__}."
        )

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
        return DerivativeKernel(self, *_expand_two(dims, allow_single_none=True))

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


def _expand_two(args, allow_single_none=False):
    if len(args) == 1:
        if args[0] is None and not allow_single_none:
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

    def _scalar(self, x, y):
        return x.new_zeros(())

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

    def _scalar(self, x, y):
        return x.new_ones(())

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

    def _scalar(self, x, y):
        d = x - y
        return self._g(torch.sum(d * d))

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

    def _scalar(self, x, y):
        return torch.sum(x * y)

    def _render(self, formatter):
        return "Linear()"

    def __eq__(self, other):
        return isinstance(other, Linear)

    __hash__ = Kernel.__hash__


def _task_index(v, t):
    """Task indices of the first input column: rounded, clipped to
    ``[0, t - 1]``, outside the graph."""
    i = torch.round(v.detach().to(torch.float64)).long()
    return torch.clamp(i, 0, t - 1)


class Coregion(Kernel):
    """Coregionalisation kernel over integer task indices in the first
    input column: ``k(i, j) = B[i, j]`` with PSD ``B (tasks, tasks)``.
    Differentiable with respect to ``B``; the indices are rounded and
    clipped to ``[0, tasks - 1]`` alike in the Gram, the elementwise and
    the scalar paths. With inputs ``(x, task)`` stacked as columns,
    ``EQ().select([0]) * Coregion(B).select([1])`` is the intrinsic
    coregionalisation model as a plain array-input kernel."""

    def __init__(self, B):
        self.B = B

    def _eval_dtype(self, x):
        """``B`` in the promotion of the input's and ``B``'s dtypes (a
        floating one: integer task indices must not truncate ``B``)."""
        B = self.B if isinstance(self.B, torch.Tensor) else torch.as_tensor(
            np.asarray(self.B), device=x.device)
        dt = torch.promote_types(x.dtype, B.dtype)
        if not dt.is_floating_point:
            dt = torch.promote_types(dt, torch.float32)
        return B.to(dtype=dt, device=x.device), dt

    @staticmethod
    def _onehot(v, t, dt):
        return (_task_index(v, t)[..., None] == torch.arange(t, device=v.device)).to(dt)

    def _pairwise(self, x, y):
        B, dt = self._eval_dtype(x)
        t = B.shape[-1]
        hi, hj = self._onehot(x[..., 0], t, dt), self._onehot(y[..., 0], t, dt)
        return Dense((hi @ B) @ hj.transpose(-1, -2))

    def _elwise(self, x, y):
        B, dt = self._eval_dtype(x)
        t = B.shape[-1]
        hi, hj = self._onehot(x[..., 0], t, dt), self._onehot(y[..., 0], t, dt)
        return torch.sum((hi @ B) * hj, dim=-1, keepdim=True)

    def _scalar(self, x, y):
        # Piecewise constant in the inputs (a zero input derivative, like
        # Delta) and differentiable with respect to B.
        B, dt = self._eval_dtype(x)
        t = B.shape[-1]
        return self._onehot(x[0], t, dt) @ B @ self._onehot(y[0], t, dt)

    def _render(self, formatter):
        return f"Coregion({formatter(self.B)})"

    def __eq__(self, other):
        return isinstance(other, Coregion) and _param_eq(self.B, other.B)

    __hash__ = Kernel.__hash__


class Delta(Kernel):
    """Kronecker-delta kernel: 1 iff the two inputs are (numerically)
    equal. When both arguments are *the same object*, the Gram is the
    identity and is returned as :class:`Diagonal`; the input path keeps one
    object for both arguments of ``k(x)`` (``kernels.eval.pairwise``), so
    a noise process stays diagonal."""

    def __init__(self, epsilon=1e-10):
        self.epsilon = epsilon

    def _pairwise(self, x, y):
        if x is y:
            return Diagonal(x.new_ones(x.shape[:-1]))
        # Exact differences (the matmul identity's cancellation could
        # exceed epsilon^2 for coincident points), one input dimension at a
        # time so that the peak is O(n m), not O(n m d).
        d2 = None
        for j in range(x.shape[-1]):
            diff = x[..., :, None, j] - y[..., None, :, j]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        return Dense((d2 <= self.epsilon**2).to(x.dtype))

    def _elwise(self, x, y):
        if x is y:
            return x.new_ones(x.shape[:-1] + (1,))
        return (ew_dists2(x, y) <= self.epsilon**2).to(x.dtype)

    def _scalar(self, x, y):
        # Zero almost everywhere, with a zero derivative: derivative
        # kernels of expressions with a noise term see a flat zero. The
        # value at coincidence matches _elwise.
        d2 = torch.sum((x - y) ** 2)
        return (d2 <= self.epsilon**2).to(x.dtype).detach()

    @property
    def stationary(self):
        return True

    def _render(self, formatter):
        return "Delta()"

    def __eq__(self, other):
        return isinstance(other, Delta) and _param_eq(self.epsilon, other.epsilon)

    __hash__ = Kernel.__hash__


class FixedDelta(Kernel):
    """Kronecker-delta kernel with fixed per-point noises: the Gram is
    ``Diagonal(noises)`` exactly when both arguments are the same object
    with ``len(noises)`` points, and zero otherwise."""

    def __init__(self, noises):
        self.noises = noises if isinstance(noises, torch.Tensor) else config.as_tensor(
            np.asarray(noises))

    def _noises(self, x):
        return self.noises.to(dtype=x.dtype, device=x.device)

    def _pairwise(self, x, y):
        n, m = x.shape[-2], y.shape[-2]
        if x is y and n == self.noises.shape[-1]:
            return Diagonal(self._noises(x).expand(x.shape[:-2] + (n,)))
        return Zero(x.dtype, n, m, device=x.device)

    def _elwise(self, x, y):
        n = x.shape[-2]
        if x is y and n == self.noises.shape[-1]:
            return self._noises(x)[..., None].expand(x.shape[:-1] + (1,))
        return x.new_zeros(x.shape[:-1] + (1,))

    def _scalar(self, x, y):
        # One pair cannot tell "the same collection of points": the value
        # almost everywhere (zero), with a zero derivative.
        return x.new_zeros(())

    @property
    def stationary(self):
        return True

    def _render(self, formatter):
        return f"FixedDelta({formatter(self.noises)})"

    def __eq__(self, other):
        return isinstance(other, FixedDelta) and (
            self.noises is other.noises
            or (self.noises.shape == other.noises.shape
                and bool(torch.equal(self.noises.cpu(), other.noises.cpu())))
        )

    __hash__ = Kernel.__hash__


class DecayingKernel(Kernel):
    """Decaying kernel ``k(x, y) = ||beta||^alpha / ||x + y + beta||^alpha``."""

    def __init__(self, alpha, beta):
        self.alpha = alpha
        self.beta = beta

    def _parts(self, x):
        alpha = _param_tensor(self.alpha, x)
        beta = _param_tensor(self.beta, x).expand(x.shape[-1:])
        bn2 = torch.clamp_min(torch.sum(beta * beta), 1e-30)
        return alpha, beta, bn2 ** (alpha / 2)

    def _pairwise(self, x, y):
        alpha, beta, raised = self._parts(x)
        return Dense(raised / pw_sums2(x + beta, y) ** (alpha / 2))

    def _elwise(self, x, y):
        alpha, beta, raised = self._parts(x)
        return raised / ew_sums2(x + beta, y) ** (alpha / 2)

    def _scalar(self, x, y):
        alpha, beta, raised = self._parts(x)
        s = x + y + beta
        return raised / torch.sum(s * s) ** (alpha / 2)

    def _render(self, formatter):
        return f"DecayingKernel({formatter(self.alpha)}, {formatter(self.beta)})"

    def __eq__(self, other):
        return (
            isinstance(other, DecayingKernel)
            and _param_eq(self.alpha, other.alpha)
            and _param_eq(self.beta, other.beta)
        )

    __hash__ = Kernel.__hash__


class LogKernel(Kernel):
    """Logarithmic kernel ``k(x, y) = log(1 + ||x - y||) / ||x - y||`` (1 in
    the limit ``x -> y``)."""

    @staticmethod
    def _g(d2):
        d = torch.clamp_min(_safe_sqrt(d2), 1e-10)
        return torch.log1p(d) / d

    def _pairwise(self, x, y):
        return Dense(self._g(pw_dists2(x, y)))

    def _elwise(self, x, y):
        return self._g(ew_dists2(x, y))

    def _scalar(self, x, y):
        diff = x - y
        return self._g(torch.sum(diff * diff))

    @property
    def stationary(self):
        return True

    def _render(self, formatter):
        return "LogKernel()"

    def __eq__(self, other):
        return isinstance(other, LogKernel)

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

    def _scalar(self, x, y):
        return _fn_scalar(self.f, x) * _fn_scalar(self._g, y)

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

    def _scalar(self, x, y):
        return self.k._scalar(y, x)

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

    def _scalar(self, x, y):
        return self.k1._scalar(x, y) + self.k2._scalar(x, y)

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

    def _scalar(self, x, y):
        return self.k1._scalar(x, y) * self.k2._scalar(x, y)

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

    def _scalar(self, x, y):
        return self.k._scalar(x, y) * self.scale

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

    def _scalar(self, x, y):
        return self.k._scalar(self._warp_vec(x, 1), self._warp_vec(y, 2))

    def _warp_vec(self, v, which):
        return self._warp(v[None, :], which)[0]

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

    def _scalar(self, x, y):
        fx = x if self.f1 is None else self.f1(x[None, :])[0]
        fy = y if self.f2 is None else self.f2(y[None, :])[0]
        return self.k._scalar(torch.atleast_1d(fx), torch.atleast_1d(fy))

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


@contextlib.contextmanager
def prime_scalar(obj):
    """A block within which ``obj._scalar``, and that of every kernel and
    mean it holds, reads inputs made before a ``torch.func`` transform
    runs it: an object with such inputs (the posterior objects) defines
    ``_scalar_inputs``, whose value is left on it until the block ends. A
    tensor made inside a transform is a wrapper of it, and one made for
    this evaluation must not stand in for a later one under another grad
    mode or jitter."""
    primed = []
    _prime(obj, primed)
    try:
        yield
    finally:
        for o in primed:
            del o.__dict__["_scalar_primed"]


def _prime(obj, primed):
    inputs = getattr(obj, "_scalar_inputs", None)
    if inputs is not None and "_scalar_primed" not in obj.__dict__:
        obj.__dict__["_scalar_primed"] = inputs()
        primed.append(obj)
    for v in vars(obj).values():
        if hasattr(v, "_scalar"):
            _prime(v, primed)


class DerivativeKernel(Kernel):
    """Derivative of a kernel.

    ``DerivativeKernel(k, d1, d2)`` differentiates argument 1 with respect
    to input dimension ``d1`` and argument 2 with respect to ``d2``;
    ``None`` leaves an argument undifferentiated (the cross-kernel
    variant). A scaled or stretched EQ takes a closed form, factors times
    the base Gram (from K1 for CUDA inputs); any other kernel is
    differentiated through its ``_scalar`` by ``torch.func.grad`` under
    ``torch.func.vmap``."""

    def __init__(self, k, d1, d2):
        self.k = k
        self.d1 = d1
        self.d2 = d2

    def _deriv_scalar_fn(self):
        from torch.func import grad

        f = self.k._scalar
        if self.d1 is not None:
            d1, f1 = self.d1, f
            f = lambda xv, yv: grad(f1, argnums=0)(xv, yv)[d1]  # noqa: E731
        if self.d2 is not None:
            d2, f2 = self.d2, f
            f = lambda xv, yv: grad(f2, argnums=1)(xv, yv)[d2]  # noqa: E731
        return f

    def _scalar(self, x, y):
        return self._deriv_scalar_fn()(x, y)

    def _eq_parts(self, like):
        """``(a1, a2)``, the per-dimension inverse stretches of each argument
        (``None`` for 1), when the wrapped kernel is ``scale * exp(-0.5
        ||a1 x - a2 y||^2)``, a scaled and stretched EQ; ``None`` when no
        closed form applies. The scale needs no tracking: the factors
        multiply the whole base Gram."""
        k = self.k
        a1 = a2 = None
        while True:
            if isinstance(k, ScaledKernel):
                k = k.k
            elif isinstance(k, StretchedKernel):
                s1 = _param(k.s1, like)
                s2 = s1 if k.s2 is k.s1 else _param(k.s2, like)
                if _ndim(s1) > 1 or _ndim(s2) > 1:
                    return None
                a1 = 1.0 / s1 if a1 is None else a1 / s1
                a2 = 1.0 / s2 if a2 is None else a2 / s2
                k = k.k
            elif isinstance(k, EQ):
                return a1, a2
            else:
                return None

    @staticmethod
    def _coef(a, d):
        if a is None:
            return 1.0
        return a if _ndim(a) == 0 else a[d]

    def _closed_form_factors(self, x, y, pair):
        """The derivative factors of a scaled or stretched EQ base, O(n m):
        with ``u = a1 x``, ``v = a2 y`` and ``Delta = u - v``,

            dk/dx_d1        = -a1_d1 Delta_d1 k
            dk/dy_d2        = +a2_d2 Delta_d2 k
            d2k/dx_d1 dy_d2 = a1_d1 a2_d2 (delta_{d1 d2} - Delta_d1 Delta_d2) k.

        ``pair`` picks the pairwise (outer) or elementwise layout."""
        parts = self._eq_parts(x)
        if parts is None:
            return None
        a1, a2 = parts
        coef = self._coef

        def delta(d):
            xd = coef(a1, d) * x[..., :, d]
            yd = coef(a2, d) * y[..., :, d]
            return xd[..., :, None] - yd[..., None, :] if pair else xd - yd

        d1, d2 = self.d1, self.d2
        if d1 is not None and d2 is not None:
            dd = 1.0 if d1 == d2 else 0.0
            return coef(a1, d1) * coef(a2, d2) * (dd - delta(d1) * delta(d2))
        if d1 is not None:
            return -coef(a1, d1) * delta(d1)
        if d2 is not None:
            return coef(a2, d2) * delta(d2)
        return 1.0

    @staticmethod
    def _batched(fm, x, y):
        """``fm`` mapped over the broadcast leading batch dimensions."""
        from torch.func import vmap

        b = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
        xb = x.expand(b + x.shape[-2:]).reshape((-1,) + x.shape[-2:])
        yb = y.expand(b + y.shape[-2:]).reshape((-1,) + y.shape[-2:])
        out = vmap(fm)(xb, yb)
        return out.reshape(b + out.shape[1:])

    def _pairwise(self, x, y):
        from torch.func import vmap

        factors = self._closed_form_factors(x, y, pair=True)
        if factors is not None:
            return Dense(factors * mat_dense(self.k._pairwise(x, y)))
        fm = vmap(vmap(self._deriv_scalar_fn(), in_dims=(None, 0)), in_dims=(0, None))
        with prime_scalar(self.k):
            if x.ndim > 2 or y.ndim > 2:
                return Dense(self._batched(fm, x, y))
            return Dense(fm(x, y))

    def _elwise(self, x, y):
        from torch.func import vmap

        if y is not x:
            y = y.expand(x.shape)
        factors = self._closed_form_factors(x, y, pair=False)
        if factors is not None:
            if _ndim(factors) >= 1:
                factors = factors[..., :, None]
            return factors * self.k._elwise(x, y)
        fv = vmap(self._deriv_scalar_fn())
        with prime_scalar(self.k):
            if x.ndim > 2:
                return self._batched(fv, x, y)[..., None]
            return fv(x, y)[:, None]

    @property
    def stationary(self):
        return self.k.stationary and self.d1 is not None and self.d2 is not None

    def _render(self, formatter):
        return f"d({self.d1}, {self.d2}) {self.k.display(formatter)}"

    def __eq__(self, other):
        return (
            isinstance(other, DerivativeKernel)
            and self.k == other.k
            and self.d1 == other.d1
            and self.d2 == other.d2
        )

    __hash__ = Kernel.__hash__
