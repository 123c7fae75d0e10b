"""Structured-matrix types.

Counterpart of ``stheno_tpu/matrix/types.py``: Dense, Diagonal, Zero,
Constant, LowRank, Woodbury, Kronecker and the triangular types. The JAX
package registers these as pytrees so that
``jit`` specialises on structure; in PyTorch they are plain objects
holding tensors, and structure dispatch happens at call time. All types
support leading batch dimensions on their tensors.
"""

import torch

from .. import config

__all__ = [
    "AbstractMatrix",
    "Dense",
    "Diagonal",
    "Zero",
    "Constant",
    "LowRank",
    "Woodbury",
    "Kronecker",
    "LowerTriangular",
    "UpperTriangular",
    "is_structured",
]


class AbstractMatrix:
    """Base class for structured matrices."""

    # Subclasses define: shape (full, incl. batch), dtype, device.

    @property
    def rows(self):
        return self.shape[-2]

    @property
    def cols(self):
        return self.shape[-1]

    @property
    def batch_shape(self):
        return tuple(self.shape[:-2])

    # Operator sugar delegates to ops (imported lazily to avoid cycles).

    def __add__(self, other):
        from .ops import add

        return add(self, other)

    def __radd__(self, other):
        from .ops import add

        return add(other, self)

    def __sub__(self, other):
        from .ops import add, scale

        return add(self, scale(other, -1))

    def __rsub__(self, other):
        from .ops import add, scale

        return add(other, scale(self, -1))

    def __mul__(self, other):
        from .ops import multiply

        return multiply(self, other)

    def __rmul__(self, other):
        from .ops import multiply

        return multiply(other, self)

    def __neg__(self):
        from .ops import scale

        return scale(self, -1)

    def __matmul__(self, other):
        from .ops import matmul

        return matmul(self, other)

    def __rmatmul__(self, other):
        from .ops import matmul

        return matmul(other, self)

    @property
    def T(self):
        from .ops import transpose

        return transpose(self)

    def dense(self):
        from .ops import dense

        return dense(self)

    def __repr__(self):
        return f"<{type(self).__name__} {'x'.join(map(str, self.shape))} {self.dtype}>"


def is_structured(a):
    return isinstance(a, AbstractMatrix)


class Dense(AbstractMatrix):
    """A dense matrix ``(..., m, n)``."""

    def __init__(self, mat):
        self.mat = config.as_tensor(mat)
        if self.mat.ndim < 2:
            raise ValueError(f"Dense requires rank >= 2, got {self.mat.ndim}.")
        self._cache = {}

    @property
    def shape(self):
        return tuple(self.mat.shape)

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device


class Diagonal(AbstractMatrix):
    """A diagonal matrix represented by its diagonal ``(..., n)``."""

    def __init__(self, diag):
        self.diag = config.as_tensor(diag)
        if self.diag.ndim < 1:
            raise ValueError("Diagonal requires rank >= 1 diagonal.")
        self._cache = {}

    @property
    def shape(self):
        n = self.diag.shape[-1]
        return tuple(self.diag.shape[:-1]) + (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device


class Zero(AbstractMatrix):
    """An all-zeros matrix. Shape, dtype and device are plain attributes."""

    def __init__(self, dtype, rows, cols=None, device=None):
        self._dtype = dtype
        self._rows = int(rows)
        self._cols = int(rows if cols is None else cols)
        self._device = config.resolve_device(device)
        self._cache = {}

    @property
    def shape(self):
        return (self._rows, self._cols)

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device


class Constant(AbstractMatrix):
    """A constant matrix: every entry equals ``const`` (a scalar, possibly
    batched ``(...,)``)."""

    def __init__(self, const, rows, cols=None):
        self.const = config.as_tensor(const)
        self._rows = int(rows)
        self._cols = int(rows if cols is None else cols)
        self._cache = {}

    @property
    def shape(self):
        return tuple(self.const.shape) + (self._rows, self._cols)

    @property
    def dtype(self):
        return self.const.dtype

    @property
    def device(self):
        return self.const.device


class LowRank(AbstractMatrix):
    """``left @ middle @ right.T`` with ``left (..., m, r)``,
    ``middle (..., r, r)`` (default: identity), ``right (..., n, r)``
    (default: ``left``, i.e. symmetric)."""

    def __init__(self, left, right=None, middle=None):
        self.left = config.as_tensor(left)
        self.right = None if right is None else config.as_tensor(right)
        self.middle = None if middle is None else config.as_tensor(middle)
        self._cache = {}

    @property
    def rank(self):
        return self.left.shape[-1]

    @property
    def sym(self):
        return self.right is None

    @property
    def _right(self):
        return self.left if self.right is None else self.right

    @property
    def shape(self):
        batch = torch.broadcast_shapes(self.left.shape[:-2], self._right.shape[:-2])
        return tuple(batch) + (self.left.shape[-2], self._right.shape[-2])

    @property
    def dtype(self):
        return self.left.dtype

    @property
    def device(self):
        return self.left.device


class Woodbury(AbstractMatrix):
    """``diag + lr``: a diagonal plus a low-rank matrix."""

    def __init__(self, diag, lr):
        if not isinstance(diag, Diagonal) or not isinstance(lr, LowRank):
            raise TypeError("Woodbury requires (Diagonal, LowRank).")
        if diag.shape[-2:] != lr.shape[-2:]:
            raise ValueError(
                f"Woodbury shape mismatch: Diagonal is {diag.shape[-2:]}, "
                f"LowRank is {lr.shape[-2:]}."
            )
        self.diag = diag
        self.lr = lr
        self._cache = {}

    @property
    def shape(self):
        batch = torch.broadcast_shapes(self.diag.batch_shape, self.lr.batch_shape)
        return tuple(batch) + self.diag.shape[-2:]

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device


class Kronecker(AbstractMatrix):
    """``kron(left, right)`` of two structured matrices. Its vec convention
    is row-major: row ``i * rows(right) + k`` of the product pairs row ``i``
    of ``left`` with row ``k`` of ``right``."""

    def __init__(self, left, right):
        self.left = left
        self.right = right
        self._cache = {}

    @property
    def shape(self):
        batch = torch.broadcast_shapes(self.left.batch_shape, self.right.batch_shape)
        return tuple(batch) + (
            self.left.rows * self.right.rows,
            self.left.cols * self.right.cols,
        )

    @property
    def dtype(self):
        return self.left.dtype

    @property
    def device(self):
        return self.left.device


class _Triangular(AbstractMatrix):
    def __init__(self, mat):
        self.mat = config.as_tensor(mat)
        self._cache = {}

    @property
    def shape(self):
        return tuple(self.mat.shape)

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device


class LowerTriangular(_Triangular):
    """A lower-triangular dense matrix (e.g. a Cholesky factor)."""


class UpperTriangular(_Triangular):
    """An upper-triangular dense matrix."""
