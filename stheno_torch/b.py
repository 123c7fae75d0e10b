"""LAB-compatible ``B`` namespace.

Counterpart of ``stheno_tpu/b.py``. The reference re-exports its
backend-generic op namespace as ``B`` (``import lab as B``), and its
README, examples and tests drive the library through ``B.*`` calls and
the ``B.epsilon`` jitter knob. This module gives the port the same
surface on top of the structured-matrix layer and ``torch``, so
reference-style user code like

    from stheno_torch import B
    B.epsilon = 1e-10
    chol = B.cholesky(B.dense(k(x)))

runs unchanged. Random states are ``torch.Generator`` objects:
``B.create_random_state`` makes one on the default device, and
``B.randn`` and ``B.sample`` return ``(state, draws)``, the state being
the generator the draws advanced. Names not shimmed here fall back to
``torch``, with numpy's ``axis=``/``keepdims=`` keywords and numbers and
numpy arrays as arguments accepted.
"""

import functools
import math
import sys
import types

import numpy as np
import torch

from . import config
from .dist.normal import _cast_matrix
from .dist.rng import next_global_key, set_global_key
from .kernels.util import uprank as _uprank
from .matrix import ops as _ops
from .matrix.types import AbstractMatrix, Diagonal, is_structured

__all__ = ["B"]


def _t(a):
    """``a`` as a tensor: a tensor as it is, anything else on the default
    device (Python floats as float64, as numpy makes them)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=config.resolve_device())


def _arr(a):
    return _ops.dense(a) if is_structured(a) else _t(a)


def _numpy_like(fn):
    """``fn`` taking numpy's keywords (``axis``, ``keepdims``) and floats
    and numpy arrays as positional arguments."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if "axis" in kwargs:
            kwargs["dim"] = kwargs.pop("axis")
        if "keepdims" in kwargs:
            kwargs["keepdim"] = kwargs.pop("keepdims")
        args = [
            _t(a) if isinstance(a, (float, complex, np.ndarray, np.generic)) else a
            for a in args
        ]
        return fn(*args, **kwargs)

    return wrapped


def _reduction(fn):
    def reduce(a, axis=None, keepdims=False):
        a = _t(a)
        return fn(a) if axis is None else fn(a, dim=axis, keepdim=keepdims)

    return staticmethod(reduce)


class _BNamespace(types.ModuleType):
    """Module-typed so ``from stheno_torch import B; B.epsilon = 1e-10``
    works like the reference's mutable module global."""

    # -- config ------------------------------------------------------------
    @property
    def epsilon(self):
        eps = config.epsilon
        return config.jitter(torch.float64) if eps is None else eps

    @epsilon.setter
    def epsilon(self, value):
        config.set_epsilon(value)

    # -- types -------------------------------------------------------------
    Numeric = (int, float, complex, np.ndarray, torch.Tensor)
    Int = (int, np.integer)
    DType = (torch.dtype, type, np.dtype)
    RandomState = torch.Generator

    # -- constants ---------------------------------------------------------
    pi = math.pi
    log_2_pi = math.log(2.0 * math.pi)
    nan = float("nan")

    # -- structure ---------------------------------------------------------
    dense = staticmethod(_ops.dense)
    diag = staticmethod(_ops.diag)
    block = staticmethod(_ops.block)
    block_diag = staticmethod(_ops.block_diag)
    submatrix = staticmethod(_ops.submatrix)
    fill_diag = staticmethod(_ops.fill_diag)

    # -- linalg ------------------------------------------------------------
    cholesky = staticmethod(_ops.cholesky)
    chol = staticmethod(_ops.cholesky)
    solve = staticmethod(_ops.solve)
    iqf = staticmethod(_ops.iqf)
    iqf_diag = staticmethod(_ops.iqf_diag)
    logdet = staticmethod(_ops.logdet)
    ratio = staticmethod(_ops.ratio)
    root = staticmethod(_ops.root)
    matmul_diag = staticmethod(_ops.matmul_diag)

    @staticmethod
    def matmul(a, b, c=None, tr_a=False, tr_b=False, tr_c=False):
        """Two- or three-matrix product with transpose flags (LAB's
        ``B.matmul(a, var, a, tr_c=True)`` pattern included)."""
        if c is not None:
            if tr_b:
                b = _BNamespace.transpose(b)
            return _ops.matmul3(a, b, c, tr_a=tr_a, tr_c=tr_c)
        return _ops.matmul(a, b, tr_a=tr_a, tr_b=tr_b)

    mm = matmul
    matmul3 = staticmethod(_ops.matmul3)

    @staticmethod
    def trace(a):
        if is_structured(a):
            return _ops.trace(a)
        return torch.diagonal(_t(a), dim1=-2, dim2=-1).sum(-1)

    @staticmethod
    def transpose(a):
        return _ops.transpose(a) if is_structured(a) else _t(a).transpose(-1, -2)

    t = transpose

    # -- arithmetic / elementwise -------------------------------------------
    @staticmethod
    def add(a, b):
        if is_structured(a) or is_structured(b):
            return _ops.add(a, b)
        return torch.add(_t(a), _t(b))

    @staticmethod
    def subtract(a, b):
        if is_structured(a) or is_structured(b):
            return _ops.add(a, _ops.scale(b, -1.0))
        return torch.subtract(_t(a), _t(b))

    @staticmethod
    def multiply(a, b):
        if is_structured(a) or is_structured(b):
            return _ops.multiply(a, b)
        return torch.multiply(_t(a), _t(b))

    @staticmethod
    def outer(a, b=None):
        b = a if b is None else b
        a, b = _uprank(_t(a)), _uprank(_t(b))
        return a @ b.transpose(-1, -2)

    # -- distances (LAB's pairwise/elementwise ops) -------------------------
    @staticmethod
    def pw_dists2(x, y=None):
        from .kernels.kernel import pw_dists2

        x = _uprank(_t(x))
        y = x if y is None else _uprank(_t(y))
        return pw_dists2(x, y)

    @staticmethod
    def pw_dists(x, y=None):
        return torch.sqrt(torch.clamp_min(_BNamespace.pw_dists2(x, y), 1e-30))

    @staticmethod
    def ew_dists2(x, y):
        from .kernels.kernel import ew_dists2

        return ew_dists2(_uprank(_t(x)), _uprank(_t(y)))

    @staticmethod
    def ew_dists(x, y):
        return torch.sqrt(torch.clamp_min(_BNamespace.ew_dists2(x, y), 1e-30))

    @staticmethod
    def pw_sums2(x, y=None):
        from .kernels.kernel import pw_sums2

        x = _uprank(_t(x))
        y = x if y is None else _uprank(_t(y))
        return pw_sums2(x, y)

    @staticmethod
    def pw_sums(x, y=None):
        return torch.sqrt(torch.clamp_min(_BNamespace.pw_sums2(x, y), 1e-30))

    @staticmethod
    def ew_sums2(x, y):
        from .kernels.kernel import ew_sums2

        return ew_sums2(_uprank(_t(x)), _uprank(_t(y)))

    @staticmethod
    def ew_sums(x, y):
        return torch.sqrt(torch.clamp_min(_BNamespace.ew_sums2(x, y), 1e-30))

    maximum = staticmethod(lambda a, b: torch.maximum(_t(a), _t(b)))
    sqrt = staticmethod(lambda a: torch.sqrt(_t(a)))
    exp = staticmethod(lambda a: torch.exp(_t(a)))
    log = staticmethod(lambda a: torch.log(_t(a)))
    isnan = staticmethod(lambda a: torch.isnan(_t(a)))
    sum = _reduction(torch.sum)
    all = _reduction(torch.all)
    concat = staticmethod(lambda *xs, axis=0: torch.cat([_t(x) for x in xs], dim=axis))
    stack = staticmethod(lambda *xs, axis=0: torch.stack([_t(x) for x in xs], dim=axis))

    @staticmethod
    def squeeze(a, axis=None):
        a = _t(a)
        return a.squeeze() if axis is None else a.squeeze(axis)

    @staticmethod
    def take(a, indices_or_mask, axis=0):
        a = _t(a)
        idx = torch.as_tensor(indices_or_mask)
        if idx.dtype == torch.bool:
            idx = idx.nonzero().flatten()
        return torch.index_select(a, axis, idx.to(a.device))

    # -- shaping / dtype -----------------------------------------------------
    uprank = staticmethod(_uprank)

    @staticmethod
    def shape(a, *dims):
        s = tuple(a.shape) if hasattr(a, "shape") else tuple(np.shape(a))
        if not dims:
            return s
        if len(dims) == 1:
            return s[dims[0]]
        return tuple(s[d] for d in dims)

    shape_matrix = staticmethod(_ops.shape_matrix)

    @staticmethod
    def rank(a):
        if isinstance(a, AbstractMatrix):
            return len(a.shape)
        return _t(a).ndim

    @staticmethod
    def is_scalar(a):
        if isinstance(a, AbstractMatrix):
            return False
        return _t(a).ndim == 0

    @staticmethod
    def dtype(*args):
        """dtype of one value, or the promoted dtype of several (LAB's
        multi-argument form, e.g. ``B.dtype(dist.mean, dist.var)``)."""

        def one(a):
            if isinstance(a, AbstractMatrix) or hasattr(a, "dtype"):
                dt = a.dtype
                return dt if isinstance(dt, torch.dtype) else _t(np.zeros((), dt)).dtype
            return _t(a).dtype

        out = one(args[0])
        for a in args[1:]:
            out = torch.promote_types(out, one(a))
        return out

    @staticmethod
    def dtype_float(a):
        dt = _BNamespace.dtype(a)
        return dt if dt.is_floating_point else torch.float64

    @staticmethod
    def issubdtype(dtype, kind):
        if isinstance(dtype, torch.dtype):
            dtype = torch.empty((), dtype=dtype).numpy().dtype
        return np.issubdtype(dtype, kind)

    @staticmethod
    def cast(dtype, a):
        if hasattr(a, "cast"):  # Normal and friends
            return a.cast(dtype)
        if is_structured(a):
            return _cast_matrix(a, dtype)
        return _t(a).to(dtype)

    @staticmethod
    def to_numpy(a):
        a = _arr(a)
        return a.detach().cpu().numpy()

    jit_to_numpy = to_numpy

    # -- constructors --------------------------------------------------------
    @staticmethod
    def zeros(dtype, *shape):
        return torch.zeros(shape, dtype=dtype, device=config.resolve_device())

    @staticmethod
    def ones(dtype, *shape):
        return torch.ones(shape, dtype=dtype, device=config.resolve_device())

    @staticmethod
    def zero(dtype_or_ref):
        # LAB accepts a dtype or a reference tensor (B.zero(var_diag)).
        dt = getattr(dtype_or_ref, "dtype", dtype_or_ref)
        dev = getattr(dtype_or_ref, "device", None)
        return torch.zeros((), dtype=dt, device=config.resolve_device(dev))

    @staticmethod
    def one(dtype_or_ref):
        dt = getattr(dtype_or_ref, "dtype", dtype_or_ref)
        dev = getattr(dtype_or_ref, "device", None)
        return torch.ones((), dtype=dt, device=config.resolve_device(dev))

    @staticmethod
    def eye(a):
        """Identity matching the reference tensor's trailing (possibly
        rectangular) shape and batch dims, like LAB's ``B.eye``."""
        if not hasattr(a, "shape"):
            return torch.eye(int(a), dtype=torch.float64, device=config.resolve_device())
        rows, cols = a.shape[-2], a.shape[-1]
        out = torch.eye(rows, cols, dtype=a.dtype, device=getattr(a, "device", None))
        if len(a.shape) > 2:
            out = out.expand(tuple(a.shape[:-2]) + (rows, cols))
        return out

    @staticmethod
    def linspace(dtype, start, stop, num):
        return torch.linspace(start, stop, num, dtype=dtype, device=config.resolve_device())

    # -- RNG -----------------------------------------------------------------
    @staticmethod
    def create_random_state(_dtype=None, seed=0):
        """A ``torch.Generator`` on the default device, seeded."""
        return torch.Generator(device=config.resolve_device()).manual_seed(int(seed))

    @staticmethod
    def global_random_state(_dtype=None):
        return next_global_key()

    @staticmethod
    def set_global_random_state(state):
        set_global_key(state)

    @staticmethod
    def randn(state, dtype, *shape):
        """``(state, x)``: standard normals of ``shape`` drawn from the
        generator ``state`` (which the draw advances)."""
        return state, torch.randn(shape, generator=state, dtype=dtype, device=state.device)

    @staticmethod
    def sample(state, var, num=1):
        """``(state, x)``: ``num`` joint samples from ``N(0, var)`` as the
        columns of ``x``, drawn from the generator ``state``."""
        return state, _ops.sample(state, var, num)

    # -- fallback -------------------------------------------------------------
    def __getattr__(self, name):
        # LAB proxies the numpy namespace: anything not shimmed above falls
        # back to ``torch`` (B.sin, B.abs, B.mean, B.where, ...).
        if not name.startswith("_"):
            fn = getattr(torch, name, None)
            if callable(fn):
                wrapped = _numpy_like(fn)
                setattr(self, name, wrapped)
                return wrapped
        raise AttributeError(f"B namespace has no op {name!r}.")


def _install():
    mod = _BNamespace("stheno_torch.B")
    mod.__doc__ = __doc__
    mod.Diagonal = Diagonal
    sys.modules["stheno_torch.B"] = mod
    return mod


B = _install()
