"""Structure-aware linear algebra over the structured matrix types.

Counterpart of ``stheno_tpu/matrix/ops.py``: ``dense``, ``diag``,
``transpose``, ``add``, ``scale``, ``multiply``, ``matmul``, ``matmul3``,
``matmul_diag``, ``cholesky``, ``solve``, ``iqf``, ``iqf_diag``,
``logdet``, ``ratio``, ``root``, ``trace``, ``sample`` and the
construction helpers (``fill_diag``, ``eye_like``, ``block_diag``,
``block``, ``submatrix``, ``shape_matrix``, ``dtype_of``). Structure
dispatch is by ``isinstance`` at call time.

The dense-Cholesky-backed reductions (``logdet``, ``iqf``, ``iqf_diag``,
``solve``, ``ratio``) are ``torch.autograd.Function``s whose backward
routes the whole cotangent through the matrix with the closed-form
adjoints of the JAX package's custom VJPs (``d logdet A = A^{-1}``,
rank-structured outer products for the quadratic forms, ``d tr(B^{-1} A)
= (B^{-1}, -B^{-1} A B^{-1})``). Their factors are detached, so no
gradient ever flows back through the factorisation itself. ``sample``
takes a ``torch.Generator`` where the JAX function takes a key.

Differences from the JAX package: a factorisation is "under autodiff"
when grad mode is on and the matrix requires grad; the fast-path backend
test is ``mat.is_cuda``; XLA's optimisation barrier and the forward-mode
fallback have no PyTorch counterpart; the ``A^{-1}`` product of the
logdet adjoint stays in full float32 (TF32 is no three-pass equivalent
of the TPU's ``Precision.HIGH``).

A Woodbury matrix ``D + L M R^T`` never densifies: ``solve`` (and with it
``iqf``, ``iqf_diag`` and ``ratio``) takes the Woodbury identity through
the ``r x r`` capacitance ``M^{-1} + R^T D^{-1} L``, and ``logdet`` the
matrix-determinant lemma, so a low-rank model with noise costs
O(N r^2). Its N-long contractions run in chunks (``_contract``). A
Kronecker matrix factors and solves factor by factor (the vec trick) and
its log-determinant is ``rows(B) logdet(A) + rows(A) logdet(B)``. These
closed forms are plain torch, differentiated by autograd, as they are
plain ``jnp`` in the JAX package.
"""

import torch

from .. import config
from ..ops.chol import cholesky_nan, cholesky_with_inv
from ..ops.trimul import auto_nb, syrk_tn_lower
from .extend import dispatch_extension as _try_ext
from .types import (
    Constant,
    Dense,
    Diagonal,
    Kronecker,
    LowRank,
    LowerTriangular,
    UpperTriangular,
    Woodbury,
    Zero,
    is_structured,
)

__all__ = [
    "adaptive_jitter_eps",
    "as_matrix",
    "dense",
    "diag",
    "diag_of",
    "transpose",
    "add",
    "scale",
    "multiply",
    "matmul",
    "matmul3",
    "matmul_diag",
    "cholesky",
    "solve",
    "iqf",
    "iqf_diag",
    "logdet",
    "ratio",
    "root",
    "trace",
    "sample",
    "fill_diag",
    "eye_like",
    "block_diag",
    "block",
    "submatrix",
    "shape_matrix",
    "dtype_of",
]


# ---------------------------------------------------------------------------
# Promotion and basic structure.
# ---------------------------------------------------------------------------


def _t(a):
    return a.transpose(-1, -2)


def _arr(a):
    """A plain tensor for ``a`` (densifying a structured matrix)."""
    return dense(a) if is_structured(a) else config.as_tensor(a)


def as_matrix(a):
    """Promote a raw tensor to :class:`Dense`; pass structured matrices through."""
    if is_structured(a):
        return a
    a = config.as_tensor(a)
    if a.ndim < 2:
        raise ValueError(f"Cannot promote rank-{a.ndim} array to a matrix.")
    return Dense(a)


def dense(a):
    """Materialise ``a`` as a plain tensor."""
    _ext = _try_ext("dense", a)
    if _ext is not NotImplemented:
        return _ext
    if not is_structured(a):
        return config.as_tensor(a)
    if isinstance(a, (Dense, LowerTriangular, UpperTriangular)):
        return a.mat
    if isinstance(a, Diagonal):
        return torch.diag_embed(a.diag)
    if isinstance(a, Zero):
        return torch.zeros(a.shape, dtype=a.dtype, device=a.device)
    if isinstance(a, Constant):
        return a.const[..., None, None].expand(a.shape)
    if isinstance(a, LowRank):
        left = a.left if a.middle is None else a.left @ a.middle
        return left @ _t(a._right)
    if isinstance(a, Woodbury):
        return dense(a.diag) + dense(a.lr)
    if isinstance(a, Kronecker):
        batch = torch.broadcast_shapes(a.left.batch_shape, a.right.batch_shape)
        prod = torch.einsum("...ij,...kl->...ikjl", dense(a.left), dense(a.right))
        return prod.reshape(tuple(batch) + (a.rows, a.cols))
    raise TypeError(f"Cannot densify {type(a).__name__}.")


def diag_of(a):
    """Diagonal of a matrix as a vector ``(..., n)``."""
    _ext = _try_ext("diag_of", a)
    if _ext is not NotImplemented:
        return _ext
    if not is_structured(a):
        return torch.diagonal(config.as_tensor(a), dim1=-2, dim2=-1)
    if isinstance(a, Diagonal):
        return a.diag
    if isinstance(a, (Dense, LowerTriangular, UpperTriangular)):
        return torch.diagonal(a.mat, dim1=-2, dim2=-1)
    if isinstance(a, Zero):
        return torch.zeros(
            a.shape[:-2] + (min(a.rows, a.cols),), dtype=a.dtype, device=a.device
        )
    if isinstance(a, Constant):
        n = min(a.rows, a.cols)
        return a.const[..., None].expand(tuple(a.const.shape) + (n,))
    if isinstance(a, LowRank):
        left = a.left if a.middle is None else a.left @ a.middle
        n = min(a.rows, a.cols)
        return torch.sum(left[..., :n, :] * a._right[..., :n, :], dim=-1)
    if isinstance(a, Woodbury):
        return diag_of(a.diag) + diag_of(a.lr)
    return torch.diagonal(dense(a), dim1=-2, dim2=-1)


def diag(a):
    """Matrix -> diagonal vector, vector -> :class:`Diagonal` matrix."""
    if is_structured(a):
        return diag_of(a)
    a = config.as_tensor(a)
    if a.ndim >= 2:
        return torch.diagonal(a, dim1=-2, dim2=-1)
    return Diagonal(a)


def transpose(a):
    _ext = _try_ext("transpose", a)
    if _ext is not NotImplemented:
        return _ext
    if not is_structured(a):
        return _t(config.as_tensor(a))
    if isinstance(a, Dense):
        return Dense(_t(a.mat))
    if isinstance(a, Diagonal):
        return a
    if isinstance(a, Zero):
        return Zero(a.dtype, a.cols, a.rows, device=a.device)
    if isinstance(a, Constant):
        return Constant(a.const, a._cols, a._rows)
    if isinstance(a, LowRank):
        if a.sym and a.middle is None:
            return a
        middle = None if a.middle is None else _t(a.middle)
        return LowRank(a._right, a.left, middle)
    if isinstance(a, Woodbury):
        return Woodbury(a.diag, transpose(a.lr))
    if isinstance(a, LowerTriangular):
        return UpperTriangular(_t(a.mat))
    if isinstance(a, UpperTriangular):
        return LowerTriangular(_t(a.mat))
    if isinstance(a, Kronecker):
        return Kronecker(transpose(a.left), transpose(a.right))
    raise TypeError(f"Cannot transpose {type(a).__name__}.")


def shape_matrix(a):
    return as_matrix(a).shape[-2:]


def dtype_of(a):
    return a.dtype if is_structured(a) else config.as_tensor(a).dtype


def _as_lowrank(a):
    """View Constant/LowRank as LowRank."""
    if isinstance(a, LowRank):
        return a
    if isinstance(a, Constant):
        shape_r = tuple(a.const.shape) + (a._rows, 1)
        ones_r = torch.ones(shape_r, dtype=a.dtype, device=a.device)
        middle = a.const[..., None, None]
        if a._rows == a._cols:
            return LowRank(ones_r, None, middle)
        ones_c = torch.ones(
            tuple(a.const.shape) + (a._cols, 1), dtype=a.dtype, device=a.device
        )
        return LowRank(ones_r, ones_c, middle)
    raise TypeError(f"Cannot view {type(a).__name__} as LowRank.")


def _lr_middle(a):
    if a.middle is not None:
        return a.middle
    return torch.eye(a.rank, dtype=a.dtype, device=a.device)


# ---------------------------------------------------------------------------
# Addition / scaling / elementwise multiplication.
# ---------------------------------------------------------------------------


def _ndim(s):
    return s.ndim if isinstance(s, torch.Tensor) else 0


def scale(a, s):
    """Multiply by a scalar (a batched ``s`` broadcasts against the batch
    dimensions), preserving structure."""
    _ext = _try_ext("scale", a, s)
    if _ext is not NotImplemented:
        return _ext
    sm = s[..., None, None] if _ndim(s) else s
    sv = s[..., None] if _ndim(s) else s
    if not is_structured(a):
        return config.as_tensor(a) * sm
    if isinstance(a, Dense):
        return Dense(a.mat * sm)
    if isinstance(a, Diagonal):
        return Diagonal(a.diag * sv)
    if isinstance(a, Zero):
        return a
    if isinstance(a, Constant):
        return Constant(a.const * s, a._rows, a._cols)
    if isinstance(a, LowRank):
        return LowRank(a.left, a.right, _lr_middle(a) * sm)
    if isinstance(a, Woodbury):
        return Woodbury(scale(a.diag, s), scale(a.lr, s))
    if isinstance(a, (LowerTriangular, UpperTriangular)):
        return type(a)(a.mat * sm)
    if isinstance(a, Kronecker):
        return Kronecker(scale(a.left, s), a.right)
    raise TypeError(f"Cannot scale {type(a).__name__}.")


def _is_scalar(x):
    return not is_structured(x) and _ndim(x) == 0


def add(a, b):
    """Structure-preserving addition of matrices of matching shape; a
    scalar adds as a constant matrix."""
    _ext = _try_ext("add", a, b)
    if _ext is not NotImplemented:
        return _ext
    if _is_scalar(a) and _is_scalar(b):
        return a + b
    if _is_scalar(b):
        if isinstance(b, (int, float)) and b == 0:
            return a
        a = as_matrix(a)
        return add(a, Constant(config.as_scalar(b, a.dtype, a.device), a.rows, a.cols))
    if _is_scalar(a):
        return add(b, a)

    a, b = as_matrix(a), as_matrix(b)
    if isinstance(a, Zero):
        return b
    if isinstance(b, Zero):
        return a
    if isinstance(a, Diagonal) and isinstance(b, Diagonal):
        return Diagonal(a.diag + b.diag)
    if isinstance(a, Constant) and isinstance(b, Constant):
        return Constant(a.const + b.const, a._rows, a._cols)
    if isinstance(a, (LowRank, Constant)) and isinstance(b, (LowRank, Constant)):
        la, lb = _as_lowrank(a), _as_lowrank(b)
        left = torch.cat(_pad_batch(la.left, lb.left), dim=-1)
        if la.sym and lb.sym and la.middle is None and lb.middle is None:
            return LowRank(left)
        middle = _block_diag2(_lr_middle(la), _lr_middle(lb))
        right = None
        if not (la.sym and lb.sym):
            right = torch.cat(_pad_batch(la._right, lb._right), dim=-1)
        return LowRank(left, right, middle)
    if isinstance(a, Diagonal) and isinstance(b, (LowRank, Constant)):
        return Woodbury(a, _as_lowrank(b))
    if isinstance(a, (LowRank, Constant)) and isinstance(b, Diagonal):
        return Woodbury(b, _as_lowrank(a))
    if isinstance(a, Woodbury) and isinstance(b, Diagonal):
        return Woodbury(add(a.diag, b), a.lr)
    if isinstance(a, Diagonal) and isinstance(b, Woodbury):
        return Woodbury(add(a, b.diag), b.lr)
    if isinstance(a, Woodbury) and isinstance(b, (LowRank, Constant)):
        return Woodbury(a.diag, add(a.lr, _as_lowrank(b)))
    if isinstance(a, (LowRank, Constant)) and isinstance(b, Woodbury):
        return Woodbury(b.diag, add(_as_lowrank(a), b.lr))
    if isinstance(a, Woodbury) and isinstance(b, Woodbury):
        return Woodbury(add(a.diag, b.diag), add(a.lr, b.lr))
    return Dense(dense(a) + dense(b))


def _block_diag2(ma, mb):
    """``[[ma, 0], [0, mb]]`` over broadcast batch dimensions."""
    batch = torch.broadcast_shapes(ma.shape[:-2], mb.shape[:-2])
    ra, rb = ma.shape[-1], mb.shape[-1]
    zeros = ma.new_zeros(batch + (ra, rb))
    top = torch.cat([ma.expand(batch + ma.shape[-2:]), zeros], dim=-1)
    bottom = torch.cat([_t(zeros), mb.expand(batch + mb.shape[-2:])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _pad_batch(x, y):
    """Broadcast the batch dimensions of two factors for concatenation."""
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    return x.expand(batch + x.shape[-2:]), y.expand(batch + y.shape[-2:])


def multiply(a, b):
    """Elementwise (Hadamard) product."""
    _ext = _try_ext("multiply", a, b)
    if _ext is not NotImplemented:
        return _ext
    if _is_scalar(a):
        return scale(b, a)
    if _is_scalar(b):
        return scale(a, b)
    if not is_structured(a) and not is_structured(b):
        return config.as_tensor(a) * config.as_tensor(b)
    a, b = as_matrix(a), as_matrix(b)
    if isinstance(a, Zero) or isinstance(b, Zero):
        return Zero(a.dtype, a.rows, a.cols, device=a.device)
    if isinstance(a, Diagonal) and isinstance(b, Diagonal):
        return Diagonal(a.diag * b.diag)
    if isinstance(a, Diagonal):
        return Diagonal(a.diag * diag_of(b))
    if isinstance(b, Diagonal):
        return Diagonal(diag_of(a) * b.diag)
    if isinstance(a, Constant):
        return scale(b, a.const)
    if isinstance(b, Constant):
        return scale(a, b.const)
    return Dense(dense(a) * dense(b))


# ---------------------------------------------------------------------------
# Matrix multiplication.
# ---------------------------------------------------------------------------


def matmul(a, b, tr_a=False, tr_b=False):
    """``a @ b`` with optional transposes, preserving structure where cheap."""
    _ext = _try_ext("matmul", a, b, tr_a=tr_a, tr_b=tr_b)
    if _ext is not NotImplemented:
        return _ext
    if tr_a:
        a = transpose(a)
    if tr_b:
        b = transpose(b)
    a_s, b_s = is_structured(a), is_structured(b)
    if not a_s and not b_s:
        return config.as_tensor(a) @ config.as_tensor(b)
    if a_s and not b_s:
        b = config.as_tensor(b)
        if b.ndim == 1:
            return matmul(a, b[:, None])[..., 0]
        if isinstance(a, Zero):
            return torch.zeros(
                torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.rows, b.shape[-1]),
                dtype=a.dtype,
                device=a.device,
            )
        if isinstance(a, Diagonal):
            return a.diag[..., :, None] * b
        if isinstance(a, Constant):
            s = torch.sum(b, dim=-2, keepdim=True)
            return (a.const[..., None, None] * s).expand(
                torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.rows, b.shape[-1])
            )
        if isinstance(a, LowRank):
            tmp = _t(a._right) @ b
            if a.middle is not None:
                tmp = a.middle @ tmp
            return a.left @ tmp
        if isinstance(a, Woodbury):
            return matmul(a.diag, b) + matmul(a.lr, b)
        return dense(a) @ b
    if b_s and not a_s:
        a = config.as_tensor(a)
        if a.ndim == 1:
            return matmul(a[None, :], b)[..., 0, :]
        return _t(matmul(transpose(b), _t(a)))

    if isinstance(a, Zero) or isinstance(b, Zero):
        return Zero(a.dtype, a.rows, b.cols, device=a.device)
    if isinstance(a, Diagonal) and isinstance(b, Diagonal):
        return Diagonal(a.diag * b.diag)
    if isinstance(a, (LowRank, Constant)):
        la = _as_lowrank(a)
        new_right = _arr(matmul(transpose(b), la._right))
        return LowRank(la.left, new_right, la.middle)
    if isinstance(b, (LowRank, Constant)):
        lb = _as_lowrank(b)
        new_left = _arr(matmul(a, lb.left))
        return LowRank(new_left, lb._right, lb.middle)
    if isinstance(a, Diagonal):
        return Dense(a.diag[..., :, None] * dense(b))
    if isinstance(b, Diagonal):
        return Dense(dense(a) * b.diag[..., None, :])
    if isinstance(a, Woodbury):
        return add(matmul(a.diag, b), matmul(a.lr, b))
    if isinstance(b, Woodbury):
        return add(matmul(a, b.diag), matmul(a, b.lr))
    if isinstance(a, Kronecker) and isinstance(b, Kronecker):
        return Kronecker(matmul(a.left, b.left), matmul(a.right, b.right))
    return Dense(dense(a) @ dense(b))


@config.pin_matmul_precision
def matmul3(a, b, c, tr_a=False, tr_c=False):
    """``a @ b @ c`` with optional transposes of ``a`` and ``c``."""
    return matmul(matmul(a, b, tr_a=tr_a), c, tr_b=tr_c)


@config.pin_matmul_precision
def matmul_diag(a, b, tr_a=False):
    """``diag(a @ b)`` (or ``diag(a^T @ b)``) without forming the product:
    one elementwise product and a sum."""
    a, b = _arr(a), _arr(b)
    if tr_a:
        return torch.sum(a * b, dim=-2)
    return torch.sum(a * _t(b), dim=-1)


def trace(a):
    return torch.sum(diag_of(a), dim=-1)


# ---------------------------------------------------------------------------
# Factorisations and solves.
# ---------------------------------------------------------------------------


def _cached(a, key, compute):
    """Memoise ``compute()`` on ``a._cache``."""
    cache = getattr(a, "_cache", None)
    if cache is None:
        return compute()
    if key not in cache:
        cache[key] = compute()
    return cache[key]


def _cached_if_constant(a, key, compute):
    """Memoise ``compute()`` on ``a._cache`` only when no autograd graph
    and no CUDA graph capture can hold it: a result that requires grad, or
    one made while a graph is captured, is recomputed at each call (a
    second backward through a cached graph would find it freed, and a
    captured tensor is overwritten by every replay). The grad mode is part
    of the key: a result made under ``torch.no_grad()`` holds no graph even
    where its inputs require grad, and must not stand in for one made with
    a graph."""
    cache = getattr(a, "_cache", None)
    if cache is None:
        return compute()
    key = (key, torch.is_grad_enabled())
    if key in cache:
        return cache[key]
    value = compute()
    if not config.capturing() and not any(t.requires_grad for t in value):
        cache[key] = value
    return value


def adaptive_jitter_eps(mat, base):
    """Smallest jitter in ``{base * 10^k}`` under which ``chol(mat + eps I)``
    succeeds, probed on a detached copy (one host sync per probe, so it
    raises while a CUDA graph is captured)."""
    if config.capturing():
        raise RuntimeError(
            "The adaptive-jitter probe reads each factorisation's status on the host, which "
            "CUDA graph capture does not allow: turn config.adaptive_jitter off to capture "
            "a step."
        )
    n = mat.shape[-1]
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device)
    sg = mat.detach()
    eps, cap = float(base), float(base) * 1e12
    while eps < cap and bool(torch.any(torch.linalg.cholesky_ex(sg + eps * eye)[1] > 0)):
        eps *= 10.0
    return eps


def _under_autodiff(mat):
    """True when a gradient flows through this factorisation."""
    return torch.is_grad_enabled() and mat.requires_grad


def _auto_policy_use_fast(mat):
    """The "auto" policy's fast-path predicate: a CUDA tensor, n >= 1024,
    and a gradient flowing through this factorisation. On the card the
    library factorisation is used for value-only calls; the differentiated
    ones take the carried-inverse recursion, whose downstream solves and
    adjoints are then products (the JAX package's measured rationale,
    ``stheno_tpu/matrix/ops.py:_chol_dense``; whether it holds on the H100
    is for H100 measurements to decide)."""
    return mat.is_cuda and mat.shape[-1] >= 1024 and _under_autodiff(mat)


def _chol_dense(mat):
    """Jittered dense Cholesky of the symmetric part of ``mat`` (as
    ``jnp.linalg.cholesky`` factors it; a symmetric matrix passes through
    bit for bit): ``(L, Linv_or_None)``."""
    mat = _sym(mat)
    n = mat.shape[-1]
    eps = config.jitter(mat.dtype)
    adaptive = config.adaptive_jitter
    if adaptive:
        eps = adaptive_jitter_eps(mat, eps)
    policy = config.cholesky_impl
    use_fast = _auto_policy_use_fast(mat) if policy == "auto" else policy == "fast"
    if adaptive and use_fast:
        # The recursion amplifies rounding beyond what the probe saw: one
        # safety decade, as in the JAX package.
        eps = eps * 10.0
    mat = mat + eps * torch.eye(n, dtype=mat.dtype, device=mat.device)
    if use_fast:
        return cholesky_with_inv(mat)
    return cholesky_nan(mat), None


def _lower_with_inv(pair):
    L, Linv = pair
    tri = LowerTriangular(L)
    if Linv is not None:
        tri._cache["inv"] = Linv
    return tri


@config.pin_matmul_precision
def cholesky(a):
    """Lower Cholesky factor, with the configured jitter for dense
    factorisations. Cached per matrix object; the jitter settings and the
    grad mode are part of the key, so a bumped jitter never returns a
    factor computed under the old one."""
    _ext = _try_ext("cholesky", a)
    if _ext is not NotImplemented:
        return _ext
    if not is_structured(a):
        return _lower_with_inv(_chol_dense(config.as_tensor(a)))

    def compute():
        if isinstance(a, Diagonal):
            return Diagonal(torch.sqrt(a.diag))
        if isinstance(a, Zero):
            return a
        if isinstance(a, Kronecker):
            return Kronecker(cholesky(a.left), cholesky(a.right))
        return _lower_with_inv(_chol_dense(dense(a)))

    key = ("cholesky", config.epsilon, config.adaptive_jitter, torch.is_grad_enabled())
    return _cached(a, key, compute)


def _solve_triangular(tri, b, lower):
    b_arr = _arr(b)
    inv = getattr(tri, "_cache", {}).get("inv")
    if inv is not None and b_arr.ndim == inv.ndim:
        return inv @ b_arr
    return torch.linalg.solve_triangular(tri.mat, b_arr, upper=not lower)


@config.pin_matmul_precision
def solve(a, b):
    """``a^{-1} b``. A 1-D ``b`` is one column and comes back 1-D."""
    _ext = _try_ext("solve", a, b)
    if _ext is not NotImplemented:
        return _ext
    if not is_structured(b):
        b_arr = config.as_tensor(b)
        if b_arr.ndim == 1:
            return solve(a, b_arr[:, None])[..., 0]
    if isinstance(a, LowerTriangular):
        return _solve_triangular(a, b, lower=True)
    if isinstance(a, UpperTriangular):
        return _solve_triangular(a, b, lower=False)
    if isinstance(a, Diagonal):
        return _arr(b) / a.diag[..., :, None]
    if isinstance(a, Woodbury):
        return _solve_woodbury(a, _arr(b))
    if isinstance(a, Kronecker):
        return _solve_kronecker(a, _arr(b))
    a = as_matrix(a)
    L = cholesky(a)
    if not isinstance(L, LowerTriangular):
        return solve(transpose(L), solve(L, b))
    b_arr = _arr(b)
    if b_arr.ndim != dense(a).ndim:
        y = _solve_triangular(L, b_arr, lower=True)
        return torch.linalg.solve_triangular(_t(L.mat), y, upper=True)
    return _SolveChol.apply(*_chol_arrays(a), b_arr)


def _wb_core(a):
    """``(D^{-1} L, R, core)`` of the Woodbury matrix ``a = D + L M R^T``,
    with the capacitance ``core = M^{-1} + R^T D^{-1} L`` (solved by LU: the
    middle need not be PSD). Cached on ``a`` when it holds no graph
    (:func:`_cached_if_constant`)."""

    def compute():
        lr = a.lr
        dinv_left = lr.left / a.diag.diag[..., :, None]
        right = lr._right
        core = torch.linalg.inv(_lr_middle(lr)) + _contract(_t(right), dinv_left)
        return dinv_left, right, core

    return _cached_if_constant(a, "wb_core", compute)


def _solve_woodbury(a, b):
    """``a^{-1} b`` by the Woodbury identity:
    ``D^{-1} b - D^{-1} L core^{-1} R^T D^{-1} b``."""
    dinv_left, right, core = _wb_core(a)
    dinv_b = b / a.diag.diag[..., :, None]
    rhs = _contract(_t(right), dinv_b)
    return dinv_b - dinv_left @ torch.linalg.solve(core, rhs)


def _solve_kronecker(a, b):
    """``(A kron B)^{-1} b`` by the vec trick: with ``b`` read row-major as
    ``X (rows(A), rows(B))`` per column, the solve is ``A^{-1} X B^{-T}``,
    one solve by each factor."""
    m_a, m_b = a.left.rows, a.right.rows
    batch, cols = b.shape[:-2], b.shape[-1]
    X = b.reshape(batch + (m_a, m_b, cols)).transpose(-3, -2)  # (..., m_b, m_a, cols)
    X = solve(a.right, X.reshape(batch + (m_b, m_a * cols)))
    X = X.reshape(batch + (m_b, m_a, cols)).transpose(-3, -2)  # (..., m_a, m_b, cols)
    X = solve(a.left, X.reshape(batch + (m_a, m_b * cols)))
    return X.reshape(batch + (m_a * m_b, cols))


# --- Closed-form adjoints of the dense Cholesky-backed reductions ----------


def _chol_arrays(a):
    """``(mat, L, Linv_or_None)``, reusing the cached factorisation. ``L``
    and ``Linv`` are detached: the reductions' backward routes the whole
    cotangent through ``mat``."""
    mat = dense(a)
    L = cholesky(a)
    inv = getattr(L, "_cache", {}).get("inv")
    return mat, L.mat.detach(), None if inv is None else inv.detach()


def _sym(M):
    """Symmetric part of a matrix cotangent (the primals factor the
    symmetric part of their input)."""
    return 0.5 * (M + _t(M))


def _kinv_from_chol(L, Linv):
    """``A^{-1}`` from its Cholesky factor: one structure-aware product of
    the carried inverse, after two triangular solves if there is none. Full
    float32 on the card (TF32 is no equivalent of the TPU's 3-pass HIGH)."""
    if Linv is None:
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return syrk_tn_lower(Linv, nb=auto_nb(Linv.shape[-1]))


def _half_solve(L, Linv, b):
    if Linv is not None:
        return Linv @ b
    return torch.linalg.solve_triangular(L, b, upper=False)


def _chol_apply_inv(L, Linv, b):
    """``A^{-1} b`` from the factor: two products or two triangular solves."""
    if Linv is not None:
        return _t(Linv) @ (Linv @ b)
    half = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(_t(L), half, upper=True)


class _LogdetChol(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mat, L, Linv):
        ctx.save_for_backward(L, Linv)
        return 2 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, g):
        L, Linv = ctx.saved_tensors
        return g[..., None, None] * _kinv_from_chol(L, Linv), None, None


class _IqfDiagChol(torch.autograd.Function):
    """``diag(b^T A^{-1} c)``; ``sym`` marks ``c is b`` (the NLML case),
    whose backward reuses one solve and needs no symmetric projection."""

    @staticmethod
    def forward(ctx, mat, L, Linv, b, c, sym):
        lb = _half_solve(L, Linv, b)
        lc = lb if sym else _half_solve(L, Linv, c)
        ctx.sym = sym
        ctx.save_for_backward(L, Linv, b, None if sym else c)
        return torch.sum(lb * lc, dim=-2)

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, g):
        L, Linv, b, c = ctx.saved_tensors
        ab = _chol_apply_inv(L, Linv, b)
        gb = g[..., None, :]
        if ctx.sym:
            bc_bar = ab * gb
            # b is passed twice (as b and c), so each slot gets half of
            # d/db = 2 A^{-1} b g.
            return -(bc_bar @ _t(ab)), None, None, bc_bar, bc_bar, None
        ac = _chol_apply_inv(L, Linv, c)
        mat_bar = -_sym((ab * gb) @ _t(ac))
        return mat_bar, None, None, ac * gb, ab * gb, None


class _IqfChol(torch.autograd.Function):
    """``b^T A^{-1} c``; ``sym`` marks ``c is b``."""

    @staticmethod
    def forward(ctx, mat, L, Linv, b, c, sym):
        lb = _half_solve(L, Linv, b)
        lc = lb if sym else _half_solve(L, Linv, c)
        ctx.sym = sym
        ctx.save_for_backward(L, Linv, b, None if sym else c)
        return _t(lb) @ lc

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, g):
        L, Linv, b, c = ctx.saved_tensors
        ab = _chol_apply_inv(L, Linv, b)
        ac = ab if ctx.sym else _chol_apply_inv(L, Linv, c)
        # value = b^T A^{-1} c; dA = -A^{-1} b g c^T A^{-1} (symmetric A).
        ab_g = ab @ g
        if ctx.sym:
            mat_bar = -(ab @ _sym(g) @ _t(ab))
            # b is passed as both b and c: the two slots' cotangents add up.
            return mat_bar, None, None, ac @ _t(g), ab_g, None
        mat_bar = -_sym(ab_g @ _t(ac))
        return mat_bar, None, None, ac @ _t(g), ab_g, None


class _SolveChol(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mat, L, Linv, b):
        x = _chol_apply_inv(L, Linv, b)
        ctx.save_for_backward(L, Linv, x)
        return x

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, g):
        L, Linv, x = ctx.saved_tensors
        # x = A^{-1} b: bbar = A^{-1} g; Abar = -sym(bbar x^T).
        b_bar = _chol_apply_inv(L, Linv, g)
        return -_sym(b_bar @ _t(x)), None, None, b_bar


def _as_col_operand(b):
    """Uprank a 1-D quadratic-form operand to a single column."""
    if not is_structured(b):
        b = config.as_tensor(b)
        if b.ndim == 1:
            return b[:, None]
    return b


_CLOSED_FORM = (Diagonal, Woodbury, LowerTriangular, UpperTriangular)

#: A contraction longer than ``_CHUNK`` runs in chunks of it (``_contract``).
_CHUNK = 2048


def _contract(a, b):
    """``a @ b``. For 2-D operands whose contraction is longer than
    ``_CHUNK``, the product of each chunk of ``_CHUNK`` terms is formed
    apart and a reduction adds the partials, so float32 rounding grows
    with the chunk and the reduction's depth instead of with the length.
    On an H100 at N=10^6, M=512 the plain product left the ELBO's ``A = I +
    B K_n^{-1} B^T`` indefinite in float32 (least eigenvalue -1.6 against
    1.0); in chunks of 2048 its least eigenvalue is 0.94."""
    n = a.shape[-1]
    if a.ndim != 2 or b.ndim != 2 or n <= _CHUNK:
        return a @ b
    nb = n // _CHUNK
    k = nb * _CHUNK
    parts = torch.bmm(a[:, :k].reshape(a.shape[0], nb, _CHUNK).transpose(0, 1),
                      b[:k].reshape(nb, _CHUNK, b.shape[1]))
    out = parts.sum(0)
    return out if k == n else out + a[:, k:] @ b[k:]


@config.pin_matmul_precision
def iqf(a, b, c=None):
    """Inner quadratic form ``b^T a^{-1} c`` (``c`` defaults to ``b``) as a
    :class:`Dense`. 1-D operands are single columns."""
    b = _as_col_operand(b)
    c = b if c is None else _as_col_operand(c)
    if isinstance(a, _CLOSED_FORM):
        return Dense(_contract(_t(_arr(b)), solve(a, c)))
    a = as_matrix(a)
    L = cholesky(a)
    b_arr = _arr(b)
    sym = c is b
    c_arr = b_arr if sym else _arr(c)
    if not isinstance(L, LowerTriangular):
        lb = solve(L, b_arr)
        lc = lb if sym else solve(L, c_arr)
        return Dense(_t(lb) @ lc)
    return Dense(_IqfChol.apply(*_chol_arrays(a), b_arr, c_arr, sym))


@config.pin_matmul_precision
def iqf_diag(a, b, c=None):
    """``diag(b^T a^{-1} c)`` as a vector ``(..., m)``."""
    b = _as_col_operand(b)
    c = b if c is None else _as_col_operand(c)
    b_arr = _arr(b)
    if isinstance(a, _CLOSED_FORM):
        return torch.sum(b_arr * solve(a, c), dim=-2)
    a = as_matrix(a)
    L = cholesky(a)
    sym = c is b
    c_arr = b_arr if sym else _arr(c)
    if not isinstance(L, LowerTriangular):
        lb = solve(L, b_arr)
        lc = lb if sym else solve(L, c_arr)
        return torch.sum(lb * lc, dim=-2)
    return _IqfDiagChol.apply(*_chol_arrays(a), b_arr, c_arr, sym)


@config.pin_matmul_precision
def logdet(a):
    """Log-determinant."""
    _ext = _try_ext("logdet", a)
    if _ext is not NotImplemented:
        return _ext
    if isinstance(a, Diagonal):
        return torch.sum(torch.log(a.diag), dim=-1)
    if isinstance(a, Woodbury):
        return _logdet_woodbury(a)
    if isinstance(a, (LowerTriangular, UpperTriangular)):
        return torch.sum(torch.log(torch.diagonal(a.mat, dim1=-2, dim2=-1)), dim=-1)
    if isinstance(a, Kronecker):
        n, m = a.left.rows, a.right.rows
        return m * logdet(a.left) + n * logdet(a.right)
    a = as_matrix(a)
    L = cholesky(a)
    if not isinstance(L, LowerTriangular):
        return 2 * torch.sum(torch.log(diag_of(L)), dim=-1)
    return _LogdetChol.apply(*_chol_arrays(a))


def _logdet_woodbury(a):
    """The matrix-determinant lemma: ``logdet(D + L M R^T) = logdet(D) +
    logdet(I + M R^T D^{-1} L)``. The core need not be symmetric, so its
    determinant is taken by LU (``slogdet``); a core whose determinant is
    not positive makes the result NaN, on the device (no host sync)."""
    d = a.diag.diag
    lr = a.lr
    core = _lr_middle(lr) @ _contract(_t(lr._right), lr.left / d[..., :, None])
    core = core + torch.eye(core.shape[-1], dtype=core.dtype, device=core.device)
    sign, ld_core = torch.linalg.slogdet(core)
    ld_core = torch.where(sign > 0, ld_core, torch.full_like(ld_core, torch.nan))
    return torch.sum(torch.log(d), dim=-1) + ld_core


@config.pin_matmul_precision
def ratio(a, b):
    """``trace(b^{-1} a)``. The dense-Cholesky branch of ``b`` carries the
    closed-form adjoint (``_RatioChol``)."""
    if isinstance(a, Diagonal) and isinstance(b, Diagonal):
        return torch.sum(a.diag / b.diag, dim=-1)
    if isinstance(b, (Diagonal, Woodbury)):
        return torch.diagonal(solve(b, dense(a)), dim1=-2, dim2=-1).sum(-1)
    b = as_matrix(b)
    L = cholesky(b)
    a_arr = _arr(a)
    if not isinstance(L, LowerTriangular):
        half = solve(L, a_arr)
        return torch.diagonal(solve(L, _t(half)), dim1=-2, dim2=-1).sum(-1)
    return _RatioChol.apply(*_chol_arrays(b), a_arr)


class _RatioChol(torch.autograd.Function):
    """``tr(B^{-1} A)`` from ``B``'s factor."""

    @staticmethod
    def forward(ctx, mat, L, Linv, a):
        half = _half_solve(L, Linv, a)
        half2 = _half_solve(L, Linv, _t(half))
        ctx.save_for_backward(L, Linv, a)
        return torch.diagonal(half2, dim1=-2, dim2=-1).sum(-1)

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, g):
        L, Linv, a = ctx.saved_tensors
        # dA = B^{-1} (symmetric); dB = -B^{-1} sym(A) B^{-1} (the primal
        # factors B's symmetric part; sym(A) is right for a free-form A).
        Binv = _kinv_from_chol(L, Linv)
        gm = g[..., None, None]
        return -gm * (Binv @ _sym(a) @ Binv), None, None, gm * Binv


@config.pin_matmul_precision
def root(a):
    """Symmetric positive-semidefinite square root."""
    if isinstance(a, Diagonal):
        return Diagonal(torch.sqrt(torch.clamp_min(a.diag, 0)))
    if isinstance(a, Zero):
        return a
    vals, vecs = torch.linalg.eigh(_arr(a))
    vals = torch.sqrt(torch.clamp_min(vals, 0))
    return Dense((vecs * vals[..., None, :]) @ _t(vecs))


# ---------------------------------------------------------------------------
# Sampling.
# ---------------------------------------------------------------------------


def _randn(generator, shape, dtype, device):
    """Standard normals of ``shape`` drawn from ``generator`` (on its own
    device) and placed on ``device``."""
    eps = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    return eps.to(device)


@config.pin_matmul_precision
def sample(generator, var, num=1):
    """Draw ``num`` zero-mean samples with covariance ``var`` as the columns
    of a ``(..., n, num)`` tensor, using the structure of ``var``; the
    normals come from the ``torch.Generator`` ``generator``."""
    var = as_matrix(var)
    n = var.rows
    if isinstance(var, Zero):
        return torch.zeros(var.batch_shape + (n, num), dtype=var.dtype, device=var.device)
    if isinstance(var, Diagonal):
        eps = _randn(generator, var.batch_shape + (n, num), var.dtype, var.device)
        return torch.sqrt(torch.clamp_min(var.diag, 0))[..., :, None] * eps
    if isinstance(var, (Constant, LowRank)):
        lr = _as_lowrank(var)
        eps = _randn(generator, lr.batch_shape + (lr.rank, num), lr.dtype, lr.device)
        if lr.middle is None:
            return lr.left @ eps
        return lr.left @ (dense(root(Dense(lr.middle))) @ eps)
    if isinstance(var, Woodbury):
        return sample(generator, var.diag, num) + sample(generator, var.lr, num)
    L = dense(cholesky(var))
    return L @ _randn(generator, var.batch_shape + (n, num), var.dtype, var.device)


# ---------------------------------------------------------------------------
# Construction helpers.
# ---------------------------------------------------------------------------


def fill_diag(scalar, n):
    """Diagonal matrix with every diagonal entry ``scalar``."""
    scalar = config.as_tensor(scalar)
    return Diagonal(scalar[..., None].expand(tuple(scalar.shape) + (n,)))


def eye_like(a):
    a = as_matrix(a)
    return Diagonal(torch.ones(a.batch_shape + (a.rows,), dtype=a.dtype, device=a.device))


def block_diag(*mats):
    """Block-diagonal assembly; square Diagonal/Zero blocks stay
    structured."""
    mats = [as_matrix(m) for m in mats]
    if len(mats) == 1:
        return mats[0]
    first = mats[0]
    if all(isinstance(m, Zero) for m in mats):
        return Zero(first.dtype, sum(m.rows for m in mats), sum(m.cols for m in mats),
                    device=first.device)
    # The Diagonal form needs every block square (a rectangular Zero makes
    # the whole non-square).
    if all(isinstance(m, (Diagonal, Zero)) and m.rows == m.cols for m in mats):
        diags = [
            m.diag if isinstance(m, Diagonal)
            else torch.zeros(m.batch_shape + (m.rows,), dtype=m.dtype, device=m.device)
            for m in mats
        ]
        batch = torch.broadcast_shapes(*[d.shape[:-1] for d in diags])
        return Diagonal(torch.cat([d.expand(batch + d.shape[-1:]) for d in diags], dim=-1))
    batch = torch.broadcast_shapes(*[m.batch_shape for m in mats])
    dtype = first.dtype
    for m in mats[1:]:
        dtype = torch.promote_types(dtype, m.dtype)
    out = torch.zeros(batch + (sum(m.rows for m in mats), sum(m.cols for m in mats)),
                      dtype=dtype, device=first.device)
    i = j = 0
    for m in mats:
        out[..., i:i + m.rows, j:j + m.cols] = dense(m)
        i += m.rows
        j += m.cols
    return Dense(out)


def block(rows):
    """Assemble a matrix from a 2-D grid of blocks (the multi-output Gram
    assembler). Diagonal structure survives when every off-diagonal block
    is Zero and every diagonal block Diagonal or Zero."""
    grid = [[as_matrix(b) for b in row] for row in rows]
    n_r, n_c = len(grid), len(grid[0])
    if n_r == n_c and all(
        isinstance(grid[i][i], (Diagonal, Zero))
        and all(isinstance(grid[i][j], Zero) for j in range(n_c) if j != i)
        for i in range(n_r)
    ):
        return block_diag(*[grid[i][i] for i in range(n_r)])
    batch = torch.broadcast_shapes(*[b.batch_shape for row in grid for b in row])
    return Dense(torch.cat(
        [torch.cat([dense(b).expand(batch + b.shape[-2:]) for b in row], dim=-1)
         for row in grid],
        dim=-2,
    ))


def submatrix(a, mask):
    """Principal submatrix selected by a boolean mask (a numpy array or a
    CPU tensor): the NaN missing-data path."""
    idx = torch.as_tensor(mask).nonzero().flatten()
    a = as_matrix(a)
    if isinstance(a, Diagonal):
        return Diagonal(a.diag[..., idx.to(a.device)])
    if isinstance(a, Zero):
        return Zero(a.dtype, len(idx), len(idx), device=a.device)
    if isinstance(a, Constant):
        return Constant(a.const, len(idx), len(idx))
    idx = idx.to(a.device)
    if isinstance(a, LowRank):
        right = None if a.sym else a._right[..., idx, :]
        return LowRank(a.left[..., idx, :], right, a.middle)
    if isinstance(a, Woodbury):
        return Woodbury(submatrix(a.diag, mask), submatrix(a.lr, mask))
    return Dense(dense(a)[..., idx, :][..., :, idx])
