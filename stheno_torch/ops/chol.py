"""Divide-and-conquer Cholesky with a carried triangular inverse.

Counterpart of ``stheno_tpu/ops/chol.py``. :func:`cholesky_with_inv`
returns ``(L, inv(L))`` with all O(n^3) work above the base case as
matrix products, so every downstream triangular solve (the reduction
adjoints of ``matrix/ops.py`` included) is a product too:

    chol([[A11, .], [A21, A22]]):
        L11 = chol(A11)                      (recurse)
        L21 = A21 @ L11^{-T}                 (product with the carried inverse)
        L22 = chol(A22 - L21 @ L21^T)        (product + recurse)

Base case: the tile kernel K2 (``ops/chol_tile.py``) for 2-D float32
inputs of n <= 1024; ``torch.linalg.cholesky`` + ``solve_triangular``
otherwise (wider dtypes, batches). A failed factorisation gives NaN, as
in the JAX package, instead of raising.
"""

import torch

from . import chol_tile as _tile
from .trimul import mul_at, mul_att, mul_ta, syrk_nt

__all__ = ["fast_cholesky", "cholesky_with_inv", "tri_inv_lower", "cholesky_nan"]

# Base-case size, as in the JAX package.
_BASE = 1024


def _split(n):
    """Split point: half, rounded up to a multiple of _BASE for aligned
    product shapes (plain half when rounding would swallow the matrix)."""
    half = (n + 1) // 2
    m = ((half + _BASE - 1) // _BASE) * _BASE
    return half if m >= n else m


def _eye_like(L):
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    return eye.expand(L.shape) if L.ndim > 2 else eye


def cholesky_nan(A):
    """``torch.linalg.cholesky`` that returns NaN for a matrix it cannot
    factor (the JAX semantics) instead of raising, without a host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[..., None, None], torch.nan, L)


def tri_inv_lower(L):
    """Inverse of a lower-triangular matrix by blocked recursion."""
    n = L.shape[-1]
    if n <= _BASE:
        return torch.linalg.solve_triangular(L, _eye_like(L), upper=False)
    m = _split(n)
    L11, L21, L22 = L[..., :m, :m], L[..., m:, :m], L[..., m:, m:]
    I11 = tri_inv_lower(L11)
    I22 = tri_inv_lower(L22)
    I21 = -mul_ta(I22, mul_at(L21, I11))
    top = torch.cat([I11, L.new_zeros(L.shape[:-2] + (m, n - m))], dim=-1)
    return torch.cat([top, torch.cat([I21, I22], dim=-1)], dim=-2)


def cholesky_with_inv(A):
    """``(L, inv(L))`` of SPD ``A``; see the module docstring."""
    n = A.shape[-1]
    if A.ndim == 2 and n <= _tile.MAX_TILE and A.dtype == torch.float32:
        return _tile.chol_tile(A)
    if n <= _BASE:
        L = cholesky_nan(A)
        return L, torch.linalg.solve_triangular(L, _eye_like(L), upper=False)
    m = _split(n)
    A11, A21, A22 = A[..., :m, :m], A[..., m:, :m], A[..., m:, m:]
    L11, I11 = cholesky_with_inv(A11)
    L21 = mul_att(A21, I11)
    L22, I22 = cholesky_with_inv(A22 - syrk_nt(L21))
    I21 = -mul_ta(I22, mul_at(L21, I11))
    zeros = A.new_zeros(A.shape[:-2] + (m, n - m))
    L = torch.cat(
        [torch.cat([L11, zeros], dim=-1), torch.cat([L21, L22], dim=-1)], dim=-2
    )
    Linv = torch.cat(
        [torch.cat([I11, zeros], dim=-1), torch.cat([I21, I22], dim=-1)], dim=-2
    )
    return L, Linv


def fast_cholesky(A):
    """Lower Cholesky factor of SPD ``A`` through :func:`cholesky_with_inv`."""
    return cholesky_with_inv(A)[0]
