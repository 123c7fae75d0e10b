"""Structure-aware matrix products for the Cholesky recursion.

Counterpart of ``stheno_tpu/ops/trimul.py``. A dense product by a
triangular matrix, or a symmetric product, pays for known zeros or for
the mirrored half. These helpers recover the factor of two by plain block
recursion: every leaf is an ordinary ``torch.matmul`` (full float32 on the
card: the chokepoints that call them run under
``config.pin_matmul_precision``, which keeps TF32 off), the recursion never
multiplies into a known-zero block and computes symmetric outputs once.

- :func:`mul_att` / :func:`mul_at` / :func:`mul_ta` — ``A T^T``, ``A T``,
  ``T A`` with ``T`` lower-triangular.
- :func:`syrk_nt` — ``A A^T``, lower blocks and mirror.
- :func:`syrk_tn_lower` — ``T^T T`` for lower-triangular ``T``.
"""

import torch

__all__ = ["mul_att", "mul_at", "mul_ta", "syrk_nt", "syrk_tn_lower", "auto_nb"]

# Below this triangular size one dense product is as cheap as the recursion.
_LEAF = 512


def _split_point(m):
    """Half, rounded up to a multiple of 256 for aligned leaf shapes."""
    half = (m + 1) // 2
    aligned = ((half + 255) // 256) * 256
    return half if aligned >= m else aligned


def _t(a):
    return a.transpose(-1, -2)


def mul_att(A, T, leaf=None):
    """``A @ T^T`` with ``T`` lower-triangular ``(..., m, m)``."""
    m = T.shape[-1]
    if m <= (leaf or _LEAF):
        return A @ _t(T)
    s = _split_point(m)
    T1, B, T2 = T[..., :s, :s], T[..., s:, :s], T[..., s:, s:]
    A1, A2 = A[..., :, :s], A[..., :, s:]
    # T^T = [[T1^T, B^T], [0, T2^T]].
    left = mul_att(A1, T1, leaf)
    right = A1 @ _t(B) + mul_att(A2, T2, leaf)
    return torch.cat([left, right], dim=-1)


def mul_at(A, T, leaf=None):
    """``A @ T`` with ``T`` lower-triangular ``(..., m, m)``."""
    m = T.shape[-1]
    if m <= (leaf or _LEAF):
        return A @ T
    s = _split_point(m)
    T1, B, T2 = T[..., :s, :s], T[..., s:, :s], T[..., s:, s:]
    A1, A2 = A[..., :, :s], A[..., :, s:]
    left = mul_at(A1, T1, leaf) + A2 @ B
    right = mul_at(A2, T2, leaf)
    return torch.cat([left, right], dim=-1)


def mul_ta(T, A, leaf=None):
    """``T @ A`` with ``T`` lower-triangular ``(..., m, m)``."""
    m = T.shape[-2]
    if m <= (leaf or _LEAF):
        return T @ A
    s = _split_point(m)
    T1, B, T2 = T[..., :s, :s], T[..., s:, :s], T[..., s:, s:]
    A1, A2 = A[..., :s, :], A[..., s:, :]
    top = mul_ta(T1, A1, leaf)
    bot = B @ A1 + mul_ta(T2, A2, leaf)
    return torch.cat([top, bot], dim=-2)


def syrk_nt(A, leaf=None):
    """``A @ A^T`` (symmetric): lower blocks once, mirrored."""
    p = A.shape[-2]
    if p <= (leaf or _LEAF):
        return A @ _t(A)
    s = _split_point(p)
    A1, A2 = A[..., :s, :], A[..., s:, :]
    C11 = syrk_nt(A1, leaf)
    C22 = syrk_nt(A2, leaf)
    C21 = A2 @ _t(A1)
    top = torch.cat([C11, _t(C21)], dim=-1)
    bot = torch.cat([C21, C22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def auto_nb(n, leaf=1024):
    """Block count for :func:`syrk_tn_lower`: the most blocks that keep
    leaves >= ``leaf`` wide and divide ``n`` exactly."""
    for nb in (16, 8, 4, 2):
        if n % nb == 0 and n // nb >= leaf:
            return nb
    return 1


def syrk_tn_lower(T, nb=8):
    """``T^T @ T`` for LOWER-triangular ``T`` ``(..., n, n)``: for block
    columns ``i >= j`` the contraction runs over rows ``k >= i*b`` only,
    each lower block is one product, and the upper half is the mirror."""
    n = T.shape[-1]
    if nb <= 1 or n % nb != 0 or n // nb < 256:
        return _t(T) @ T
    b = n // nb
    blocks = [[None] * nb for _ in range(nb)]
    for i in range(nb):
        k0 = i * b
        Ti = T[..., k0:, i * b:(i + 1) * b]
        for j in range(i + 1):
            blocks[i][j] = _t(Ti) @ T[..., k0:, j * b:(j + 1) * b]
    rows = [
        torch.cat(
            [blocks[i][j] if j <= i else _t(blocks[j][i]) for j in range(nb)], dim=-1
        )
        for i in range(nb)
    ]
    return torch.cat(rows, dim=-2)
