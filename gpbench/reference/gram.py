"""Plain float64 products with the EQ Gram ``K_ij = s2 exp(-(x_i - x_j)^2 /
(2 ell^2))`` at D = 1, in row blocks so that a block of ``K`` fits on the
card (the Gram at N = 262,144 would take 550 GB)."""

import torch

__all__ = ["rows_per_block", "eq_block", "matmul", "bilinear_grads"]

#: Bytes of one float64 row block of the Gram.
BLOCK_BYTES = 1 << 32


def rows_per_block(n, block_bytes=None):
    return max(1, (BLOCK_BYTES if block_bytes is None else block_bytes) // (8 * n))


def eq_block(xb, x, s2, ell):
    """``K(xb, x)`` and the squared distances over ``ell^2``."""
    d2 = torch.square(xb[:, None] - x[None, :]).div_(ell * ell)
    return torch.exp(d2 * -0.5).mul_(s2), d2


def matmul(x, V, s2, ell, block_bytes=None):
    """``K(x, x) V``, the Gram made ``block_bytes`` (default
    ``BLOCK_BYTES``) at a time."""
    out = torch.empty_like(V)
    b = rows_per_block(x.shape[0], block_bytes)
    for i in range(0, x.shape[0], b):
        K, _ = eq_block(x[i:i + b], x, s2, ell)
        out[i:i + b] = K @ V
    return out


def bilinear_grads(x, A, V, s2, ell):
    """``sum(A * (dK V))`` for ``dK = dK/dlog s2 = K`` and ``dK = dK/dlog ell
    = K d^2 / ell^2``: the gradient of the bilinear form ``sum(A * (K V))``
    with respect to ``(log s2, log ell)``."""
    g_s2 = torch.zeros((), dtype=V.dtype, device=V.device)
    g_ell = torch.zeros((), dtype=V.dtype, device=V.device)
    b = rows_per_block(x.shape[0])
    for i in range(0, x.shape[0], b):
        K, d2 = eq_block(x[i:i + b], x, s2, ell)
        g_s2 += torch.sum(A[i:i + b] * (K @ V))
        g_ell += torch.sum(A[i:i + b] * (d2.mul_(K) @ V))
    return g_s2, g_ell
