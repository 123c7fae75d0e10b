"""Tile Cholesky with the inverses of its diagonal blocks (kernel K2).

Counterpart of ``stheno_tpu/ops/pallas_chol.py``. :func:`chol_tile`
returns ``(L, inv(L))`` of an SPD float32 tile (n <= 1024), padded to a
multiple of 128 with an identity block that factors block-diagonally and
is sliced away.

- On CUDA tensors it runs the hand-written kernels of
  ``csrc/chol_tile.cu``, which replace the TPU kernel
  ``stheno_tpu/ops/pallas_chol.py:_chol_kernel`` (with ``_factor_block``).
  A 1024^2 float32 tile does not fit in one SM's shared memory, so the
  whole-tile-in-VMEM design does not carry over: a host loop over the
  diagonal 128-blocks launches a one-block factor-and-invert kernel, a
  panel kernel and a trailing-update kernel. It is bound by the 128-step
  dependency chain of the diagonal factor, which runs on one SM; see the
  source's header for what the design does about it.
- On CPU tensors it runs :func:`chol_tile_plain`, the same blocked
  algorithm in plain torch, which the tests and ``chip_smoke.py`` compare
  the kernel with.

The full ``inv(L)`` is assembled from the block inverses outside the
kernel by block forward substitution (``torch.matmul``), as the JAX
package does outside the Pallas call. The gradient is the Cholesky
adjoint (Murray 2016) plus the ``d inv(L) = -Linv dL Linv`` correction, in
plain torch.
"""

import torch

from . import _build

__all__ = ["chol_tile", "chol_tile_plain", "MAX_TILE", "launches"]

_T = 128  # Diagonal block size; also the rank-1 loop length per block.
MAX_TILE = 1024

#: Number of tile factorisations run by the CUDA kernels in this process
#: (one per :func:`chol_tile` call on a CUDA tensor).
launches = 0


def _round_up(v, m):
    return (v + m - 1) // m * m


def _factor_block(Akk):
    """Factor one 128x128 SPD block and build its inverse in the same
    right-looking rank-1 loop (forward substitution for the inverse rows)."""
    T = Akk.shape[0]
    idx = torch.arange(T, device=Akk.device)
    M = Akk.clone()
    L = torch.zeros_like(Akk)
    Inv = torch.zeros_like(Akk)
    for j in range(T):
        dinv = torch.rsqrt(M[j, j])
        col = torch.where(idx >= j, M[:, j], 0.0) * dinv
        L[:, j] = col
        M -= torch.outer(col, col)
        lrow = torch.where(idx < j, L[j, :], 0.0)
        Inv[j, :] = ((idx == j).to(Akk.dtype) - lrow @ Inv) * dinv
    return L, Inv


def _factor_plain(Ap):
    """Blocked right-looking Cholesky of ``Ap`` (n x n, n % 128 == 0):
    ``L`` and the stacked diagonal-block inverses ``(n, 128)``."""
    n = Ap.shape[0]
    L = Ap.clone()
    dinv = torch.empty((n, _T), dtype=Ap.dtype, device=Ap.device)
    for k0 in range(0, n, _T):
        k1 = k0 + _T
        Lkk, Ikk = _factor_block(L[k0:k1, k0:k1])
        L[k0:k1, k0:k1] = Lkk
        dinv[k0:k1] = Ikk
        if k1 < n:
            Lp = L[k1:, k0:k1] @ Ikk.T
            L[k1:, k0:k1] = Lp
            L[k1:, k1:] -= Lp @ Lp.T
    return torch.tril(L), dinv


def _factor_cuda(Ap):
    global launches
    lib = _build.library()
    n = Ap.shape[0]
    L = Ap.clone(memory_format=torch.contiguous_format)
    dinv = torch.empty((n, _T), dtype=Ap.dtype, device=Ap.device)
    with torch.cuda.device(Ap.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_chol_tile(L.data_ptr(), dinv.data_ptr(), n, stream)
    _build.check(code, "chol_tile")
    launches += 1
    return L, dinv


def _assemble_inv(L, dinv, n):
    """Full ``inv(L)`` from the diagonal-block inverses by log-depth block
    forward substitution (products only)."""
    diag_invs = [dinv[k0:k0 + _T] for k0 in range(0, n, _T)]

    def rec(lo, hi):
        if hi - lo == 1:
            return diag_invs[lo]
        mid = (lo + hi + 1) // 2
        I11 = rec(lo, mid)
        I22 = rec(mid, hi)
        L21 = L[mid * _T:hi * _T, lo * _T:mid * _T]
        I21 = -(I22 @ (L21 @ I11))
        top = torch.cat([I11, I11.new_zeros((I11.shape[0], I22.shape[0]))], dim=1)
        return torch.cat([top, torch.cat([I21, I22], dim=1)], dim=0)

    return rec(0, n // _T)


def _pad(A):
    n0 = A.shape[-1]
    n = _round_up(n0, _T)
    if n == n0:
        return A.contiguous()
    Ap = A.new_zeros((n, n))
    Ap[:n0, :n0] = A
    Ap.diagonal()[n0:] = 1.0
    return Ap


def _chol_tile_impl(A, factor):
    n0 = A.shape[-1]
    Ap = _pad(A)
    L, dinv = factor(Ap)
    Linv = _assemble_inv(L, dinv, Ap.shape[0])
    return L[:n0, :n0], Linv[:n0, :n0]


def chol_tile_plain(A):
    """Plain torch version of the tile factorisation: ``(L, inv(L))``."""
    return _chol_tile_impl(A, _factor_plain)


def _phi(X):
    """Lower triangle with the diagonal halved (Cholesky-adjoint projector)."""
    return torch.tril(X) - 0.5 * torch.diag_embed(torch.diagonal(X))


class _CholTile(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        L, Linv = _chol_tile_impl(A, _factor_cuda if A.is_cuda else _factor_plain)
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, Lbar, Linvbar):
        L, Linv = ctx.saved_tensors
        LinvT = Linv.T
        # d inv(L) = -Linv dL Linv  =>  extra L-cotangent -Linv^T Linvbar Linv^T.
        Lbar = Lbar - LinvT @ Linvbar @ LinvT
        # Cholesky adjoint (Murray 2016), symmetrised for symmetric inputs.
        Abar = LinvT @ _phi(L.T @ Lbar) @ Linv
        return 0.5 * (Abar + Abar.T)


def chol_tile(A):
    """``(L, inv(L))`` of SPD float32 ``A`` (2-D, n <= MAX_TILE): the CUDA
    kernels for a CUDA tensor, the plain version for a CPU tensor. The
    caller adds the jitter. Differentiable.

    float32 only, like the TPU kernel: it computes in float32, so wider
    inputs would get float32 accuracy in float64 clothing."""
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[-1] > MAX_TILE:
        raise ValueError(f"chol_tile: unsupported shape {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(
            f"chol_tile computes in float32; got {A.dtype}. Use the "
            f"torch.linalg base case for wider dtypes."
        )
    return _CholTile.apply(A)
