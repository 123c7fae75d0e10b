"""Tile Cholesky with the inverses of its diagonal blocks (kernel K2).

Counterpart of ``stheno_tpu/ops/pallas_chol.py``. :func:`chol_tile`
returns ``(L, inv(L))`` of an SPD float32 tile (n <= 1024), padded to a
multiple of 128 with an identity block that factors block-diagonally and
is sliced away.

- On CUDA tensors it runs the hand-written kernels of
  ``csrc/chol_tile.cu``, which replace the TPU kernel
  ``stheno_tpu/ops/pallas_chol.py:_chol_kernel`` (with ``_factor_block``).
  A 1024^2 float32 tile does not fit in one SM's shared memory, so a host
  loop over the diagonal 128-blocks launches two kernels per block: one
  that factors the block in 32-wide sub-steps (a warp factors each 32x32
  sub-block in registers, the warps invert it and update below it), joins
  the block's inverse from the 32-block inverses by products and forms
  the panel below it; and a trailing update. Then one kernel copies the
  diagonal blocks in and zeroes the upper triangles, and two launches
  per level of the join tree build the full inverse. See the source's
  header for what bounds it.
- On CPU tensors it runs :func:`chol_tile_plain`, the same blocked
  algorithm in plain torch, with the same sub-block size and the same
  order of products, which the tests and ``chip_smoke.py`` compare the
  kernel with.

The full ``inv(L)`` is joined from the block inverses by block forward
substitution, in :func:`_assemble_inv`'s order: by the CUDA library
itself on the card (one call per tile, no torch operation per join), by
``_assemble_inv`` (``torch.matmul``) in the plain version, as the JAX
package does outside the Pallas call. The gradient is the Cholesky
adjoint (Murray 2016) plus the ``d inv(L) = -Linv dL Linv`` correction, in
plain torch.
"""

import torch

from . import _build

__all__ = ["chol_tile", "chol_tile_plain", "MAX_TILE", "launches"]

_T = 128  # Diagonal block size: the rows of each stacked block inverse.
_S = 32  # Sub-block that one warp factors and inverts (kS in the source).
MAX_TILE = 1024

#: Number of tile factorisations run by the CUDA kernels in this process
#: (one per :func:`chol_tile` call on a CUDA tensor).
launches = 0


def _round_up(v, m):
    return (v + m - 1) // m * m


def _factor_sub(A):
    """Factor and invert one ``_S x _S`` SPD block as one warp does: the
    right-looking rank-1 loop with ``rsqrt`` pivots, then the row sweep of
    the inverse (row ``p`` scaled by the pivot's ``rsqrt``, then taken
    from every later row)."""
    S = A.shape[0]
    a = torch.tril(A)
    L = torch.zeros_like(A)
    r = torch.empty(S, dtype=A.dtype, device=A.device)
    for j in range(S):
        r[j] = torch.rsqrt(a[j, j])
        col = a[j:, j] * r[j]
        L[j:, j] = col
        a[j + 1:, j + 1:] -= torch.outer(col[1:], col[1:])
    X = torch.eye(S, dtype=A.dtype, device=A.device)
    for p in range(S):
        X[p] = X[p] * r[p]
        X[p + 1:] -= torch.outer(L[p + 1:, p], X[p])
    return L, X


def _factor_block(Akk):
    """Factor one 128x128 SPD block in ``_S``-wide sub-steps (factor and
    invert the diagonal sub-block, form the sub-panel against its inverse,
    update below), then join its inverse from the sub-block inverses."""
    T = Akk.shape[0]
    M = torch.tril(Akk)
    sub_inv = torch.empty((T, _S), dtype=Akk.dtype, device=Akk.device)
    for c0 in range(0, T, _S):
        c1 = c0 + _S
        Lss, X = _factor_sub(M[c0:c1, c0:c1])
        M[c0:c1, c0:c1] = Lss
        sub_inv[c0:c1] = X
        if c1 < T:
            P = M[c1:, c0:c1] @ X.T
            M[c1:, c0:c1] = P
            M[c1:, c1:] -= torch.tril(P @ P.T)
    return M, _assemble_inv(M, sub_inv, T, _S)


def _factor_plain(Ap):
    """Blocked right-looking Cholesky of ``Ap`` (n x n, n % 128 == 0, factored
    in place): ``(L, inv(L))``, the inverse joined from the
    diagonal-block inverses by :func:`_assemble_inv`."""
    n = Ap.shape[0]
    L = Ap
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
    L = torch.tril(L)
    return L, _assemble_inv(L, dinv, n)


def _factor_cuda(Ap):
    """``(L, inv(L))`` of ``Ap`` (factored in place) by the kernels of
    ``csrc/chol_tile.cu``, which also join the full inverse (in
    :func:`_assemble_inv`'s order)."""
    global launches
    lib = _build.library()
    n = Ap.shape[0]
    L = Ap
    Linv = torch.empty_like(L)
    dinv, ld = torch.empty((2, n, _T), dtype=Ap.dtype, device=Ap.device)
    scratch = torch.empty_like(L)
    with torch.cuda.device(Ap.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_chol_tile(L.data_ptr(), dinv.data_ptr(), Linv.data_ptr(),
                                    ld.data_ptr(), scratch.data_ptr(), n, stream)
    _build.check(code, "chol_tile")
    launches += 1
    return L, Linv


def _assemble_inv(L, dinv, n, block=_T):
    """Full ``inv(L)`` (n x n) from the stacked inverses of its diagonal
    ``block``-blocks by log-depth block forward substitution (products
    only): ``I21 = -(I22 (L21 I11))``, halves split at the middle block
    rounded up, each written in place into one zeroed matrix (three
    device operations per join)."""
    nb = n // block
    Linv = L.new_zeros((n, n))
    Linv.view(nb, block, nb, block).diagonal(dim1=0, dim2=2).copy_(
        dinv.view(nb, block, block).permute(1, 2, 0))

    def rec(lo, hi):
        if hi - lo == 1:
            return
        mid = (lo + hi + 1) // 2
        rec(lo, mid)
        rec(mid, hi)
        a, m, b = lo * block, mid * block, hi * block
        T = L[m:b, a:m] @ Linv[a:m, a:m]
        Linv[m:b, a:m] = torch.addmm(T, Linv[m:b, m:b], T, beta=0, alpha=-1)

    rec(0, nb)
    return Linv


def _pad(A):
    """A fresh contiguous copy of ``A`` padded with an identity block to a
    multiple of 128: the factorisations work in place on it."""
    n0 = A.shape[-1]
    n = _round_up(n0, _T)
    if n == n0:
        return A.clone(memory_format=torch.contiguous_format)
    Ap = A.new_zeros((n, n))
    Ap[:n0, :n0] = A
    Ap.diagonal()[n0:] = 1.0
    return Ap


def _chol_tile_impl(A, factor):
    n0 = A.shape[-1]
    L, Linv = factor(_pad(A))
    return L[:n0, :n0], Linv[:n0, :n0]


def chol_tile_plain(A):
    """Plain torch version of the tile factorisation: ``(L, inv(L))``."""
    return _chol_tile_impl(A, _factor_plain)


def _phi(X):
    """Lower triangle with the diagonal halved (Cholesky-adjoint projector);
    batched over leading dimensions (a ``vmap`` of tangents)."""
    return torch.tril(X) - 0.5 * torch.diag_embed(torch.diagonal(X, dim1=-2, dim2=-1))


class _CholTile(torch.autograd.Function):
    """``(L, inv(L))`` of the tile, with the Cholesky adjoint as its
    backward (plain torch on the saved outputs, so forward-over-reverse
    differentiates it), a forward rule that uses the carried inverse and
    a vmap rule (one factorisation per matrix of the batch), so that
    ``torch.func.jvp``, ``jacfwd`` and ``hessian`` go through K2."""

    @staticmethod
    def forward(A):
        return _chol_tile_impl(A, _factor_cuda if A.is_cuda else _factor_plain)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*output)
        ctx.save_for_forward(*output)

    @staticmethod
    def backward(ctx, Lbar, Linvbar):
        L, Linv = ctx.saved_tensors
        LinvT = Linv.T
        # d inv(L) = -Linv dL Linv  =>  extra L-cotangent -Linv^T Linvbar Linv^T.
        Lbar = Lbar - LinvT @ Linvbar @ LinvT
        # Cholesky adjoint (Murray 2016), symmetrised for symmetric inputs.
        Abar = LinvT @ _phi(L.T @ Lbar) @ Linv
        return 0.5 * (Abar + Abar.T)

    @staticmethod
    def jvp(ctx, Adot):
        L, Linv = ctx.saved_tensors
        # The factorisation reads A's symmetric part, so its tangent is the
        # symmetric part of Adot (as the backward symmetrises):
        # dL = L Phi(L^{-1} dA L^{-T}), d inv(L) = -L^{-1} dL L^{-1}.
        Adot = 0.5 * (Adot + Adot.mT)
        Ldot = L @ _phi(Linv @ Adot @ Linv.T)
        return Ldot, -(Linv @ Ldot @ Linv)

    @staticmethod
    def vmap(info, in_dims, A):
        (d,) = in_dims
        outs = [_CholTile.apply(a) for a in A.movedim(d, 0)]
        return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])), (0, 0)


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
