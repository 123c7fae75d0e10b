"""Amortised (LOVE-style) posterior variance for matrix-free GPs.

Counterpart of ``stheno_tpu/iterative/variance.py``. A one-time cache
over an orthonormal rank-``r`` eig basis ``U`` of the training Gram turns
the per-point variance into GEMM work:

    reduction(x*) = k_*^T (K + s2 I)^{-1} k_*
                  ~ 2 k_*^T S c - c^T M c + e^T e / (s2 + tau),

with ``c = U^T k_*``, ``e = k_* - U c``, ``S = (K + s2 I)^{-1} U`` and
``M = U^T S``. The in-span terms are exact; the out-of-span residual is
bounded with ``tau``, the smallest captured Ritz value (never overstating
the reduction). ``basis_tile_dtype`` rounds the Gram tiles of the basis
build's subspace sweeps only (``kernel_matvec(tile_dtype=...)``); the
refinement CG always runs the full-precision operator.
"""

import warnings
from typing import NamedTuple

import torch

from .. import config
from ..kernels.eval import elwise, pairwise
from ..kernels.util import uprank
from ..matrix import dense
from .cg import batched_cg
from .matvec import kernel_matvec
from .pchol import eig_preconditioner_factors, eig_preconditioner_ops

__all__ = [
    "VarianceCache",
    "variance_cache",
    "cached_posterior_var",
    "cached_posterior_mean_var",
]


class VarianceCache(NamedTuple):
    """Precomputed state for :func:`cached_posterior_var`.

    Fields:
        U: orthonormal eig basis ``(n, r)`` of the training Gram.
        S: ``(K + noise I)^{-1} U`` ``(n, r)``.
        M: ``sym(U^T S)`` ``(r, r)``.
        noise: scalar observation noise ``s2``.
        tau: tail-spectrum bound of the out-of-span term (the smallest
            captured Ritz value, or 0 for the maximum-reduction bracket).
    """

    U: torch.Tensor
    S: torch.Tensor
    M: torch.Tensor
    noise: torch.Tensor
    tau: torch.Tensor


@config.pin_matmul_precision
def variance_cache(
    kernel_fn,
    params,
    x,
    noise,
    *,
    rank=512,
    generator=None,
    precond_state=None,
    power_iters=2,
    refine=True,
    cg_tol=1e-3,
    max_cg_iters=50,
    block=4096,
    tail="conservative",
    basis_tile_dtype=None,
):
    """Build the amortised-variance cache (one-time, after training; no
    autograd).

    Args:
        kernel_fn: ``params -> Kernel`` expression builder.
        params: hyperparameters (used detached).
        x: training inputs ``(n, d)`` or ``(n,)``.
        noise: scalar observation noise.
        rank: basis width ``r`` (``rank >= n`` is exact to CG tolerance).
        generator: ``torch.Generator`` of the subspace probes (required
            unless ``precond_state`` is given).
        precond_state: optional ``(U, lam)`` from ``eig_precond_state``,
            used as the basis when at least ``rank`` wide; narrower, it is
            widened with ``rank - r0`` fresh columns from ``generator`` and
            ``power_iters`` sweeps (without a generator this warns and
            builds at the state's width).
        power_iters: subspace-iteration sweeps of a fresh build.
        refine: CG-refine ``S`` from the spectral warm start ``U diag(1 /
            (lam + noise))`` by one whitened CG on the residual system.
        cg_tol, max_cg_iters: the refinement solve's tolerance and cap.
        block: row-block size of the Gram sweeps.
        tail: ``"conservative"`` (``tau = min(lam)``) or ``"zero"``.
        basis_tile_dtype: optional dtype the Gram tiles of the subspace
            sweeps are rounded to (e.g. ``torch.bfloat16``): the basis is
            self-correcting (QR) and the refinement runs full-precision
            tiles. The JAX package measured it as an end-to-end loss on the
            TPU at N=262,144 (the refinement CG ran to its cap). Unused
            when ``precond_state`` supplies the whole basis.

    Returns:
        :class:`VarianceCache`.
    """
    with torch.no_grad():
        x = uprank(x)
        n = x.shape[0]
        noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
        k = kernel_fn(params)
        mv = lambda v: kernel_matvec(k, x, v, block=block)  # noqa: E731
        mv_basis = mv if basis_tile_dtype is None else (
            lambda v: kernel_matvec(k, x, v, block=block, tile_dtype=basis_tile_dtype))
        if precond_state is not None:
            U, lam = precond_state
            r0 = U.shape[-1]
            if r0 < min(rank, n):
                if generator is None:
                    warnings.warn(
                        f"variance_cache: precond_state has rank {r0} < requested rank "
                        f"{rank} and no `generator` was given; building the cache at rank "
                        f"{r0}. Pass `generator` to widen the basis, or rank={r0} to "
                        "silence.",
                        stacklevel=2,
                    )
                else:
                    extra = torch.randn((n, min(rank, n) - r0), generator=generator,
                                        dtype=x.dtype, device=x.device)
                    U, lam = eig_preconditioner_factors(
                        mv_basis, torch.cat([U, extra], dim=1), power_iters
                    )
        else:
            if generator is None:
                raise ValueError(
                    "variance_cache: pass `generator` (subspace probe seed) or a prebuilt "
                    "`precond_state`."
                )
            om = torch.randn((n, min(rank, n)), generator=generator, dtype=x.dtype,
                             device=x.device)
            U, lam = eig_preconditioner_factors(mv_basis, om, power_iters)
        # Spectral warm start: (K + s2 I) U ~ U (lam + s2) for Ritz pairs.
        S0 = U / (lam + noise)[None, :]
        if refine:
            # Solve (K + s2 I) dS = U - (K + s2 I) S0 on the whitened
            # operator, whose condition number is O(1).
            _, _, phi, _ = eig_preconditioner_ops(U, lam, noise, n)

            def mv_white(v):
                pv = phi(v)
                return phi(mv(pv) + noise * pv)

            R0 = U - (mv(S0) + noise * S0)
            dSw, _ = batched_cg(mv_white, phi(R0), tol=cg_tol, max_iters=max_cg_iters)
            S = S0 + phi(dSw)
        else:
            S = S0
        M = U.T @ S
        M = 0.5 * (M + M.T)
        if tail == "conservative":
            tau = torch.min(lam)
        elif tail == "zero":
            tau = torch.zeros((), dtype=lam.dtype, device=lam.device)
        else:
            raise ValueError(f"Unknown tail policy {tail!r}.")
        return VarianceCache(U=U, S=S, M=M, noise=noise, tau=tau)


def _chunk_terms(U, S, M, Kxc):
    """The cache's reduction of one chunk of cross-covariance columns
    ``Kxc (n, c)``: ``(in_span, out_sq)``. The out-of-span energy is
    taken from the explicit residual ``E = Kxc - U U^T Kxc``, which does not
    cancel the way ``||k||^2 - ||U^T k||^2`` does in float32."""
    C_u = U.T @ Kxc
    C_s = S.T @ Kxc
    E = Kxc - U @ C_u
    out_sq = torch.sum(E * E, dim=0)
    in_span = 2.0 * torch.sum(C_s * C_u, dim=0) - torch.sum(C_u * (M @ C_u), dim=0)
    return in_span, out_sq


@config.pin_matmul_precision
def cached_posterior_var(kernel_fn, params, x, cache, x_new, *, chunk=1024, clamp=True):
    """Posterior variance diagonal at ``x_new`` from a
    :class:`VarianceCache`: per chunk of ``c`` test points one ``(n, c)``
    cross-Gram (K1 on the card) and two ``(r, n) @ (n, c)`` products, no
    CG. ``params`` must be those of the cache build."""
    k = kernel_fn(params)
    x_arr, xn = uprank(x), uprank(x_new)
    U, S, M, noise, tau = cache
    reductions = []
    for xc in torch.split(xn, min(chunk, max(xn.shape[0], 1))):
        in_span, out_sq = _chunk_terms(U, S, M, dense(pairwise(k, x_arr, xc)))
        reductions.append(in_span + out_sq / (noise + tau))
    out = dense(elwise(k, xn))[:, 0] - torch.cat(reductions)
    return torch.clamp_min(out, 0.0) if clamp else out


@config.pin_matmul_precision
def cached_posterior_mean_var(kernel_fn, params, x, alpha, cache, x_new, *, chunk=1024,
                              clamp=True):
    """Fused ``(mean, var)`` at ``x_new`` from representer weights
    ``alpha`` and a :class:`VarianceCache`: one ``(n, c)`` cross-Gram per
    chunk serves both the mean product and the variance reduction."""
    k = kernel_fn(params)
    x_arr, xn = uprank(x), uprank(x_new)
    U, S, M, noise, tau = cache
    means, reductions = [], []
    for xc in torch.split(xn, min(chunk, max(xn.shape[0], 1))):
        Kxc = dense(pairwise(k, x_arr, xc))
        means.append(Kxc.T @ alpha)
        in_span, out_sq = _chunk_terms(U, S, M, Kxc)
        reductions.append(in_span + out_sq / (noise + tau))
    var = dense(elwise(k, xn))[:, 0] - torch.cat(reductions)
    return torch.cat(means), (torch.clamp_min(var, 0.0) if clamp else var)
