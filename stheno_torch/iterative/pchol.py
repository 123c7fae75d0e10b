"""Preconditioners for kernel systems: partial pivoted Cholesky with its
Woodbury inverse, and the subspace-iteration eig preconditioner with the
whitened solver built on it.

Counterpart of ``stheno_tpu/iterative/pchol.py``. JAX ``key``s become
``torch.Generator``s. Only the plain path of the whitened solver is
ported: the segmented, host-driven CG of the JAX package exists for the
compensated two-float matvec, which waits for a later slice
(``compensated=True`` raises ``NotImplementedError``).
"""

import torch

from .. import config
from ..kernels.eval import elwise, pairwise
from ..kernels.util import uprank
from ..matrix import dense
from .cg import batched_cg
from .compensated import resolve_compensated
from .matvec import not_ported

__all__ = [
    "pivoted_cholesky",
    "preconditioner_sqrt_ops",
    "woodbury_preconditioner",
    "eig_preconditioner_factors",
    "eig_preconditioner_ops",
    "make_whitened_solver",
]


def pivoted_cholesky(k, x, rank):
    """Rank-``rank`` pivoted Cholesky of ``k(x, x)``: ``L (n, rank)``.

    Matrix-free: each step evaluates one kernel row (a K1 launch of
    ``(n, 1)`` on the card). Once the largest residual diagonal entry
    falls to ``100 eps`` of the largest initial one, the remaining steps
    write zero columns, which the Woodbury and square-root ops treat as an
    identity block."""
    x = uprank(x)
    n = x.shape[0]
    d = dense(elwise(k, x))[:, 0]  # Residual diagonal.
    L = torch.zeros((n, rank), dtype=x.dtype, device=x.device)
    tol = 100 * torch.finfo(x.dtype).eps * torch.clamp_min(torch.max(d), 1e-30)
    for i in range(rank):
        piv = torch.argmax(d)
        live = d[piv] > tol
        row = dense(pairwise(k, x, x[piv][None, :]))[:, 0]
        row = row - L @ L[piv]
        pivot_val = torch.sqrt(torch.clamp_min(d[piv], 1e-30))
        l_i = torch.where(live, row / pivot_val, torch.zeros_like(row))
        L[:, i] = l_i
        d = torch.clamp_min(d - l_i**2, 0.0)
        d[piv] = torch.where(live, torch.zeros_like(d[piv]), d[piv])
    return L


def _scaled_apply(U, coeff, base):
    """``v -> base v + U diag(coeff) U^T v`` for 1-D or 2-D ``v``."""

    def apply(v):
        v2 = v[:, None] if v.ndim == 1 else v
        out = v2 * base + U @ (coeff[:, None] * (U.T @ v2))
        return out[:, 0] if v.ndim == 1 else out

    return apply


def preconditioner_sqrt_ops(L, noise):
    """For ``P = noise I + L L^T``: ``(apply_P_half_inv, apply_P_half,
    logdet_P)``."""
    noise = torch.as_tensor(noise, dtype=L.dtype, device=L.device)
    n, k = L.shape
    U, S, _ = torch.linalg.svd(L, full_matrices=False)
    lam = noise + S**2
    sqrt_noise = torch.sqrt(noise)
    apply_half_inv = _scaled_apply(U, 1.0 / torch.sqrt(lam) - 1.0 / sqrt_noise, 1.0 / sqrt_noise)
    apply_half = _scaled_apply(U, torch.sqrt(lam) - sqrt_noise, sqrt_noise)
    logdet_p = torch.sum(torch.log(lam)) + (n - k) * torch.log(noise)
    return apply_half_inv, apply_half, logdet_p


def eig_preconditioner_factors(matvec, om, power_iters=1):
    """Approximate top eigenpairs ``(U, lam)`` of the SPD operator behind
    ``matvec`` by randomized subspace iteration (Halko, Martinsson and
    Tropp 2011) from the probe block ``om (n, rank)``: ``power_iters``
    QR-orthonormalised sweeps, then a Rayleigh-Ritz step. Every step is one
    Gram sweep against ``rank`` right-hand sides."""
    Q, _ = torch.linalg.qr(matvec(om))
    for _ in range(power_iters - 1):
        Q, _ = torch.linalg.qr(matvec(Q))
    KQ = matvec(Q)
    T = Q.T @ KQ
    T = 0.5 * (T + T.T)
    lam, V = torch.linalg.eigh(T)
    return Q @ V, torch.clamp_min(lam, 0.0)


def eig_preconditioner_ops(U, lam, noise, n, *, compensated=False):
    """Preconditioner ops for ``P = noise I + U diag(lam) U^T`` with
    orthonormal ``U (n, r)``: ``(apply_P_inv, apply_P_half,
    apply_P_half_inv, logdet_P)``, each exact in the eigenbasis (two
    ``(n, r)`` products per application). ``compensated=True`` is not
    ported."""
    if compensated:
        raise not_ported("eig_preconditioner_ops(compensated=True)")
    noise = torch.as_tensor(noise, dtype=lam.dtype, device=lam.device)
    dsum = lam + noise
    r = lam.shape[0]
    sqrt_noise = torch.sqrt(noise)
    apply_inv = _scaled_apply(U, -(lam / (noise * dsum)), 1.0 / noise)
    apply_half = _scaled_apply(U, torch.sqrt(dsum) - sqrt_noise, sqrt_noise)
    apply_half_inv = _scaled_apply(U, 1.0 / torch.sqrt(dsum) - 1.0 / sqrt_noise, 1.0 / sqrt_noise)
    logdet_p = torch.sum(torch.log(dsum)) + (n - r) * torch.log(noise)
    return apply_inv, apply_half, apply_half_inv, logdet_p


def woodbury_preconditioner(L, noise):
    """``P^{-1}`` for ``P = noise I + L L^T`` by the Woodbury identity."""
    noise = torch.as_tensor(noise, dtype=L.dtype, device=L.device)
    rank = L.shape[1]
    core = torch.eye(rank, dtype=L.dtype, device=L.device) + (L.T @ L) / noise
    core_chol = torch.linalg.cholesky(core)

    def apply(r):
        r2 = r[:, None] if r.ndim == 1 else r
        sol = torch.cholesky_solve(L.T @ r2 / noise, core_chol)
        out = r2 / noise - (L @ sol) / noise
        return out[:, 0] if r.ndim == 1 else out

    return apply


def _device_of(*candidates):
    for c in candidates:
        if isinstance(c, torch.Tensor):
            return c.device
    return config.resolve_device()


def make_whitened_solver(
    mv_raw, n, noise, rank, generator=None, *, power_iters=1, dtype=None,
    state=None, mv_raw_comp=None, compensated="auto",
):
    """Split-preconditioned CG solves of ``(K + noise I) X = B``, the
    solve path shared by the matrix-free posteriors.

    ``mv_raw`` applies ``K`` only (no noise term). The returned
    ``solve(rhs, tol=..., max_iters=...) -> (X, info)`` whitens with the
    eig preconditioner built here once (or taken from ``state``, a prebuilt
    ``(U, lam)``; ``rank``, ``generator`` and ``power_iters`` are then
    ignored). ``generator`` seeds the subspace probes (default: a fixed
    seed; the preconditioner affects only the convergence speed). ``tol``
    is the relative residual of the whitened system; ``true_residual=True``
    adds ``info["rel_residual_true"]`` of the unwhitened one (one more
    sweep).

    ``compensated``: the policy of ``compensated.resolve_compensated``
    (``mv_raw_comp`` says whether a compensated matvec exists on the
    caller's path). Where it resolves to ``True`` this raises
    ``NotImplementedError``: the two-float path is not ported yet, nor are
    its options (``comp_refine``, the solve's ``segment_iters``). Requires
    scalar ``noise``."""
    noise = torch.as_tensor(noise, device=_device_of(noise, state[0] if state else None))
    if noise.ndim != 0:
        raise ValueError(
            "make_whitened_solver requires scalar noise; use an unpreconditioned CG "
            "solve (precond_rank=0) for per-point noise."
        )
    if dtype is None:
        dtype = noise.dtype
    noise = noise.to(dtype)
    if state is not None:
        U, lam = state
    else:
        if generator is None:
            generator = torch.Generator(device=noise.device).manual_seed(0)
        om = torch.randn(
            (n, min(rank, n)), generator=generator, dtype=dtype, device=noise.device
        )
        U, lam = eig_preconditioner_factors(mv_raw, om, power_iters)
    if resolve_compensated(compensated, noise, lam, n, dtype, mv_raw_comp is not None):
        raise not_ported("The compensated (two-float) whitened solve")
    _, _, phi, _ = eig_preconditioner_ops(U, lam, noise, n)

    def mv_white(v):
        pv = phi(v)
        return phi(mv_raw(pv) + noise * pv)

    def solve(rhs, *, tol=1e-6, max_iters=1000, true_residual=False, **cg_kwargs):
        sol, info = batched_cg(mv_white, phi(rhs), tol=tol, max_iters=max_iters, **cg_kwargs)
        sol = phi(sol)
        if true_residual:
            r = rhs - (mv_raw(sol) + noise * sol)
            r2 = r[:, None] if r.ndim == 1 else r
            b2 = rhs[:, None] if rhs.ndim == 1 else rhs
            info["rel_residual_true"] = torch.max(
                torch.linalg.vector_norm(r2, dim=0)
                / torch.clamp_min(torch.linalg.vector_norm(b2, dim=0), 1e-30)
            )
        return sol, info

    solve.compensated = False  # Which matvec the CG runs on.
    return solve
