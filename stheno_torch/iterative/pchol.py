"""Preconditioners for kernel systems: partial pivoted Cholesky with its
Woodbury inverse, and the subspace-iteration eig preconditioner with the
whitened solver built on it.

Counterpart of ``stheno_tpu/iterative/pchol.py``. JAX ``key``s become
``torch.Generator``s. The whitened solver's compensated branch (the
small-noise escape of ``compensated.py``) keeps the JAX package's
segmented CG, warm restarts every ``segment_iters`` iterations: the JAX
package segments to bound each device program, and the restarts change
the iterates, so the port keeps them for its iterates and iteration
counts to be the JAX package's.
"""

import torch

from .. import config
from ..kernels.eval import elwise, pairwise
from ..kernels.util import uprank
from ..matrix import dense
from .cg import batched_cg
from .compensated import f64_scaled_apply, resolve_compensated

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
    ``(n, r)`` products per application).

    ``compensated=True`` applies each through
    ``compensated.f64_scaled_apply``: at small noise the plain
    ``apply_half_inv`` cancels ``sqrt((lam + noise) / noise)`` digits
    between its base and correction terms, which caps the whitened CG's
    true residual whatever the Gram matvec's accuracy. Float64 products of
    the promoted operands compute the JAX package's two-float application
    (``compensated.compensated_scaled_apply``, ported beside it) to about
    1e-16; ``scripts/torch_item9.py`` measured them at 0.79 against 235 ms
    at rank 256 and N=262,144 on the H100 (``PERF.md``)."""
    noise = torch.as_tensor(noise, dtype=lam.dtype, device=lam.device)
    dsum = lam + noise
    r = lam.shape[0]
    sqrt_noise = torch.sqrt(noise)
    if compensated:
        def scaled(coeff, base):
            return lambda v: f64_scaled_apply(U, coeff, base, v)
    else:
        def scaled(coeff, base):
            return _scaled_apply(U, coeff, base)
    apply_inv = scaled(-(lam / (noise * dsum)), 1.0 / noise)
    apply_half = scaled(torch.sqrt(dsum) - sqrt_noise, sqrt_noise)
    apply_half_inv = scaled(1.0 / torch.sqrt(dsum) - 1.0 / sqrt_noise, 1.0 / sqrt_noise)
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
    state=None, mv_raw_comp=None, compensated="auto", comp_refine=1,
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
    sweep, through the compensated operator on a compensated solve).

    ``mv_raw_comp`` applies ``K`` through the compensated matvec;
    ``compensated`` (``"auto"``, ``True``, ``False``) is the policy of
    ``compensated.resolve_compensated``, decided from the state's top Ritz
    value. The preconditioner build always runs ``mv_raw``. A compensated
    solve applies the preconditioner through the compensated ops, runs its
    CG in warm-started segments of ``segment_iters`` iterations (a
    ``solve`` keyword, default 6; the JAX package's, kept for its
    iterates) and appends ``comp_refine`` refinement passes: the true
    residual through the compensated operator, a correction solve, the
    correction added. ``solve.compensated`` says which matvec the CG runs
    on. Requires scalar ``noise``."""
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
    use_comp = resolve_compensated(compensated, noise, lam, n, dtype, mv_raw_comp is not None)
    mv_use = mv_raw_comp if use_comp else mv_raw
    _, _, phi, _ = eig_preconditioner_ops(U, lam, noise, n, compensated=use_comp)

    def mv_white(v):
        pv = phi(v)
        return phi(mv_use(pv) + noise * pv)

    def mv_full(v):
        return mv_use(v) + noise * v

    @config.pin_matmul_precision
    def solve(rhs, *, tol=1e-6, max_iters=1000, true_residual=False, segment_iters=6,
              **cg_kwargs):
        segmented = use_comp and segment_iters and not cg_kwargs.get("track_tridiag")

        def cg(b_white, budget):
            if not segmented:
                return batched_cg(mv_white, b_white, tol=tol, max_iters=budget, **cg_kwargs)
            x, done = None, 0
            while True:
                x, info = batched_cg(mv_white, b_white, tol=tol, max_iters=segment_iters,
                                     x0=x, **cg_kwargs)
                it = int(info["iters"])
                done += it
                if float(info["rel_residual"]) <= tol or it == 0 or done >= budget:
                    return x, dict(info, iters=done)

        sol, info = cg(phi(rhs), max_iters)
        sol = phi(sol)
        if use_comp:
            # Iterative refinement: the compensated operator gives the true
            # residual to about eps ||rhs||, so each pass contracts the error
            # by the solve's own accuracy.
            for _ in range(comp_refine):
                dw, info_r = cg(phi(rhs - mv_full(sol)), max_iters)
                sol = sol + phi(dw)
                info = dict(info, iters=info["iters"] + info_r["iters"],
                            rel_residual=info_r["rel_residual"])
        if true_residual:
            r = rhs - mv_full(sol)
            r2 = r[:, None] if r.ndim == 1 else r
            b2 = rhs[:, None] if rhs.ndim == 1 else rhs
            info["rel_residual_true"] = torch.max(
                torch.linalg.vector_norm(r2, dim=0)
                / torch.clamp_min(torch.linalg.vector_norm(b2, dim=0), 1e-30)
            )
        return sol, info

    solve.compensated = use_comp  # Which matvec the CG runs on.
    return solve
