"""Batched (preconditioned) conjugate gradients for kernel systems.

Counterpart of ``stheno_tpu/iterative/cg.py``. The ``lax.while_loop``
becomes a Python loop that reads the residual on the host once per
iteration (one synchronisation, cheap against a Gram sweep).
"""

import torch

__all__ = ["batched_cg"]


def _col_norms(a):
    return torch.linalg.vector_norm(a, dim=0)


def batched_cg(
    matvec,
    b,
    *,
    precond=None,
    tol=1e-6,
    max_iters=1000,
    x0=None,
    min_iters=0,
    track_tridiag=0,
):
    """Solve ``A X = B`` for SPD matrix-free ``A`` with multiple right-hand
    sides at once (they share each Gram sweep).

    Args:
        matvec: callable ``(n, p) -> (n, p)`` applying ``A``.
        b: right-hand sides ``(n, p)`` (or ``(n,)``).
        precond: optional callable applying ``P^{-1}``.
        tol: relative residual tolerance (per column, on the max).
        max_iters: iteration cap.
        x0: optional warm start.
        min_iters: run at least this many iterations even after the
            residual converges (more Lanczos quadrature nodes).
        track_tridiag: record the first ``track_tridiag`` CG coefficients
            ``(alpha_t, beta_t)`` per column (the mBCG identity; see
            ``slq.cg_quadrature_logdet``). A column's coefficients are
            recorded only as a contiguous prefix, while its residual is
            above ``sqrt(eps)``.

    Returns:
        ``(x, info)`` with ``info = {"iters", "rel_residual"}`` plus, when
        ``track_tridiag > 0``, ``info["tridiag"] = (alphas (m, p), betas
        (m, p), steps (p,))``. ``iters`` is a Python int.
    """
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    p_apply = precond if precond is not None else (lambda r: r)
    ncols = b.shape[1]
    m = int(track_tridiag)

    if x0 is None:
        # A zero start needs no operator application: r = b - A 0 = b.
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0[:, None] if squeeze and x0.ndim == 1 else x0
        r = b - matvec(x)
    z = p_apply(r)
    d = z
    rz = torch.sum(r * z, dim=0)
    b_norm = torch.clamp_min(_col_norms(b), 1e-30)

    alphas = torch.zeros((m, ncols), dtype=b.dtype, device=b.device)
    betas = torch.zeros((m, ncols), dtype=b.dtype, device=b.device)
    steps = torch.zeros((ncols,), dtype=torch.int32, device=b.device)
    # Recording floor: coefficients stay valid Lanczos nodes until the
    # residual reaches the rounding regime, whatever the solve tolerance.
    rec_floor = torch.finfo(b.dtype).eps ** 0.5

    it = 0
    while it < max_iters:
        res = _col_norms(r) / b_norm
        if not (float(torch.max(res)) > tol or it < min_iters):
            break
        active = res > rec_floor
        Ad = matvec(d)
        dAd = torch.sum(d * Ad, dim=0)
        alpha = rz / torch.where(dAd == 0, torch.ones_like(dAd), dAd)
        x = x + alpha[None, :] * d
        r = r - alpha[None, :] * Ad
        z = p_apply(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        d = z + beta[None, :] * d
        if it < m:
            # Contiguous prefixes only (steps == it): once a column
            # converges its coefficient ratios are rounding noise, and a
            # residual that wobbles back above the floor must not append
            # non-contiguous nodes.
            record = active & (steps == it)
            alphas[it] = torch.where(record, alpha, alphas[it])
            betas[it] = torch.where(record, beta, betas[it])
            steps = steps + record.to(torch.int32)
        rz = rz_new
        it += 1
    rel = torch.max(_col_norms(r) / b_norm)
    info = {"iters": it, "rel_residual": rel}
    if m > 0:
        info["tridiag"] = (alphas, betas, steps)
    return (x[:, 0] if squeeze else x), info
