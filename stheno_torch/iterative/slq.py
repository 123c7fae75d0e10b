"""Stochastic Lanczos quadrature for matrix-free log-determinants.

Counterpart of ``stheno_tpu/iterative/slq.py``: the ``lax.scan`` of the
Lanczos recurrence becomes a Python loop, and each probe's quadrature is
a batched ``torch.linalg.eigh`` of its ``(m, m)`` tridiagonal in the
input dtype.
"""

import torch

__all__ = ["lanczos", "slq_logdet", "cg_quadrature_logdet"]


def lanczos(matvec, z, num_steps):
    """Batched Lanczos tridiagonalisation.

    Args:
        matvec: ``(n, p) -> (n, p)`` SPD operator.
        z: start vectors ``(n, p)``.
        num_steps: Lanczos steps ``m``.

    Returns:
        ``(alphas (m, p), betas (m-1, p))``, the tridiagonal coefficients
        of each probe.
    """
    n, p = z.shape
    q = z / torch.clamp_min(torch.linalg.vector_norm(z, dim=0, keepdim=True), 1e-30)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(p, dtype=z.dtype, device=z.device)
    tiny = torch.finfo(z.dtype).eps ** 0.5
    alphas, betas = [], []
    for _ in range(num_steps):
        w = matvec(q) - beta_prev[None, :] * q_prev
        alpha = torch.sum(q * w, dim=0)
        w = w - alpha[None, :] * q
        # One round of reorthogonalisation against the two live vectors.
        w = w - torch.sum(q * w, dim=0)[None, :] * q
        w = w - torch.sum(q_prev * w, dim=0)[None, :] * q_prev
        beta = torch.linalg.vector_norm(w, dim=0)
        # Breakdown (the Krylov space is exhausted): zero the recurrence
        # instead of dividing noise by ~0; the tridiagonal decouples and
        # the zero block adds nothing to the e1-quadrature.
        live = beta > tiny * torch.clamp_min(torch.abs(alpha), 1.0)
        beta = torch.where(live, beta, torch.zeros_like(beta))
        q_next = torch.where(
            live[None, :], w / torch.clamp_min(beta, 1e-30)[None, :], torch.zeros_like(w)
        )
        q_prev, q, beta_prev = q, q_next, beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def _tridiag(diag, off):
    """``(p, m, m)`` symmetric tridiagonals from ``diag (m, p)`` and
    ``off (m-1, p)``."""
    T = torch.diag_embed(diag.T)
    if diag.shape[0] > 1:
        T = T + torch.diag_embed(off.T, offset=1) + torch.diag_embed(off.T, offset=-1)
    return T


def _e1_quadrature(diag, off, z_norms):
    """``mean_j z_norms[j] * e1^T log(T_j) e1`` for symmetric tridiagonals
    given as ``diag (m, p)`` and ``off (m-1, p)`` stacks."""
    evals, evecs = torch.linalg.eigh(_tridiag(diag, off))
    evals = torch.clamp_min(evals, torch.finfo(diag.dtype).tiny)
    w1 = evecs[:, 0, :] ** 2
    quad = torch.sum(w1 * torch.log(evals), dim=1)
    return torch.mean(z_norms * quad)


def cg_quadrature_logdet(alphas, betas, steps, z_norms):
    """Stochastic logdet estimate from CG's own coefficients (the mBCG
    identity, Gardner et al. 2018): CG on ``A x = b`` implicitly runs
    Lanczos on ``A`` with start ``b/||b||``, with

        T[0, 0] = 1/alpha_0
        T[t, t] = 1/alpha_t + beta_{t-1}/alpha_{t-1}
        T[t-1, t] = T[t, t-1] = sqrt(beta_{t-1})/alpha_{t-1}

    so ``b^T log(A) b ~ ||b||^2 e1^T log(T) e1``.

    Args:
        alphas, betas: ``(m, p)`` coefficient buffers from
            ``batched_cg(..., track_tridiag=m)``.
        steps: ``(p,)`` number of valid rows per column.
        z_norms: ``(p,)`` squared norms ``||u_j||^2`` of the unwhitened
            start vectors.

    Returns:
        Scalar estimate of ``tr log`` of the operator CG iterated on.
    """
    m, p = alphas.shape
    valid = torch.arange(m, device=alphas.device)[:, None] < steps[None, :]
    one = torch.ones_like(alphas)
    safe_a = torch.where(valid, alphas, one)
    prev_b = torch.cat([torch.zeros_like(alphas[:1]), betas[:-1]], dim=0)
    prev_a = torch.cat([torch.ones_like(alphas[:1]), safe_a[:-1]], dim=0)
    diag = 1.0 / safe_a + prev_b / prev_a
    # Padded rows become an identity block decoupled from the quadrature.
    diag = torch.where(valid, diag, one)
    if m > 1:
        off = torch.sqrt(torch.clamp_min(betas[:-1], 0.0)) / safe_a[:-1]
        off = torch.where(valid[1:], off, torch.zeros_like(off))
    else:
        off = alphas[:0]
    return _e1_quadrature(diag, off, z_norms)


def slq_logdet(matvec, z, *, num_steps=24):
    """Estimate ``logdet(A)`` for SPD matrix-free ``A`` by SLQ:
    ``E_z[z^T log(A) z] = tr log A`` for ``z ~ N(0, I)`` probes ``(n, p)``."""
    alphas, betas = lanczos(matvec, z, num_steps)
    evals, evecs = torch.linalg.eigh(_tridiag(alphas, betas))
    evals = torch.clamp_min(evals, 1e-30)
    w1 = evecs[:, 0, :] ** 2  # First components of each eigenvector.
    quad = torch.sum(w1 * torch.log(evals), dim=1)
    z_norms = torch.sum(z * z, dim=0)
    return torch.mean(z_norms * quad)
