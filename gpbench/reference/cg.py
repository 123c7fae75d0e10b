"""Plain conjugate gradients for several right-hand sides, with the
Lanczos coefficients the mBCG identity reads (Gardner et al. 2018,
"GPyTorch: Blackbox Matrix-Matrix Gaussian Process Inference with GPU
Acceleration", arXiv:1809.11165), and the eig preconditioner of randomized
subspace iteration (Halko, Martinsson and Tropp 2011)."""

import math

import torch

__all__ = ["cg", "quadrature_logdet", "eig_factors", "eig_precond"]


def cg(matvec, B, tol, max_iters, track=0):
    """Solve ``A X = B`` from ``X = 0`` until every column's residual is at
    most ``tol`` of its right-hand side (or ``max_iters``). Returns ``(X,
    iters, (alphas, betas, steps))``: each column's first ``track`` step
    sizes and ratios, recorded while its residual at the step's start is
    above the square root of the dtype's epsilon."""
    X = torch.zeros_like(B)
    R = B.clone()
    D = R
    rz = torch.sum(R * R, dim=0)
    bnorm = torch.linalg.vector_norm(B, dim=0).clamp_min(1e-300)
    floor = math.sqrt(torch.finfo(B.dtype).eps)
    alphas = torch.zeros((track, B.shape[1]), dtype=B.dtype, device=B.device)
    betas = torch.zeros_like(alphas)
    steps = torch.zeros(B.shape[1], dtype=torch.long, device=B.device)
    it = 0
    while it < max_iters:
        res = torch.linalg.vector_norm(R, dim=0) / bnorm
        if float(res.max()) <= tol:
            break
        AD = matvec(D)
        a = rz / torch.sum(D * AD, dim=0)
        X = X + a * D
        R = R - a * AD
        rz_new = torch.sum(R * R, dim=0)
        b = rz_new / rz
        D = R + b * D
        if it < track:
            keep = (res > floor) & (steps == it)
            alphas[it] = torch.where(keep, a, alphas[it])
            betas[it] = torch.where(keep, b, betas[it])
            steps += keep.long()
        rz = rz_new
        it += 1
    return X, it, (alphas, betas, steps)


def quadrature_logdet(alphas, betas, steps, z_norms):
    """``mean_j ||z_j||^2 e1^T log(T_j) e1``, with ``T_j`` the Lanczos
    tridiagonal that CG's coefficients of column ``j`` define:
    ``T[t, t] = 1/a_t + b_{t-1}/a_{t-1}``, ``T[t, t+1] = sqrt(b_t)/a_t``."""
    quads = []
    for j in range(alphas.shape[1]):
        k = int(steps[j])
        a, b = alphas[:k, j], betas[:k, j]
        diag = 1.0 / a
        diag[1:] += b[:-1] / a[:-1]
        T = torch.diag(diag)
        if k > 1:
            off = torch.sqrt(b[:-1]) / a[:-1]
            T += torch.diag(off, 1) + torch.diag(off, -1)
        lam, V = torch.linalg.eigh(T)
        quads.append(z_norms[j] * torch.sum(V[0] ** 2 * torch.log(lam)))
    return torch.stack(quads).mean()


def eig_factors(matvec, om, power_iters):
    """Approximate top eigenpairs ``(U, lam)`` of the operator from the
    start block ``om``: ``power_iters`` orthonormalised sweeps, then a
    Rayleigh-Ritz step."""
    Q, _ = torch.linalg.qr(matvec(om))
    for _ in range(power_iters - 1):
        Q, _ = torch.linalg.qr(matvec(Q))
    T = Q.T @ matvec(Q)
    lam, V = torch.linalg.eigh(0.5 * (T + T.T))
    return Q @ V, lam.clamp_min(0.0)


def eig_precond(U, lam, noise, n):
    """For ``P = noise I + U diag(lam) U^T``: ``(P^-1/2, log det P)``,
    the first as a function of a block."""
    d = lam + noise

    def scaled(coeff, base):
        return lambda V: base * V + U @ (coeff[:, None] * (U.T @ V))

    half_inv = scaled(d.rsqrt() - 1.0 / math.sqrt(noise), 1.0 / math.sqrt(noise))
    logdet = torch.sum(torch.log(d)) + (n - lam.shape[0]) * math.log(noise)
    return half_inv, logdet
