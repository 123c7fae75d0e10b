"""Stochastic variational GP inference (uncollapsed ELBO, minibatchable).

Counterpart of ``stheno_tpu/model/svgp.py`` (Hensman, Fusi and Lawrence
2013): q(u) = N(m, S) is kept explicit, so the ELBO is a sum over data
points that a minibatch estimates. At full batch with q(u) set optimally
the ELBO equals the collapsed VFE bound of ``PseudoObs``.

The parameters are a dict of tensors, ``{"z", "q_mu", "q_sqrt"}``, in the
whitened coordinates ``u = L_z eps`` with ``q(eps) = N(q_mu, S S^T)``
(``L_z = chol(K_z)``, ``S = tril(q_sqrt)``), so the KL is the
identity-prior form ``1/2 (||m||^2 + ||S||_F^2 - M - 2 sum log |diag S|)``.
Gradients flow by autograd through ``z`` and the kernel's
hyperparameters. The natural-gradient step on ``(q_mu, q_sqrt)`` is the
closed form for a Gaussian likelihood,

    Lam <- (1 - rho) Lam + rho (I + (N/B) A_b A_b^T / noise)
    nu  <- (1 - rho) nu  + rho (N/B) A_b y_b / noise

with ``A_b = L_z^{-1} K_{z,x_b}``.

The sums over the batch (``A A^T``, ``A y`` and the likelihood's) run
through the chunked contraction of ``matrix/ops.py:_contract``: at a batch
of 10^6 one float32 product over all its terms loses the digits that the
collapsed bound's identity needs.

A sharded batch: where the JAX package data-parallelises the step through
its inputs' shardings (GSPMD inserts one ``psum``), here ``x`` and ``y``
are ``DTensor``s placed ``Shard(0)`` on a 1-D mesh (the port's convention
for row-sharded inputs, ``parallel/__init__.py`` point 2). Each rank then
computes its rows' part of the batch sums (the likelihood's, ``A_b A_b^T``
and ``A_b y_b``) from the kernel and parameters routed through
``copy_to_mesh``, and one ``reduce_from_mesh`` sums them over the ranks;
the O(M^2) terms after it (the KL, the natural-parameter update) are
replicated. A plain tensor batch takes the single-device path.
"""

import math

import torch

from .. import config
from ..kernels import elwise, mean_eval, pairwise
from ..matrix import cholesky, dense, solve
from ..matrix.ops import _contract

__all__ = ["svgp_init", "svgp_elbo", "svgp_predict", "svgp_natgrad_step"]


def _as_col(y):
    y = config.as_tensor(y)
    return y[:, None] if y.ndim == 1 else y


def _as_mean(mean):
    """Promote numbers and callables to a mean expression."""
    from ..kernels import OneMean
    from ..kernels.mean import Mean

    if isinstance(mean, Mean):
        return mean
    return mean * OneMean()


def _sum(v):
    """The sum of the vector ``v``, as a chunked contraction."""
    return _contract(v[None, :], torch.ones_like(v)[:, None])[0, 0]


def _whitened_A(k, params, x):
    """``A = L_z^{-1} k(z, x)`` ``(M, B)``, through the library's
    structured ops (its jitter policy and carried inverse apply)."""
    z = params["z"]
    L = cholesky(pairwise(k, z))
    return dense(solve(L, dense(pairwise(k, z, x))))


def _whitened_stats(k, params, x):
    """``A`` and the prior kernel's diagonal at ``x`` ``(B,)``."""
    A = _whitened_A(k, params, x)
    return A, dense(elwise(k, x))[..., 0]


def _marginals(A, k_diag, m_w, S):
    """Predictive marginals: mean ``A^T m`` ``(B, 1)`` and ``k_ii - a_i^T
    a_i + a_i^T S S^T a_i`` clamped at zero."""
    f_mean = A.transpose(-1, -2) @ m_w
    SA = S.transpose(-1, -2) @ A
    f_var = k_diag - torch.sum(A * A, dim=-2) + torch.sum(SA * SA, dim=-2)
    return f_mean, torch.clamp_min(f_var, 0)


def _centred(y, x, mean):
    y = _as_col(y)
    if mean is not None:
        y = y - mean_eval(_as_mean(mean), x)
    return y


def _batch(k, params, x, y, mean):
    """``(k, params, x, y, mean, b, reduce)``: the batch as this rank sees
    it, ``b`` the whole batch's size and ``reduce(t, what)``, which sums a
    batch term over the ranks. A plain batch comes back as it is, with the
    identity for ``reduce``. A sharded batch (``x`` a ``DTensor``) gives
    this rank's rows of ``x`` and ``y``, the kernel, parameters and mean
    routed through ``copy_to_mesh``, and one ``reduce_from_mesh``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return k, params, x, y, mean, _as_col(y).shape[-2], lambda t, what: t
    from ..parallel._comm import MeshAxis, reduce_from_mesh
    from ..parallel.cholesky import local_rows
    from ..parallel.exact import _route, check_routed

    mesh = x.device_mesh
    if mesh.ndim != 1:
        raise ValueError("a sharded SVGP batch lies on a 1-D mesh.")
    ax = MeshAxis(mesh, mesh.mesh_dim_names[0])

    def reduce(t, what):
        if t.requires_grad:
            check_routed(t, what)
        return reduce_from_mesh(t, ax)

    x_loc, y_loc = local_rows(x, ax), local_rows(config.as_tensor(y), ax)
    return _route(k, ax), _route(params, ax), x_loc, y_loc, _route(mean, ax), x.shape[0], reduce


@config.pin_matmul_precision
def svgp_init(k, z, dtype=None):
    """Initial parameters for inducing inputs ``z`` ``(M, d)`` or ``(M,)``:
    ``q(eps) = N(0, I)``, so the predictive equals the prior."""
    z = config.as_tensor(z)
    if z.ndim == 1:
        z = z[:, None]
    if dtype is not None:
        z = z.to(dtype)
    m = z.shape[0]
    return {
        "z": z,
        "q_mu": torch.zeros((m, 1), dtype=z.dtype, device=z.device),
        "q_sqrt": torch.eye(m, dtype=z.dtype, device=z.device),
    }


@config.pin_matmul_precision
def svgp_elbo(k, params, x, y, noise, num_data, mean=None):
    """Minibatch evidence lower bound (to be maximised).

    ``x``: batch inputs ``(B, d)`` or ``(B,)``; ``y``: ``(B,)`` or ``(B,
    1)``; ``noise``: the Gaussian observation-noise variance; ``num_data``:
    the dataset size N (the likelihood term is scaled by ``N / B``, so a
    minibatch ELBO is an unbiased estimate of the full one); ``mean``: an
    optional mean expression, subtracted from ``y``. ``x`` and ``y`` may be
    ``DTensor``s placed ``Shard(0)`` on a 1-D mesh (the module docstring):
    every rank then returns the same value and, under autograd, the same
    whole gradient."""
    k_b, p_b, x_b, y_b, mean_b, b, reduce = _batch(k, params, x, y, mean)
    y_b = _centred(y_b, x_b, mean_b)
    A, k_diag = _whitened_stats(k_b, p_b, x_b)
    f_mean, f_var = _marginals(A, k_diag, p_b["q_mu"], torch.tril(p_b["q_sqrt"]))
    total = reduce(_sum((y_b - f_mean)[..., 0] ** 2 + f_var), "svgp_elbo")
    m_w, S = params["q_mu"], torch.tril(params["q_sqrt"])
    noise = config.as_scalar(noise, y_b.dtype, y_b.device)
    lik = -0.5 * (b * torch.log(2 * math.pi * noise) + total / noise)
    m_dim = m_w.shape[-2]
    # KL(N(m, S S^T) || N(0, I)).
    kl = 0.5 * (
        torch.sum(m_w**2)
        + torch.sum(S**2)
        - m_dim
        - 2 * torch.sum(torch.log(torch.abs(torch.diagonal(S, dim1=-2, dim2=-1))))
    )
    return (num_data / b) * lik - kl


@config.pin_matmul_precision
def svgp_predict(k, params, x_new, noise=None, mean=None):
    """Predictive marginals ``(mean, var)`` at ``x_new``, each ``(n,)``:
    the latent function's, or with ``noise`` added to the variance."""
    A, k_diag = _whitened_stats(k, params, x_new)
    m_w, S = params["q_mu"], torch.tril(params["q_sqrt"])
    f_mean, f_var = _marginals(A, k_diag, m_w, S)
    f_mean = f_mean[..., 0]
    if mean is not None:
        f_mean = f_mean + mean_eval(_as_mean(mean), x_new)[..., 0]
    if noise is not None:
        f_var = f_var + noise
    return f_mean, f_var


@config.pin_matmul_precision
def svgp_natgrad_step(k, params, x, y, noise, num_data, rho, mean=None):
    """One natural-gradient step on ``(q_mu, q_sqrt)`` for a Gaussian
    likelihood: closed form in the whitened natural parameters, with no
    autodiff through a factorisation. ``rho = 1`` with the whole dataset as
    the batch lands on the optimal q(u), the collapsed VFE optimum. Returns
    new parameters (``z`` untouched). A sharded batch (``DTensor``s, as
    :func:`svgp_elbo` takes) sums ``A_b A_b^T`` and ``A_b y_b`` over the
    ranks in one reduction; the update after it is replicated."""
    k_b, p_b, x_b, y_b, mean_b, b, reduce = _batch(k, params, x, y, mean)
    y_b = _centred(y_b, x_b, mean_b)
    A = _whitened_A(k_b, p_b, x_b)
    m = A.shape[-2]
    both = reduce(torch.cat([_contract(A, A.transpose(-1, -2)), _contract(A, y_b)], dim=-1),
                  "svgp_natgrad_step")
    AAt, Ay = both[..., :m], both[..., m:]
    m_w, S = params["q_mu"], torch.tril(params["q_sqrt"])
    m_dim = m_w.shape[-2]
    noise = config.as_scalar(noise, y_b.dtype, y_b.device)
    scale = num_data / b
    eye = torch.eye(m_dim, dtype=A.dtype, device=A.device)

    # Natural parameters of q: Lam = Sigma^{-1}, nu = Sigma^{-1} m. S is a
    # lower factor of Sigma, so it inverts Sigma with no factorisation.
    Lam = torch.cholesky_solve(eye, S)
    nu = torch.cholesky_solve(m_w, S)

    Lam_hat = eye + scale * AAt / noise
    nu_hat = scale * Ay / noise

    Lam_new = (1 - rho) * Lam + rho * Lam_hat
    nu_new = (1 - rho) * nu + rho * nu_hat

    L_lam = torch.linalg.cholesky(Lam_new)
    Sigma_new = torch.cholesky_solve(eye, L_lam)
    Sigma_new = 0.5 * (Sigma_new + Sigma_new.transpose(-1, -2))
    S_new = torch.linalg.cholesky(Sigma_new + config.jitter(A.dtype) * 1e-2 * eye)
    m_new = torch.cholesky_solve(nu_new, L_lam)
    return {**params, "q_mu": m_new, "q_sqrt": S_new}
