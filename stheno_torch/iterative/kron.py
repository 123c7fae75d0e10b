"""Exact GP inference on tensor-product grids by Kronecker structure.

Counterpart of ``stheno_tpu/iterative/kron.py``. On a grid ``axes_1 x ...
x axes_d`` (axes need not be uniform) with a kernel separable across
dimensions, ``k(x, y) = prod_i k_i(x_i, y_i)``, the Gram is ``K_1 (x) ...
(x) K_d``. Eigendecomposing each factor (Saatci 2011) diagonalises ``K +
s2 I`` at O(sum n_i^3) plus O(N sum n_i) for the mode products, so the
NLML, its gradient and the posterior are exact, with no Monte Carlo
noise.

The factor Grams and the posterior's cross matrices come from
``pairwise`` (K1 on the card), and the factors' cotangents go back
through it (K1's backward). The eigendecompositions are
``torch.linalg.eigh`` (cuSOLVER on the card), as the JAX package's are
XLA's.

Gradients: the JAX ``custom_vjp`` core becomes the
``torch.autograd.Function`` :class:`_KronNLML`, whose backward is the
analytic partial-trace VJP in the eigenbasis (prefix and suffix tensors of
the clamped factors). It does not differentiate ``eigh``: kernel Grams are
numerically rank-deficient, and the eigh JVP's ``1 / (lam_i - lam_j)``
factors blow up on their clustered near-zero eigenvalues.
"""

import math

import torch

from .. import config
from ..kernels.eval import elwise, pairwise
from ..kernels.util import uprank
from ..matrix import dense
from .toeplitz import _as_axes

__all__ = ["kron_gram_factors", "kron_matvec", "kron_nlml", "kron_posterior"]

_LOG_2_PI = math.log(2 * math.pi)


def _mode_apply(M, T, axis):
    """``M (m, n_axis)`` applied along ``axis`` of ``T``: one ``(m, n_axis)
    x (n_axis, N / n_axis)`` product."""
    T = torch.movedim(T, axis, 0)
    shp = T.shape
    out = M @ T.reshape(shp[0], -1)
    return torch.movedim(out.reshape((M.shape[0],) + tuple(shp[1:])), 0, axis)


def _mat(T, axis):
    """The mode-``axis`` matricisation ``(n_axis, N / n_axis)``."""
    return torch.movedim(T, axis, 0).reshape(T.shape[axis], -1)


def _lam_outer(lams, replace=None):
    """The tensor of ``prod_j lams[j][k_j]``, with factor ``replace`` set
    to 1; shape ``(n_1, ..., n_d)``."""
    cur = torch.ones((), dtype=lams[0].dtype, device=lams[0].device)
    for j, lam in enumerate(lams):
        v = torch.ones_like(lam) if j == replace else lam
        cur = cur[..., None] * v
    return cur


def kron_gram_factors(kernels, axes):
    """The per-axis dense Grams ``K_i = k_i(axes_i, axes_i)``."""
    axes = _as_axes(axes)
    if len(kernels) != len(axes):
        raise ValueError(f"Got {len(kernels)} kernels for {len(axes)} grid axes.")
    return tuple(dense(pairwise(k, a[:, None])) for k, a in zip(kernels, axes))


@config.pin_matmul_precision
def kron_matvec(kernels, axes, v, *, noise=None):
    """``(K_1 (x) ... (x) K_d [+ noise I]) @ v`` in O(N sum n_i).

    Args:
        kernels: one 1-D kernel per grid axis.
        axes: 1-D array or tuple of 1-D arrays (need not be uniform).
        v: ``(n,)`` or ``(n, p)``, rows in ``grid_coords`` order.
        noise: optional scalar or ``(n,)`` diagonal noise.
    """
    Ks = kron_gram_factors(kernels, axes)
    shape = tuple(K.shape[0] for K in Ks)
    n = math.prod(shape)
    v_in = config.as_tensor(v)
    v2 = v_in[:, None] if v_in.ndim == 1 else v_in
    if v2.shape[0] != n:
        raise ValueError(f"v has {v2.shape[0]} rows; the grid has {n} points.")
    # The columns lead; each factor applies along its grid axis.
    T = v2.T.reshape((v2.shape[1],) + shape)
    for i, K in enumerate(Ks):
        T = _mode_apply(K, T, i + 1)
    out = T.reshape(v2.shape[1], n).T
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=v2.dtype, device=v2.device)
        out = out + (noise[:, None] if noise.ndim == 1 else noise) * v2
    return out[:, 0] if v_in.ndim == 1 else out


def _eig_solve(Ks, noise, y_t):
    """Eigendecompose the factors and solve ``(K + noise I) alpha = y``:
    ``(Qs, lams, D, y_til, alpha_t)`` with ``y_til = Qkron^T y`` and
    ``alpha_t`` the alpha tensor. The factors' eigenvalues are clamped at 0
    (a Gram is PSD: negative eigenvalues are rounding) and ``D`` is floored
    at ``config.jitter``, so zero noise with rank-deficient factors keeps a
    finite logdet."""
    Qs, lams = [], []
    for K in Ks:
        lam, Q = torch.linalg.eigh(K)
        lams.append(torch.clamp_min(lam, 0))
        Qs.append(Q)
    D = _lam_outer(lams) + noise
    D = torch.clamp_min(D, config.jitter(D.dtype))
    y_til = y_t
    for i, Q in enumerate(Qs):
        y_til = _mode_apply(Q.T, y_til, i)
    alpha_t = y_til / D
    for i, Q in enumerate(Qs):
        alpha_t = _mode_apply(Q, alpha_t, i)
    return Qs, lams, D, y_til, alpha_t


class _KronNLML(torch.autograd.Function):
    """The exact zero-mean NLML of ``N(0, kron(Ks) + noise I)`` at the
    tensor ``y_t``, with the analytic VJP to the factor Grams, the noise
    and ``y``. Inputs: ``noise, y_t, *Ks``."""

    @staticmethod
    def forward(ctx, noise, y_t, *Ks):
        n = y_t.numel()
        Qs, lams, D, y_til, alpha_t = _eig_solve(Ks, noise, y_t)
        nlml = 0.5 * (torch.sum(torch.log(D)) + torch.sum(y_til * y_til / D) + n * _LOG_2_PI)
        ctx.save_for_backward(D, alpha_t, *Qs, *lams)
        ctx.d = len(Ks)
        return nlml

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, g):
        # d NLML = 0.5 <(K + s2 I)^{-1} - alpha alpha^T, dK>; for dK =
        # sum_i K_1 (x) .. dK_i .. (x) K_d it reduces to per-factor partial
        # traces: the logdet part Q_i diag(w_i) Q_i^T, w_i[m] = sum over
        # k with k_i = m of prod_{j != i} lam_j[k_j] / D[k]; the quadratic
        # part mat_i(alpha) (kron_{j != i} Kc_j) mat_i(alpha)^T, with Kc_j =
        # Q_j diag(max(lam_j, 0)) Q_j^T the clamped reconstruction (the
        # operator the forward solved with). The co-factor product splits
        # into prefix and suffix tensors, 2 (d - 1) mode products in all.
        D, alpha_t, *rest = ctx.saved_tensors
        d = ctx.d
        Qs, lams = rest[:d], rest[d:]
        need = ctx.needs_input_grad
        Kcs = [(Q * lam) @ Q.T for Q, lam in zip(Qs, lams)]
        prefs = [alpha_t]
        for j in range(d - 1):
            prefs.append(_mode_apply(Kcs[j], prefs[-1], j))
        sufxs = [alpha_t]
        for j in range(d - 1, 0, -1):
            sufxs.append(_mode_apply(Kcs[j], sufxs[-1], j))
        sufxs.reverse()  # sufxs[i] = (kron_{j > i} Kc_j) alpha.
        K_bars = []
        for i in range(d):
            if not need[2 + i]:
                K_bars.append(None)
                continue
            P = _lam_outer(lams, replace=i) / D
            w = _mat(P, i).sum(dim=1)
            G_inv = (Qs[i] * w) @ Qs[i].T
            B = _mat(prefs[i], i) @ _mat(sufxs[i], i).T
            K_bars.append(0.5 * g * (G_inv - B))
        noise_bar = (0.5 * g * (torch.sum(1.0 / D) - torch.sum(alpha_t * alpha_t))
                     if need[0] else None)
        y_bar = g * alpha_t if need[1] else None
        return (noise_bar, y_bar, *K_bars)


@config.pin_matmul_precision
def kron_nlml(kernel_fns, params, axes, y, noise):
    """The exact NLML of a separable-kernel GP on a tensor grid, ``-log
    N(y | 0, kron_i k_i(axes_i, axes_i) + noise I)``: value and gradients
    (with respect to the tensors in ``params``, ``noise``, ``y`` and the
    axes) at O(sum n_i^3 + N sum n_i).

    Args:
        kernel_fns: ``params -> sequence of per-axis kernels``.
        params: parameter dict.
        axes: 1-D array or tuple of 1-D arrays; need not be uniform.
        y: observations ``(n,)`` in ``grid_coords`` order.
        noise: scalar observation-noise variance.
    """
    axes = _as_axes(axes)
    kernels = tuple(kernel_fns(params))
    y = config.as_tensor(y)
    noise = torch.as_tensor(noise, dtype=y.dtype, device=y.device)
    if noise.ndim != 0:
        raise ValueError(
            "kron_nlml requires scalar observation noise; per-point noise breaks the "
            "Kronecker eigenstructure."
        )
    Ks = kron_gram_factors(kernels, axes)
    shape = tuple(K.shape[0] for K in Ks)
    return _KronNLML.apply(noise, y.reshape(shape), *Ks)


def _contract(T, mats):
    """``sum_k prod_i mats_i[p, k_i] T[k]`` for every query point ``p``."""
    R = torch.einsum("pa,a...->p...", mats[0], T)
    for M in mats[1:]:
        R = torch.einsum("pb,pb...->p...", M, R)
    return R


@config.pin_matmul_precision
def kron_posterior(kernel_fns, params, axes, y, noise, x_new):
    """The exact posterior mean and latent variance at any ``x_new`` from
    tensor-grid observations: per query point the cross-covariance to the
    grid is the rank-1 tensor ``kron_i k_i(x_p_i, axes_i)``, so the mean and
    the reduction ``k_*^T (K + noise I)^{-1} k_*`` are d mode contractions
    each, with no ``N x m`` cross Gram. Returns ``(mean, var)``, each
    ``(m,)``."""
    axes = _as_axes(axes)
    kernels = tuple(kernel_fns(params))
    y = config.as_tensor(y)
    noise = torch.as_tensor(noise, dtype=y.dtype, device=y.device)
    if noise.ndim != 0:
        raise ValueError("kron_posterior requires scalar observation noise.")
    Ks = kron_gram_factors(kernels, axes)
    shape = tuple(K.shape[0] for K in Ks)
    d = len(shape)
    Qs, lams, D, _, alpha_t = _eig_solve(Ks, noise, y.reshape(shape))
    xn = uprank(x_new)
    if xn.shape[1] != d:
        raise ValueError(f"x_new has {xn.shape[1]} columns; the grid has {d}.")
    Cs = [dense(pairwise(k, xn[:, i:i + 1], a[:, None]))
          for i, (k, a) in enumerate(zip(kernels, axes))]
    mean = _contract(alpha_t, Cs)
    reduction = _contract(1.0 / D, [(C @ Q) ** 2 for C, Q in zip(Cs, Qs)])
    prior = torch.prod(
        torch.stack([dense(elwise(k, xn[:, i:i + 1]))[:, 0] for i, k in enumerate(kernels)]),
        dim=0,
    )
    return mean, torch.clamp_min(prior - reduction, 0.0)
