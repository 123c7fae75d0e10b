"""Distributed pseudo-point (inducing-point) inference: the VFE, FITC and
DTC ELBOs and the predictive posterior with the N observations row-sharded
over a mesh axis.

Counterpart of ``stheno_tpu/parallel/sparse.py``. The M inducing points
stay replicated (M is small); every O(N) quantity partitions along N: each
rank builds its M x (N/D) cross Gram ``K_zx`` with the fused Gram kernel
K1 (its backward kernel under a gradient), and its shares of ``A = I + B
K_n^{-1} B^T``, ``c = B K_n^{-1} y`` and the ELBO's scalar sums. Those go
over the ranks in one ``reduce_from_mesh`` (M^2 + M + 3 numbers); the
O(M^3) work after it (the Cholesky of ``A``, the ELBO) runs on every rank.

Gradients of replicated inputs: the kernel's tensors, ``z``, ``x``, ``y``
and the noise enter through ``copy_to_mesh``, and everything that uses
them runs before the reduction, so each rank's gradient is its share and
``copy_to_mesh``'s backward sums the shares; the replicated work after the
reduction reads only the reduced sums, and its gradient reaches each rank
once. N is padded to a multiple of the mesh size with rows of zero mask
weight, as the JAX package pads, so every O(N) term is unchanged.
"""

import math

import torch

from .. import config
from ..kernels import elwise, pairwise
from ..kernels.util import uprank
from ..matrix import dense
from ..matrix.ops import _contract, _kinv_from_chol, adaptive_jitter_eps
from ._comm import MeshAxis, copy_to_mesh, reduce_from_mesh, replicate_from_root, root_gradient
from .exact import _route, check_routed

__all__ = ["dist_elbo", "dist_sparse_posterior"]

_LOG_2_PI = math.log(2 * math.pi)


def _chol(K):
    """Cholesky with escalating jitter, always (float32 rounding alone makes
    a rank-deficient inducing Gram indefinite, so no fixed absolute jitter
    works across problem scales; see the JAX package's ``_chol``)."""
    eps = adaptive_jitter_eps(K, config.jitter(K.dtype))
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return torch.linalg.cholesky(K + eps * eye)


def _solve_tri(L, b):
    return torch.linalg.solve_triangular(L, b, upper=False)


class _LogdetQuad(torch.autograd.Function):
    """``(log det A, c^T A^{-1} c)`` of the replicated M x M ``A`` (factored
    by ``_chol``), with the closed-form adjoints that the single-device path
    takes (``matrix/ops.py:_LogdetChol``, ``_IqfDiagChol``): ``A^{-1}`` and
    ``-a a^T`` for ``A``, ``2 a`` for ``c``, ``a = A^{-1} c``. In float32
    at N=10^6, M=512 on an H100, autograd through the factorisation and the
    solve left the ELBO's gradient in ell several times further off float64
    than these adjoints do, and than the single-device path
    (``scripts/torch_item12a.py`` measures the three)."""

    @staticmethod
    def forward(ctx, A, c):
        L = _chol(A)
        w = _solve_tri(L, c[:, None])
        ctx.save_for_backward(L, w)
        return torch.stack([2.0 * torch.log(L.diagonal()).sum(), (w * w).sum()])

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, g):
        L, w = ctx.saved_tensors
        a = torch.linalg.solve_triangular(L.mT, w, upper=True)  # A^{-1} c
        gA = g[0] * _kinv_from_chol(L, None) - g[1] * (a @ a.mT)
        return gA, 2.0 * g[1] * a[:, 0]


def _inducing_chol(kernel, z, noise_z):
    """The factor of the inducing Gram ``k(z, z) (+ noise_z I)``."""
    K_z = dense(pairwise(kernel, z))
    if noise_z is not None:
        K_z = K_z + noise_z * torch.eye(K_z.shape[-1], dtype=K_z.dtype, device=K_z.device)
    return _chol(K_z)


def _sparse_core(kernel, z, x, y, noise, ax, method, noise_z):
    """Shared pipeline. Returns ``(elbo, A, c)`` (replicated) where the
    optimal ``q(u)`` is ``N(L_z A^{-1} c, L_z A^{-1} L_z^T)``, ``L_z`` the
    factor of the inducing Gram."""
    if method not in ("vfe", "fitc", "dtc"):
        raise ValueError(f'Invalid approximation method "{method}".')
    y = config.as_tensor(y).reshape(-1)
    x = uprank(config.as_tensor(x))
    z = uprank(config.as_tensor(z))
    n, dtype = y.shape[0], y.dtype
    noise = config.as_tensor(noise, dtype=dtype, device=y.device)
    kernel, x, y, z, noise = (_route(a, ax) for a in (kernel, x, y, z, noise))
    noise = noise.broadcast_to((n,))

    # This rank's rows of the data padded to a multiple of the mesh size:
    # padded rows repeat x[0] and carry zero mask weight, y = 0, noise = 1.
    nl = -(-n // ax.size)
    rows = torch.arange(ax.rank * nl, (ax.rank + 1) * nl, device=y.device)
    real = rows < n
    idx = torch.where(real, rows, 0)
    mask = real.to(dtype)
    x_l = x[idx]
    y_l = torch.where(real, y[idx], 0.0)
    noise_l = torch.where(real, noise[idx], 1.0)

    # M x M inducing Gram (replicated) and M x (N/D) cross Gram (K1).
    if noise_z is not None:
        noise_z = copy_to_mesh(config.as_tensor(noise_z, dtype, y.device), ax)
    L_z = _inducing_chol(kernel, z, noise_z)
    K_zx = dense(pairwise(kernel, z, x_l))
    Bm = _solve_tri(L_z, K_zx)  # L_z^{-1} K_zx, M x (N/D).

    trace_part = torch.zeros((), dtype=dtype, device=y.device)
    if method in ("vfe", "fitc"):
        correction = torch.clamp_min(elwise(kernel, x_l)[:, 0] - (Bm * Bm).sum(0), 0.0)
        if method == "vfe":
            trace_part = (mask * correction / noise_l).sum()
        else:
            noise_l = noise_l + correction

    # The N/D-term products in chunks (``_contract``): one float32 product
    # over 10^6 terms leaves A indefinite, as on the single-device path.
    Bw = Bm * (mask / noise_l)
    parts = torch.cat([
        _contract(Bw, Bm.mT).reshape(-1),  # B K_n^{-1} B^T
        _contract(Bw, y_l[:, None])[:, 0],  # B K_n^{-1} y
        torch.stack([
            trace_part,
            (mask * torch.log(noise_l)).sum(),
            (mask * y_l * y_l / noise_l).sum(),
        ]),
    ])
    if parts.requires_grad:
        check_routed(parts, "dist_elbo")
    sums = reduce_from_mesh(parts, ax)

    M = L_z.shape[-1]
    A = torch.eye(M, dtype=dtype, device=y.device) + sums[:M * M].reshape(M, M)
    c = sums[M * M:M * M + M]
    trace_sum, log_noise_sum, iqf_sum = sums[M * M + M:]
    logdet_A, quad = _LogdetQuad.apply(A, c)
    det_part = log_noise_sum + n * _LOG_2_PI + logdet_A
    elbo = -0.5 * (det_part + iqf_sum - quad + trace_sum)
    return elbo, A, c


@config.pin_matmul_precision
def dist_elbo(kernel, z, x, y, noise, mesh, axis="data", method="vfe", noise_z=None):
    """Collapsed evidence lower bound of a zero-mean sparse GP with the N
    observations row-sharded over ``mesh``'s ``axis``.

    Equals ``PseudoObs(u(z), (f(x, noise), y)).elbo(measure)`` (and the
    FITC/DTC variants) for ``f = GP(kernel)``. ``z``, ``x``, ``y`` are
    replicated; ``noise`` is a scalar or an (N,)-vector. Differentiable in
    the kernel's hyperparameters, ``z``, ``y`` and ``noise``; every rank
    gets the same value and gradient."""
    elbo, _, _ = _sparse_core(kernel, z, x, y, noise, MeshAxis(mesh, axis), method, noise_z)
    return elbo


@config.pin_matmul_precision
def dist_sparse_posterior(kernel, z, x, y, noise, x_new, mesh, axis="data", method="vfe",
                          noise_z=None):
    """Predictive mean and variance-diagonal at ``x_new`` of the optimal
    sparse approximation, replicated: ``mean = k_*z K_z^{-1} m_u`` and
    ``var = k_** - ||L_z^{-1} k_z*||^2 + ||L_A^{-1} L_z^{-1} k_z*||^2``
    with ``q(u) = N(m_u, L_z A^{-1} L_z^T)``. Differentiable as
    :func:`dist_elbo` is, and in ``x_new``: the O(M^3) work after the
    reduction reads the inputs as they are, so its gradient reaches each
    rank once.

    Every rank runs that work on its own, from the same bits. Its results
    are rank 0's on every rank by construction: the mean and variance are
    broadcast from rank 0 (``replicate_from_root``), and so are the
    gradients that the work hands the inputs it reads directly (the
    kernel's tensors, ``z``, ``x_new``, ``noise_z``: ``root_gradient``), so
    no rank's own rounding shows in a replicated output or gradient."""
    ax = MeshAxis(mesh, axis)
    _, A, c = _sparse_core(kernel, z, x, y, noise, ax, method, noise_z)
    kernel = _route(kernel, ax, to=root_gradient)
    z, x_new = (root_gradient(uprank(config.as_tensor(t)), ax) for t in (z, x_new))
    if noise_z is not None:
        noise_z = root_gradient(config.as_tensor(noise_z, A.dtype, A.device), ax)
    L_z = _inducing_chol(kernel, z, noise_z)
    L_A = _chol(A)
    v = _solve_tri(L_z, dense(pairwise(kernel, z, x_new)))  # L_z^{-1} k_z*
    w = _solve_tri(L_A, v)  # L_A^{-1} v
    # mean = v^T A^{-1} c = (L_A^{-1} v)^T (L_A^{-1} c).
    mean = w.mT @ _solve_tri(L_A, c[:, None])[:, 0]
    var = elwise(kernel, x_new)[:, 0] - (v * v).sum(0) + (w * w).sum(0)
    return replicate_from_root(mean, ax), replicate_from_root(torch.clamp_min(var, 0.0), ax)
