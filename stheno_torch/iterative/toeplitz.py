"""O(N log N) stationary-kernel matvecs on uniform grids by circulant
embedding.

Counterpart of ``stheno_tpu/iterative/toeplitz.py``. On a uniform grid the
Gram of a stationary kernel is (multilevel) Toeplitz; it embeds into a
circulant operator of twice the size per axis, whose matvec is three FFTs,
``irfftn(rfftn(pad(v)) * spectrum)``. Plugged into the CG and SLQ
machinery of ``nlml.py`` (as its ``matvec_fn``) this gives exact GP
training on gridded data at N far beyond the dense Gram sweep.

The FFTs are ``torch.fft.rfftn`` and ``irfftn`` (cuFFT on the card), as the
JAX package's are XLA's: no Pallas kernel stands behind them. The JAX
package's ``vmap`` over right-hand-side columns is one batched transform
over a leading column dimension here. The spectrum's real part is kept and
the inverse transform's output shape is fixed (``s=``), as there.
Gradients reach the hyperparameters through the O(N) lag-grid evaluation
and the grid coordinates through ``_axes_from_coords``.

The posterior mean's cross product is ``kernel_matvec(..., x_cols=grid)``
(K3 on the card), and the posterior variance's cross Grams come from
``pairwise`` (K1 on the card).
"""

import math

import torch

from .. import config
from ..kernels.eval import elwise, pairwise
from ..kernels.util import uprank
from ..matrix import dense
from .cg import batched_cg
from .matvec import kernel_matvec
from .nlml import _nlml, _randn
from .pchol import make_whitened_solver

__all__ = [
    "circulant_spectrum",
    "grid_coords",
    "grid_matvec",
    "grid_iterative_nlml",
    "grid_posterior_mean",
    "grid_posterior_var",
]


def _check_stationary(k):
    if not k.stationary:
        raise ValueError(f"Circulant embedding requires a stationary kernel; got {k}.")


def _as_axes(axes):
    """``axes`` as a tuple of 1-D tensors (a single array is a 1-D grid)."""
    if isinstance(axes, (tuple, list)):
        return tuple(config.as_tensor(a).reshape(-1) for a in axes)
    return (config.as_tensor(axes).reshape(-1),)


def grid_coords(axes):
    """The full tensor grid's coordinates ``(prod N_i, d)`` in row-major
    (``indexing="ij"``) order, the order of every vector on the grid here."""
    axes = _as_axes(axes)
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([g.reshape(-1) for g in mesh], dim=-1)


def _lag_axis(axis):
    """Wrap-around lags of the 2N-point circulant embedding of a uniform
    N-point axis: ``[0, d, ..., N d, -(N - 1) d, ..., -d]``."""
    n = axis.shape[0]
    delta = axis[1] - axis[0] if n > 1 else torch.ones((), dtype=axis.dtype, device=axis.device)
    m = torch.arange(2 * n, device=axis.device)
    return delta * torch.where(m <= n, m, m - 2 * n).to(axis.dtype)


@config.pin_matmul_precision
def circulant_spectrum(k, axes):
    """Real spectrum of the circulant embedding of ``k``'s Gram on the
    uniform grid ``axes``, of shape ``(2 N_1, ..., 2 N_{d-1}, N_d + 1)``
    (the rFFT layout); differentiable in the kernel's hyperparameters."""
    _check_stationary(k)
    axes = _as_axes(axes)
    lag_pts = grid_coords(tuple(_lag_axis(a) for a in axes))
    c = elwise(k, lag_pts, torch.zeros_like(lag_pts))[..., 0]
    c = c.reshape(tuple(2 * a.shape[0] for a in axes))
    return torch.fft.rfftn(c).real


@config.pin_matmul_precision
def grid_matvec(k, axes, v, *, noise=None, spectrum=None):
    """``(K [+ noise I]) @ v`` for the Gram of the stationary ``k`` on the
    uniform grid ``axes``, in O(N log N).

    Args:
        k: stationary kernel expression.
        axes: 1-D array (one axis) or tuple of uniform 1-D arrays.
        v: ``(n,)`` or ``(n, p)``, ``n = prod(len(axis))``, rows in
            :func:`grid_coords` order.
        noise: optional scalar or ``(n,)`` diagonal noise.
        spectrum: optional precomputed :func:`circulant_spectrum`.

    Returns:
        ``(n,)`` or ``(n, p)`` matching ``v``.
    """
    axes = _as_axes(axes)
    shape = tuple(a.shape[0] for a in axes)
    n = math.prod(shape)
    if spectrum is None:
        spectrum = circulant_spectrum(k, axes)
    v_in = config.as_tensor(v)
    v2 = v_in[:, None] if v_in.ndim == 1 else v_in
    if v2.shape[0] != n:
        raise ValueError(f"v has {v2.shape[0]} rows; the grid has {n} points.")
    d = len(shape)
    big = tuple(2 * s for s in shape)
    dims = tuple(range(1, d + 1))
    cols = v2.T.reshape((v2.shape[1],) + shape)
    pad = []
    for s in reversed(shape):
        pad += [0, s]
    g = torch.nn.functional.pad(cols, pad)
    out = torch.fft.irfftn(torch.fft.rfftn(g, dim=dims) * spectrum, s=big, dim=dims)
    out = out[(slice(None),) + tuple(slice(0, s) for s in shape)]
    out = out.reshape(v2.shape[1], n).T.to(v2.dtype)
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=v2.dtype, device=v2.device)
        out = out + (noise[:, None] if noise.ndim == 1 else noise) * v2
    return out[:, 0] if v_in.ndim == 1 else out


def _axes_from_coords(x, shape):
    """The per-axis 1-D arrays of row-major :func:`grid_coords` output of
    the grid ``shape``; gradients reach ``x`` through the recovered origins
    and spacings."""
    axes = []
    stride = 1
    for i in reversed(range(len(shape))):
        n_i = shape[i]
        start = x[0, i]
        delta = x[stride, i] - start if n_i > 1 else torch.ones((), dtype=x.dtype,
                                                                device=x.device)
        axes.append(start + delta * torch.arange(n_i, dtype=x.dtype, device=x.device))
        stride *= n_i
    return tuple(reversed(axes))


@config.pin_matmul_precision
def grid_iterative_nlml(
    kernel_fn,
    params,
    axes,
    y,
    noise,
    generator,
    *,
    num_probes=8,
    cg_tol=1e-4,
    max_cg_iters=500,
    slq_steps=20,
    precond_rank=64,
    precond_method="eig",
    precond_power_iters=1,
):
    """The stochastic exact-GP NLML on a uniform grid with circulant
    matvecs: ``iterative_nlml``'s estimator (CG and preconditioned SLQ
    forward, Hutchinson surrogate backward) with every Gram sweep replaced
    by the FFT matvec, through the NLML core's ``matvec_fn``.

    Args:
        kernel_fn: ``params -> Kernel`` (a stationary kernel).
        params: parameter dict.
        axes: 1-D array or tuple of uniform 1-D arrays (the grid).
        y: observations ``(n,)`` in :func:`grid_coords` order.
        noise: scalar observation-noise variance.
        generator: ``torch.Generator`` of the probes (``u (n, num_probes)``
            first, then the subspace block).

    Differentiable with respect to the tensors in ``params``, ``noise``,
    ``y`` and ``axes``.
    """
    axes = _as_axes(axes)
    shape = tuple(int(a.shape[0]) for a in axes)
    _check_stationary(kernel_fn(params))
    x = grid_coords(axes)
    y = config.as_tensor(y)
    n = x.shape[0]
    u = _randn((n, num_probes), generator, y)
    om = None
    if precond_method == "eig" and precond_rank and precond_rank > 0:
        om = _randn((n, min(precond_rank, n)), generator, y)

    def matvec_fn(k, xx, v, nz):
        return grid_matvec(k, _axes_from_coords(xx, shape), v, noise=nz)

    val, _ = _nlml(
        params, y, noise, x, u, om, None, kernel_fn, cg_tol, max_cg_iters, slq_steps,
        precond_rank, precond_method, precond_power_iters, matvec_fn=matvec_fn,
    )
    return val


def _grid_solver(k, axes, x, spectrum, noise, precond_rank, dtype):
    """``solve(rhs, tol, max_iters) -> (X, info)`` of ``(K + noise I) X =
    rhs`` with circulant matvecs: whitened for scalar noise with a rank,
    plain CG otherwise."""
    noise = torch.as_tensor(noise, dtype=dtype, device=x.device)
    if precond_rank and precond_rank > 0 and noise.ndim == 0:
        solver = make_whitened_solver(
            lambda v: grid_matvec(k, axes, v, spectrum=spectrum), x.shape[0], noise,
            precond_rank, dtype=dtype,
        )
        return lambda rhs, tol, max_iters: solver(rhs, tol=tol, max_iters=max_iters)

    def mv(v):
        return grid_matvec(k, axes, v, noise=noise, spectrum=spectrum)

    return lambda rhs, tol, max_iters: batched_cg(mv, rhs, tol=tol, max_iters=max_iters)


@config.pin_matmul_precision
def grid_posterior_mean(kernel_fn, params, axes, y, noise, x_new, *, cg_tol=1e-6,
                        max_cg_iters=1000, precond_rank=64, block=4096):
    """Posterior mean at any ``x_new`` from gridded observations: ``(K +
    noise I) alpha = y`` by preconditioned CG on circulant matvecs, then one
    cross-Gram product ``k(x_new, grid) @ alpha``. Returns ``(mean,
    info)``. Runs without autograd."""
    with torch.no_grad():
        axes = _as_axes(axes)
        k = kernel_fn(params)
        _check_stationary(k)
        x = grid_coords(axes)
        y = config.as_tensor(y)
        solver = _grid_solver(k, axes, x, circulant_spectrum(k, axes), noise, precond_rank,
                              y.dtype)
        alpha, info = solver(y, cg_tol, max_cg_iters)
        mean = kernel_matvec(k, uprank(x_new), alpha, x_cols=x, block=block)
        return mean, info


@config.pin_matmul_precision
def grid_posterior_var(kernel_fn, params, axes, y, noise, x_new, *, cg_tol=1e-6,
                       max_cg_iters=1000, precond_rank=64, block=4096, chunk=512):
    """Posterior variance diagonal at any ``x_new`` from gridded
    observations: per ``chunk`` of test points one batched CG with the
    chunk's cross-covariances ``k(grid, x_chunk)`` as right-hand sides
    (the last chunk padded with zero inputs, as in the JAX package), on
    circulant matvecs. Runs without autograd."""
    with torch.no_grad():
        axes = _as_axes(axes)
        k = kernel_fn(params)
        _check_stationary(k)
        x = grid_coords(axes)
        solver = _grid_solver(k, axes, x, circulant_spectrum(k, axes), noise, precond_rank,
                              config.as_tensor(y).dtype)
        xn = uprank(x_new)
        m = xn.shape[0]
        chunk = min(chunk, m)
        m_pad = -(-m // chunk) * chunk
        xn_pad = torch.cat([xn, xn.new_zeros((m_pad - m, xn.shape[1]))], dim=0)
        reductions = []
        for xc in torch.split(xn_pad, chunk):
            K_xc = dense(pairwise(k, x, xc))  # (N, chunk)
            sol, _ = solver(K_xc, cg_tol, max_cg_iters)
            reductions.append(torch.sum(K_xc * sol, dim=0))
        prior = dense(elwise(k, xn))[:, 0]
        return torch.clamp_min(prior - torch.cat(reductions)[:m], 0.0)
