"""Pathwise posterior sampling (Matheron's rule and random features).

Counterpart of ``stheno_tpu/model/pathwise.py``: posterior *functions*,
callables that evaluate at any test points, by the decoupled construction
of Wilson et al., "Efficiently sampling functions from Gaussian process
posteriors" (ICML 2020):

    f_s(.) = phi(.)^T w_s  +  k(., X) K_n^{-1} (y - Phi w_s - eps_s)

with ``w_s ~ N(0, I)`` a random-feature prior draw (``kernels/features.py``)
and ``eps_s ~ N(0, noise I)``. One solve against the observations serves
all draws; evaluating them at ``n_new`` points is the feature product and
one matrix-free cross-Gram product (``kernel_matvec``, kernel K3 on the
card). The solve is dense (``solver="chol"``) or matrix-free
(``solver="cg"``: the eig-preconditioned whitened CG, or plain batched CG
when ``precond_rank=0``).

Draws come from a ``torch.Generator`` where the JAX package splits a key:
the features' frequencies, then ``w``, then ``eps``. Drawing is kept apart
from building (``_draw`` and ``_build``), so the same draws can be handed
to either package. At small noise the CG solve runs on the compensated
operator (``iterative/compensated.py``) where ``compensated`` asks for it
or ``"auto"`` resolves to it. Not ported yet: a ``mesh`` (``ROADMAP.md``
queue 1 item 12), which raises ``NotImplementedError``.
"""

import warnings

import torch

from .. import config
from ..iterative.cg import batched_cg
from ..iterative.matvec import kernel_matvec, not_ported
from ..iterative.pchol import make_whitened_solver
from ..kernels import pairwise
from ..kernels.features import _checked_plan, _feature_map_from_draws
from ..kernels.util import uprank
from ..matrix import add, as_matrix, dense, fill_diag, solve

__all__ = ["pathwise_sampler"]


def _draw(kernel, generator, n, d, dtype, *, num_samples, num_features):
    """``(feature_draws, w, eps)``: the feature map's draws, the prior
    weights ``w (n_features, num_samples)`` and the unit noise draws ``eps
    (n, num_samples)``, in that order from ``generator``."""
    n_feat, draw, _ = _checked_plan(kernel, num_features, d, dtype, generator.device)
    feats = draw(generator)
    w = torch.randn((n_feat, num_samples), generator=generator, dtype=dtype,
                    device=generator.device)
    eps = torch.randn((n, num_samples), generator=generator, dtype=dtype,
                      device=generator.device)
    return feats, w, eps


def _to(draws, device):
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    if isinstance(draws, tuple):
        return tuple(_to(t, device) for t in draws)
    return draws


def _stall_warning(info, tol, compensated=False):
    rel = info["rel_residual"]
    # `not (rel <= tol)`: a NaN residual (a diverged solve) trips it too.
    if not (float(rel) <= tol):
        advice = (
            "Raise the preconditioner rank or max_cg_iters." if compensated else
            "Pass compensated=True (the two-float matvec; the plain float32 solve needs noise "
            ">~ ||K||*eps*sqrt(N)), raise the preconditioner rank, or max_cg_iters."
        )
        warnings.warn(
            f"pathwise_sampler: CG STALLED — rel residual {float(rel):.3e} > tol {tol:.1e} "
            f"after {int(info['iters'])} iterations; the draws' update weights are "
            f"unreliable. {advice}",
            stacklevel=3,
        )


@config.pin_matmul_precision
def _build(kernel, x, y, noise, draws, *, num_features, solver, block, cg_tol, max_cg_iters,
           precond_rank, compensated):
    """``(sample_fn, cg_info)`` from the draws of :func:`_draw`."""
    x2 = uprank(x)
    y = config.as_tensor(y)
    n, d = x2.shape
    noise = config.as_scalar(noise, y.dtype, y.device)
    feats, w, eps = _to(draws, y.device)
    phi, _ = _feature_map_from_draws(kernel, feats, num_features, d, y.dtype, y.device)

    resid = y[:, None] - phi(x2) @ w - torch.sqrt(noise) * eps

    cg_info, used_comp = None, False
    if solver == "chol":
        K = add(as_matrix(pairwise(kernel, x2)), fill_diag(noise, n))
        v = solve(K, resid)
        v = dense(v) if not isinstance(v, torch.Tensor) else v
    elif solver == "cg":
        if precond_rank and precond_rank > 0:
            solve_w = make_whitened_solver(
                lambda u: kernel_matvec(kernel, x2, u, block=block), n, noise, precond_rank,
                dtype=resid.dtype,
                mv_raw_comp=lambda u: kernel_matvec(kernel, x2, u, block=block, compensated=True),
                compensated=compensated,
            )
            v, cg_info = solve_w(resid, tol=cg_tol, max_iters=max_cg_iters)
            used_comp = solve_w.compensated
        else:
            v, cg_info = batched_cg(
                lambda u: kernel_matvec(kernel, x2, u, noise=noise, block=block), resid,
                tol=cg_tol, max_iters=max_cg_iters,
            )
        _stall_warning(cg_info, cg_tol, used_comp)
    else:
        raise ValueError(f"Unknown solver {solver!r} (use 'chol' or 'cg').")

    @config.pin_matmul_precision
    def sample_fn(x_new):
        xn = uprank(x_new)
        return phi(xn) @ w + kernel_matvec(kernel, xn, v, block=block, x_cols=x2)

    return sample_fn, cg_info


@config.pin_matmul_precision
def pathwise_sampler(
    kernel,
    x,
    y,
    noise,
    generator,
    *,
    num_samples=1,
    num_features=2048,
    solver="chol",
    block=4096,
    cg_tol=1e-6,
    max_cg_iters=1000,
    precond_rank=64,
    mesh=None,
    axis="data",
    return_info=False,
    compensated="auto",
):
    """Build posterior function draws for an exact GP.

    Args:
        kernel: kernel expression (it must admit a random-feature expansion,
            see :func:`stheno_torch.kernels.features.feature_map`).
        x: observation inputs ``(n,)`` or ``(n, d)``.
        y: observations ``(n,)``.
        noise: scalar observation-noise variance.
        generator: ``torch.Generator`` for the draws.
        num_samples: number of function draws sharing the solve.
        num_features: random-feature budget of the prior draws.
        solver: ``"chol"`` (dense, O(n^3) once) or ``"cg"`` (matrix-free,
            O(n) memory).
        block: row-block size of the matrix-free products.
        cg_tol, max_cg_iters, precond_rank: the CG solve's settings
            (``precond_rank=0``: no preconditioner).
        mesh, axis: not ported (``mesh`` must be ``None``).
        return_info: also return the solve's health dict.
        compensated: the two-float policy of the whitened CG solve
            (``"auto"``, ``True`` or ``False``; ``iterative/compensated.py``).

    Returns:
        ``(sample_fn, generator)``, or ``(sample_fn, generator, cg_info)``
        with ``return_info=True`` (``cg_info``: ``iters`` and
        ``rel_residual`` of the update solve, ``None`` for ``"chol"``).
        ``sample_fn(x_new)`` evaluates the draws at ``x_new`` as ``(n_new,
        num_samples)``; the draws are fixed, so two calls evaluate the same
        functions. A stalled CG solve warns.
    """
    if mesh is not None:
        raise not_ported("pathwise_sampler(mesh=...)", item=12)
    x2 = uprank(x)
    y = config.as_tensor(y)
    n, d = x2.shape
    draws = _draw(kernel, generator, n, d, y.dtype, num_samples=num_samples,
                  num_features=num_features)
    sample_fn, cg_info = _build(
        kernel, x2, y, noise, draws, num_features=num_features, solver=solver, block=block,
        cg_tol=cg_tol, max_cg_iters=max_cg_iters, precond_rank=precond_rank,
        compensated=compensated,
    )
    if return_info:
        return sample_fn, generator, cg_info
    return sample_fn, generator
