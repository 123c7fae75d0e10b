"""One-object amortised serving for extreme-N exact GPs.

Counterpart of ``stheno_tpu/iterative/serving.py``:
:class:`AmortisedPosterior` builds the representer weights
(``nlml.posterior_weights``) and the variance cache
(``variance.variance_cache``) once, then serves ``mean``, ``var``,
``mean_var`` and ``marginal_credible_bounds`` for any batch of test points
with no CG in the query path. The JAX package's internally jitted query
closures are plain calls here.
"""

import torch

from ..kernels.util import uprank
from .nlml import cached_posterior_mean, posterior_weights
from .variance import cached_posterior_mean_var, cached_posterior_var, variance_cache

__all__ = ["AmortisedPosterior"]


def _pad_rows(xn, mult):
    """Pad ``xn`` (2-D) up to a multiple of ``mult`` rows by repeating its
    first row; returns ``(padded, true_m)``."""
    m = xn.shape[0]
    m_pad = -(-m // mult) * mult
    if m_pad == m:
        return xn, m
    return torch.cat([xn, xn[:1].expand(m_pad - m, *xn.shape[1:])], dim=0), m


class AmortisedPosterior:
    """Amortised posterior of an exact GP at large N.

    Build once (one preconditioned CG solve for the weights and one cache
    build for the variance)::

        post = AmortisedPosterior(kernel_fn, params, x, y, noise, rank=512,
                                  generator=torch.Generator("cuda").manual_seed(0))

    then serve: ``post.mean(x_new)``, ``post.var(x_new)``,
    ``post.mean_var(x_new)``, ``post.marginal_credible_bounds(x_new)``.

    Args:
        kernel_fn: ``params -> Kernel`` expression builder.
        params: hyperparameters (fixed at build time).
        x: training inputs ``(n, d)`` or ``(n,)``.
        y: training targets ``(n,)``.
        noise: scalar observation noise.
        rank: variance-cache basis width (see :func:`variance_cache`).
        generator: ``torch.Generator`` of the cache's subspace probes
            (required unless ``precond_state`` is given).
        precond_state: optional ``(U, lam)`` from ``eig_precond_state``,
            shared by the weights solve and the variance basis (widened to
            ``rank`` when narrower and a generator is given).
        cg_tol / max_cg_iters: weights-solve tolerances.
        refine / var_cg_tol / var_max_cg_iters: variance-cache refinement.
        block: Gram row-block size.
        chunk: test-point chunk width of variance queries.
    """

    def __init__(self, kernel_fn, params, x, y, noise, *, rank=512, generator=None,
                 precond_state=None, cg_tol=1e-4, max_cg_iters=200, refine=True,
                 var_cg_tol=1e-3, var_max_cg_iters=50, power_iters=2, block=4096,
                 chunk=1024):
        self.kernel_fn = kernel_fn
        self.params = params
        self.x = uprank(x)
        self.noise = torch.as_tensor(noise, dtype=self.x.dtype, device=self.x.device)
        self.block = block
        self.chunk = chunk
        precond_rank = precond_state[0].shape[-1] if precond_state is not None else min(64, rank)
        self.alpha, self.solve_info = posterior_weights(
            kernel_fn, params, self.x, y, self.noise, cg_tol=cg_tol,
            max_cg_iters=max_cg_iters, precond_rank=precond_rank,
            precond_state=precond_state, block=block,
        )
        self.cache = variance_cache(
            kernel_fn, params, self.x, self.noise, rank=rank, generator=generator,
            precond_state=precond_state, power_iters=power_iters, refine=refine,
            cg_tol=var_cg_tol, max_cg_iters=var_max_cg_iters, block=block,
        )

    def mean(self, x_new):
        """Posterior mean at ``x_new``. Queries are padded to a multiple
        of ``min(block, 256)`` rows, as in the JAX package: a row bucket
        that bounds the cross-Gram work of a small query."""
        xn, m = _pad_rows(uprank(x_new), min(self.block, 256))
        return cached_posterior_mean(
            self.kernel_fn, self.params, self.x, self.alpha, xn, block=self.block
        )[:m]

    def var(self, x_new):
        """Posterior variance diagonal at ``x_new``: cache products only."""
        xn, m = _pad_rows(uprank(x_new), self.chunk)
        return cached_posterior_var(
            self.kernel_fn, self.params, self.x, self.cache, xn, chunk=self.chunk
        )[:m]

    def mean_var(self, x_new):
        """``(mean, var)`` at ``x_new``, sharing each chunk's cross-Gram."""
        xn, m = _pad_rows(uprank(x_new), self.chunk)
        mean, var = cached_posterior_mean_var(
            self.kernel_fn, self.params, self.x, self.alpha, self.cache, xn, chunk=self.chunk
        )
        return mean[:m], var[:m]

    def marginal_credible_bounds(self, x_new):
        """``(mean, lower, upper)``: central 95% credible bounds."""
        mean, var = self.mean_var(x_new)
        sd = torch.sqrt(var)
        return mean, mean - 1.96 * sd, mean + 1.96 * sd
