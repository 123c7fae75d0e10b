"""The matrix-free (iterative) exact-GP path: Gram matvecs, batched CG,
stochastic Lanczos quadrature, preconditioners, the stochastic NLML and
the amortised posterior. Counterpart of ``stheno_tpu/iterative``; the
structured-grid (``toeplitz``), Kronecker (``kron``) and two-float
compensated paths are not ported yet (``ROADMAP.md``)."""

from .cg import batched_cg
from .compensated import AUTO_WALL_FACTOR, plain_noise_wall, resolve_compensated
from .matvec import kernel_matvec
from .nlml import (
    cached_posterior_mean,
    eig_precond_state,
    iterative_nlml,
    iterative_posterior_mean,
    iterative_posterior_var,
    posterior_weights,
)
from .pchol import (
    eig_preconditioner_factors,
    eig_preconditioner_ops,
    make_whitened_solver,
    pivoted_cholesky,
    woodbury_preconditioner,
)
from .serving import AmortisedPosterior
from .slq import lanczos, slq_logdet
from .variance import (
    VarianceCache,
    cached_posterior_mean_var,
    cached_posterior_var,
    variance_cache,
)

__all__ = [
    "batched_cg",
    "AUTO_WALL_FACTOR",
    "plain_noise_wall",
    "resolve_compensated",
    "kernel_matvec",
    "iterative_nlml",
    "eig_precond_state",
    "iterative_posterior_mean",
    "iterative_posterior_var",
    "posterior_weights",
    "cached_posterior_mean",
    "pivoted_cholesky",
    "woodbury_preconditioner",
    "eig_preconditioner_factors",
    "eig_preconditioner_ops",
    "make_whitened_solver",
    "AmortisedPosterior",
    "VarianceCache",
    "variance_cache",
    "cached_posterior_var",
    "cached_posterior_mean_var",
    "lanczos",
    "slq_logdet",
]
