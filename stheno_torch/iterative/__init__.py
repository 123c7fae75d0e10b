"""The matrix-free (iterative) exact-GP path: Gram matvecs, batched CG,
stochastic Lanczos quadrature, preconditioners, the stochastic NLML and
the amortised posterior, the structured-grid (``toeplitz``: circulant FFT
matvecs) and Kronecker (``kron``: exact eigenbasis solves) paths, and the
two-float compensated operator of small-noise solves (``compensated``).
Counterpart of ``stheno_tpu/iterative``."""

from .cg import batched_cg
from .compensated import (
    AUTO_WALL_FACTOR,
    compensated_matmul,
    df32_pairwise,
    plain_noise_wall,
    resolve_compensated,
)
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
from .toeplitz import (
    circulant_spectrum,
    grid_coords,
    grid_iterative_nlml,
    grid_matvec,
    grid_posterior_mean,
    grid_posterior_var,
)
from .kron import kron_gram_factors, kron_matvec, kron_nlml, kron_posterior

__all__ = [
    "batched_cg",
    "AUTO_WALL_FACTOR",
    "compensated_matmul",
    "df32_pairwise",
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
    "circulant_spectrum",
    "grid_coords",
    "grid_iterative_nlml",
    "grid_matvec",
    "grid_posterior_mean",
    "grid_posterior_var",
    "kron_gram_factors",
    "kron_matvec",
    "kron_nlml",
    "kron_posterior",
]
