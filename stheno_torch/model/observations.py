"""Observation objects: exact conditioning and pseudo-point (inducing)
approximations.

Counterpart of ``stheno_tpu/model/observations.py``:

- ``combine``: merge FDDs (or ``(fdd, y)`` pairs) into one FDD on the
  cross process with block-diagonal noise.
- ``Observations`` (alias ``Obs``): exact conditioning, of one process or
  of several (combined), with a per-measure ``K_x`` cache and the
  closed-form posterior kernel and mean objects.
- ``PseudoObservations`` (VFE, Titsias 2009), ``PseudoObservationsFITC``
  (Snelson & Ghahramani 2006) and ``PseudoObservationsDTC`` (Csato &
  Opper 2002; Seeger et al. 2003): one pipeline, differing only in the
  diagonal correction and the trace term, with the ELBO, the optimal
  mean ``mu`` and the corrective variance ``A`` cached per measure. The
  cross-Gram ``K_zx`` and the inducing Gram ``K_z`` are the only Grams
  it builds: no evaluation at (x_obs, x_obs).
"""

import math

import torch

from .. import config
from ..kernels import (
    PosteriorKernel,
    PosteriorMean,
    SubspaceKernel,
    elwise,
    mean_eval,
    pairwise,
)
from ..kernels.util import uprank
from ..matrix import (
    Diagonal,
    add,
    block_diag,
    cholesky,
    dense,
    eye_like,
    iqf,
    iqf_diag,
    logdet,
    matmul3,
    matmul_diag,
    ratio,
    solve,
    transpose,
)
from ..mo import num_elements
from .fdd import FDD, take
from .gp import cross

__all__ = [
    "combine",
    "AbstractObservations",
    "Observations",
    "Obs",
    "AbstractPseudoObservations",
    "PseudoObservations",
    "PseudoObs",
    "PseudoObservationsFITC",
    "PseudoObsFITC",
    "PseudoObservationsDTC",
    "PseudoObsDTC",
    "SparseObs",
    "SparseObservations",
]

_LOG_2_PI = math.log(2 * math.pi)


def combine(*objs):
    """Combine FDDs (or ``(fdd, y)`` pairs) into one FDD on the cross process
    with block-diagonal noise."""
    if objs and isinstance(objs[0], tuple):
        fdds, ys = zip(*objs)
        combined_y = torch.cat([uprank(config.as_tensor(y)) for y in ys], dim=-2)
        return combine(*fdds), combined_y
    combined_noise = block_diag(*[fdd.noise for fdd in objs])
    return cross(*[fdd.p for fdd in objs])(tuple(objs), combined_noise)


class AbstractObservations:
    """Base: takes an ``(fdd, y)`` pair or several (combined on the cross
    process), upranks ``y`` to a column and drops the rows where ``y`` is
    NaN (one host sync to find them, skipped while a CUDA graph is
    captured)."""

    def __init__(self, *args):
        # A single tuple of pairs stands for the pairs themselves.
        if (
            len(args) == 1
            and isinstance(args[0], tuple)
            and all(isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], FDD)
                    for p in args[0])
        ):
            args = args[0]
        if len(args) == 2 and isinstance(args[0], FDD):
            fdd, y = args
        elif args and all(isinstance(a, tuple) for a in args):
            fdd, y = combine(*args)
        else:
            raise ValueError("Give a (fdd, y) pair or tuples of pairs.")
        y_shape = tuple(getattr(y, "shape", ()))
        y = uprank(config.as_tensor(y))
        if y.shape[-1] != 1:
            raise ValueError(f"Invalid shape of observed values {y_shape}.")
        if y.ndim == 2 and not config.capturing():
            available = ~torch.isnan(y[:, 0])
            if not bool(available.all()):
                fdd = take(fdd, available.cpu())
                y = y[available]
        self.fdd = fdd
        self.y = y

    def posterior_kernel(self, measure, p_i, p_j):  # pragma: no cover - abstract
        raise NotImplementedError("Posterior kernel construction not implemented.")

    def posterior_mean(self, measure, p):  # pragma: no cover - abstract
        raise NotImplementedError("Posterior mean construction not implemented.")


class Observations(AbstractObservations):
    """Exact observations."""

    def __init__(self, *args):
        AbstractObservations.__init__(self, *args)
        self._K_x = {}

    def K_x(self, measure):
        """Gram matrix of the observation inputs plus noise, cached per
        measure."""
        key = id(measure)
        if key not in self._K_x:
            self._K_x[key] = add(
                pairwise(measure.kernels[self.fdd.p], self.fdd.x), self.fdd.noise
            )
        return self._K_x[key]

    def posterior_kernel(self, measure, p_i, p_j):
        if num_elements(self.fdd.x) == 0:
            return measure.kernels[p_i, p_j]
        return PosteriorKernel(
            measure.kernels[p_i, p_j],
            measure.kernels[self.fdd.p, p_i],
            measure.kernels[self.fdd.p, p_j],
            self.fdd.x,
            self.K_x(measure),
        )

    def posterior_mean(self, measure, p):
        if num_elements(self.fdd.x) == 0:
            return measure.means[p]
        return PosteriorMean(
            measure.means[p],
            measure.means[self.fdd.p],
            measure.kernels[self.fdd.p, p],
            self.fdd.x,
            self.K_x(measure),
            self.y,
        )


class AbstractPseudoObservations(AbstractObservations):
    """Inducing-point observations ``(u, (fdd, y))``: ``u`` is the FDD of
    the inducing points (or pairs of FDDs to combine); subclasses pick the
    approximation by ``method``."""

    def __init__(self, u, *args):
        if isinstance(u, tuple):
            u = combine(*u)
        AbstractObservations.__init__(self, *args)
        self.u = u
        self._K_z = {}
        self._elbo = {}
        self._mu = {}
        self._A = {}

    def K_z(self, measure):
        """Gram matrix of the inducing inputs plus their noise."""
        return self._cached(self._K_z, measure)

    def elbo(self, measure):
        """Evidence lower bound of the approximation under ``measure``."""
        return self._cached(self._elbo, measure)

    def mu(self, measure):
        """Mean of the optimal approximating distribution over u."""
        return self._cached(self._mu, measure)

    def A(self, measure):
        """Corrective-variance parameter of the optimal approximation."""
        return self._cached(self._A, measure)

    def posterior_kernel(self, measure, p_i, p_j):
        return PosteriorKernel(
            measure.kernels[p_i, p_j],
            measure.kernels[self.u.p, p_i],
            measure.kernels[self.u.p, p_j],
            self.u.x,
            self.K_z(measure),
        ) + SubspaceKernel(
            measure.kernels[self.u.p, p_i],
            measure.kernels[self.u.p, p_j],
            self.u.x,
            self.A(measure),
        )

    def posterior_mean(self, measure, p):
        return PosteriorMean(
            measure.means[p],
            measure.means[self.u.p],
            measure.kernels[self.u.p, p],
            self.u.x,
            self.K_z(measure),
            self.mu(measure),
        )

    def _cached(self, cache, measure):
        """``cache``'s entry for ``measure``, running the pipeline if it has
        none (a state installed from elsewhere may fill some caches only)."""
        if id(measure) not in cache:
            self._compute(measure)
        return cache[id(measure)]

    def _compute(self, measure):
        """The VFE/FITC/DTC pipeline."""
        p_x, x, noise_x = self.fdd.p, self.fdd.x, self.fdd.noise
        p_z, z, noise_z = self.u.p, self.u.x, self.u.noise

        K_zx = pairwise(measure.kernels[p_z, p_x], z, x)
        K_z = add(pairwise(measure.kernels[p_z], z), noise_z)
        self._K_z[id(measure)] = K_z

        K_n = noise_x
        if not isinstance(K_n, Diagonal):
            raise RuntimeError(
                f"Kernel matrix of observation noise must be diagonal, "
                f'not "{type(K_n).__name__}".'
            )

        L_z = cholesky(K_z)
        iLz_Kzx = solve(L_z, K_zx)

        if self.method in {"vfe", "fitc"}:
            K_x_diag = elwise(measure.kernels[p_x], x)[..., 0]
            Q_x_diag = matmul_diag(iLz_Kzx, iLz_Kzx, tr_a=True)
            diag_correction = Diagonal(K_x_diag - Q_x_diag)

        if self.method == "vfe":
            trace_part = ratio(diag_correction, K_n)
        elif self.method == "fitc":
            K_n = add(K_n, diag_correction)
            trace_part = 0
        elif self.method == "dtc":
            trace_part = 0
        else:  # pragma: no cover
            raise ValueError(f'Invalid approximation method "{self.method}".')

        # Subspace variance: A = I + (L_z^{-1} K_zx) K_n^{-1} (...)^T,
        # re-whitened by L_z.
        A = add(eye_like(K_z), iqf(K_n, transpose(iLz_Kzx)))
        self._A[id(measure)] = matmul3(L_z, A, L_z, tr_c=True)

        # Optimal mean.
        y_bar = uprank(self.y) - mean_eval(measure.means[p_x], x)
        prod_y_bar = dense(iqf(K_n, transpose(iLz_Kzx), y_bar))
        mu = mean_eval(measure.means[p_z], z) + dense(iqf(A, transpose(L_z), prod_y_bar))
        self._mu[id(measure)] = mu

        # ELBO.
        n = K_n.rows
        det_part = logdet(K_n) + n * _LOG_2_PI + logdet(A)
        iqf_part = iqf_diag(K_n, y_bar)[..., 0] - iqf_diag(A, prod_y_bar)[..., 0]
        self._elbo[id(measure)] = -0.5 * (det_part + iqf_part + trace_part)


class PseudoObservations(AbstractPseudoObservations):
    """VFE approximation (Titsias, 2009)."""

    @property
    def method(self):
        return "vfe"


class PseudoObservationsFITC(AbstractPseudoObservations):
    """FITC approximation (Snelson & Ghahramani, 2006)."""

    @property
    def method(self):
        return "fitc"


class PseudoObservationsDTC(AbstractPseudoObservations):
    """DTC approximation (Csato & Opper, 2002; Seeger et al., 2003)."""

    @property
    def method(self):
        return "dtc"


Obs = Observations
PseudoObs = PseudoObservations
PseudoObsFITC = PseudoObservationsFITC
PseudoObsDTC = PseudoObservationsDTC

# The reference's older names.
SparseObs = PseudoObservations
SparseObservations = PseudoObservations
