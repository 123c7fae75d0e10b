"""Exact observations.

Counterpart of the exact-conditioning part of
``stheno_tpu/model/observations.py``: ``Observations`` (alias ``Obs``)
with a per-measure ``K_x`` cache and the closed-form posterior kernel and
mean objects. ``combine`` (several observed processes) and the
pseudo-point approximations (VFE, FITC, DTC) are not ported yet.
"""

import torch

from .. import config
from ..kernels import PosteriorKernel, PosteriorMean, pairwise
from ..kernels.util import uprank
from ..matrix import add
from ..mo import num_elements
from .fdd import FDD, take

__all__ = ["AbstractObservations", "Observations", "Obs"]


class AbstractObservations:
    """Base: takes an ``(fdd, y)`` pair, upranks ``y`` to a column and drops
    the rows where ``y`` is NaN (one host sync to find them, skipped while a
    CUDA graph is captured)."""

    def __init__(self, *args):
        if len(args) == 1 and isinstance(args[0], tuple):
            args = args[0]
        if len(args) != 2 or not isinstance(args[0], FDD):
            raise NotImplementedError(
                "Give one (fdd, y) pair: combining observations of several "
                "processes is not ported yet."
            )
        fdd, y = args
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


Obs = Observations
