"""Multivariate normal over structured matrices with lazy mean/variance.

Counterpart of ``stheno_tpu/dist/normal.py``, ported for the exact-GP
path: lazy thunks with the ``var_diag``/``mean_var``/``mean_var_diag``
fast paths (so ``marginals`` of a posterior never forms the N x N
covariance), ``logpdf`` with batching, NaN-dropped missing data and a
boolean ``mask``, and ``sample`` from a ``torch.Generator``. ``entropy``,
``kl``, ``w2`` and the affine arithmetic are not ported yet.
"""

import math
import numbers

import torch

from .. import config
from ..matrix import (
    Diagonal,
    Zero,
    add,
    as_matrix,
    dense,
    diag_of,
    fill_diag,
    iqf_diag,
    is_structured,
    logdet,
    submatrix,
)
from ..matrix import sample as mat_sample
from .rng import global_generator

__all__ = ["Random", "RandomProcess", "RandomVector", "Normal"]

_LOG_2_PI = math.log(2 * math.pi)


class Random:
    """A random object."""


class RandomProcess(Random):
    """A random process."""


class RandomVector(Random):
    """A random vector."""


def _arr(a):
    return dense(a) if is_structured(a) else config.as_tensor(a)


class Normal(RandomVector):
    """Normal random variable.

    Construct eagerly as ``Normal(mean, var)`` / ``Normal(var)``, or lazily
    from thunks: ``Normal(mean_fn, var_fn, var_diag=..., mean_var=...,
    mean_var_diag=...)``."""

    def __init__(self, mean=None, var=None, *, var_diag=None, mean_var=None, mean_var_diag=None):
        if var is None:
            mean, var = None, mean
        if callable(var) or callable(mean):
            self._mean = None
            self._construct_mean = (
                mean if callable(mean) else (lambda: 0 if mean is None else mean)
            )
            self._var = None
            self._construct_var = var if callable(var) else (lambda: var)
            self._var_diag = None
            self._construct_var_diag = var_diag
            self._construct_mean_var = mean_var
            self._construct_mean_var_diag = mean_var_diag
        else:
            self._mean = 0 if mean is None else mean
            self._construct_mean = None
            self._var = var
            self._construct_var = None
            self._var_diag = None
            self._construct_var_diag = None
            self._construct_mean_var = None
            self._construct_mean_var_diag = None

    # -- resolution -------------------------------------------------------

    def _resolve_mean(self):
        if self._mean is None:
            self._mean = self._construct_mean()
        if _is_symbolic_zero(self._mean):
            if self._var is None and (
                self._var_diag is not None or self._construct_var_diag is not None
            ):
                # Shape from the cheap diagonal, so a marginals-only query
                # never materialises the full variance.
                self._mean = torch.zeros_like(self.var_diag)
            else:
                var = self.var
                self._mean = torch.zeros(
                    var.batch_shape + (var.rows, 1), dtype=var.dtype, device=var.device
                )

    def _resolve_var(self):
        if self._var is None:
            self._var = self._construct_var()
        self._var = as_matrix(self._var)

    def _resolve_var_diag(self):
        if self._var_diag is None:
            if self._construct_var_diag is not None:
                self._var_diag = self._construct_var_diag()
            else:
                self._var_diag = diag_of(self.var)[..., :, None]

    # -- properties -------------------------------------------------------

    @property
    def mean(self):
        """Mean as a column vector."""
        self._resolve_mean()
        return self._mean

    @property
    def var(self):
        """Variance as a structured matrix."""
        self._resolve_var()
        return self._var

    @property
    def var_diag(self):
        """Diagonal of the variance as a column ``(..., n, 1)``."""
        self._resolve_var_diag()
        return self._var_diag

    @property
    def mean_var(self):
        if self._mean is None and self._var is None and self._construct_mean_var is not None:
            self._mean, self._var = self._construct_mean_var()
        return self.mean, self.var

    @property
    def dtype(self):
        return self.var.dtype

    @property
    def dim(self):
        return as_matrix(self.var).rows

    # -- marginals --------------------------------------------------------

    def marginals(self):
        """Marginal means and variances, never forming the full covariance
        when a diagonal fast path is available."""
        if (
            self._mean is None
            and self._var_diag is None
            and self._construct_mean_var_diag is not None
        ):
            self._mean, self._var_diag = self._construct_mean_var_diag()
        mean, var_diag = _arr(self.mean), _arr(self.var_diag)
        return (
            mean[..., 0] if mean.ndim >= 2 else mean,
            torch.clamp_min(var_diag[..., 0] if var_diag.ndim >= 2 else var_diag, 0),
        )

    def marginal_credible_bounds(self):
        """Marginal means and central 95% credible bounds."""
        mean, var = self.marginals()
        error = 1.96 * torch.sqrt(var)
        return mean, mean - error, mean + error

    # -- densities --------------------------------------------------------

    def logpdf(self, x, mask=None):
        """Log-density of ``x`` (a column; extra trailing columns are a
        batch of inputs). Rows where ``x`` is NaN are dropped (one host sync
        to find them, skipped while a CUDA graph is captured); ``mask``
        (boolean ``(n,)``) marginalises out the rows where it is False with
        static shapes."""
        x = config.as_tensor(x)
        if x.ndim == 0:
            x = x[None, None]
        elif x.ndim == 1:
            x = x[:, None]

        if mask is not None:
            return self._masked_logpdf(x, mask)

        if x.ndim == 2 and x.shape[1] == 1 and not config.capturing():
            available = ~torch.isnan(x[:, 0])
            if not bool(available.all()):
                mean = _arr(self.mean)[available]
                var = submatrix(self.var, available.cpu())
                return Normal(mean, var).logpdf(x[available])

        resid = x - _arr(self.mean)
        logpdfs = -0.5 * (
            logdet(self.var)[..., None] + self.dim * _LOG_2_PI + iqf_diag(self.var, resid)
        )
        return logpdfs[..., 0] if logpdfs.shape[-1] == 1 else logpdfs

    def _masked_logpdf(self, x, mask):
        """Zero the masked rows/columns of the covariance, put ones on their
        diagonal and zero the masked residuals: the masked rows then add
        nothing to the log-determinant or the quadratic form. A Diagonal
        variance stays diagonal; anything else densifies."""
        var = self.var
        m = config.as_tensor(mask).to(device=x.device, dtype=x.dtype)
        resid = m[:, None] * torch.nan_to_num(x - _arr(self.mean))
        if isinstance(var, Diagonal):
            masked = Diagonal(m * var.diag + (1.0 - m))
        else:
            K = dense(var)
            masked = as_matrix(m[:, None] * m[None, :] * K + torch.diag(1.0 - m))
        logpdfs = -0.5 * (
            logdet(masked)[..., None] + torch.sum(m) * _LOG_2_PI + iqf_diag(masked, resid)
        )
        return logpdfs[..., 0] if logpdfs.shape[-1] == 1 else logpdfs

    # -- sampling ---------------------------------------------------------

    def sample(self, generator=None, num=1, noise=None):
        """``num`` samples as the columns of an ``(n, num)`` tensor, drawn
        from ``generator`` (default: the global generator), with ``noise``
        added to the variance's diagonal."""
        var = self.var
        if noise is not None:
            var = add(var, fill_diag(config.as_scalar(noise, var.dtype, var.device), self.dim))
        generator = global_generator() if generator is None else generator
        return mat_sample(generator, var, num=int(num)) + _arr(self.mean)


def _is_symbolic_zero(mean):
    return (isinstance(mean, numbers.Number) and mean == 0) or isinstance(mean, Zero)
