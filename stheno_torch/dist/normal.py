"""Multivariate normal over structured matrices with lazy mean/variance.

Counterpart of ``stheno_tpu/dist/normal.py``: lazy thunks with the
``var_diag``/``mean_var``/``mean_var_diag`` fast paths (so ``marginals``
of a posterior never forms the N x N covariance), ``logpdf`` with
batching, NaN-dropped missing data and a boolean ``mask`` that keeps a
Diagonal, Woodbury or LowRank variance structured (and a Kronecker one
under a mask of one boolean vector per factor), ``entropy``, ``kl``,
``w2``, the second moment, the affine arithmetic, ``cast``, and
``sample`` from a ``torch.Generator``.
"""

import math
import numbers

import numpy as np
import torch

from .. import config
from ..matrix import (
    AbstractMatrix,
    Diagonal,
    Kronecker,
    LowRank,
    Woodbury,
    Zero,
    add,
    as_matrix,
    dense,
    diag_of,
    fill_diag,
    iqf_diag,
    is_structured,
    logdet,
    matmul,
    matmul3,
    ratio,
    root,
    scale,
    submatrix,
    trace,
)
from ..matrix import sample as mat_sample
from ..utils.display import indented_kv
from .rng import global_generator

__all__ = ["Random", "RandomProcess", "RandomVector", "Normal"]

_LOG_2_PI = math.log(2 * math.pi)


class Random:
    """A random object, with arithmetic sugar."""

    def __radd__(self, other):
        return self + other

    def __rmul__(self, other):
        return self * other

    def __neg__(self):
        return -1 * self

    def __sub__(self, other):
        return self + (-other)

    def __rsub__(self, other):
        return (-self) + other

    def __truediv__(self, other):
        return self * (1 / other)


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

    def _resolve_mean(self, construct_zeros=True):
        if self._mean is None:
            self._mean = self._construct_mean()
        if _is_symbolic_zero(self._mean) and construct_zeros:
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
    def mean_is_zero(self):
        """Whether the mean is zero: symbolically, or by value where reading
        it needs no host sync that a graph capture forbids."""
        self._resolve_mean(construct_zeros=False)
        return _is_zero(self._mean)

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

    @property
    def m2(self):
        """Second moment."""
        mean = _arr(self.mean)
        return add(self.var, matmul(mean, mean, tr_b=True))

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

    def diagonalise(self):
        """Drop the correlations: keep only the marginal variances."""
        return Normal(self.mean, Diagonal(_arr(self.var_diag)[..., 0]))

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
        nothing to the log-determinant or the quadratic form. Structure is
        kept where a closed form exists: a Diagonal stays diagonal; a
        Woodbury stays a Woodbury (its factors' masked rows zeroed); a
        LowRank becomes a Woodbury whose diagonal is the dense path's
        jitter; a Kronecker under a mask of one boolean vector per factor,
        ``mask=(mask_left, mask_right)``, takes
        :meth:`_masked_logpdf_kron`. Any other variance, and a Kronecker
        under a mask that does not factor, is masked densely."""
        var = self.var
        if isinstance(mask, tuple):
            if isinstance(var, Kronecker) and len(mask) == 2:
                return self._masked_logpdf_kron(x, mask[0], mask[1])
            m_full = config.as_tensor(mask[0])
            for part in mask[1:]:
                m_full = torch.kron(m_full, config.as_tensor(part))
            mask = m_full
        m = config.as_tensor(mask).to(device=x.device, dtype=x.dtype)
        resid = m[:, None] * torch.nan_to_num(x - _arr(self.mean))
        if isinstance(var, Diagonal):
            masked = Diagonal(m * var.diag + (1.0 - m))
        elif isinstance(var, Woodbury):
            lr = var.lr
            masked = Woodbury(
                Diagonal(m * var.diag.diag + (1.0 - m)),
                LowRank(m[:, None] * lr.left, None if lr.right is None else m[:, None] * lr.right,
                        middle=lr.middle),
            )
        elif isinstance(var, LowRank):
            # A degenerate variance: the dense path factors masked + eps I;
            # fold the same eps into a Woodbury diagonal, so that the
            # closed forms run on the same regularised matrix. Its
            # quadratic form differences O(1/eps) terms when the residual
            # lies in the low-rank range: a float64 path.
            eps = config.jitter(x.dtype)
            masked = Woodbury(
                Diagonal(eps * m + (1.0 - m)),
                LowRank(m[:, None] * var.left, None if var.right is None else m[:, None] * var.right,
                        middle=var.middle),
            )
        else:
            K = dense(var)
            masked = as_matrix(m[:, None] * m[None, :] * K + torch.diag(1.0 - m))
        logpdfs = -0.5 * (
            logdet(masked)[..., None] + torch.sum(m) * _LOG_2_PI + iqf_diag(masked, resid)
        )
        return logpdfs[..., 0] if logpdfs.shape[-1] == 1 else logpdfs

    def _masked_logpdf_kron(self, x, mask_a, mask_b):
        """Masked logpdf of a Kronecker variance ``A kron B`` under the mask
        ``kron(mask_a, mask_b)`` (whole rows or columns of the grid observed
        or missing). The observed submatrix is ``A_obs kron B_obs``: each
        factor is masked with ones on its diagonal (so its inverse,
        restricted to the observed rows, is the observed factor's), the
        log-determinant is ``n_b_obs logdet(A_obs) + n_a_obs logdet(B_obs)``
        and the quadratic form runs through the Kronecker solve."""
        var = self.var
        ma = config.as_tensor(mask_a).to(device=x.device, dtype=x.dtype)
        mb = config.as_tensor(mask_b).to(device=x.device, dtype=x.dtype)
        m = torch.kron(ma, mb)
        resid = m[:, None] * torch.nan_to_num(x - _arr(self.mean))
        A, B = dense(var.left), dense(var.right)
        mA = as_matrix(ma[:, None] * ma[None, :] * A + torch.diag(1.0 - ma))
        mB = as_matrix(mb[:, None] * mb[None, :] * B + torch.diag(1.0 - mb))
        na_obs, nb_obs = torch.sum(ma), torch.sum(mb)
        ld = nb_obs * logdet(mA) + na_obs * logdet(mB)
        logpdfs = -0.5 * (
            ld[..., None] + na_obs * nb_obs * _LOG_2_PI + iqf_diag(Kronecker(mA, mB), resid)
        )
        return logpdfs[..., 0] if logpdfs.shape[-1] == 1 else logpdfs

    def entropy(self):
        return 0.5 * (logdet(self.var) + self.dim * (_LOG_2_PI + 1))

    def kl(self, other):
        """KL divergence ``KL(self || other)``."""
        mean_diff = _arr(other.mean) - _arr(self.mean)
        return 0.5 * (
            iqf_diag(other.var, mean_diff)[..., 0]
            + ratio(self.var, other.var)
            + logdet(other.var)
            - logdet(self.var)
            - self.dim
        )

    def w2(self, other):
        """2-Wasserstein distance."""
        var_root = root(self.var)
        inner = root(matmul3(var_root, other.var, var_root))
        var_part = trace(self.var) + trace(other.var) - 2 * trace(inner)
        mean_part = torch.sum((_arr(self.mean) - _arr(other.mean)) ** 2)
        return torch.sqrt(torch.clamp_min(mean_part + var_part, 0))

    # -- sampling ---------------------------------------------------------

    def sample(self, *args, generator=None, num=None, noise=None):
        """Samples as the columns of an ``(n, num)`` tensor, with ``noise``
        added to the variance's diagonal.

        Functional form, the JAX package's with a key: ``state, s =
        dist.sample(gen[, num])`` with a ``torch.Generator`` first returns
        that generator (advanced by the draw) and the samples. Keyword
        form: ``s = dist.sample([num,] generator=gen)`` returns the
        samples only; without a generator it draws from the global one."""
        functional = bool(args) and isinstance(args[0], torch.Generator)
        if functional:
            if generator is not None:
                raise TypeError("Give the generator once: first, or as generator=.")
            generator, args = args[0], args[1:]
        if len(args) > 1 or (args and num is not None):
            raise TypeError("sample() takes at most (generator, num).")
        num = int(args[0]) if args else (1 if num is None else int(num))
        var = self.var
        if noise is not None:
            var = add(var, fill_diag(config.as_scalar(noise, var.dtype, var.device), self.dim))
        s = mat_sample(global_generator() if generator is None else generator, var, num=num)
        s = s + _arr(self.mean)
        return (generator, s) if functional else s

    # -- affine arithmetic -------------------------------------------------

    def __add__(self, other):
        if isinstance(other, Normal):
            return Normal(_arr(self.mean) + _arr(other.mean), add(self.var, other.var))
        if isinstance(other, Random):
            raise NotImplementedError(f"Cannot add a Normal and a {type(other).__name__}.")
        other = config.as_tensor(other)
        if other.ndim == 1:
            # The mean is a column (n, 1): a 1-D shift would broadcast to
            # (n, n).
            other = other[:, None]
        return Normal(_arr(self.mean) + other, self.var)

    def __mul__(self, other):
        if isinstance(other, Random):
            raise NotImplementedError("Cannot multiply two random variables.")
        if is_structured(other) or np.ndim(other) > 0:
            raise NotImplementedError(
                "Can only multiply a Normal by a scalar; use lmatmul/rmatmul "
                "for matrix transforms."
            )
        return Normal(_arr(self.mean) * other, scale(self.var, other * other))

    def lmatmul(self, a):
        """Distribution of ``a @ self``."""
        return Normal(matmul(a, _arr(self.mean)), matmul3(a, self.var, a, tr_c=True))

    def rmatmul(self, a):
        """Distribution of ``a^T @ self``."""
        return Normal(matmul(a, _arr(self.mean), tr_a=True), matmul3(a, self.var, a, tr_a=True))

    def cast(self, dtype):
        """Mean and variance cast to ``dtype``."""
        return Normal(_arr(self.mean).to(dtype), _cast_matrix(self.var, dtype))

    # -- display ----------------------------------------------------------

    def _render(self, fmt):
        # Lazy thunks show as "unresolved": printing must not force them.
        mean = "unresolved" if self._mean is None else fmt(self._mean)
        var = "unresolved" if self._var is None else fmt(self._var)
        return (
            "<Normal:\n"
            + indented_kv("mean", mean, suffix=",\n")
            + indented_kv("var", var, suffix=">")
        )

    def __str__(self):
        return self._render(str)

    def __repr__(self):
        return self._render(repr)


def _is_symbolic_zero(mean):
    return (isinstance(mean, numbers.Number) and mean == 0) or isinstance(mean, Zero)


def _is_zero(mean):
    """Zero symbolically, or by value where reading it on the host is
    allowed (not while a CUDA graph is captured)."""
    if _is_symbolic_zero(mean):
        return True
    if isinstance(mean, torch.Tensor) and not config.capturing():
        return bool((mean == 0).all())
    return False


def _cast_matrix(a, dtype):
    """A structured matrix with every floating tensor it holds cast to
    ``dtype``."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype) if a.is_floating_point() else a
    if isinstance(a, Zero):
        return Zero(dtype, a.rows, a.cols, device=a.device)
    if not isinstance(a, AbstractMatrix):
        return a
    out = object.__new__(type(a))
    out.__dict__.update({k: _cast_matrix(v, dtype) for k, v in a.__dict__.items()
                         if k != "_cache"})
    out._cache = {}
    return out
