"""Closed-form posterior kernel/mean objects.

Counterpart of ``stheno_tpu/kernels/posterior.py``:

- ``PosteriorKernel(k_ij, k_zi, k_zj, z, K_z)``:
      ``k(x, y) = k_ij(x, y) - k_zi(z, x)^T K_z^{-1} k_zj(z, y)``
- ``SubspaceKernel(k_zi, k_zj, z, A)``:
      ``k(x, y) = k_zi(z, x)^T A^{-1} k_zj(z, y)``
- ``PosteriorMean(m_i, m_z, k_zi, z, K_z, y)``:
      ``m(x) = m_i(x) + k_zi(z, x)^T K_z^{-1} (y - m_z(z))``

The weight vector ``K_z^{-1} (y - m_z(z))`` is cached on the mean, and the
``K_z`` Cholesky on ``K_z`` itself (keyed on the jitter settings), so
repeated predictions and the fused ``mean_var_diag`` path do the
expensive work once. The weights are kept only where they hold no
autograd graph and no CUDA graph capture made them
(``matrix/ops.py:_cached_if_constant``), under the jitter settings and the
grad mode.

Each object also has ``_scalar``, the one-pair form that
``DerivativeKernel``/``DerivativeMean`` differentiate under
``torch.func``. There the row ``k_zi(z, x)`` comes from ``k_zi._scalar``
mapped over the rows of ``z`` (``pairwise`` would reach the CUDA kernels,
which ``torch.func`` cannot batch), and the quadratic form is a product
with the inverse of the Cholesky factor of ``K_z`` (or ``A``): a batched
product folds the mapped points into the columns of one product, where
the batching rule of a triangular solve copies the factor once per point
(64 GB at 2000 points of 2000). The inverse factor and the mean's
weights (``_scalar_inputs``) are made outside the transform, for one
evaluation, by :func:`~stheno_torch.kernels.kernel.prime_scalar`, which
the derivative objects enter around theirs: a tensor made inside a
transform is a wrapper of it, and must outlive neither the transform nor
the grad mode, jitter and capture it was made under. The inverse factor
is kept in the matrix's cache by the weights' rule.
"""

import torch

from .. import config
from ..matrix import add, as_matrix, cholesky, dense, eye_like, iqf, iqf_diag, scale, solve
from ..matrix.ops import _cached_if_constant
from .kernel import Kernel
from .mean import Mean
from .util import uprank


def _jitter_key(name):
    return (name, config.epsilon, config.adaptive_jitter)


def _inv_factor(mat):
    """``L^{-1}``, dense, for ``L`` the library's jittered Cholesky factor
    of ``mat``."""
    return _cached_if_constant(mat, _jitter_key("scalar_inv_factor"),
                               lambda: (dense(solve(cholesky(mat), eye_like(mat))),))[0]


def _primed(obj):
    """``obj._scalar_inputs()`` as ``prime_scalar`` left it for the
    evaluation under way; made now outside a ``torch.func`` transform."""
    value = obj.__dict__.get("_scalar_primed")
    if value is not None:
        return value
    if torch._C._functorch.peek_interpreter_stack() is not None:
        raise RuntimeError(
            f"{type(obj).__name__}._scalar under a torch.func transform needs its inputs made "
            "outside it: run the transform inside kernels.kernel.prime_scalar(obj)."
        )
    return obj._scalar_inputs()


def _row(k, z, x):
    """``k(z_i, x)`` for each row ``z_i`` of ``z``: a vector ``(m,)``."""
    from torch.func import vmap

    z = uprank(z)
    if z.ndim != 2:
        raise NotImplementedError("Scalar evaluation of a posterior needs unbatched inputs.")
    return vmap(lambda zi: k._scalar(zi, x))(z)


def _iqf_scalar(Linv, a, b):
    """``a^T (L L^T)^{-1} b`` for vectors ``a`` and ``b``."""
    return torch.sum((Linv @ a) * (Linv @ b))

__all__ = ["PosteriorKernel", "SubspaceKernel", "PosteriorMean", "FusedPosterior"]


def _k_zx_zy(k_zi, k_zj, z, x, y):
    from .eval import pairwise

    K_zx = pairwise(k_zi, z, x)
    K_zy = K_zx if (y is x and k_zj is k_zi) else pairwise(k_zj, z, y)
    return K_zx, K_zy


class PosteriorKernel(Kernel):
    def __init__(self, k_ij, k_zi, k_zj, z, K_z):
        self.k_ij = k_ij
        self.k_zi = k_zi
        self.k_zj = k_zj
        self.z = z
        self.K_z = as_matrix(K_z)

    def _pairwise(self, x, y):
        from .eval import pairwise

        K_zx, K_zy = _k_zx_zy(self.k_zi, self.k_zj, self.z, x, y)
        correction = iqf(self.K_z, dense(K_zx), dense(K_zy))
        return add(pairwise(self.k_ij, x, y), scale(correction, -1))

    def _elwise(self, x, y):
        from .eval import elwise

        K_zx, K_zy = _k_zx_zy(self.k_zi, self.k_zj, self.z, x, y)
        correction = iqf_diag(self.K_z, dense(K_zx), dense(K_zy))
        return elwise(self.k_ij, x, y) - correction[..., :, None]

    def _scalar_inputs(self):
        return _inv_factor(self.K_z)

    def _scalar(self, x, y):
        Linv = _primed(self)
        corr = _iqf_scalar(Linv, _row(self.k_zi, self.z, x), _row(self.k_zj, self.z, y))
        return self.k_ij._scalar(x, y) - corr

    def _render(self, formatter):
        return f"PosteriorKernel({self.k_ij.display(formatter)})"


class SubspaceKernel(Kernel):
    def __init__(self, k_zi, k_zj, z, A):
        self.k_zi = k_zi
        self.k_zj = k_zj
        self.z = z
        self.A = as_matrix(A)

    def _pairwise(self, x, y):
        K_zx, K_zy = _k_zx_zy(self.k_zi, self.k_zj, self.z, x, y)
        return iqf(self.A, dense(K_zx), dense(K_zy))

    def _elwise(self, x, y):
        K_zx, K_zy = _k_zx_zy(self.k_zi, self.k_zj, self.z, x, y)
        return iqf_diag(self.A, dense(K_zx), dense(K_zy))[..., :, None]

    def _scalar_inputs(self):
        return _inv_factor(self.A)

    def _scalar(self, x, y):
        Linv = _primed(self)
        return _iqf_scalar(Linv, _row(self.k_zi, self.z, x), _row(self.k_zj, self.z, y))

    def _render(self, formatter):
        return f"SubspaceKernel({self.k_zi.display(formatter)})"


class PosteriorMean(Mean):
    def __init__(self, m_i, m_z, k_zi, z, K_z, y):
        self.m_i = m_i
        self.m_z = m_z
        self.k_zi = k_zi
        self.z = z
        self.K_z = as_matrix(K_z)
        self.y = y
        self._cache = {}

    def _weights(self):
        """``K_z^{-1} (y - m_z(z))``, cached where it is constant."""
        from .eval import mean_eval

        return _cached_if_constant(
            self, _jitter_key("weights"),
            lambda: (solve(self.K_z, self.y - mean_eval(self.m_z, self.z)),))[0]

    def _scalar_inputs(self):
        return self._weights()

    def _scalar(self, x):
        w = _primed(self)
        return self.m_i._scalar(x) + torch.sum(_row(self.k_zi, self.z, x) * w.reshape(-1))

    def _eval(self, x):
        from .eval import mean_eval, pairwise

        K_zx = dense(pairwise(self.k_zi, self.z, x))
        return mean_eval(self.m_i, x) + K_zx.transpose(-1, -2) @ self._weights()

    def _render(self, formatter):
        return f"PosteriorMean({self.m_i.display(formatter)})"


class FusedPosterior:
    """Shares the ``K_zx`` Gram between the posterior mean and (co)variance."""

    def __init__(self, mean: PosteriorMean, post_k: PosteriorKernel, sub_k):
        self.mean = mean
        self.post_k = post_k
        self.sub_k = sub_k

    def _pieces(self, x):
        from .eval import pairwise

        K_zx = dense(pairwise(self.post_k.k_zi, self.post_k.z, x))
        mean = self.mean.m_i(x) + K_zx.transpose(-1, -2) @ self.mean._weights()
        return K_zx, mean

    def mean_var(self, x):
        from .eval import pairwise

        K_zx, mean = self._pieces(x)
        var = add(pairwise(self.post_k.k_ij, x, x), scale(iqf(self.post_k.K_z, K_zx), -1))
        if self.sub_k is not None:
            var = add(var, iqf(self.sub_k.A, K_zx))
        return mean, var

    def mean_var_diag(self, x):
        from .eval import elwise

        K_zx, mean = self._pieces(x)
        var_diag = elwise(self.post_k.k_ij, x, x) - iqf_diag(self.post_k.K_z, K_zx)[..., :, None]
        if self.sub_k is not None:
            var_diag = var_diag + iqf_diag(self.sub_k.A, K_zx)[..., :, None]
        return mean, var_diag

