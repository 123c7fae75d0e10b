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
expensive work once.
"""

from ..matrix import add, as_matrix, dense, iqf, iqf_diag, scale, solve
from .kernel import Kernel
from .mean import Mean

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
        self._weights_cache = None

    def _weights(self):
        """``K_z^{-1} (y - m_z(z))``, cached."""
        from .eval import mean_eval

        if self._weights_cache is None:
            resid = self.y - mean_eval(self.m_z, self.z)
            self._weights_cache = solve(self.K_z, resid)
        return self._weights_cache

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

