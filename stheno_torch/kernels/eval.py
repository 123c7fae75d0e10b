"""Kernel/mean evaluation entry points.

Counterpart of ``stheno_tpu/kernels/eval.py``: ``pairwise``/``elwise``/
``mean_eval`` normalise inputs (raw arrays are placed on the default
device and upranked to ``(..., n, d)``) and delegate to the expression
objects; ``mean_var``/``mean_var_diag`` are the fused posterior paths
that let ``marginals`` avoid the N x N posterior covariance. A tuple
input (the multi-output form) recurses: ``pairwise`` assembles the block
Gram, ``elwise`` and ``mean_eval`` stack the blocks' columns.
"""

import numbers

import numpy as np
import torch

from .. import config
from ..matrix import block, is_structured
from .kernel import Kernel, SumKernel
from .mean import Mean
from .util import uprank

__all__ = ["pairwise", "elwise", "mean_eval", "mean_var", "mean_var_diag"]


def _is_raw_input(x):
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, numbers.Number, list))


def _process(x):
    """Normalise an input: arrays are upranked to (..., n, d); tuples
    recurse; tagged inputs (FDDs) pass through untouched."""
    if isinstance(x, tuple):
        return tuple(_process(xi) for xi in x)
    if is_structured(x):
        raise TypeError("Structured matrices are not valid kernel inputs.")
    if _is_raw_input(x):
        return uprank(x)
    return x


@config.pin_matmul_precision
def pairwise(k: Kernel, x, y=None):
    """Gram matrix of ``k`` between ``x`` and ``y`` (default ``y = x``),
    returned as a structured matrix."""
    x = _process(x)
    y = x if y is None else _process(y)
    if isinstance(x, tuple) or isinstance(y, tuple):
        xs = x if isinstance(x, tuple) else (x,)
        ys = y if isinstance(y, tuple) else (y,)
        return block([[pairwise(k, xi, yi) for yi in ys] for xi in xs])
    return k._pairwise(x, y)


@config.pin_matmul_precision
def elwise(k: Kernel, x, y=None):
    """Elementwise kernel evaluation ``(..., n, 1)``."""
    x = _process(x)
    y = x if y is None else _process(y)
    if isinstance(x, tuple) or isinstance(y, tuple):
        xs = x if isinstance(x, tuple) else (x,)
        ys = y if isinstance(y, tuple) else (y,)
        if len(xs) != len(ys):
            raise ValueError('"elwise" must be called with similarly sized tuples.')
        return torch.cat([elwise(k, xi, yi) for xi, yi in zip(xs, ys)], dim=-2)
    return k._elwise(x, y)


def mean_eval(m: Mean, x):
    """Evaluate a mean function at ``x`` as a column ``(..., n, 1)``."""
    x = _process(x)
    if isinstance(x, tuple):
        return torch.cat([mean_eval(m, xi) for xi in x], dim=-2)
    return m._eval(x)


def mean_var(m: Mean, k: Kernel, x):
    """Fused (mean, Gram) evaluation; shares work for posterior objects."""
    fused = _match_posterior(m, k)
    if fused is not None:
        return fused.mean_var(x)
    return mean_eval(m, x), pairwise(k, x, x)


def mean_var_diag(m: Mean, k: Kernel, x):
    """Fused (mean, var-diagonal) evaluation: the marginals fast path."""
    fused = _match_posterior(m, k)
    if fused is not None:
        return fused.mean_var_diag(x)
    return mean_eval(m, x), elwise(k, x, x)


def _match_posterior(m, k):
    """Detect the (PosteriorMean, PosteriorKernel [+ SubspaceKernel])
    pattern produced by conditioning, where the K_zx Gram and the K_z
    Cholesky can be shared between mean and variance."""
    from .posterior import FusedPosterior, PosteriorKernel, PosteriorMean, SubspaceKernel

    if not isinstance(m, PosteriorMean):
        return None
    post_k, sub_k = None, None
    if isinstance(k, PosteriorKernel):
        post_k = k
    elif isinstance(k, SumKernel):
        k1, k2 = k.k1, k.k2
        if isinstance(k1, PosteriorKernel) and isinstance(k2, SubspaceKernel):
            post_k, sub_k = k1, k2
        elif isinstance(k2, PosteriorKernel) and isinstance(k1, SubspaceKernel):
            post_k, sub_k = k2, k1
    if post_k is None:
        return None
    if not (m.k_zi is post_k.k_zi and m.z is post_k.z and m.K_z is post_k.K_z):
        return None
    return FusedPosterior(m, post_k, sub_k)
