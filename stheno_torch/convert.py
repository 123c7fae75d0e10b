"""Carry hyperparameters and data across from the JAX package.

The JAX package's flagship step takes a dict of scalar arrays
(``{"log_ell": ..., "log_s2": ..., "log_noise": ...}``). Converting that
pytree to numpy (``{k: np.asarray(v) for k, v in params.items()}``) and
through :func:`params_from_jax` gives the port the same numbers, so both
packages compute the same thing. The iterative path's state crosses the
same way: :func:`precond_state_from_jax` takes the numpy arrays of an
eig-preconditioner state ``(U, lam)`` and :func:`variance_cache_from_jax`
those of a ``VarianceCache``. Nothing here imports JAX.
"""

import numpy as np
import torch

from . import config

__all__ = [
    "params_from_jax",
    "array_from_jax",
    "precond_state_from_jax",
    "variance_cache_from_jax",
]


def array_from_jax(a, device=None, dtype=None):
    """A numpy array (e.g. ``np.asarray`` of a JAX array) as a tensor on
    ``device`` (default: ``config.default_device``)."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=config.resolve_device(device))


def params_from_jax(params, device=None, dtype=None):
    """``{name: tensor}`` from ``{name: numpy array}``."""
    return {k: array_from_jax(v, device, dtype) for k, v in params.items()}


def precond_state_from_jax(state, device=None, dtype=None):
    """An eig-preconditioner state ``(U, lam)`` from its numpy arrays."""
    U, lam = state
    return array_from_jax(U, device, dtype), array_from_jax(lam, device, dtype)


def variance_cache_from_jax(cache, device=None, dtype=None):
    """A :class:`~stheno_torch.iterative.VarianceCache` from the numpy
    arrays of the JAX package's (fields ``U, S, M, noise, tau``, in
    order)."""
    from .iterative import VarianceCache

    return VarianceCache(*(array_from_jax(a, device, dtype) for a in cache))
