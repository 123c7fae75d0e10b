"""Carry hyperparameters and data across from the JAX package.

The JAX package's flagship step takes a dict of scalar arrays
(``{"log_ell": ..., "log_s2": ..., "log_noise": ...}``). Converting that
pytree to numpy (``{k: np.asarray(v) for k, v in params.items()}``) and
through :func:`params_from_jax` gives the port the same numbers, so both
packages compute the same thing. Nothing here imports JAX.
"""

import numpy as np
import torch

from . import config

__all__ = ["params_from_jax", "array_from_jax"]


def array_from_jax(a, device=None, dtype=None):
    """A numpy array (e.g. ``np.asarray`` of a JAX array) as a tensor on
    ``device`` (default: ``config.default_device``)."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=config.resolve_device(device))


def params_from_jax(params, device=None, dtype=None):
    """``{name: tensor}`` from ``{name: numpy array}``."""
    return {k: array_from_jax(v, device, dtype) for k, v in params.items()}
