"""Shared helpers for the parity tests of the PyTorch port
(``tests/test_torch_*.py``). Holds no tests itself.

Each test file imports :func:`torch_cpu` so that it applies to every test
there: the port runs on the CPU (its default device is the card) with one
torch thread, so that several test workers do not oversubscribe the
cores."""

import numpy as np
import pytest
import torch

from stheno_torch import config


@pytest.fixture(autouse=True)
def torch_cpu():
    prev_device, prev_impl, prev_eps = (
        config.default_device,
        config.cholesky_impl,
        config.epsilon,
    )
    torch.set_num_threads(1)
    config.set_default_device("cpu")
    yield
    config.set_default_device(prev_device)
    config.set_cholesky_impl(prev_impl)
    config.set_epsilon(prev_eps)


def np_(t):
    """A tensor (or JAX array) as a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def spd(n, seed, dtype=np.float64):
    """A well-conditioned SPD matrix ``B B^T / n + I``."""
    r = np.random.RandomState(seed)
    B = r.randn(n, n)
    return (B @ B.T / n + np.eye(n)).astype(dtype)


def both_impls(jax_config, impl):
    """Set the dense-Cholesky policy of both packages."""
    jax_config.set_cholesky_impl(impl)
    config.set_cholesky_impl(impl)
