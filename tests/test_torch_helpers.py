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


class LargestTensor:
    """Context manager that records the largest tensor created by any
    operation run inside it (backward passes included), by the elements
    its storage holds, so that a view, such as an ``expand``, counts as
    the storage under it. ``numel`` is that size and ``op`` the operation
    that made it.

    It is how the tests hold a structured path to never densifying: a
    tensor of N x N elements shows up here, where an attempt to allocate
    one too large to exist could instead succeed under overcommit and then
    end the test worker."""

    def __init__(self):
        self.numel, self.op = 0, None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        owner = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        n = t.untyped_storage().nbytes() // max(t.element_size(), 1)
                        if n > owner.numel:
                            owner.numel, owner.op = n, str(func)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)
