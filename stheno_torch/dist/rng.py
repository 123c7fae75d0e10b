"""Global RNG convenience.

Counterpart of ``stheno_tpu/dist/rng.py``: ``torch.Generator`` objects take
the place of ``jax.random`` keys. The global generator is created lazily,
on the default device, at first use. The two frameworks draw different
numbers from the same seed, so parity tests feed both packages the same
numbers made with numpy.

:func:`set_global_key` and :func:`next_global_key` keep the JAX package's
names: the "key" is the global generator itself, which each draw from it
advances (a generator is its own state, where a key is split)."""

import numbers

import torch

from .. import config

__all__ = ["set_global_seed", "global_generator", "set_global_key", "next_global_key"]

_generator = None


def set_global_seed(seed):
    """Reset the global generator with an integer seed."""
    global _generator
    _generator = torch.Generator(device=config.resolve_device()).manual_seed(int(seed))


def global_generator():
    """The global generator, created with seed 0 at first use."""
    if _generator is None:
        set_global_seed(0)
    return _generator


def set_global_key(seed_or_generator):
    """Set the global generator: an integer seeds a new one on the default
    device, a ``torch.Generator`` is used as it is."""
    global _generator
    if isinstance(seed_or_generator, numbers.Integral):
        set_global_seed(seed_or_generator)
    elif isinstance(seed_or_generator, torch.Generator):
        _generator = seed_or_generator
    else:
        raise TypeError(f"Give a seed or a torch.Generator, not {type(seed_or_generator).__name__}.")


def next_global_key():
    """The global generator, to draw from (a draw advances it)."""
    return global_generator()
