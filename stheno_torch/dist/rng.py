"""Global RNG convenience.

Counterpart of ``stheno_tpu/dist/rng.py``: ``torch.Generator`` objects take
the place of ``jax.random`` keys. The global generator is created lazily,
on the default device, at first use. The two frameworks draw different
numbers from the same seed, so parity tests feed both packages the same
numbers made with numpy."""

import torch

from .. import config

__all__ = ["set_global_seed", "global_generator"]

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
