"""Seeds of the streams one run draws, derived from its ``--seed``.

Every stream (the data, the preconditioner's start block, one step's
probes, the traffic's order, the check's sample) has a seed of its own,
derived from the run's seed and the stream's label, so that the same run
seed gives the same inputs and two streams never share draws.
"""

import zlib

import numpy as np
import torch

__all__ = ["derive", "generator", "numpy_rng"]


def derive(seed, *labels):
    """A 63-bit seed for the stream named by ``labels`` (strings or
    integers) of run seed ``seed`` (any whole number)."""
    key = [zlib.crc32(str(label).encode()) for label in labels]
    words = np.random.SeedSequence(int(seed) % (1 << 64), spawn_key=key).generate_state(2)
    return (int(words[0]) << 31 ^ int(words[1])) & ((1 << 63) - 1)


def generator(device, seed, *labels):
    """A ``torch.Generator`` on ``device`` seeded for the stream ``labels``."""
    return torch.Generator(device=device).manual_seed(derive(seed, *labels))


def numpy_rng(seed, *labels):
    """A numpy ``Generator`` for the stream ``labels`` (host-side traffic)."""
    return np.random.default_rng(derive(seed, *labels))
