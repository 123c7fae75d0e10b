"""Functional gradient transformations: the port's counterpart of the
optax transformations that the JAX package's users pass in
(``resumable_minimise``'s ``optimizer``, examples 14-16).

Each transformation has ``init(params) -> state`` and ``update(grads,
state, params=None) -> (updates, state)`` and works on any pytree of
tensors that ``torch.utils._pytree`` knows (dicts, lists, tuples,
namedtuples); :func:`apply_updates` adds the updates to the parameters.
Nothing is updated in place: a state passed in stays as it was, so a
caller may keep it as a rollback anchor.

The states have optax's layout, field names and dtypes: Adam's is
``(ScaleByAdamState(count, mu, nu), EmptyState())`` with an int32
``count``, SGD's ``(EmptyState(), EmptyState())``. So the key paths of a
state (``torch.utils._pytree.keystr``) are those of the JAX package's
(``[0].count``, ``[0].mu['w']``, ...), and a checkpoint of one loads as
the other (``stheno_torch.utils.checkpoint``)."""

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

__all__ = [
    "GradientTransformation",
    "ScaleByAdamState",
    "EmptyState",
    "adam",
    "sgd",
    "apply_updates",
]


class EmptyState(NamedTuple):
    """The state of a stateless transformation."""


class ScaleByAdamState(NamedTuple):
    """Adam's state: the step count (int32) and the two moments."""

    count: Any
    mu: Any
    nu: Any


class GradientTransformation(NamedTuple):
    """A pair of pure functions, ``init`` and ``update``."""

    init: Any
    update: Any


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """optax's ``adam``: ``scale_by_adam`` then ``-learning_rate``.

    The update is ``-lr * mu_hat / (sqrt(nu_hat + eps_root) + eps)`` with
    ``mu_hat = mu / (1 - b1^t)`` and ``nu_hat = nu / (1 - b2^t)``, ``t``
    the count after the increment, as ``optax.scale_by_adam`` computes it."""

    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(_tensor(p)), params)
        first = tree_leaves(mu)
        count = torch.zeros((), dtype=torch.int32, device=first[0].device if first else None)
        return ScaleByAdamState(count, mu, tree_map(torch.zeros_like, mu)), EmptyState()

    def update(grads, state, params=None):
        del params
        s, empty = state
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, s.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, s.nu)
        count = s.count + 1
        t = count.to(torch.float64)
        updates = tree_map(
            lambda m, v: -learning_rate * (
                (m / (1 - b1 ** t).to(m.dtype))
                / (torch.sqrt(v / (1 - b2 ** t).to(v.dtype) + eps_root) + eps)
            ),
            mu, nu,
        )
        return updates, (ScaleByAdamState(count, mu, nu), empty)

    return GradientTransformation(init, update)


def sgd(learning_rate):
    """optax's ``sgd`` without momentum: the update is ``-lr * g``."""

    def init(params):
        del params
        return EmptyState(), EmptyState()

    def update(grads, state, params=None):
        del params
        return tree_map(lambda g: -learning_rate * g, grads), state

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """``params + updates``, leaf by leaf, in each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)

