"""Carry hyperparameters and data across from the JAX package.

The JAX package's flagship step takes a dict of scalar arrays
(``{"log_ell": ..., "log_s2": ..., "log_noise": ...}``). Converting that
pytree to numpy (``{k: np.asarray(v) for k, v in params.items()}``) and
through :func:`params_from_jax` gives the port the same numbers, so both
packages compute the same thing. The iterative path's state crosses the
same way: :func:`precond_state_from_jax` takes the numpy arrays of an
eig-preconditioner state ``(U, lam)`` and :func:`variance_cache_from_jax`
those of a ``VarianceCache``. A fitted sparse posterior crosses with
:func:`pseudo_obs_state_from_jax` (the ``K_z``, ``mu`` and ``A`` of a
JAX ``PseudoObs``, installed in a port one's caches). SVGP parameters
cross with :func:`svgp_params_from_jax` (the ``z``, ``q_mu`` and
``q_sqrt`` of ``svgp_init``'s pytree). An optimisation
crosses mid-way with
:func:`vars_from_jax` (the latent values of a JAX ``Vars``) and
:func:`adam_state_from_jax` (optax's Adam state) into
:meth:`~stheno_torch.opt.AdamDriver.load_state`. Nothing here imports JAX.
"""

import numpy as np
import torch

from . import config

__all__ = [
    "params_from_jax",
    "array_from_jax",
    "precond_state_from_jax",
    "variance_cache_from_jax",
    "vars_from_jax",
    "adam_state_from_jax",
    "pseudo_obs_state_from_jax",
    "svgp_params_from_jax",
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


def vars_from_jax(latent, kinds, device=None, dtype=torch.float64):
    """A :class:`~stheno_torch.opt.Vars` with the JAX ``Vars``' latent
    values ``{name: numpy array}`` (``vs.latent_dict()`` through
    ``np.asarray``) and, from ``kinds``, each name's constraint:
    ``"unbounded"``, ``"positive"`` or ``("bounded", lower, upper)``. Its
    constrained values are the JAX ``Vars``'."""
    from .opt.vars import Vars, _Exp, _Identity, _Logistic

    vs = Vars(dtype=dtype, device=device)
    for name, z in latent.items():
        kind = kinds[name]
        if kind == "unbounded":
            bij = _Identity()
        elif kind == "positive":
            bij = _Exp()
        elif isinstance(kind, tuple) and kind[0] == "bounded":
            bij = _Logistic(*kind[1:])
        else:
            raise ValueError(f"Unknown constraint {kind!r} of {name!r}.")
        vs._latent[name] = array_from_jax(z, vs.device, dtype)
        vs._bijections[name] = bij
    return vs


def adam_state_from_jax(mu, nu, count, device=None, dtype=torch.float64):
    """The port's Adam state, ``{name: {"step", "exp_avg", "exp_avg_sq"}}``,
    from optax's ``ScaleByAdamState`` as numpy: ``mu`` and ``nu`` dicts like
    the parameters, ``count`` the number of steps taken."""
    return {
        name: {
            "step": torch.tensor(float(count)),
            "exp_avg": array_from_jax(mu[name], device, dtype),
            "exp_avg_sq": array_from_jax(nu[name], device, dtype),
        }
        for name in mu
    }


def pseudo_obs_state_from_jax(obs, measure, K_z, mu, A, device=None, dtype=None):
    """Install the JAX package's fitted sparse state, the numpy arrays of
    ``obs.K_z(m)``, ``obs.mu(m)`` and ``obs.A(m)`` of a JAX ``PseudoObs``
    (dense), in the port's pseudo-observations ``obs`` for ``measure``:
    conditioning ``measure`` on ``obs`` then predicts with that state.
    Returns ``obs``."""
    from .matrix import Dense

    key = id(measure)
    obs._K_z[key] = Dense(array_from_jax(K_z, device, dtype))
    obs._mu[key] = array_from_jax(mu, device, dtype)
    obs._A[key] = Dense(array_from_jax(A, device, dtype))
    return obs


def svgp_params_from_jax(params, device=None, dtype=None):
    """The port's SVGP parameters ``{"z", "q_mu", "q_sqrt"}`` from the
    numpy arrays of the JAX package's (``svgp_init``'s pytree, or a trained
    one, through ``np.asarray``)."""
    return {k: array_from_jax(params[k], device, dtype) for k in ("z", "q_mu", "q_sqrt")}
