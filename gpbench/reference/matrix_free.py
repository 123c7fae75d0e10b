"""Plain float64 reference of the matrix-free exact GP
(``configs/eq-mf262k.json``), and the preconditioner that the benchmark
hands to both sides.

The configuration states a rank-``precond_rank`` eig preconditioner ``P =
noise I + U diag(lam) U^T``. An estimator's realisation at given probes
moves with ``P`` (it is unbiased for any ``P``), and a CG stopped at the
configuration's tolerance leaves an error that ``P`` shapes, so both sides
must run on one ``P``. :func:`precond_input` builds it from the run's seed
with this module's plain float64 code (randomized subspace iteration from
a seeded start block) and rounds it to the configuration's float32: the
program takes it as ``precond_state`` in set-up, and the reference takes
the same numbers as an input, as it takes ``x`` and ``y``. Nothing of the
program's making enters the reference.

- Training steps (``step_gap``): the same stochastic estimator of the NLML
  and its gradient (Gardner et al. 2018; Wang et al. 2019) in float64 on
  ``P``: the step's probes ``u`` from its own seed, CG on the whitened
  ``P^-1/2 A P^-1/2`` (``A = K + noise I``) for ``[P^-1/2 y, u]`` to the
  configuration's tolerance, ``log det P`` plus the Lanczos quadrature
  from CG's coefficients, and the gradient of the Hutchinson surrogate
  ``0.5 (mean_i U_i^T A w_i - alpha^T A alpha)`` (``U = P^-1/2 X_u``, ``w =
  P^-1/2 u``, ``alpha = P^-1/2 X_y``), the solves held constant. The gap is
  the step's worst component: the value against its size, each gradient
  against the larger of its size and the median's.
"""

import math

import numpy as np
import torch

from ..harness import seeds
from ..harness import traffic as trafficmod
from . import cg as cgmod
from . import gram

__all__ = ["check", "step", "precond_state", "precond_input"]

#: Bytes of one float64 row block of the Gram while the input is built in
#: set-up (small, so that it does not set the run's memory peak).
INPUT_BLOCK_BYTES = 1 << 28


def _seeded(device, seed_value):
    return torch.Generator(device=device).manual_seed(seed_value)


def precond_state(config, x, s2, ell, om, block_bytes=None):
    """``(U, lam)`` from the start block ``om``, as the configuration
    states the preconditioner."""
    return cgmod.eig_factors(lambda V: gram.matmul(x, V, s2, ell, block_bytes), om,
                             config["precond_power_iters"])


def precond_input(config, x, seed):
    """The run's preconditioner ``(U, lam)`` over the rows ``x`` (float32
    on its device): built in float64 from the start block of the seed's
    ``precond`` stream, then rounded to ``x``'s dtype."""
    with torch.no_grad():
        om = torch.randn((x.shape[0], config["precond_rank"]),
                         generator=seeds.generator(x.device, seed, "precond"),
                         dtype=torch.float64, device=x.device)
        U, lam = precond_state(config, x.double(), math.exp(config["log_s2"]),
                               math.exp(config["log_ell"]), om, INPUT_BLOCK_BYTES)
    return U.to(x.dtype), lam.to(x.dtype)


def step(config, x, y, state, u):
    """``(value, (d/dlog s2, d/dlog ell))`` of the estimator at probes ``u``."""
    n, p = u.shape
    noise, s2, ell = config["noise"], math.exp(config["log_s2"]), math.exp(config["log_ell"])
    half_inv, logdet_p = cgmod.eig_precond(*state, noise, n)

    def whitened(V):
        W = half_inv(V)
        return half_inv(gram.matmul(x, W, s2, ell) + noise * W)

    rhs = torch.cat([half_inv(y[:, None]), u], dim=1)
    sol, _, (alphas, betas, steps) = cgmod.cg(
        whitened, rhs, config["cg_tol"], config["max_cg_iters"], track=config["slq_steps"])
    alpha = half_inv(sol[:, :1])[:, 0]
    U = half_inv(sol[:, 1:])
    w = half_inv(u)
    logdet = logdet_p + cgmod.quadrature_logdet(alphas[:, 1:], betas[:, 1:], steps[1:],
                                                torch.sum(u * u, dim=0))
    value = 0.5 * (logdet + torch.dot(y, alpha) + n * math.log(2 * math.pi))
    A = 0.5 * torch.cat([U / p, -alpha[:, None]], dim=1)
    V = torch.cat([w, alpha[:, None]], dim=1)
    return float(value), tuple(float(g) for g in gram.bilinear_grads(x, A, V, s2, ell))


def check(config, traffic, seed, inputs, answers, device):
    x, y = inputs["x"].double(), inputs["y"].double()
    state = tuple(t.double() for t in inputs["state"])
    with torch.no_grad():
        return _check_steps(config, seed, x, y, state, answers, device)


def _check_steps(config, seed, x, y, state, answers, device):
    if not answers["steps"]:
        return {"step_gap": math.inf}
    gap = 0.0
    for a in answers["steps"]:
        gen = _seeded(device, trafficmod.probe_seed(seed, a["step"]))
        u = torch.randn((x.shape[0], config["num_probes"]), generator=gen, dtype=torch.float32,
                        device=device).double()
        value, grads = step(config, x, y, state, u)
        gap = max(gap, abs(a["value"] - value) / abs(value))
        scale = max(float(np.median(np.abs(grads))), 1e-300)
        for g_p, g_r in zip(a["grads"], grads):
            gap = max(gap, abs(g_p - g_r) / max(abs(g_r), scale))
    return {"step_gap": gap}
