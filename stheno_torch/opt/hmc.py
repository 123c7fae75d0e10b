"""Hamiltonian Monte Carlo over kernel hyperparameters.

Counterpart of ``stheno_tpu/opt/hmc.py``: leapfrog integration with the
gradient threaded through the carry and dual-averaging step-size
adaptation during warm-up. The JAX package runs its chains under ``vmap``
(sharded over a mesh when given one); here they run one after another,
since ``vmap`` cannot pass through the ctypes kernels, and the sampler is
host-driven (``_flat.Target``). Randomness comes from an explicit CPU
``torch.Generator`` where the JAX package takes a key: the two packages
draw different numbers, so they agree in distribution, not draw by draw.
"""

import math

import torch

from ._flat import Target

__all__ = ["sample_hmc"]


def _leapfrog(target, q, p, step_size, n_steps):
    """Leapfrog with the gradient threaded through the carry: n_steps + 1
    gradient evaluations, not 2 * n_steps (the end-of-step gradient is the
    next step's start-of-step gradient). Returns ``(q, p, logpdf(q))``."""
    logp, g = target.value_and_grad(q)
    for _ in range(n_steps):
        p = p + 0.5 * step_size * g
        q = q + step_size * p
        logp, g = target.value_and_grad(q)
        p = p + 0.5 * step_size * g
    return q, p, logp


def _kinetic(p):
    return 0.5 * float(torch.dot(p, p))


def _hmc_step(target, step_size, n_leapfrog, q, logp, gen):
    p = torch.randn(q.shape, generator=gen, dtype=q.dtype)
    u = float(torch.rand((), generator=gen, dtype=torch.float64))
    q_new, p_new, logp_new = _leapfrog(target, q, p, step_size, n_leapfrog)
    log_accept = (logp_new - _kinetic(p_new)) - (logp - _kinetic(p))
    if math.isnan(log_accept):
        log_accept = -math.inf
    if math.log(u) < log_accept:
        q, logp = q_new, logp_new
    return q, logp, math.exp(min(log_accept, 0.0))


def _single_chain(target, init, gen, num_samples, num_warmup, step_size0, n_leapfrog,
                  target_accept):
    q = init
    logp, _ = target.value_and_grad(q)

    # Warm-up with dual-averaging step-size adaptation (Hoffman & Gelman
    # 2014, Algorithm 5).
    mu = math.log(10 * step_size0)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    log_eps = log_eps_bar = math.log(step_size0)
    h_bar = t = 0.0
    for _ in range(num_warmup):
        q, logp, accept_prob = _hmc_step(target, math.exp(log_eps), n_leapfrog, q, logp, gen)
        t += 1.0
        eta = 1.0 / (t + t0)
        h_bar = (1 - eta) * h_bar + eta * (target_accept - accept_prob)
        log_eps = mu - math.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
    step_size = math.exp(log_eps_bar)

    qs, logps, accepts = [], [], []
    for _ in range(num_samples):
        q, logp, accept_prob = _hmc_step(target, step_size, n_leapfrog, q, logp, gen)
        qs.append(q)
        logps.append(logp)
        accepts.append(accept_prob)
    return torch.stack(qs), torch.tensor(logps, dtype=q.dtype), sum(accepts) / max(len(accepts), 1)


def sample_hmc(
    logpdf,
    init,
    generator,
    *,
    num_samples=500,
    num_warmup=200,
    step_size=0.1,
    n_leapfrog=16,
    num_chains=1,
    target_accept=0.8,
    mesh=None,
    chain_axis="chains",
):
    """Run HMC.

    Args:
        logpdf: callable ``{name: tensor} -> scalar`` log-density (e.g.
            the log marginal likelihood plus a prior).
        init: initial parameters, a dict of tensors (one chain); chains
            start from ``init`` jittered by 0.1 standard normals.
        generator: a CPU ``torch.Generator``.
        num_chains: chains, run one after another.
        mesh, chain_axis: chains over several devices are not ported
            (``ROADMAP.md`` queue 1 item 12); a mesh raises.

    Returns:
        ``(samples, logps, accept_rate)``: ``samples`` a dict of tensors of
        shape ``(num_chains, num_samples, ...)`` on the parameters' device,
        ``logps`` ``(num_chains, num_samples)``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sample_hmc: chains over a device mesh are not ported yet (ROADMAP.md, queue 1 "
            "item 12); the chains run one after another on one device."
        )
    target = Target(logpdf, init)
    inits = target.q0 + 0.1 * torch.randn(
        (num_chains, target.dim), generator=generator, dtype=target.dtype
    )
    runs = [
        _single_chain(target, inits[c], generator, num_samples, num_warmup, step_size,
                      n_leapfrog, target_accept)
        for c in range(num_chains)
    ]
    qs = torch.stack([r[0] for r in runs])
    logps = torch.stack([r[1] for r in runs]).to(target.device)
    accept = sum(r[2] for r in runs) / num_chains
    return target.samples(qs), logps, float(accept)
