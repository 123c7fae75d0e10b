"""Hamiltonian Monte Carlo over kernel hyperparameters.

Counterpart of ``stheno_tpu/opt/hmc.py``: leapfrog integration with the
gradient threaded through the carry and dual-averaging step-size
adaptation during warm-up. The JAX package runs its chains under ``vmap``
(sharded over a mesh when given one); here the sampler is host-driven and
each chain a coroutine (``_flat``): the chains run together, each round's
leapfrog steps evaluated in one batch and read back once
(``_flat.Target.batch_value_and_grad``); with a mesh, each rank runs its
share of the chains so (``_flat.run_chains``). Randomness comes from an explicit CPU
``torch.Generator`` where the JAX package takes a key, one per chain
seeded from the caller's: the two packages draw different numbers, so
they agree in distribution, not draw by draw.
"""

import math

import torch

from ._flat import Target, chain_generators, run_chains

__all__ = ["sample_hmc"]


def _leapfrog(q, p, step_size, n_steps):
    """Leapfrog with the gradient threaded through the carry: n_steps + 1
    gradient evaluations, not 2 * n_steps (the end-of-step gradient is the
    next step's start-of-step gradient), each yielded (``_flat``). Returns
    ``(q, p, logpdf(q))``."""
    logp, g = yield q
    for _ in range(n_steps):
        p = p + 0.5 * step_size * g
        q = q + step_size * p
        logp, g = yield q
        p = p + 0.5 * step_size * g
    return q, p, logp


def _kinetic(p):
    return 0.5 * float(torch.dot(p, p))


def _hmc_step(step_size, n_leapfrog, q, logp, gen):
    p = torch.randn(q.shape, generator=gen, dtype=q.dtype)
    u = float(torch.rand((), generator=gen, dtype=torch.float64))
    q_new, p_new, logp_new = yield from _leapfrog(q, p, step_size, n_leapfrog)
    log_accept = (logp_new - _kinetic(p_new)) - (logp - _kinetic(p))
    if math.isnan(log_accept):
        log_accept = -math.inf
    if math.log(u) < log_accept:
        q, logp = q_new, logp_new
    return q, logp, math.exp(min(log_accept, 0.0))


def _single_chain(init, gen, num_samples, num_warmup, step_size0, n_leapfrog, target_accept):
    """Warm-up with step-size adaptation then sampling, for one chain, as a
    coroutine (``_flat``). Returns ``(qs, logps, accept rate)``."""
    q = init
    logp, _ = yield q

    # Warm-up with dual-averaging step-size adaptation (Hoffman & Gelman
    # 2014, Algorithm 5).
    mu = math.log(10 * step_size0)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    log_eps = log_eps_bar = math.log(step_size0)
    h_bar = t = 0.0
    for _ in range(num_warmup):
        q, logp, accept_prob = yield from _hmc_step(math.exp(log_eps), n_leapfrog, q, logp,
                                                    gen)
        t += 1.0
        eta = 1.0 / (t + t0)
        h_bar = (1 - eta) * h_bar + eta * (target_accept - accept_prob)
        log_eps = mu - math.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
    step_size = math.exp(log_eps_bar)

    qs, logps, accepts = [], [], []
    for _ in range(num_samples):
        q, logp, accept_prob = yield from _hmc_step(step_size, n_leapfrog, q, logp, gen)
        qs.append(q)
        logps.append(logp)
        accepts.append(accept_prob)
    accept = sum(accepts) / max(len(accepts), 1)
    return (torch.stack(qs), torch.tensor(logps, dtype=q.dtype),
            torch.tensor([accept], dtype=torch.float64))


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
        num_chains: chains, each with a generator of its own seeded from
            ``generator`` (after the starts' jitter), run together: each
            round's leapfrog steps evaluated in one batch.
        mesh, chain_axis: a ``DeviceMesh`` and the name of its dimension
            over which the chains split: each rank runs the chains ``c =
            rank (mod D)`` (``D`` must divide ``num_chains``) and the
            results are gathered.

    Returns:
        ``(samples, logps, accept_rate)``: ``samples`` a dict of tensors of
        shape ``(num_chains, num_samples, ...)`` on the parameters' device,
        ``logps`` ``(num_chains, num_samples)``.
    """
    return _sample_hmc(logpdf, init, generator, None, num_samples=num_samples,
                       num_warmup=num_warmup, step_size=step_size, n_leapfrog=n_leapfrog,
                       num_chains=num_chains, target_accept=target_accept, mesh=mesh,
                       chain_axis=chain_axis)


def _sample_hmc(logpdf, init, generator, drive, *, num_samples, num_warmup, step_size,
                n_leapfrog, num_chains, target_accept, mesh, chain_axis):
    """:func:`sample_hmc` with its chains run by ``drive``
    (``_flat.run_chains``; ``None`` for the batched driver)."""
    target = Target(logpdf, init)
    inits = target.q0 + 0.1 * torch.randn(
        (num_chains, target.dim), generator=generator, dtype=target.dtype
    )
    gens = chain_generators(generator, num_chains)

    def chain(c):
        return _single_chain(inits[c], gens[c], num_samples, num_warmup, step_size,
                             n_leapfrog, target_accept)

    runs = run_chains(target, chain, num_chains, mesh, chain_axis, drive)
    qs = torch.stack([r[0] for r in runs])
    logps = torch.stack([r[1] for r in runs]).to(target.device)
    accept = sum(float(r[2]) for r in runs) / num_chains
    return target.samples(qs), logps, float(accept)
