"""No-U-Turn Sampler (iterative, multinomial).

Counterpart of ``stheno_tpu/opt/nuts.py``, the same algorithm:

- trajectories double up to ``2^max_depth`` leapfrog steps;
- within a subtree, U-turns are checked against checkpointed left
  endpoints of every power-of-two aligned sub-subtree;
- proposals are drawn multinomially (streaming logsumexp weights) with
  biased-progressive sampling across subtrees;
- the step size adapts by dual averaging on the subtree-averaged
  Metropolis statistic;
- a diagonal or dense mass matrix adapts in Stan-style expanding warm-up
  windows.

Where the JAX package runs fixed-size loops under ``jit`` and ``vmap``,
this one is host-driven: each leaf's U-turn and divergence checks are read
on the host, so a subtree stops at its first U-turn instead of idling
through its remaining leaves. Each chain is a coroutine that yields the
positions it needs evaluated (``_flat``): the chains run together, each
round's pending leapfrog steps evaluated in one batch where the
parameters lie and read back once (where the JAX package ``vmap``s its
chains), and a chain whose tree has stopped waits out no other's.
Randomness comes from a CPU ``torch.Generator``; the two packages agree in
distribution, not draw by draw. Each chain draws from its own generator,
seeded from the caller's, so with a mesh the chains split over the ranks
of a mesh dimension (``_flat.run_chains``).
"""

import math

import numpy as np
import torch

from ._flat import Target, chain_generators, run_chains

__all__ = ["sample_nuts"]

_DIVERGENCE_THRESHOLD = 1000.0


def _velocity(inv_mass, p):
    """``M^{-1} p`` for a diagonal (vector) or dense (matrix) metric."""
    return inv_mass @ p if inv_mass.ndim == 2 else inv_mass * p


def _turning(dq, p_start, p_end, inv_mass):
    # Stan's generalized criterion: the time-oriented chord against the
    # VELOCITIES ``v = M^{-1} p`` at both ends (equivalent at unit mass).
    return bool(
        torch.dot(dq, _velocity(inv_mass, p_start)) < 0
        or torch.dot(dq, _velocity(inv_mass, p_end)) < 0
    )


def _logaddexp(a, b):
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def _uniform(gen):
    return float(torch.rand((), generator=gen, dtype=torch.float64))


class _Leaf:
    """A point of a trajectory: position, momentum, log-density, gradient."""

    __slots__ = ("q", "p", "logp", "grad")

    def __init__(self, q, p, logp, grad):
        self.q, self.p, self.logp, self.grad = q, p, logp, grad


def _nuts_trajectory(q0, logp0, grad0, gen, eps, max_depth, inv_mass):
    """One NUTS transition from ``q0`` (with its log-density and gradient)
    under a diagonal (vector) or dense (matrix) inverse mass ``inv_mass =
    Sigma`` (momenta ~ N(0, M), ``M = Sigma^{-1}``, kinetic ``p^T Sigma p /
    2``), as a coroutine: it yields each position to evaluate and receives
    its ``(logp, grad)``. Returns ``(q, logp, grad)`` of the proposal, the
    accept statistic and the tree's depth (the subtrees it built)."""

    def kinetic(p):
        return 0.5 * float(torch.dot(p, _velocity(inv_mass, p)))

    z0 = torch.randn(q0.shape, generator=gen, dtype=q0.dtype)
    if inv_mass.ndim == 2:
        # p ~ N(0, Sigma^{-1}): with Sigma = L L^T, p = L^{-T} z.
        L_sig = torch.linalg.cholesky(inv_mass)
        p0 = torch.linalg.solve_triangular(L_sig.T, z0[:, None], upper=True)[:, 0]
    else:
        p0 = z0 / torch.sqrt(inv_mass)
    H0 = logp0 - kinetic(p0)

    def leapfrog(leaf, direction):
        e = direction * eps
        p_half = leaf.p + 0.5 * e * leaf.grad
        q = leaf.q + e * _velocity(inv_mass, p_half)
        logp, grad = yield q
        return _Leaf(q, p_half + 0.5 * e * grad, logp, grad)

    def build_subtree(start, depth, direction):
        """``2^depth`` leapfrog steps from ``start``, stopping at the first
        U-turn or divergence; checkpoints hold the left end of every
        aligned sub-subtree."""
        leaf, prop, logw = start, None, -math.inf
        sum_accept, turning, diverged = 0.0, False, False
        ckpt = [None] * (depth + 1)
        for i in range(2**depth):
            leaf = yield from leapfrog(leaf, direction)
            for k in range(depth + 1):
                if i % (2**k) == 0:
                    ckpt[k] = leaf
            delta = leaf.logp - kinetic(leaf.p) - H0
            if math.isnan(delta):
                delta = -math.inf
            diverged = delta < -_DIVERGENCE_THRESHOLD
            logw_leaf = -math.inf if diverged else delta
            sum_accept += math.exp(min(delta, 0.0))
            # Streaming multinomial proposal within the subtree.
            logw_new = _logaddexp(logw, logw_leaf)
            if logw_new > -math.inf and math.log(_uniform(gen)) < logw_leaf - logw_new:
                prop = leaf
            logw = logw_new
            # U-turn check against every aligned sub-subtree that this leaf
            # closes. The chord is time-oriented (the first-built leaf is
            # the latest in time when integrating backwards).
            for k in range(1, depth + 1):
                if (i + 1) % (2**k) == 0 and _turning(
                    direction * (leaf.q - ckpt[k].q), ckpt[k].p, leaf.p, inv_mass
                ):
                    turning = True
            if turning or diverged:
                break
        return leaf, prop, logw, sum_accept, turning, diverged

    minus = plus = prop = _Leaf(q0, p0, logp0, grad0)
    logw = 0.0  # The root leaf has weight exp(H0 - H0) = 1.
    sum_accept, n_accept = 0.0, 0.0
    depth = 0
    for depth in range(max_depth):
        go_right = _uniform(gen) < 0.5
        direction = 1.0 if go_right else -1.0
        end, sub_prop, sub_logw, sub_accept, sub_turning, sub_diverged = yield from build_subtree(
            plus if go_right else minus, depth, direction
        )
        if go_right:
            plus = end
        else:
            minus = end
        sub_ok = not sub_turning and not sub_diverged
        # Biased progressive sampling: take the subtree's proposal with
        # probability min(1, w_sub / w_tree).
        if sub_ok and math.log(_uniform(gen)) < sub_logw - logw:
            prop = sub_prop
        if sub_ok:
            logw = _logaddexp(logw, sub_logw)
        sum_accept += sub_accept
        n_accept += 2.0**depth
        if sub_turning or sub_diverged or _turning(plus.q - minus.q, minus.p, plus.p, inv_mass):
            break
    return (prop.q, prop.logp, prop.grad), sum_accept / max(n_accept, 1.0), depth + 1


def _warmup_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Stan's three-phase warmup schedule as static per-step flags.

    Returns ``(collect, window_end)`` boolean arrays of length
    ``num_warmup``: ``collect[t]`` marks steps inside a mass-estimation
    window, ``window_end[t]`` marks the last step of each window (where
    the mass matrix updates and dual averaging restarts). Windows double
    in size; the final window absorbs the remainder. Short warmups scale
    the buffers down proportionally (Stan's behaviour)."""
    w = int(num_warmup)
    collect = np.zeros(w, bool)
    window_end = np.zeros(w, bool)
    if w < 20:
        # Too short for windows: step-size adaptation only.
        return collect, window_end
    if init_buffer + term_buffer + base_window > w:
        scale = w / float(init_buffer + term_buffer + base_window)
        init_buffer = max(1, int(init_buffer * scale))
        term_buffer = max(1, int(term_buffer * scale))
        base_window = w - init_buffer - term_buffer
    start = init_buffer
    end_all = w - term_buffer
    size = base_window
    while start < end_all:
        stop = start + size
        # The final window absorbs what's left.
        if stop + 2 * size > end_all:
            stop = end_all
        collect[start:stop] = True
        window_end[stop - 1] = True
        start = stop
        size *= 2
    return collect, window_end


def _single_chain(q, gen, num_warmup, num_samples, step_size0, max_depth, target_accept,
                  collect, window_end, dense):
    """Warm-up (dual averaging and windowed Welford estimation of the
    metric) then sampling, for one chain, as a coroutine (``_flat``).
    Returns ``(qs, accepts, depths)``: the accept statistics as a float64
    tensor, each transition's tree depth (warm-up included) as an int64
    one."""
    gamma, t0, kappa = 0.05, 10.0, 0.75
    dim = q.shape[0]
    eye = torch.eye(dim, dtype=q.dtype)
    inv_mass = eye.clone() if dense else torch.ones(dim, dtype=q.dtype)
    log_eps = log_eps_bar = math.log(step_size0)
    mu, h_bar, t = math.log(10 * step_size0), 0.0, 0.0
    w_count, w_mean = 0.0, torch.zeros_like(q)
    w_m2 = torch.zeros((dim, dim) if dense else (dim,), dtype=q.dtype)
    depths = []
    cur = (q, *(yield q))
    for step in range(num_warmup):
        cur, accept, depth = yield from _nuts_trajectory(*cur, gen, math.exp(log_eps),
                                                         max_depth, inv_mass)
        depths.append(depth)
        q = cur[0]
        # Dual averaging on the subtree-averaged Metropolis statistic.
        t += 1.0
        eta = 1.0 / (t + t0)
        h_bar = (1 - eta) * h_bar + eta * (target_accept - accept)
        log_eps = mu - math.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
        # Welford accumulation of the position variance (diag) or full
        # covariance (dense metric) inside windows.
        if collect[step]:
            w_count += 1.0
            delta = q - w_mean
            w_mean = w_mean + delta / w_count
            w_m2 = w_m2 + (torch.outer(delta, q - w_mean) if dense else delta * (q - w_mean))
        if window_end[step]:
            # Window close: regularized (co)variance -> inverse mass (Stan's
            # shrinkage towards unit scale), reset the accumulator, restart
            # dual averaging anchored at the CURRENT step size.
            if w_count > 1.0:
                var = w_m2 / max(w_count - 1.0, 1.0)
                shrink = w_count / (w_count + 5.0)
                reg = (5.0 / (w_count + 5.0)) * 1e-3
                if dense:
                    inv_mass = shrink * var + reg * eye
                else:
                    inv_mass = torch.clamp_min(shrink * var + reg, 1e-10)
                mu = log_eps + math.log(10.0)
                h_bar, t = 0.0, 0.0
                log_eps_bar = log_eps
            w_count, w_mean, w_m2 = 0.0, torch.zeros_like(w_mean), torch.zeros_like(w_m2)

    eps = math.exp(log_eps_bar)
    qs, accepts = [], []
    for _ in range(num_samples):
        cur, accept, depth = yield from _nuts_trajectory(*cur, gen, eps, max_depth, inv_mass)
        depths.append(depth)
        qs.append(cur[0])
        accepts.append(accept)
    return (torch.stack(qs), torch.tensor(accepts, dtype=torch.float64),
            torch.tensor(depths, dtype=torch.int64))


def sample_nuts(
    logpdf,
    init,
    generator,
    *,
    num_samples=500,
    num_warmup=300,
    step_size=0.1,
    max_depth=8,
    num_chains=1,
    target_accept=0.8,
    adapt_mass=True,
    dispatch_chunk=None,
    mesh=None,
    chain_axis="chains",
):
    """Run NUTS over a dict of tensors.

    ``adapt_mass``: estimate a mass matrix in Stan-style expanding warm-up
    windows (75-step init buffer, doubling windows, 50-step terminal
    buffer, scaled down for short warm-ups) with dual averaging restarted
    at each window close. ``True``/``"diag"``: a diagonal metric (scale
    separation); ``"dense"``: the regularized sample covariance, with one
    ``dim x dim`` Cholesky per trajectory (the fix for correlated
    parameters, which no diagonal metric whitens); ``False``: the unit
    metric.

    ``dispatch_chunk`` bounds the transitions per device program in the
    JAX package; the sampler here runs eagerly, so it is accepted and does
    not change the result.

    ``generator`` is a CPU ``torch.Generator``. Chains start from ``init``
    jittered by 0.1 standard normals drawn from it; then each chain gets a
    generator of its own, seeded from it. The chains run together, each
    round's leapfrog steps evaluated in one batch; with a ``mesh`` (a
    ``DeviceMesh``), each rank runs so the chains ``c = rank (mod D)`` of
    its dimension ``chain_axis`` (size ``D``, which must divide
    ``num_chains``) and the results are gathered over it.

    Returns ``(samples, accept_rate)`` with ``samples`` a dict of tensors
    shaped ``(num_chains, num_samples, ...)`` on the parameters' device."""
    del dispatch_chunk
    samples, accept, _, _ = _sample_nuts(
        logpdf, init, generator, None, num_samples=num_samples, num_warmup=num_warmup,
        step_size=step_size, max_depth=max_depth, num_chains=num_chains,
        target_accept=target_accept, adapt_mass=adapt_mass, mesh=mesh, chain_axis=chain_axis)
    return samples, accept


def _sample_nuts(logpdf, init, generator, drive, *, num_samples, num_warmup, step_size,
                 max_depth, num_chains, target_accept, adapt_mass, mesh, chain_axis):
    """:func:`sample_nuts` with its chains run by ``drive``
    (``_flat.run_chains``; ``None`` for the batched driver). Returns
    ``(samples, accept_rate, accepts, depths)``: each chain's accept
    statistics ``(num_chains, num_samples)`` and tree depths ``(num_chains,
    num_warmup + num_samples)`` besides."""
    target = Target(logpdf, init)
    inits = target.q0 + 0.1 * torch.randn(
        (num_chains, target.dim), generator=generator, dtype=target.dtype
    )
    gens = chain_generators(generator, num_chains)
    if adapt_mass:
        collect, window_end = _warmup_schedule(num_warmup)
    else:
        collect = window_end = np.zeros(num_warmup, bool)

    def chain(c):
        return _single_chain(inits[c], gens[c], num_warmup, num_samples, step_size, max_depth,
                             target_accept, collect, window_end, adapt_mass == "dense")

    runs = run_chains(target, chain, num_chains, mesh, chain_axis, drive)
    qs = torch.stack([r[0] for r in runs])
    accepts = torch.stack([r[1] for r in runs])
    rate = sum(accepts.reshape(-1).tolist()) / max(accepts.numel(), 1)
    return target.samples(qs), rate, accepts, torch.stack([r[2] for r in runs])
