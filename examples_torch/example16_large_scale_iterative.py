"""Large-scale exact-GP training and serving, the amortised way.

The port's counterpart of ``examples/example16_large_scale_iterative.py``,
the pattern behind the N=262,144 numbers at a CI-friendly size: build the
subspace-iteration preconditioner ONCE (`eig_precond_state`), train with
`iterative_nlml(precond_state=...)` while watching the forward solver's
health (`return_info=True`: a stalled CG must never be silent), refresh
the state on a cadence, then serve the full posterior (mean AND variance
diagonal) through the same shared state. No N x N matrix is ever
materialised.
"""

import numpy as np
import torch

from stheno_torch import B, EQ
from stheno_torch.iterative import (
    AmortisedPosterior,
    eig_precond_state,
    iterative_nlml,
    iterative_posterior_mean,
)
from stheno_torch.opt.transform import adam, apply_updates
from stheno_torch.utils import StepMetrics

n = 2000  # 262,144 on the card: same code, block=8192, rank=64.
rng = np.random.RandomState(0)
x = B.cast(torch.float64, np.sort(rng.rand(n)) * 10)
y = torch.sin(x) + 0.1 * B.cast(torch.float64, rng.randn(n))


def kernel_fn(p):
    return torch.exp(p["log_s2"]) * EQ().stretch(torch.exp(p["log_ell"]))


params = {"log_s2": B.zeros(torch.float64), "log_ell": 0.5 + B.zeros(torch.float64)}
noise = 0.1
RANK, BLOCK, REFRESH_EVERY = 32, 256, 4

opt = adam(5e-2)
opt_state = opt.init(params)
metrics = StepMetrics(print_every=1)


def train_step(params, opt_state, state, generator):
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    val, info = iterative_nlml(
        kernel_fn, p, x, y, noise, generator,
        num_probes=8, cg_tol=1e-6, precond_state=state, block=BLOCK, return_info=True,
    )
    grads = dict(zip(p, torch.autograd.grad(val, list(p.values()))))
    updates, opt_state = opt.update(grads, opt_state)
    return apply_updates(params, updates), opt_state, val.detach(), info, grads


gen = B.create_random_state(seed=0)
state = eig_precond_state(kernel_fn, params, x, RANK, gen, block=BLOCK)
for step in range(8):
    if step and step % REFRESH_EVERY == 0:
        # Warm-started refresh from the previous basis; a stale state is
        # exact regardless (it only costs CG iterations), so the cadence
        # is a speed knob, not a correctness one.
        state = eig_precond_state(kernel_fn, params, x, RANK, init=state[0], block=BLOCK)
    params, opt_state, val, info, grads = train_step(params, opt_state, state, gen)
    metrics.log(
        step, val, grads,
        cg_iters=int(info["cg_iters"]),
        cg_rel_residual=float(info["cg_rel_residual"]),
    )
    assert bool(info["cg_converged"])  # Loud, not silent.

# Serve the posterior, amortised: ONE weights solve + ONE variance cache,
# then every query batch is GEMM work only. The rank-32 training state
# seeds the weights-solve preconditioner; the variance basis is WIDENED to
# the requested rank=256 from it (the generator supplies the extra probe
# columns).
state = eig_precond_state(kernel_fn, params, x, RANK, init=state[0], block=BLOCK)
post = AmortisedPosterior(
    kernel_fn, params, x, y, noise,
    rank=256, generator=B.create_random_state(seed=42), precond_state=state,
    cg_tol=1e-8, var_cg_tol=1e-6, var_max_cg_iters=200,
    block=BLOCK, chunk=64,
)
x_new = B.linspace(torch.float64, 0.0, 10.0, 200)
mean, lo, hi = post.marginal_credible_bounds(x_new)
var = post.var(x_new)
rmse = float(((mean - torch.sin(x_new)) ** 2).mean().sqrt())
print(f"posterior rmse vs truth: {rmse:.4f}")
print(
    f"mean var: {float(var.mean()):.5f}  "
    f"(weights CG residual: {float(post.solve_info['rel_residual']):.2e})"
)
assert rmse < 0.05
assert bool((var >= 0).all())
assert bool((lo <= mean).all()) and bool((mean <= hi).all())

# Per-query-exact fallback (same API family): iterative_posterior_mean
# re-runs CG per call, for one-off queries.
mean1, info = iterative_posterior_mean(
    kernel_fn, params, x, y, noise, x_new[:16], cg_tol=1e-8, precond_state=state, block=BLOCK,
)
assert float((mean1 - mean[:16]).abs().max()) < 1e-4
