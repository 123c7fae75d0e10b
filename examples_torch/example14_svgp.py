"""Minibatch SVGP training (beyond the reference): the uncollapsed
Hensman-et-al.-2013 ELBO with interleaved natural-gradient steps on the
variational parameters and Adam steps on hyperparameters + inducing inputs.

The port's counterpart of ``examples/example14_svgp.py``: autograd
through the minibatch ELBO and ``stheno_torch.opt.transform.adam`` in
place of optax's.
"""

import numpy as np
import torch

from stheno_torch import B, EQ, GP, PseudoObs, svgp_elbo, svgp_init, svgp_natgrad_step
from stheno_torch.opt.transform import adam, apply_updates

N, M, BATCH, NOISE = 4000, 24, 256, 0.05

r = np.random.RandomState(0)
x = B.cast(torch.float64, np.sort(r.rand(N) * 10.0))
y = torch.sin(2.0 * x) + 0.1 * x + B.cast(torch.float64, np.sqrt(NOISE) * r.randn(N))

params = svgp_init(EQ(), B.linspace(torch.float64, 0.0, 10.0, M))
theta = {"log_s2": B.zeros(torch.float64), "log_ell": B.zeros(torch.float64)}


def kernel(theta):
    return torch.exp(theta["log_s2"]) * EQ().stretch(torch.exp(theta["log_ell"]))


def hyper_step(theta, params, opt_state, xb, yb):
    t = {k: v.detach().requires_grad_(True) for k, v in theta.items()}
    p = {k: v.detach().requires_grad_(k == "z") for k, v in params.items()}
    loss = -svgp_elbo(kernel(t), p, xb, yb, NOISE, N)
    g = torch.autograd.grad(loss, list(t.values()) + [p["z"]])
    g_t = dict(zip(t, g[:-1]))
    # z rides the Adam step alongside the hyperparameters; q_mu/q_sqrt are
    # updated by natural gradient below, so their Adam update is masked out.
    g_p = {"z": g[-1], "q_mu": torch.zeros_like(p["q_mu"]),
           "q_sqrt": torch.zeros_like(p["q_sqrt"])}
    (u_t, u_p), opt_state = opt.update((g_t, g_p), opt_state)
    return apply_updates(theta, u_t), apply_updates(params, u_p), opt_state, -loss.detach()


opt = adam(2e-2)
opt_state = opt.init((theta, params))

for step in range(300):
    idx = torch.as_tensor(r.choice(N, size=BATCH, replace=False), device=x.device)
    xb, yb = x[idx][:, None], y[idx]
    params = svgp_natgrad_step(kernel(theta), params, xb, yb, NOISE, N,
                               rho=0.3 / (1.0 + 0.01 * step))
    theta, params, opt_state, elbo = hyper_step(theta, params, opt_state, xb, yb)
    if step % 100 == 0:
        print(f"step {step:4d}  minibatch ELBO {float(elbo):10.1f}")

# Compare against the collapsed VFE bound at the learned hyperparameters.
# One rho=1 full-batch natural-gradient step lands q(u) exactly on the
# collapsed optimum, so the two bounds must coincide.
k = kernel(theta)
params = svgp_natgrad_step(k, params, x[:, None], y, NOISE, N, rho=1.0)
full = float(svgp_elbo(k, params, x[:, None], y, NOISE, N))
f = GP(k)
opt_bound = float(f.measure.logpdf(PseudoObs(f(params["z"][:, 0]), (f(x, NOISE), y))))
print(f"full-batch uncollapsed ELBO: {full:10.1f}")
print(f"collapsed VFE at same (theta, z): {opt_bound:10.1f}  (equal: rho=1 full-batch step is optimal)")
print(f"learned lengthscale {float(torch.exp(theta['log_ell'])):.3f}, "
      f"signal variance {float(torch.exp(theta['log_s2'])):.3f}")
