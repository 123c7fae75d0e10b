"""Exact GP regression on a 2-D tensor grid via Kronecker structure
(beyond the reference): 4,096 observations, exact NLML + exact gradients +
exact posterior, never forming the 4096 x 4096 Gram.

The port's counterpart of ``examples/example15_grid_kron.py``: autograd
through ``kron_nlml`` and ``stheno_torch.opt.transform.adam`` in place of
optax's.
"""

import numpy as np
import torch

from stheno_torch import B, EQ
from stheno_torch.iterative import grid_coords, kron_nlml, kron_posterior
from stheno_torch.opt.transform import adam, apply_updates

NOISE = 0.05

# Non-uniform tensor grid: 64 x 64 = 4,096 points.
r = np.random.RandomState(0)
axes = (
    B.cast(torch.float64, np.sort(r.rand(64) * 10.0)),
    B.cast(torch.float64, np.sort(r.rand(64) * 6.0)),
)
x = grid_coords(axes)
f_true = lambda x: torch.sin(x[:, 0]) * torch.cos(0.8 * x[:, 1])
y = f_true(x) + B.cast(torch.float64, np.sqrt(NOISE) * r.randn(x.shape[0]))


def kernels(p):
    # Separable anisotropic EQ: s2 * EQ(ell_0) (x) EQ(ell_1).
    return (
        torch.exp(p["log_s2"]) * EQ().stretch(torch.exp(p["log_ell"][0])),
        EQ().stretch(torch.exp(p["log_ell"][1])),
    )


params = {"log_s2": B.zeros(torch.float64), "log_ell": B.zeros(torch.float64, 2)}
opt = adam(0.1)
opt_state = opt.init(params)


def step(params, opt_state):
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    val = kron_nlml(kernels, p, axes, y, NOISE)
    grads = dict(zip(p, torch.autograd.grad(val, list(p.values()))))
    updates, opt_state = opt.update(grads, opt_state)
    return apply_updates(params, updates), opt_state, val.detach()


for i in range(30):
    params, opt_state, nlml = step(params, opt_state)
    if i % 10 == 0:
        print(f"step {i:2d}  exact NLML = {float(nlml):.2f}")

x_new = B.cast(torch.float64, r.rand(200, 2) * np.array([10.0, 6.0]))
mean, var = kron_posterior(kernels, params, axes, y, NOISE, x_new)
rmse = float(((mean - f_true(x_new)) ** 2).mean().sqrt())
print(f"held-out RMSE at 200 off-grid points: {rmse:.4f}")
print(f"learned lengthscales: {B.to_numpy(torch.exp(params['log_ell']))}")
assert rmse < 0.1, rmse
