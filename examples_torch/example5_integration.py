"""Integration via derivative processes: model f with a GP in one
measure, pin f(0) and f'(0), then condition the second derivative on data.

The port's counterpart of ``examples/example5_integration.py`` (the
kernel derivatives come from ``torch.func``).
"""

import torch

from stheno_torch import B, EQ, GP, Measure

with Measure() as prior:
    f = 0.7 * GP(EQ()).stretch(1.5)
    df = f.diff()
    ddf = df.diff()

# Pin integration constants: f(0) = 1, f'(0) = 0.
zero = B.zeros(torch.float64, 1)
prior2 = prior.condition((f(zero), B.ones(torch.float64, 1)), (df(zero), B.zeros(torch.float64, 1)))
mean_f0, var_f0 = prior2(f)(zero).marginals()
print(f"f(0) posterior: {float(mean_f0[0]):.6f} +- {float(var_f0[0]):.2e}")

# Condition f'' on observations.
x_obs = B.linspace(torch.float64, 0, 5, 30)
y_obs = -torch.sin(x_obs)
post = prior2.condition(ddf(x_obs, 1e-6), y_obs)
mean_ddf, _ = post(ddf)(x_obs).marginals()
print(f"f'' fit max error: {float((mean_ddf - y_obs).abs().max()):.2e}")
