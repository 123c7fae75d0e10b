"""Bayesian linear regression as GP algebra: slope, intercept and noise are
all processes in one measure, and the posterior decomposes back into them.

The port's counterpart of ``examples/example6_blr.py``.
"""

import numpy as np
import torch

from stheno_torch import B, Delta, GP, Measure

x = B.linspace(torch.float64, 0, 10, 100)
x_obs = B.linspace(torch.float64, 0, 10, 30)

with Measure() as prior:
    slope = GP(1.0)
    intercept = GP(5.0)
    f = slope * (lambda z: z) + intercept
    e = 0.2 * GP(Delta())
    y = f + e

gen, y_obs = prior.sample(B.create_random_state(seed=4), y(x_obs))
post = prior.condition(y(x_obs), y_obs[:, 0])

zero = B.zeros(torch.float64, 1)
mean_slope, _ = post(slope)(zero).marginals()
mean_intercept, _ = post(intercept)(zero).marginals()
print(f"posterior slope:     {float(mean_slope[0]):.4f}")
print(f"posterior intercept: {float(mean_intercept[0]):.4f}")

mean_f, _ = post(f)(x).marginals()
coef = np.polyfit(B.to_numpy(x), B.to_numpy(mean_f), 1)
print(f"posterior f is the line {coef[0]:.4f} * x + {coef[1]:.4f}")
