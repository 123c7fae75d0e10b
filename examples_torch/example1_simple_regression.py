"""Simple regression: prior sample -> condition -> credible bounds.

The port's counterpart of ``examples/example1_simple_regression.py``, with
the stheno_torch API on the default device (no plotting; prints a
summary instead).
"""

import torch

from stheno_torch import B, EQ, GP

x = B.linspace(torch.float64, 0, 10, 100)
x_obs = B.linspace(torch.float64, 0, 7, 20)

# Construct a prior.
f = GP(EQ())

# Sample a truth and noisy observations jointly from the prior.
gen, f_true, y_obs = f.measure.sample(B.create_random_state(seed=0), f(x), f(x_obs, 0.1))

# Condition on the observations to make predictions.
f_post = f | (f(x_obs, 0.1), y_obs[:, 0])
mean, lower, upper = f_post(x).marginal_credible_bounds()

truth = f_true[:, 0]
err = (mean - truth).abs()
cover = ((lower <= truth) & (truth <= upper)).double()
print(f"mean abs error: {float(err.mean()):.4f}")
print(f"credible-interval coverage of the truth: {float(cover.mean()):.2%}")
