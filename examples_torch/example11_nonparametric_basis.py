"""Nonparametric basis: windowed GPs shifted to the observation sites
sum to the model, and the posterior decomposes over the basis.

The port's counterpart of ``examples/example11_nonparametric_basis.py``.
"""

import torch

from stheno_torch import B, EQ, GP, Measure

x = B.linspace(torch.float64, 0, 10, 50)
x_obs = B.linspace(torch.float64, 0, 10, 10)

with Measure() as prior:
    w = lambda z: torch.exp(-(z**2) / 0.5)  # Window.
    b = [(w * GP(EQ())).shift(float(xi)) for xi in x_obs]  # Basis.
    f = sum(b)  # Model.

gen, f_true, y_obs = prior.sample(B.create_random_state(seed=7), f(x), f(x_obs, 0.2))
post = prior.condition(f(x_obs, 0.2), y_obs[:, 0])

mean_f, _ = post(f)(x).marginals()
total = torch.zeros_like(mean_f)
for bi in b:
    mean_b, _ = post(bi)(x).marginals()
    total += mean_b
print(f"basis posteriors sum to the full posterior within {float((total - mean_f).abs().max()):.2e}")
