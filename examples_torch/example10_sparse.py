"""Sparse regression: 2,000 noisy observations summarised by 20
inducing points with the Titsias VFE approximation.

The port's counterpart of ``examples/example10_sparse.py``.
"""

import torch

from stheno_torch import B, EQ, GP, PseudoObs

x = B.linspace(torch.float64, 0, 10, 2000)
x_ind = B.linspace(torch.float64, 0, 10, 20)

f = GP(EQ().periodic(2.0))
gen, y = f.measure.sample(B.create_random_state(seed=6), f(x, 0.5))
y = y[:, 0]

obs = PseudoObs(f(x_ind), (f(x, 0.5), y))
elbo = float(f.measure.logpdf(obs))
lp = float(f.measure.logpdf(f(x, 0.5), y))
print(f"ELBO:        {elbo:.2f}")
print(f"exact logpdf: {lp:.2f}  (ELBO is a lower bound; gap {lp - elbo:.4f})")

post = f.measure.condition(obs)
mean, _ = post(f)(x).marginals()
dense_post = f | (f(x, 0.5), y)
mean_ref, _ = dense_post(x).marginals()
print(f"sparse vs exact posterior mean max diff: {float((mean - mean_ref).abs().max()):.4f}")
