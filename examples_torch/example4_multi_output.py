"""Multi-output regression: latent GPs mixed into several outputs by a
matrix H, conditioned jointly on all outputs.

The port's counterpart of ``examples/example4_multi_output.py`` (the
reference's VGP construction).
"""

import numpy as np
import torch

from stheno_torch import B, EQ, GP, Measure


class VGP:
    """A vector-valued GP: a list of scalar processes."""

    def __init__(self, ps):
        self.ps = ps

    def __add__(self, other):
        return VGP([f + g for f, g in zip(self.ps, other.ps)])

    def lmatmul(self, A):
        m, n = A.shape
        ps = [0 for _ in range(m)]
        for i in range(m):
            for j in range(n):
                ps[i] = A[i, j] * self.ps[j] + ps[i]
        return VGP(ps)


m_latent, p_out = 2, 4
H = np.random.RandomState(0).randn(p_out, m_latent)

x_obs = B.linspace(torch.float64, 0, 10, 10)

with Measure() as prior:
    us = VGP([GP(EQ()) for _ in range(m_latent)])
    fs = us.lmatmul(H)

fdds = [f(x_obs, 0.01) for f in fs.ps]
out = prior.sample(B.create_random_state(seed=3), *fdds)
samples = out[1:]

post = prior.condition(*((fdd, s[:, 0]) for fdd, s in zip(fdds, samples)))
for i, (f, s) in enumerate(zip(fs.ps, samples)):
    mean, _ = post(f)(x_obs).marginals()
    rmse = float(((mean - s[:, 0]) ** 2).mean().sqrt())
    print(f"output {i}: posterior RMSE at observations = {rmse:.4f}")
