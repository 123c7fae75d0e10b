"""Product of two GPs: the (non-Gaussian) product is approximated by a
Gaussian with matched first and second moments.

The port's counterpart of ``examples/example9_product.py``.
"""

import torch

from stheno_torch import B, EQ, GP, Measure

with Measure() as prior:
    f1 = GP(3.0, EQ())
    f2 = GP(3.0, EQ())
    f_prod = f1 * f2

x = B.linspace(torch.float64, 0, 10, 50)
gen, s1, s2 = prior.sample(B.create_random_state(seed=5), f1(x), f2(x))

post = prior.condition((f1(x), s1[:, 0]), (f2(x), s2[:, 0]))
mean, lower, upper = post(f_prod)(x).marginal_credible_bounds()

true_prod = s1[:, 0] * s2[:, 0]
rel = ((mean - true_prod) ** 2).mean().sqrt() / (true_prod**2).mean().sqrt()
print(f"moment-matched product: relative RMSE vs true product = {float(rel):.4f}")
