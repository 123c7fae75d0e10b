"""Decomposition of a prediction into a smooth and a wiggly component.

The port's counterpart of ``examples/example2_decomposition.py``: build an
additive model in one Measure, condition the sum, and read off posterior
predictions for each component.
"""

import torch

from stheno_torch import B, EQ, GP, Measure, RQ

m = Measure()
f_smooth = GP(EQ().stretch(2.0), measure=m)
f_wiggly = GP(RQ(1e-1).stretch(0.5), measure=m)
f = f_smooth + f_wiggly

x = B.linspace(torch.float64, 0, 10, 100)
gen, y_smooth, y_wiggly = m.sample(B.create_random_state(seed=1), f_smooth(x), f_wiggly(x))
y = (y_smooth + y_wiggly)[:, 0]

post = m.condition(f(x, 1e-6), y)
mean_s, _ = post(f_smooth)(x).marginals()
mean_w, _ = post(f_wiggly)(x).marginals()
mean_f, _ = post(f)(x).marginals()

recon = float((mean_s + mean_w - mean_f).abs().max())
print(f"components sum to the full prediction within {recon:.2e}")
print(f"full prediction matches data within {float((mean_f - y).abs().max()):.2e}")
