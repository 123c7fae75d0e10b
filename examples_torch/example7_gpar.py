"""GPAR: the second output's GP takes the first output as an extra input,
so outputs are modelled autoregressively.

The port's counterpart of ``examples/example7_gpar.py`` (the reference's
two-layer construction with joint hyperparameter fitting).
"""

import numpy as np
import torch

from stheno_torch import B, EQ, GP
from stheno_torch.opt import Vars, minimise_lbfgs

x_obs1 = B.linspace(torch.float64, 0, 10, 30)
r = np.random.RandomState(1)
inds2 = torch.as_tensor(np.sort(r.permutation(30)[:10]), device=x_obs1.device)
x_obs2 = x_obs1[inds2]

y1_obs = torch.sin(x_obs1) + 0.05 * torch.as_tensor(r.randn(30), device=x_obs1.device)
y2_obs = torch.sin(x_obs2) ** 2 + 0.05 * torch.as_tensor(r.randn(10), device=x_obs1.device)


def objective(vs):
    f1 = GP(vs.positive(1.0, name="var1") * EQ().stretch(vs.positive(1.0, name="scale1")))
    f2 = GP(vs.positive(1.0, name="var2") * EQ().stretch(vs.positive(1.0, name="scale2")))
    # Second layer sees (x, y1) as its input.
    x2 = torch.stack([x_obs2, y1_obs[inds2]], dim=1)
    lp = f1(x_obs1, vs.positive(0.1, name="noise1")).logpdf(y1_obs)
    lp = lp + f2(x2, vs.positive(0.1, name="noise2")).logpdf(y2_obs)
    return -lp


vs = Vars(dtype=torch.float64)
init = float(objective(vs))
final = minimise_lbfgs(objective, vs, iters=30)
print(f"joint NLML: {init:.2f} -> {final:.2f}")

f1 = GP(vs["var1"] * EQ().stretch(vs["scale1"]))
post = f1 | (f1(x_obs1, vs["noise1"]), y1_obs)
mean, _ = post(x_obs1).marginals()
rmse = float(((mean - torch.sin(x_obs1)) ** 2).mean().sqrt())
print(f"first-layer RMSE vs sin: {rmse:.4f}")
