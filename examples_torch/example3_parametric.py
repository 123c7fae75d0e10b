"""Parametric model: learn a GP's variance, length scale and noise by
maximising the log marginal likelihood, then predict.

The port's counterpart of ``examples/example3_parametric.py``; the
constrained-parameter container is ``stheno_torch.opt.Vars``.
"""

import torch

from stheno_torch import B, EQ, GP
from stheno_torch.opt import Vars, minimise_lbfgs

x = B.linspace(torch.float64, 0, 10, 80)
f_gen = GP(2.0 * EQ().stretch(1.5))
gen, y = f_gen.measure.sample(B.create_random_state(seed=2), f_gen(x, 0.1))
y = y[:, 0]


def model(vs):
    return GP(vs.positive(1.0, name="var") * EQ().stretch(vs.positive(1.0, name="scale")))


def objective(vs):
    f = model(vs)
    return -f.measure.logpdf(f(x, vs.positive(0.1, name="noise")), y)


vs = Vars(dtype=torch.float64)
init = float(objective(vs))
final = minimise_lbfgs(objective, vs, iters=40)
print(f"NLML: {init:.2f} -> {final:.2f}")
for name in ("var", "scale", "noise"):
    print(f"{name}: {float(vs[name]):.4f}")

f = model(vs)
f_post = f | (f(x, vs["noise"]), y)
mean, _ = f_post(x).marginals()
rmse = float(((mean - y) ** 2).mean().sqrt())
print(f"training RMSE: {rmse:.4f}")
