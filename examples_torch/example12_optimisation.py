"""Hyperparameter optimisation with constrained parameters and L-BFGS
(the reference's `readme_example12_optimisation_varz.py`, with
``stheno_torch.opt.Vars`` playing Varz's role).

The port's counterpart of ``examples/example12_optimisation.py``.
"""

import torch

from stheno_torch import B, EQ, GP
from stheno_torch.opt import Vars, minimise_lbfgs

x = B.linspace(torch.float64, 0, 10, 100)
f_gen = GP(EQ().periodic(1.3))
gen, y = f_gen.measure.sample(B.create_random_state(seed=8), f_gen(x, 0.2))
y = y[:, 0]


def objective(vs):
    f = GP(
        vs.positive(1.0, name="var")
        * EQ().stretch(vs.positive(1.0, name="scale")).periodic(vs.positive(1.0, name="period"))
    )
    return -f.measure.logpdf(f(x, vs.positive(0.1, name="noise")), y)


vs = Vars(dtype=torch.float64)
init = float(objective(vs))
final = minimise_lbfgs(objective, vs, iters=40)
print(f"NLML: {init:.2f} -> {final:.2f}")
for name in ("var", "scale", "period", "noise"):
    print(f"{name}: {float(vs[name]):.4f}")

f = GP(vs["var"] * EQ().stretch(vs["scale"]).periodic(vs["period"]))
post = f | (f(x, vs["noise"]), y)
mean, _ = post(x).marginals()
print(f"training RMSE: {float(((mean - y) ** 2).mean().sqrt()):.4f}")
