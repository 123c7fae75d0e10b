"""Hyperparameter optimisation with Adam (the reference's
`readme_example13_optimisation_torch.py`): autograd through the NLML and
the port's Adam driver, whose step is one CUDA graph on the card.

The port's counterpart of ``examples/example13_optimisation_adam.py``.
"""

import torch

from stheno_torch import B, EQ, GP
from stheno_torch.opt import Vars, minimise_adam

x = B.linspace(torch.float64, 0, 10, 100)
f_gen = GP(2.0 * EQ().stretch(1.0))
gen, y = f_gen.measure.sample(B.create_random_state(seed=9), f_gen(x, 0.1))
y = y[:, 0]


def objective(vs):
    f = GP(vs.positive(1.0, name="var") * EQ().stretch(vs.positive(1.0, name="scale")))
    return -f.measure.logpdf(f(x, vs.positive(0.2, name="noise")), y)


vs = Vars(dtype=torch.float64)
init = float(objective(vs))
final = minimise_adam(objective, vs, iters=200, rate=5e-2)
print(f"NLML: {init:.2f} -> {final:.2f}")
for name in ("var", "scale", "noise"):
    print(f"{name}: {float(vs[name]):.4f}")
