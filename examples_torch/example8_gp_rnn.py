"""GP-modulated parametric model, jointly fit by Adam: y = (1 + a) * g(x)
with a GP modulation `a` and a small tanh network `g`.

The port's counterpart of ``examples/example8_gp_rnn.py``: the network is
plain tensors held in the same ``Vars`` container as the GP
hyperparameters, so one optimiser fits everything (on the card, its step
is captured in a CUDA graph).
"""

import math

import numpy as np
import torch

from stheno_torch import B, EQ, GP, Measure
from stheno_torch.opt import Vars, minimise_adam

x = B.linspace(torch.float64, 0, 1, 60)[:, None]
r = np.random.RandomState(2)
a_true = 0.3 * torch.sin(2 * math.pi * x[:, 0])
f_true = (1 + a_true) * torch.sin(2 * math.pi * 3 * x[:, 0])
y = f_true + 0.05 * torch.as_tensor(r.randn(60), device=x.device)
# The network's initial weights, drawn once (as the first evaluation draws
# them in the JAX example).
w1_init = 0.1 * torch.as_tensor(r.randn(1, 8), device=x.device)
w2_init = 0.1 * torch.as_tensor(r.randn(8, 1), device=x.device)


def interp(z, xp, fp):
    """Piecewise-linear interpolation of ``(xp, fp)`` at ``z`` (``xp``
    increasing; constant beyond its ends)."""
    i = torch.searchsorted(xp, z).clamp(1, xp.shape[0] - 1)
    w = ((z - xp[i - 1]) / (xp[i] - xp[i - 1])).clamp(0, 1)
    return fp[i - 1] + w * (fp[i] - fp[i - 1])


def net(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[:, 0]


def objective(vs):
    params = {
        "w1": vs.unbounded(w1_init, name="w1", shape=(1, 8)),
        "b1": vs.unbounded(0.0, name="b1", shape=(8,)),
        "w2": vs.unbounded(w2_init, name="w2", shape=(8, 1)),
        "b2": vs.unbounded(0.0, name="b2", shape=(1,)),
    }
    g = net(params, x)
    m = Measure()
    a = GP(1e-1 * EQ().stretch(vs.positive(0.2, name="a_scale")), measure=m)
    # y - g = a * g + noise: condition the modulation GP on the residual.
    f_mod = a * (lambda z: interp(z[..., 0], x[:, 0], g))
    resid = y - g
    return -m.logpdf(f_mod(x, vs.positive(0.05, name="noise")), resid)


vs = Vars(dtype=torch.float64)
init = float(objective(vs))
final = minimise_adam(objective, vs, iters=100, rate=2e-2)
print(f"joint NLML: {init:.2f} -> {final:.2f}")
print(f"fitted modulation lengthscale: {float(vs['a_scale']):.4f}")
print(f"fitted noise: {float(vs['noise']):.4f}")
