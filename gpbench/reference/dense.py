"""Plain float64 reference of the dense exact GP under Adam
(``configs/eq-n2000.json``): the NLML of ``N(0, s2 K_EQ/ell + (noise +
jitter) I)`` by a dense Cholesky, its gradient by autograd with respect to
the latent ``(log ell, log s2)``, and Adam (Kingma and Ba 2015, optax's
defaults) followed for the traffic's first ``check_steps`` steps from the
configuration's start.

Compared, as the program's state gives them: each step's objective, the
first gradient's size per leaf (Adam's first moment after one step over
``1 - beta1``) and the parameters' change after the last step, each leaf
against the reference's size of it or of the median leaf, whichever is
larger. A leaf whose first gradient is under a thousandth of the median
leaf's in the reference moves by rounding alone under Adam and is left out
of the change.
"""

import math

import numpy as np
import torch

__all__ = ["check", "nlml", "follow_adam", "LEAVES"]

LEAVES = ("ell", "s2")


def nlml(theta, x, y, config):
    """The NLML at latent ``theta = (log ell, log s2)``."""
    ell, s2 = torch.exp(theta[0]), torch.exp(theta[1])
    n = x.shape[0]
    K = s2 * torch.exp(-0.5 * torch.square(x[:, None] - x[None, :]) / (ell * ell))
    K = K + (config["noise"] + config["jitter"]) * torch.eye(n, dtype=x.dtype, device=x.device)
    L = torch.linalg.cholesky(K)
    a = torch.cholesky_solve(y[:, None], L)[:, 0]
    return 0.5 * (torch.dot(y, a) + 2 * torch.sum(torch.log(torch.diagonal(L)))
                  + n * math.log(2 * math.pi))


def follow_adam(x, y, config, steps):
    """``(losses, first gradient, change)`` of ``steps`` Adam steps."""
    b1, b2 = config["adam_betas"]
    eps, lr = config["adam_eps"], config["rate"]
    theta = torch.tensor([math.log(config["ell"]), math.log(config["s2"])], dtype=x.dtype,
                         device=x.device)
    start = theta.clone()
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        th = theta.clone().requires_grad_(True)
        loss = nlml(th, x, y, config)
        (g,) = torch.autograd.grad(loss, th)
        losses.append(float(loss.detach()))
        if t == 1:
            grad1 = g.clone()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        theta = theta - lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
    return losses, grad1.tolist(), (theta - start).tolist()


def _leaf_gap(prog, ref, keep):
    """The worst leaf's gap of sizes, against the larger of the leaf's
    reference size and the median leaf's."""
    sizes = [abs(r) for r in ref]
    scale = max(float(np.median(sizes)), 1e-300)
    return max((abs(abs(p) - s) / max(s, scale) for p, s, k in zip(prog, sizes, keep) if k),
               default=0.0)


def check(config, traffic, seed, inputs, answers, device):
    x, y = inputs["x"].double(), inputs["y"].double()
    losses, grad1, change = follow_adam(x, y, config, traffic["check_steps"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(answers["losses"], losses))
    median = float(np.median(np.abs(grad1)))
    moves = [abs(g) >= 1e-3 * median for g in grad1]
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap([answers["grad1"][k] for k in LEAVES], grad1, [True] * 2),
        "change_gap": _leaf_gap([answers["change"][k] for k in LEAVES], change, moves),
    }
