"""The program side of the matrix-free exact GP (``configs/eq-mf262k.json``):
``stheno_torch.iterative``'s amortised training step at N = 262,144.

Set-up hands the step the eig preconditioner ``(U, lam)`` that the
benchmark builds from the seed (``reference/matrix_free.py:precond_input``)
as its ``precond_state``. A ``steps`` unit is one value and gradient of
``iterative_nlml`` under ``torch.autograd.grad`` on that state, as
``stheno_torch/entry.py:iterative_step(precond_state=...)`` runs it; step
``i``'s probes come from its own generator.
"""

import time

import numpy as np
import torch

from stheno_torch.iterative import iterative_nlml
from stheno_torch.kernels import EQ

from ..harness import seeds
from ..harness import traffic as trafficmod
from ..reference.matrix_free import precond_input
from . import _common

__all__ = ["Session", "kernel_fn"]

#: A fault's relative change of an answer (the check's tests).
ALTERED = 1e-2


def kernel_fn(p):
    """``exp(log_s2) * EQ().stretch(exp(log_ell))``."""
    return torch.exp(p["log_s2"]) * EQ().stretch(torch.exp(p["log_ell"]))


def make_data(config, seed, device):
    """The benchmark's data: ``x`` sorted uniform, ``y = sin x + std eps``."""
    x, eps = _common.uniform_sorted(config, seed, device)
    return x, torch.sin(x) + config["y_noise_std"] * eps


class Session:
    def __init__(self, config, traffic, seed, device, *, control=False, fault=None):
        if fault not in (None, "half_batch", "answer_altered"):
            raise ValueError(f"no fault {fault!r} in this path")
        if traffic["kind"] != "steps":
            raise ValueError(f"the matrix-free path runs no {traffic['kind']!r} traffic")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.fault = fault
        self._prev = _common.set_precision(config, control)
        self.x, self.y = make_data(config, seed, device)
        # The program's operands: with the half-batch fault, every other row.
        self._x, self._y = (self.x[::2], self.y[::2]) if fault == "half_batch" else (self.x, self.y)
        self._scale = 2.0 if fault == "half_batch" else 1.0
        self.params = {k: torch.tensor(float(config[k]), device=device)
                       for k in ("log_s2", "log_ell")}
        # The benchmark's preconditioner, an input of both sides; with the
        # half-batch fault the broken path takes one over its own rows.
        self.state = precond_input(config, self.x, seed)
        self._state = (precond_input(config, self._x, seed) if fault == "half_batch"
                       else self.state)
        for w in range(traffic["warm_units"]):
            self._step(seeds.derive(seed, "warm", w))

    # -- training steps --------------------------------------------------

    def _step(self, probe_seed):
        c = self.config
        gen = torch.Generator(device=self.device).manual_seed(probe_seed)
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in self.params.items()}
        with torch.enable_grad():
            with torch.profiler.record_function("gpbench.iterative_nlml"):
                val, info = iterative_nlml(
                    kernel_fn, leaves, self._x, self._y, c["noise"], gen,
                    num_probes=c["num_probes"], cg_tol=c["cg_tol"],
                    max_cg_iters=c["max_cg_iters"], slq_steps=c["slq_steps"],
                    precond_rank=c["precond_rank"], precond_state=self._state, block=c["block"],
                    return_info=True, compensated=False)
            with torch.profiler.record_function("gpbench.autograd_grad"):
                grads = torch.autograd.grad(val, [leaves["log_s2"], leaves["log_ell"]])
        out = torch.stack([val.detach(), *grads]).double().cpu().numpy() * self._scale
        if self.fault == "answer_altered":
            out = out * (1.0 + ALTERED)
        return out, info

    # -- the session's interface ----------------------------------------

    def unit(self, i):
        t0 = time.perf_counter()
        out, info = self._step(trafficmod.probe_seed(self.seed, i))
        t1 = time.perf_counter()
        return {"t0": t0, "t1": t1, "n_units": 1, "ok": bool(np.isfinite(out).all()),
                "step": i, "value": out[0], "grads": out[1:].tolist(),
                "cg_iters": int(info["cg_iters"]),
                "cg_rel_residual": float(info["cg_rel_residual"])}

    def answers(self, records):
        """What the check compares: ``check_units`` of the window's steps,
        drawn from the seed."""
        rng = seeds.numpy_rng(self.seed, "check")
        done = [r for r in records if r["ok"]]
        k = min(self.traffic["check_units"], len(done))
        picked = sorted(rng.choice(len(done), k, replace=False).tolist())
        return {"steps": [{"step": done[j]["step"], "value": done[j]["value"],
                           "grads": done[j]["grads"]} for j in picked]}

    def inputs(self):
        """The benchmark's inputs, which the reference takes too: the data
        and the preconditioner ``(U, lam)`` built from the seed."""
        return {"x": self.x, "y": self.y, "state": self.state}

    def close(self):
        """Free the program's state and restore its precision setting."""
        for name in ("_state", "params"):
            self.__dict__.pop(name, None)
        _common.restore_precision(self._prev)
