"""The program side of the dense exact GP (``configs/eq-n2000.json``):
``stheno_torch.opt.AdamDriver`` on the NLML of ``GP(s2 *
EQ().stretch(ell))``, its step captured as one CUDA graph on the card.

Set-up builds the one driver (capture included), drives it through the
traffic's ``check_steps`` first steps by the window's own call
(``run(1)``), keeps what the check compares (each step's objective, the
first gradient as Adam's state holds it after one step, the parameters'
change after the last), and hands the same driver to the window, whose
units are ``run(steps_per_call)``.
"""

import math
import time
import unittest.mock

import torch

from stheno_torch import EQ, GP
from stheno_torch.opt import AdamDriver, Vars

from . import _common

__all__ = ["Session", "make_data"]


def make_data(config, seed, device):
    """The benchmark's data: ``x`` sorted uniform, ``y = sin x + 0.3 cos
    3.2x + std eps`` (the README model's target with noise)."""
    x, eps = _common.uniform_sorted(config, seed, device)
    return x, torch.sin(x) + 0.3 * torch.cos(3.2 * x) + config["y_noise_std"] * eps


def _no_step(self, closure=None):
    """An optimiser step that leaves the state as it is (a fault)."""
    return None


class Session:
    def __init__(self, config, traffic, seed, device, *, control=False, fault=None):
        if fault not in (None, "half_batch", "state_unchanged"):
            raise ValueError(f"no fault {fault!r} in this path")
        if traffic["kind"] != "adam":
            raise ValueError(f"the dense path runs no {traffic['kind']!r} traffic")
        self.config, self.traffic, self.device = config, traffic, device
        self._prev = _common.set_precision(config, control)
        self._patch = None
        if fault == "state_unchanged":
            self._patch = unittest.mock.patch.object(torch.optim.Adam, "step", _no_step)
            self._patch.start()
        self.x, self.y = make_data(config, seed, device)
        # The half-batch fault: every other row, the NLML scaled to the rest.
        x, y = (self.x[::2], self.y[::2]) if fault == "half_batch" else (self.x, self.y)
        scale = 2.0 if fault == "half_batch" else 1.0
        noise = config["noise"]

        def objective(vs):
            ell = vs.positive(config["ell"], name="ell")
            s2 = vs.positive(config["s2"], name="s2")
            g = GP(s2 * EQ().stretch(ell))
            return -scale * g.measure.logpdf(g(x, noise), y)

        self.driver = AdamDriver(objective, Vars(dtype=torch.float32, device=device),
                                 rate=config["rate"])
        beta1 = config["adam_betas"][0]
        start = {k: p.detach().clone() for k, p in self.driver.params.items()}
        self.losses, self.grad1 = [], None
        for t in range(traffic["check_steps"]):
            self.losses.append(float(self.driver.run(1)))
            if t == 0:
                self.grad1 = {k: float(self.driver.opt.state[p]["exp_avg"] / (1.0 - beta1))
                              for k, p in self.driver.params.items()}
        self.change = {k: float(p.detach() - start[k]) for k, p in self.driver.params.items()}

    def unit(self, i):
        k = self.traffic["steps_per_call"]
        t0 = time.perf_counter()
        with torch.profiler.record_function("gpbench.adam_run"):
            val = self.driver.run(k)
        t1 = time.perf_counter()
        return {"t0": t0, "t1": t1, "n_units": k, "ok": math.isfinite(float(val))}

    def answers(self, records):
        return {"losses": self.losses, "grad1": self.grad1, "change": self.change}

    def inputs(self):
        return {"x": self.x, "y": self.y}

    def close(self):
        self.__dict__.pop("driver", None)
        if self._patch is not None:
            self._patch.stop()
        _common.restore_precision(self._prev)
