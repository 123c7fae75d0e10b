"""Entry points: the exact-GP training-and-prediction step.

Counterparts of ``__graft_entry__.py:_flagship_step``/``entry()`` and of
the model of ``bench.py:bench_n2000``:

- :func:`flagship_step` differentiates the negative log marginal
  likelihood of an EQ GP with respect to its hyperparameters, then
  conditions on the data and returns the posterior marginals at new
  inputs;
- :func:`entry` returns the step and its example arguments at the JAX
  shapes (n=1024, m=256, float32);
- :func:`nlml_n2000` is the reference's headline, the periodic-EQ NLML at
  N=2000 (:func:`n2000_inputs`), as a value or a value and gradient.

Raw inputs go to ``device`` (default ``config.default_device``, the card);
tensors keep their own device.
"""

import torch

from . import config
from .kernels import EQ
from .model import GP

__all__ = ["flagship_step", "entry", "periodic_nlml", "n2000_inputs", "nlml_n2000"]


def _eq_model(params):
    ell = torch.exp(params["log_ell"])
    s2 = torch.exp(params["log_s2"])
    noise = torch.exp(params["log_noise"])
    return GP(s2 * EQ().stretch(ell)), noise


def flagship_step(x, y, x_new, params, device=None):
    """NLML value and gradient + posterior marginals for an EQ GP.

    ``params`` holds ``log_ell``, ``log_s2`` and ``log_noise``. Returns
    ``(value, grads, mean, var)`` with ``grads`` a dict like ``params``."""
    config.pin_matmul_precision()
    x, y, x_new = (config.as_tensor(a, device=device) for a in (x, y, x_new))
    leaves = {
        k: config.as_tensor(v, device=device).detach().requires_grad_(True)
        for k, v in params.items()
    }
    with torch.enable_grad():
        f, noise = _eq_model(leaves)
        val = -f.measure.logpdf(f(x, noise), y)
        grads = torch.autograd.grad(val, list(leaves.values()))
    with torch.no_grad():
        f, noise = _eq_model({k: v.detach() for k, v in leaves.items()})
        post = f | (f(x, noise), y)
        mean, var = post(x_new).marginals()
    return val.detach(), dict(zip(leaves, grads)), mean, var


def entry(device=None):
    """``(flagship_step, example_args)`` at the JAX package's shapes."""
    dev = config.resolve_device(device)
    n, m = 1024, 256
    x = torch.linspace(0.0, 10.0, n, dtype=torch.float32, device=dev)
    y = torch.sin(x)
    x_new = torch.linspace(0.0, 10.0, m, dtype=torch.float32, device=dev)
    params = {
        "log_ell": torch.tensor(0.0, device=dev),
        "log_s2": torch.tensor(0.0, device=dev),
        "log_noise": torch.tensor(-2.0, device=dev),
    }
    return flagship_step, (x, y, x_new, params)


def periodic_nlml(x, y, ell, period=1.0, noise=0.1):
    """NLML of ``GP(EQ().stretch(ell).periodic(period))`` with noise."""
    x, y = config.as_tensor(x), config.as_tensor(y)
    period = torch.as_tensor(period, dtype=x.dtype, device=x.device)
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    f = GP(EQ().stretch(ell).periodic(period))
    return -f.measure.logpdf(f(x, noise), y)


def n2000_inputs(dtype=torch.float32, device=None):
    """The headline's data: ``x`` on [0, 10], ``y = sin x + 0.3 cos 3.2x``,
    and the stretch ``ell = 2``."""
    x = torch.linspace(0.0, 10.0, 2000, dtype=dtype, device=config.resolve_device(device))
    y = torch.sin(x) + 0.3 * torch.cos(3.2 * x)
    return x, y, torch.tensor(2.0, dtype=dtype, device=x.device)


def nlml_n2000(x, y, ell, grad=False):
    """The headline NLML: its value, or ``(value, d value / d ell)``."""
    config.pin_matmul_precision()
    if not grad:
        with torch.no_grad():
            return periodic_nlml(x, y, ell)
    ell = ell.detach().requires_grad_(True)
    with torch.enable_grad():
        val = periodic_nlml(x, y, ell)
        (g,) = torch.autograd.grad(val, ell)
    return val.detach(), g
