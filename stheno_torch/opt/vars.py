"""Constrained-parameter containers.

Counterpart of ``stheno_tpu/opt/vars.py``: latent parameters live in a
flat dict of leaf tensors on one device; constraints are bijections (exp
for positivity, a scaled logistic for bounds), so the latent values can
be optimised with any gradient method."""

import torch

from .. import config

__all__ = ["Vars"]


class _Bijection:
    def forward(self, z):  # latent -> constrained
        raise NotImplementedError

    def inverse(self, x):  # constrained -> latent
        raise NotImplementedError


class _Identity(_Bijection):
    def forward(self, z):
        return z

    def inverse(self, x):
        return x


class _Exp(_Bijection):
    def forward(self, z):
        return torch.exp(z)

    def inverse(self, x):
        return torch.log(x)


class _Logistic(_Bijection):
    def __init__(self, lower, upper):
        self.lower, self.upper = lower, upper

    def forward(self, z):
        return self.lower + (self.upper - self.lower) / (1 + torch.exp(-z))

    def inverse(self, x):
        p = (x - self.lower) / (self.upper - self.lower)
        return torch.log(p) - torch.log1p(-p)


class Vars:
    """A container of named, optionally-constrained parameters.

    ``vs.positive(init, name=...)`` / ``vs.bounded(...)`` /
    ``vs.unbounded(...)`` register a parameter on first call and return
    its current (constrained) value on every call: get-or-create, so model
    functions can both build and re-read parameters. The latent values are
    leaf tensors of ``dtype`` on ``device`` (default
    ``config.resolve_device()``)."""

    def __init__(self, dtype=torch.float64, device=None):
        self.dtype = dtype
        self.device = config.resolve_device(device)
        self._latent = {}
        self._bijections = {}
        self._counter = 0

    # -- registration / access -------------------------------------------

    def _get(self, name, init, bijection, shape):
        if name is None:
            # Positional identity for unnamed parameters (varz semantics):
            # the i-th unnamed call in an evaluation is always `var{i}`;
            # ``with_latent`` views reset the counter per evaluation.
            name = f"var{self._counter}"
            self._counter += 1
        if name not in self._latent:
            init = torch.as_tensor(init, dtype=self.dtype, device=self.device)
            init = torch.broadcast_to(init, shape).clone(memory_format=torch.contiguous_format)
            self._latent[name] = bijection.inverse(init).detach()
            self._bijections[name] = bijection
        return self._bijections[name].forward(self._latent[name])

    def unbounded(self, init=0.0, *, name=None, shape=()):
        """An unconstrained parameter."""
        return self._get(name, init, _Identity(), shape)

    def positive(self, init=1.0, *, name=None, shape=()):
        """A positive parameter (exp transform)."""
        return self._get(name, init, _Exp(), shape)

    def bounded(self, init, lower, upper, *, name=None, shape=()):
        """A parameter constrained to ``(lower, upper)``."""
        return self._get(name, init, _Logistic(lower, upper), shape)

    def __getitem__(self, name):
        return self._bijections[name].forward(self._latent[name])

    def names(self):
        return list(self._latent.keys())

    # -- functional views for optimisation -------------------------------

    def latent_dict(self):
        """The latent values, ``{name: tensor}``."""
        return dict(self._latent)

    def with_latent(self, latent):
        """A view sharing bijections but with other latent values (tensors
        that may require grad): one objective evaluation."""
        view = Vars.__new__(Vars)
        view.dtype = self.dtype
        view.device = self.device
        view._latent = dict(latent)
        view._bijections = dict(self._bijections)
        # Each view is one objective evaluation: unnamed parameters replay
        # positionally from var0.
        view._counter = 0
        return view

    def assign_latent(self, latent):
        """Write back optimised latent values (detached)."""
        self._latent.update({k: v.detach() for k, v in latent.items()})

    def __str__(self):
        rows = [f"  {name} = {self[name].detach().cpu().numpy()}" for name in self._latent]
        return "Vars(\n" + "\n".join(rows) + "\n)"

    __repr__ = __str__
