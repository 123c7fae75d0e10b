"""The samplers' view of a log-density over a dict of tensors.

The samplers are host-driven: positions, momenta and the metric are one
flat vector on the CPU (in the parameters' dtype), and each proposal's
log-density and gradient are computed where the parameters lie (the card,
for a GP on it) and read back. The flat order is the sorted names, as
``jax.flatten_util.ravel_pytree`` orders a dict."""

import torch

__all__ = ["Target"]


class Target:
    """``logpdf`` (a function of ``{name: tensor}``) as a function of a
    flat host vector; ``init`` fixes the names, shapes, dtype and device."""

    def __init__(self, logpdf, init):
        if not isinstance(init, dict) or not init:
            raise TypeError("The samplers take the parameters as a non-empty dict of tensors.")
        self.logpdf = logpdf
        self.names = sorted(init)
        leaves = [torch.as_tensor(init[k]) for k in self.names]
        self.shapes = [t.shape for t in leaves]
        self.dtype = leaves[0].dtype
        self.device = leaves[0].device
        self.q0 = torch.cat([t.detach().reshape(-1).to(self.dtype).cpu() for t in leaves])

    @property
    def dim(self):
        return self.q0.shape[0]

    def unravel(self, q):
        out, start = {}, 0
        for name, shape in zip(self.names, self.shapes):
            size = shape.numel()
            out[name] = q[..., start:start + size].reshape(q.shape[:-1] + shape)
            start += size
        return out

    def value_and_grad(self, q):
        """``(logpdf, gradient)`` at the host vector ``q``: a Python float
        and a host vector."""
        qd = q.detach().to(self.device).requires_grad_(True)
        with torch.enable_grad():
            val = self.logpdf(self.unravel(qd))
            (grad,) = torch.autograd.grad(val, qd, allow_unused=True)
        grad = torch.zeros_like(q) if grad is None else grad.detach().cpu()
        return float(val.detach()), grad

    def samples(self, qs):
        """``{name: (..., *shape)}`` on the parameters' device from host
        vectors ``qs (..., dim)``."""
        return {k: v.to(self.device) for k, v in self.unravel(qs).items()}
