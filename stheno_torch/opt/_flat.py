"""The samplers' view of a log-density over a dict of tensors.

The samplers are host-driven: positions, momenta and the metric are one
flat vector on the CPU (in the parameters' dtype), and each proposal's
log-density and gradient are computed where the parameters lie (the card,
for a GP on it) and read back. The flat order is the sorted names, as
``jax.flatten_util.ravel_pytree`` orders a dict.

The chains share nothing but their start: each draws from its own
generator (:func:`chain_generators`), so :func:`run_chains` can run them
one after another or split them over the ranks of a mesh dimension, with
the same result to the bit."""

import torch

__all__ = ["Target", "chain_generators", "run_chains"]


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


def chain_generators(generator, num_chains):
    """One CPU generator per chain, each seeded from a seed drawn from
    ``generator``: chain ``c``'s stream depends on nothing but its seed, so
    a chain draws the same numbers wherever it runs."""
    seeds = torch.randint(0, 2**62, (num_chains,), generator=generator, dtype=torch.int64)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def run_chains(run_one, num_chains, mesh=None, chain_axis="chains"):
    """``[run_one(c) for c in range(num_chains)]``, each a tuple of
    tensors. With a ``mesh``, this rank runs the chains ``c = rank (mod
    D)`` of the mesh dimension ``chain_axis`` (size ``D``, which must
    divide ``num_chains``; ranks that share a coordinate run the same
    chains), and one all-gather per output over that dimension hands
    every rank every chain's result, in chain order and on the CPU."""
    if mesh is None:
        return [run_one(c) for c in range(num_chains)]
    from ..parallel._comm import MeshAxis, all_gather_rows

    ax = MeshAxis(mesh, chain_axis)
    D = ax.size
    if num_chains % D:
        raise ValueError(
            f"num_chains={num_chains} does not divide evenly over the {D} ranks of mesh "
            f"dimension {chain_axis!r}.")
    mine = [run_one(c) for c in range(ax.rank, num_chains, D)]
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    per = num_chains // D
    # Gathered row rank * per + j holds chain j * D + rank.
    order = [(c % D) * per + c // D for c in range(num_chains)]
    gathered = [all_gather_rows(torch.stack(out).to(device), ax)[order].cpu()
                for out in zip(*mine)]
    return [tuple(g[c] for g in gathered) for c in range(num_chains)]
