"""The samplers' view of a log-density over a dict of tensors, and the
driver that runs their chains together.

The samplers are host-driven: positions, momenta and the metric are one
flat vector on the CPU (in the parameters' dtype), and each proposal's
log-density and gradient are computed where the parameters lie (the card,
for a GP on it) and read back. The flat order is the sorted names, as
``jax.flatten_util.ravel_pytree`` orders a dict.

Each chain is a coroutine (a generator): it yields the position it needs
evaluated and receives ``(logpdf, gradient)``, so it follows its own
control flow (a NUTS tree stops at its own U-turn) and draws from its own
generator (:func:`chain_generators`). :func:`run_chains` gathers every
pending chain's position into one batch, evaluates the batch at once
(:meth:`Target.batch_value_and_grad`: each member's gradient queued where
the parameters lie, then one host read for the batch), and sends each
chain its result; a chain that has finished drops out of the batch. With a
mesh, each rank runs its share of the chains so."""

import torch

__all__ = ["Target", "chain_generators", "run_chains"]

#: Batched evaluations (each one host read) and the positions they
#: evaluated, in this process.
batch_calls = 0
batch_points = 0


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
        and a host vector, by ``torch.autograd`` (one chain)."""
        qd = q.detach().to(self.device).requires_grad_(True)
        with torch.enable_grad():
            val = self.logpdf(self.unravel(qd))
            (grad,) = torch.autograd.grad(val, qd, allow_unused=True)
        grad = torch.zeros_like(q) if grad is None else grad.detach().cpu()
        return float(val.detach()), grad

    def batch_value_and_grad(self, qs):
        """``(logpdfs (k,), gradients (k, dim))`` at the host vectors ``qs
        (k, dim)``, on the host: each member's log-density and gradient by
        ``torch.autograd`` where the parameters lie, queued one after
        another with no read between them, then one read of the stacked
        results. A member's bits are those of :meth:`value_and_grad` at
        its position, whichever chains share its batch, so a chain draws
        the same to the bit however its rank's share and the pending set
        change, with or without a mesh. (A ``torch.func.vmap`` over the
        members costs no less on the card, since K1 and K2 take one launch
        per member under it, and its rounding depends on the batch:
        ``scripts/torch_chains.py``.)"""
        global batch_calls, batch_points
        vals, grads = [], []
        for q in qs.detach().to(self.device):
            q = q.clone().requires_grad_(True)
            with torch.enable_grad():
                val = self.logpdf(self.unravel(q))
                (grad,) = torch.autograd.grad(val, q, allow_unused=True)
            vals.append(val.detach().double())
            grads.append(torch.zeros_like(q) if grad is None else grad)
        # float64 holds both the values and the gradients exactly.
        both = torch.cat([torch.stack(vals)[:, None], torch.stack(grads).double()], 1).cpu()
        batch_calls += 1
        batch_points += qs.shape[0]
        return both[:, 0], both[:, 1:].to(qs.dtype)

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


def _drive_batched(target, chains):
    """Run the coroutines ``chains`` together: each round evaluates every
    pending chain's position in one batch. Returns their results in
    order."""
    results, pending = [None] * len(chains), {}
    for i, chain in enumerate(chains):
        try:
            pending[i] = chain.send(None)
        except StopIteration as stop:
            results[i] = stop.value
    while pending:
        idx = list(pending)
        vals, grads = target.batch_value_and_grad(torch.stack([pending[i] for i in idx]))
        for j, i in enumerate(idx):
            try:
                pending[i] = chains[i].send((float(vals[j]), grads[j]))
            except StopIteration as stop:
                results[i] = stop.value
                del pending[i]
    return results


def _drive_in_turn(target, chains):
    """Run the coroutines one after another, each evaluation alone
    (:meth:`Target.value_and_grad`): what the batched driver is held to."""
    results = []
    for chain in chains:
        try:
            q = chain.send(None)
            while True:
                q = chain.send(target.value_and_grad(q))
        except StopIteration as stop:
            results.append(stop.value)
    return results


def run_chains(target, chain, num_chains, mesh=None, chain_axis="chains", drive=None):
    """The results of the coroutines ``chain(c)``, ``c < num_chains``, each
    a tuple of tensors, run together (each round one batched evaluation of
    ``target``; ``drive`` replaces that driver, as the tests and
    ``chip_smoke.py`` do with :func:`_drive_in_turn`). With a ``mesh``,
    this rank runs the chains ``c = rank (mod D)`` of the mesh dimension
    ``chain_axis`` (size ``D``, which must divide ``num_chains``; ranks
    that share a coordinate run the same chains), and one all-gather per
    output over that dimension hands every rank every chain's result, in
    chain order and on the CPU."""
    drive = _drive_batched if drive is None else drive
    if mesh is None:
        return drive(target, [chain(c) for c in range(num_chains)])
    from ..parallel._comm import MeshAxis, all_gather_rows

    ax = MeshAxis(mesh, chain_axis)
    D = ax.size
    if num_chains % D:
        raise ValueError(
            f"num_chains={num_chains} does not divide evenly over the {D} ranks of mesh "
            f"dimension {chain_axis!r}.")
    mine = drive(target, [chain(c) for c in range(ax.rank, num_chains, D)])
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    per = num_chains // D
    # Gathered row rank * per + j holds chain j * D + rank.
    order = [(c % D) * per + c // D for c in range(num_chains)]
    gathered = [all_gather_rows(torch.stack(out).to(device), ax)[order].cpu()
                for out in zip(*mine)]
    return [tuple(g[c] for g in gathered) for c in range(num_chains)]
