"""Gradient-based minimisation of objectives over :class:`Vars`.

Counterpart of ``stheno_tpu/opt/minimise.py``, which runs optax under
``jit``. Here Adam is ``torch.optim.Adam`` with optax's defaults (betas
0.9 and 0.999, eps 1e-8, no eps_root), which computes optax's update
``m_hat / (sqrt(v_hat) + eps)``; L-BFGS is ``torch.optim.LBFGS`` with a
strong-Wolfe line search, which is not optax's zoom line search, so the
two reach the same optimum by other iterates.

Where the JAX driver traces and compiles its step once, the port's
:class:`AdamDriver` on a CUDA device captures its step in one CUDA graph,
so that a replay runs the whole step with no host work in between its
kernels."""

import gc

import torch

from .. import config

__all__ = ["AdamDriver", "minimise_adam", "minimise_lbfgs", "minimise_l_bfgs_b"]

# optax.adam's defaults.
_BETAS, _EPS = (0.9, 0.999), 1e-8
# Steps run before a capture: the recipe of PyTorch's whole-network
# capture example.
_WARMUP = 3


def _make_loss(f, vs):
    # Evaluate once eagerly so parameters created inside `f` register into
    # `vs` before the latent values are read (varz discovers variables the
    # same way); without this a fresh Vars would optimise nothing.
    with torch.no_grad():
        f(vs)
    if not vs.latent_dict():
        raise ValueError("The objective registered no parameters in the Vars container.")

    def loss(latent):
        return f(vs.with_latent(latent))

    return loss


def _leaves(vs):
    """The latent values as fresh leaf tensors that require grad."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in vs.latent_dict().items()}


class AdamDriver:
    """Reusable Adam loop over a :class:`Vars` objective.

    ``steps_per_dispatch`` is accepted for the JAX driver's signature,
    where it sets how many steps one dispatch chains; here it changes
    nothing, and the update sequence is the same for every value. (On
    the H100 a graph launch costs microseconds against a step of about
    2 ms, so replaying the one-step graph ``k`` times runs as fast as a
    graph of ``k`` steps: see PERF.md.)

    On a CUDA device, construction captures the step (objective, gradient
    and Adam update) in one CUDA graph, and ``run`` only replays it.
    Before the capture, a few steps run on a side stream under
    ``config.no_host_sync`` (every host sync an error, so a sync in ``f``
    names its own line); the parameters and the optimiser state are then
    restored in place, so the driver starts from the initial values. The
    objective ``f`` must make no host sync (no ``float``, ``bool`` or
    ``.item()`` of a device value, no copy from host memory) and
    ``config.adaptive_jitter`` must be off. A capture that fails raises;
    nothing runs eagerly instead.

    On the CPU the same steps run eagerly.
    """

    def __init__(self, f, vs, rate=5e-2, steps_per_dispatch=1):
        cuda = vs.device.type == "cuda"
        if cuda and config.adaptive_jitter:
            raise NotImplementedError(
                "AdamDriver captures its step in a CUDA graph on the card, and the "
                "adaptive-jitter probe (config.adaptive_jitter) reads each factorisation's "
                "status on the host, which a graph cannot: turn adaptive jitter off, or run "
                "on the CPU. A device-side probe is still to be ported."
            )
        self.vs = vs
        self._loss = _make_loss(f, vs)
        self.params = _leaves(vs)
        self.opt = torch.optim.Adam(
            list(self.params.values()), lr=rate, betas=_BETAS, eps=_EPS, capturable=cuda
        )
        # The optimiser's state, made up front (as Adam makes it at its
        # first step) so that warm-up and load_state can write it in place.
        for p in self.params.values():
            self.opt.state[p].update(
                step=torch.zeros((), dtype=torch.float32, device=p.device if cuda else "cpu"),
                exp_avg=torch.zeros_like(p),
                exp_avg_sq=torch.zeros_like(p),
            )
        self._graph = None
        if cuda:
            self._capture()

    # -- the step ---------------------------------------------------------

    def _step(self):
        """One Adam step; returns the objective at the step's start."""
        self.opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            val = self._loss(self.params)
            val.backward()
        self.opt.step()
        return val.detach()

    def _state_tensors(self):
        tensors = list(self.params.values())
        for p in self.params.values():
            tensors.extend(self.opt.state[p].values())
        return tensors

    def _capture(self):
        state = self._state_tensors()
        initial = [t.detach().clone() for t in state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), config.no_host_sync():
            for _ in range(_WARMUP):
                self._step()
        torch.cuda.current_stream().wait_stream(side)
        # The graph holds these tensors' storage: restore them in place.
        with torch.no_grad():
            for t, t0 in zip(state, initial):
                t.copy_(t0)
        self.opt.zero_grad(set_to_none=True)
        # The model's objects hold reference cycles (an FDD and its lazy
        # thunks) that keep a step's autograd graph alive until a
        # collection: collect the earlier steps', or the capture would
        # accumulate gradients through nodes made on another stream.
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        try:
            with config.no_host_sync(), torch.cuda.graph(graph):
                out = self._step()
        except RuntimeError as e:
            raise RuntimeError(
                f"AdamDriver: capturing the Adam step in a CUDA graph failed: {e}"
            ) from e
        self._graph = (graph, out)

    def _replay(self):
        graph, out = self._graph
        graph.replay()
        return out

    # -- the public loop --------------------------------------------------

    def run(self, iters, trace=False):
        """Advance ``iters`` optimiser steps; assigns the result back into
        the ``Vars`` and returns the objective value at the LAST step's
        start (a 0-d tensor; no extra evaluation). Returns when the work is
        done on the device."""
        val = None
        every = max(1, iters // 10)
        for i in range(iters):
            val = self._replay() if self._graph else self._step()
            if trace and i % every == 0:
                print(f"adam iter {i}: {float(val):.6f}")
        self.vs.assign_latent({k: p.detach().clone() for k, p in self.params.items()})
        if val is None:
            return None
        # A replay writes the next value into the same buffer.
        val = val.clone()
        if val.is_cuda:
            torch.cuda.synchronize(val.device)
        return val

    def objective(self):
        """Objective at the CURRENT parameters (one eager evaluation, on the
        route a step takes)."""
        with torch.enable_grad():
            return float(self._loss(self.params).detach())

    def load_state(self, state):
        """Set the optimiser's state, ``{name: {"step", "exp_avg",
        "exp_avg_sq"}}`` (e.g. from :func:`~stheno_torch.convert.adam_state_from_jax`),
        in place: the captured graph goes on reading it."""
        with torch.no_grad():
            for name, p in self.params.items():
                for key, t in self.opt.state[p].items():
                    t.copy_(state[name][key])


def minimise_adam(f, vs, iters=200, rate=5e-2, trace=False, steps_per_dispatch=1):
    """Minimise ``f(vs)`` with Adam over the latent parameters; assigns the
    optimised values back into ``vs`` and returns the final objective.

    One-shot wrapper over :class:`AdamDriver`; loops that call back into
    the optimiser should hold a driver instead (each call here captures
    its graph anew on the card)."""
    driver = AdamDriver(f, vs, rate=rate, steps_per_dispatch=steps_per_dispatch)
    driver.run(iters, trace=trace)
    return driver.objective()


def minimise_lbfgs(f, vs, iters=100, trace=False):
    """Minimise ``f(vs)`` with L-BFGS (strong-Wolfe line search), one
    iteration per ``step``; stops early on a non-finite objective."""
    loss = _make_loss(f, vs)
    params = _leaves(vs)
    opt = torch.optim.LBFGS(list(params.values()), max_iter=1, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        val = loss(params)
        val.backward()
        return val

    every = max(1, iters // 10)
    for i in range(iters):
        val = opt.step(closure)
        if trace and i % every == 0:
            print(f"lbfgs iter {i}: {float(val):.6f}")
        if not torch.isfinite(val):
            break
    vs.assign_latent(params)
    with torch.no_grad():
        return float(loss(params))


# Name-compatible alias with the varz API used in the reference's examples.
minimise_l_bfgs_b = minimise_lbfgs
