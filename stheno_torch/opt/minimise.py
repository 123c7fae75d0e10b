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
# Evaluations one L-BFGS line search may make (torch's own default).
_LINE_SEARCH_EVALS = 25


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
    ``.item()`` of a device value, no copy from host memory). The
    adaptive-jitter probe (``config.adaptive_jitter``) and rq's alpha stay
    on the device, so both are captured. A capture that fails raises;
    nothing runs eagerly instead.

    On the CPU the same steps run eagerly.
    """

    def __init__(self, f, vs, rate=5e-2, steps_per_dispatch=1):
        cuda = vs.device.type == "cuda"
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


class _NonFinite(Exception):
    pass


def minimise_lbfgs(f, vs, iters=100, trace=False):
    """Minimise ``f(vs)`` with L-BFGS (strong-Wolfe line search), one
    iteration per ``step``; stops at the first non-finite objective, with
    the parameters of the last step's start."""
    loss = _make_loss(f, vs)
    params = _leaves(vs)
    # One iteration per step, and the line search's own budget: torch
    # bounds the line search by what ``max_eval`` leaves after the step's
    # first evaluation, so its default (``max_iter * 5 // 4`` = 1) would
    # leave the search one trial, and a step whose first trial fails the
    # Armijo test would not move.
    opt = torch.optim.LBFGS(list(params.values()), max_iter=1, max_eval=1 + _LINE_SEARCH_EVALS,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        val = loss(params)
        if not torch.isfinite(val):
            # The line search cannot compare a non-finite value: stop.
            raise _NonFinite
        val.backward()
        return val

    every = max(1, iters // 10)
    for i in range(iters):
        start = {k: p.detach().clone() for k, p in params.items()}
        try:
            val = opt.step(closure)
        except _NonFinite:
            # Back to the last step's start (a trial point of the line
            # search may be left in the parameters).
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(start[k])
            break
        if trace and i % every == 0:
            print(f"lbfgs iter {i}: {float(val):.6f}")
    vs.assign_latent(params)
    with torch.no_grad():
        return float(loss(params))


# Name-compatible alias with the varz API used in the reference's examples.
minimise_l_bfgs_b = minimise_lbfgs
