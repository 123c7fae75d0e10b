"""Fault-tolerant training loops: checkpointed optimisation with automatic
resume and non-finite-step recovery.

Counterpart of ``stheno_tpu/utils/resilience.py``, with the same
arguments, ``info`` keys and semantics: the loop (a) atomically
checkpoints the last *validated* ``(params, opt_state, step)`` every
``checkpoint_every`` steps, (b) resumes from the checkpoint after a
restart, and (c) detects a non-finite objective or gradient (a float32
Cholesky that fails, an overshoot into a NaN region) and rolls back: the
last validated update is applied again at a halved scale until the
objective is finite again.

Where the JAX package compiles the value-and-gradient, the update and a
``lax.scan`` chain of masked steps with ``jit``, the port captures each
of the three as a CUDA graph when the parameters lie on the card: a step
is one replay and one host read of the device's finite flag, and a chain
of ``k`` steps is ``k`` replays of the masked step and one read. The
graphs read and write fixed buffers; every update is out of place until
the last copy into them, so the rollback anchor is never written through
an alias. On the CPU the same steps run eagerly."""

import gc
import os

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .. import config
from ..opt.transform import adam, apply_updates
from .checkpoint import load_pytree, save_pytree

__all__ = ["resumable_minimise"]

# Steps run before a capture (the recipe of AdamDriver and PyTorch's
# whole-network capture example).
_WARMUP = 3


def _finite_flag(val, grads):
    """One all-finite reduction over the value and every gradient leaf, on
    the device: the host then reads one scalar per step."""
    flag = torch.isfinite(val)
    for g in tree_flatten(grads)[0]:
        flag = flag & torch.isfinite(g).all()
    return flag


def _value_and_grad(objective, params):
    """``(value, grads, finite flag)`` of ``objective`` at ``params``."""
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        val = objective(tree_unflatten(leaves, spec))
        grads = torch.autograd.grad(val, leaves, allow_unused=True)
    grads = tree_unflatten(
        [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)], spec
    )
    val = val.detach()
    return val, grads, _finite_flag(val, grads)


def _apply(optimizer, params, opt_state, grads, scale):
    # Scale the post-optimizer UPDATES, not the gradients: Adam's update
    # is (near-)invariant to the gradients' scale, so halved-gradient
    # retries would apply the same step again and never recover.
    updates, opt_state = optimizer.update(grads, opt_state, params)
    updates = tree_map(lambda u: u * scale, updates)
    return apply_updates(params, updates), opt_state


def _masked_step(objective, optimizer, params, opt_state, ok, last_pre):
    """One step of a chain: the update is kept only where the chain is
    still finite, and ``last_pre`` (the pre-update state and the gradients
    of the last kept step, the rollback anchor after a good chain) moves
    with it. Returns ``(params, opt_state, ok, last_pre, value)``."""
    val, grads, flag = _value_and_grad(objective, params)
    finite = ok & flag
    updates, new_state = optimizer.update(grads, opt_state, params)
    new_params = apply_updates(params, updates)

    def keep(new, old):
        return tree_map(lambda a, b: torch.where(finite, a, b), new, old)

    return (keep(new_params, params), keep(new_state, opt_state), finite,
            keep((params, opt_state, grads), last_pre), val)


class _EagerSteps:
    """The loop's steps run eagerly: pytrees, never updated in place."""

    def __init__(self, objective, optimizer, params, opt_state, k):
        self.objective, self.optimizer, self.k = objective, optimizer, k
        self.params, self.opt_state = params, opt_state
        self.anchor = None
        self._grads = None

    def value_and_grad(self):
        val, self._grads, flag = _value_and_grad(self.objective, self.params)
        return val, bool(flag)

    def validate(self):
        self.anchor = (self.params, self.opt_state, self._grads)

    def apply(self, scale):
        self.params, self.opt_state = _apply(self.optimizer, *self.anchor, scale)

    def chain(self, want_values):
        params, opt_state = self.params, self.opt_state
        ok = torch.ones((), dtype=torch.bool, device=_device(params))
        last_pre = (params, opt_state, tree_map(torch.zeros_like, params))
        vals = []
        for _ in range(self.k):
            params, opt_state, ok, last_pre, val = _masked_step(
                self.objective, self.optimizer, params, opt_state, ok, last_pre)
            vals.append(val)
        if not bool(ok):
            return False, None
        self.params, self.opt_state, self.anchor = params, opt_state, last_pre
        return True, [float(v) for v in vals] if want_values else None

    def current(self):
        return self.params, self.opt_state

    def validated(self):
        return self.anchor[0], self.anchor[1]


def _device(tree):
    leaves = [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def _copy(dst, src):
    with torch.no_grad():
        for d, s in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
            d.copy_(s)


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _capture(name, fn, writes):
    """``fn`` captured as a CUDA graph: ``_WARMUP`` calls on a side stream
    under ``config.no_host_sync`` (a host sync raises at its line), the
    tensors in ``writes`` restored in place, a collection (a step's
    reference cycles would keep earlier autograd graphs alive into the
    capture), then the capture. A capture that fails raises."""
    saved = [t.detach().clone() for t in writes]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), config.no_host_sync():
        for _ in range(_WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.no_grad():
        for t, t0 in zip(writes, saved):
            t.copy_(t0)
    gc.collect()
    graph = torch.cuda.CUDAGraph()
    try:
        with config.no_host_sync(), torch.cuda.graph(graph):
            out = fn()
    except RuntimeError as e:
        raise RuntimeError(
            f"resumable_minimise: capturing the {name} in a CUDA graph failed: {e}"
        ) from e
    return graph, out


class _GraphSteps:
    """The loop's steps as CUDA graph replays over fixed buffers: the
    current state ``P``/``S``, the rollback anchor, the chain's start and
    its masked carry. Host work between replays is copies into the
    buffers and one read of a device flag."""

    def __init__(self, objective, optimizer, params, opt_state, k):
        self.k = k
        dev = _device(params)
        self.P, self.S = _clone(params), _clone(opt_state)
        self.AP, self.AS = _clone(params), _clone(opt_state)
        self.AG = tree_map(torch.zeros_like, params)
        self.CP, self.CS = _clone(params), _clone(opt_state)
        self.LP = (_clone(params), _clone(opt_state), tree_map(torch.zeros_like, params))
        # The update scale in the parameters' dtype, as a Python float
        # multiplies them in the eager steps.
        self.scale = torch.ones((), dtype=tree_flatten(params)[0][0].dtype, device=dev)
        self.ok = torch.ones((), dtype=torch.bool, device=dev)
        self.idx = torch.zeros(1, dtype=torch.long, device=dev)
        self.vals = torch.zeros(k, dtype=torch.float64, device=dev)
        state = tree_flatten((self.P, self.S))[0]
        carry = state + tree_flatten(self.LP)[0] + [self.ok, self.idx, self.vals]

        def vg():
            return _value_and_grad(objective, self.P)

        def apply():
            p, s = _apply(optimizer, self.AP, self.AS, self.AG, self.scale)
            _copy((self.P, self.S), (p, s))

        def chain_step():
            p, s, ok, last_pre, val = _masked_step(
                objective, optimizer, self.P, self.S, self.ok, self.LP)
            _copy((self.P, self.S, self.LP), (p, s, last_pre))
            with torch.no_grad():
                self.ok.copy_(ok)
                self.vals.index_copy_(0, self.idx, val.reshape(1).to(self.vals.dtype))
                self.idx.add_(1)

        self._vg, (self._val, self._grads, self._flag) = _capture("value and gradient", vg, [])
        self._apply, _ = _capture("update", apply, state)
        self._chain = None
        if k > 1:
            self._chain, _ = _capture("masked chain step", chain_step, carry)

    def value_and_grad(self):
        self._vg.replay()
        return self._val, bool(self._flag.item())

    def validate(self):
        _copy((self.AP, self.AS, self.AG), (self.P, self.S, self._grads))

    def apply(self, scale):
        self.scale.fill_(scale)
        self._apply.replay()

    def chain(self, want_values):
        _copy((self.CP, self.CS), (self.P, self.S))
        _copy(self.LP[:2], (self.P, self.S))
        with torch.no_grad():
            for g in tree_flatten(self.LP[2])[0]:
                g.zero_()
            self.ok.fill_(True)
            self.idx.zero_()
        for _ in range(self.k):
            self._chain.replay()
        if not bool(self.ok.item()):
            # The chain froze at its last finite step: back to its start,
            # from which the caller replays it step by step.
            _copy((self.P, self.S), (self.CP, self.CS))
            return False, None
        _copy((self.AP, self.AS, self.AG), self.LP)
        return True, self.vals.tolist() if want_values else None

    def current(self):
        return _clone(self.P), _clone(self.S)

    def validated(self):
        return _clone(self.AP), _clone(self.AS)


def resumable_minimise(
    objective,
    params,
    *,
    steps,
    checkpoint_path,
    checkpoint_every=10,
    optimizer=None,
    rate=5e-3,
    max_retries=6,
    trace=False,
    steps_per_dispatch=1,
):
    """Minimise ``objective(params)`` with checkpoint/resume and bad-step
    rollback.

    A step is only *validated* once the objective evaluates finite at the
    parameters it produced: a diverged update is caught at the next
    evaluation, rolled back to the last validated state, and the same
    gradients applied again at a halved update scale (up to
    ``max_retries`` times, then ``FloatingPointError``). Checkpoints
    store the last validated state, so a resumed run never starts inside
    a bad region.

    Args:
        objective: a function of the parameter pytree to a 0-d tensor (e.g.
            an NLML closure), differentiated with ``torch.autograd``. On
            the card it must make no host sync: it is captured in CUDA
            graphs.
        params: initial parameter pytree of tensors (ignored when a
            checkpoint exists at ``checkpoint_path``).
        steps: total number of optimisation steps for the run.
        checkpoint_path: file path for the rolling checkpoint. A restarted
            process pointing at the same path continues where the dead one
            stopped.
        checkpoint_every: persist state every this many validated steps
            (and at the final step).
        optimizer: a transformation of ``stheno_torch.opt.transform``
            (default: Adam at ``rate``).
        max_retries: consecutive halvings tolerated per rollback episode.
        trace: collect per-step objective values.
        steps_per_dispatch: chain this many steps between two host reads
            of the finite flag. The chain freezes on its first non-finite
            step; a failed chain is replayed step by step from its start,
            so rollback semantics are exactly the per-step ones. Rollback
            episodes and checkpoints always run step-granular.

    Returns:
        ``(params, info)`` with ``info = {"steps_run", "resumed_from",
        "objective_trace", "rejected_steps", "rollback_steps"}``.
        ``objective_trace[i]`` (with ``trace=True``) is the objective
        after ``start + i`` validated updates; ``rollback_steps`` lists
        the steps whose first update attempt was rejected.
    """
    if optimizer is None:
        optimizer = adam(rate)
    opt_state = optimizer.init(params)
    start_step = 0
    resumed_from = None
    device = _device(params)
    if os.path.exists(checkpoint_path):
        template = {"params": params, "opt_state": opt_state,
                    "step": torch.zeros((), dtype=torch.int32, device=device)}
        state = load_pytree(checkpoint_path, like=template)
        params, opt_state = state["params"], state["opt_state"]
        start_step = int(state["step"])
        resumed_from = start_step
    k = max(1, int(steps_per_dispatch))
    runner = _GraphSteps if device.type == "cuda" else _EagerSteps
    run = runner(objective, optimizer, params, opt_state, k)

    def save(state, step):
        p, s = state
        save_pytree(checkpoint_path, {
            "params": p, "opt_state": s,
            "step": torch.tensor(step, dtype=torch.int32),
        })

    # ``history[i]`` is the objective after ``start_step + i`` validated
    # updates: rollback retries never append, only the evaluation that
    # validates a step does.
    history = []
    rejected = 0
    rollback_steps = []
    # ``step`` counts validated updates. The loop evaluates at the top and
    # breaks only after the final update's parameters validate.
    step = start_step
    validated = False
    retries = 0
    scale = 1.0
    # After a failed chain, this many step-granular iterations (the
    # chain's worth) localise the bad step and roll it back as per-step
    # mode does.
    per_step_left = 0
    while True:
        if k > 1 and retries == 0 and per_step_left == 0 and validated and step + k <= steps:
            ok, vals = run.chain(trace)
            if ok:
                if trace:
                    history.extend(vals)
                first, last = step, step + k - 1
                step += k
                # (The final checkpoint, at step == steps, is the per-step
                # tail's: a chain runs only while step + k <= steps.)
                if any(s % checkpoint_every == 0 for s in range(first, last + 1)):
                    # The chain's last VALIDATED state: its final step's
                    # pre-update state (the state it produced is only
                    # validated by the next evaluation).
                    save(run.validated(), last)
                continue
            per_step_left = k
        val, finite = run.value_and_grad()
        if not finite:
            if not validated:
                raise FloatingPointError(
                    "Objective/gradients non-finite at the initial parameters."
                )
            if retries >= max_retries:
                raise FloatingPointError(
                    f"Non-finite objective persisted through {max_retries} "
                    f"halved-step retries at step {step}."
                )
            rejected += 1
            # ``step`` was already advanced past the update that produced
            # these parameters, so the rejected step IS ``step``.
            if not rollback_steps or rollback_steps[-1] != step:
                rollback_steps.append(step)
            retries += 1
            scale *= 0.5
            run.apply(scale)
            continue
        retries = 0
        scale = 1.0
        per_step_left = max(0, per_step_left - 1)
        run.validate()
        validated = True
        if trace:
            history.append(float(val))
        if step % checkpoint_every == 0 or step == steps:
            save(run.current(), step)
        if step >= steps:
            break
        run.apply(1.0)
        step += 1
    info = {
        "steps_run": step - start_step,
        "resumed_from": resumed_from,
        "objective_trace": history,
        "rejected_steps": rejected,
        "rollback_steps": rollback_steps,
    }
    return run.current()[0], info
