"""The port's fault-tolerant training loop
(``stheno_torch.utils.resumable_minimise``) against
``stheno_tpu.utils.resumable_minimise``: each of the 11 tests of
``tests/utils/test_resilience.py`` runs both packages on the same
objective and initial values in float64 on the CPU, and holds the port's
trajectory (parameters and objective trace) to the JAX package's at rtol
1e-10, with the same ``rollback_steps`` and ``rejected_steps``.

Each test runs the port twice: with its eager steps, and with the steps
the card runs as CUDA graphs (``_GraphSteps``: the fixed buffers, the
copies into them, the masked chain with its device flag and value
buffer), their captures replaced by a stand-in that calls the captured
function again at each replay and copies its outputs into the captured
ones. On the card the same buffers are read and written by the graphs.

Beyond the mirrors: the loop against ``AdamDriver`` on the N=2000
objective at N=200 (rtol 1e-10), a run resumed in the port from the JAX
package's checkpoint (rtol 1e-10 against the JAX package's uninterrupted
run), and the refusals on the card (adaptive jitter; a capture that fails
raises, nothing runs eagerly instead).
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._pytree import tree_leaves

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu.utils import resumable_minimise as jrm
from stheno_torch import config
from stheno_torch import entry as E
from stheno_torch.opt import AdamDriver
from stheno_torch.opt import transform as T
from stheno_torch.utils import resilience
from stheno_torch.utils import resumable_minimise as trm
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

RTOL = 1e-10


class _Replay:
    """A stand-in for a captured CUDA graph: a replay calls the captured
    function again and copies its outputs into the captured outputs."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new = self.fn()
        if self.out is None:
            return
        with torch.no_grad():
            for d, s in zip(tree_leaves(self.out), tree_leaves(new)):
                d.copy_(s)


def _fake_capture(name, fn, writes):
    # A capture allocates the outputs and changes nothing else.
    saved = [t.clone() for t in writes]
    out = fn()
    with torch.no_grad():
        for t, t0 in zip(writes, saved):
            t.copy_(t0)
    return _Replay(fn, out), out


@pytest.fixture(params=["eager", "graphs"])
def steps(request, monkeypatch):
    if request.param == "graphs":
        monkeypatch.setattr(resilience, "_capture", _fake_capture)
        monkeypatch.setattr(resilience, "_EagerSteps", resilience._GraphSteps)
    return request.param


def _t(v):
    return torch.tensor(np.asarray(v), dtype=torch.float64)


def _both(obj_j, obj_t, init, opt, tmp_path, tag="", **kw):
    """Run both packages from the numpy ``init`` with optimiser ``opt``
    (a name and its rate); return ``(jax params, jax info, port params,
    port info)``."""
    name, rate = opt
    pj, ij = jrm(obj_j, {k: jnp.asarray(v) for k, v in init.items()},
                 checkpoint_path=str(tmp_path / f"j{tag}.npz"),
                 optimizer=getattr(optax, name)(rate), **kw)
    pt, it = trm(obj_t, {k: _t(v) for k, v in init.items()},
                 checkpoint_path=str(tmp_path / f"t{tag}.npz"),
                 optimizer=getattr(T, name)(rate), **kw)
    return pj, ij, pt, it


def _same(pj, ij, pt, it):
    for k in pj:
        np.testing.assert_allclose(np_(pt[k]), np.asarray(pj[k]), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(it["objective_trace"], ij["objective_trace"], rtol=RTOL)
    for key in ("steps_run", "resumed_from", "rejected_steps", "rollback_steps"):
        assert it[key] == ij[key], key


def _quad(M):
    return lambda p: M.sum((p["x"] - 2.0) ** 2)


# -- tests/utils/test_resilience.py ------------------------------------------------


def test_basic_minimise(tmp_path, steps):
    pj, ij, pt, it = _both(_quad(jnp), _quad(torch), {"x": np.zeros(2)}, ("adam", 0.1),
                           tmp_path, steps=150, trace=True)
    _same(pj, ij, pt, it)
    assert it["resumed_from"] is None and it["steps_run"] == 150
    assert it["objective_trace"][-1] < it["objective_trace"][0]
    np.testing.assert_allclose(np_(pt["x"]), 2.0, atol=0.1)


def test_resume_after_restart(tmp_path, steps):
    kw = dict(checkpoint_every=2)
    init = {"x": np.zeros(())}
    _both(_quad(jnp), _quad(torch), init, ("sgd", 0.05), tmp_path, steps=6, **kw)
    assert os.path.exists(tmp_path / "t.npz")
    # The restarted process continues from the checkpoint, not from init.
    pj, ij, pt, it = _both(_quad(jnp), _quad(torch), init, ("sgd", 0.05), tmp_path,
                           steps=12, **kw)
    _same(pj, ij, pt, it)
    assert it["resumed_from"] == 6 and it["steps_run"] == 6
    np.testing.assert_allclose(float(pt["x"]), 2.0 * (1 - 0.9**12), rtol=1e-12)


def _log_wall(M):
    return lambda p: M.log(1.5 - p["x"]) + (p["x"] - 0.5) ** 2


def test_rollback_on_nan(tmp_path, steps):
    pj, ij, pt, it = _both(_log_wall(jnp), _log_wall(torch), {"x": np.asarray(1.4)},
                           ("sgd", 0.1), tmp_path, steps=3, max_retries=8, trace=True)
    _same(pj, ij, pt, it)
    assert it["rejected_steps"] > 0
    assert bool(torch.isfinite(_log_wall(torch)(pt)))


def test_raises_on_bad_init(tmp_path, steps):
    for M, run, arr in ((jnp, jrm, jnp.asarray), (torch, trm, _t)):
        with pytest.raises(FloatingPointError):
            run(lambda p, M=M: M.log(-1.0 - p["x"] ** 2), {"x": arr(0.0)}, steps=2,
                checkpoint_path=str(tmp_path / "ck.npz"))


def _bowl(M):
    return lambda p: (p["x"] - 0.5) ** 2 + 1e-6 * M.sqrt(1.0 - (p["x"] - 0.5) ** 2)


def test_rollback_recovers_under_adam(tmp_path, steps):
    # Adam's update is invariant to the gradients' scale, so the rollback
    # halves the UPDATE: an oversized step overshoots the bowl into the
    # NaN region and is halved back inside it.
    pj, ij, pt, it = _both(_bowl(jnp), _bowl(torch), {"x": np.asarray(1.4)}, ("adam", 2.5),
                           tmp_path, steps=3, max_retries=6, trace=True)
    _same(pj, ij, pt, it)
    assert it["rejected_steps"] > 0
    assert bool(torch.isfinite(_bowl(torch)(pt)))
    assert abs(float(pt["x"]) - 0.5) < 1.0


def _wall(M):
    nan = jnp.nan if M is jnp else torch.nan
    return lambda p: M.where(p["w"] ** 2 > 25.0, nan, 10.0 * (p["w"] - 3.0) ** 2)


def test_trace_aligns_with_steps_despite_rollback(tmp_path, steps):
    pj, ij, pt, it = _both(_wall(jnp), _wall(torch), {"w": np.asarray(0.0)}, ("sgd", 0.4),
                           tmp_path, steps=8, trace=True)
    _same(pj, ij, pt, it)
    assert len(it["objective_trace"]) == 8 + 1
    assert it["rejected_steps"] >= 1
    # The first update (w = 0 -> 24, through the wall) is the rejected one.
    assert it["rollback_steps"] == [1]


def test_checkpoint_treedef_mismatch_raises(tmp_path, steps):
    from stheno_torch.utils.checkpoint import load_pytree, save_pytree

    path = str(tmp_path / "ck.npz")
    save_pytree(path, {"a": torch.tensor(1.0), "b": torch.tensor(2.0)})
    out = load_pytree(path, {"a": torch.tensor(0.0), "b": torch.tensor(0.0)})
    assert float(out["a"]) == 1.0
    with pytest.raises(ValueError, match="structure"):
        load_pytree(path, {"a": (torch.tensor(0.0), torch.tensor(0.0))})


def test_checkpoint_treedef_repr_drift_warns_but_loads(tmp_path, steps):
    import json

    from stheno_torch.utils.checkpoint import load_pytree, save_pytree

    path = str(tmp_path / "ck.npz")
    save_pytree(path, {"a": torch.tensor(1.0), "b": torch.tensor(2.0)})
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps("TreeSpec(dict, ['a', 'b'], renamed-by-upgrade)").encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    template = {"a": torch.tensor(0.0), "b": torch.tensor(0.0)}
    with pytest.warns(UserWarning, match="repr"):
        out = load_pytree(path, template)
    assert float(out["a"]) == 1.0 and float(out["b"]) == 2.0
    with pytest.raises(ValueError, match="repr"):
        load_pytree(path, template, strict=True)


def _quartic(M):
    return lambda p: M.sum((p["x"] - 2.0) ** 2) + M.sum(p["y"] ** 4)


def test_chained_dispatch_matches_per_step_trajectory(tmp_path, steps):
    init = {"x": np.zeros(2), "y": np.asarray(0.7)}
    kw = dict(steps=20, trace=True)
    pj, ij, pt1, it1 = _both(_quartic(jnp), _quartic(torch), init, ("adam", 0.05), tmp_path,
                             tag="1", **kw)
    _same(pj, ij, pt1, it1)
    pj5, ij5, pt5, it5 = _both(_quartic(jnp), _quartic(torch), init, ("adam", 0.05), tmp_path,
                               tag="5", steps_per_dispatch=5, **kw)
    _same(pj5, ij5, pt5, it5)
    for k in ("x", "y"):
        np.testing.assert_allclose(np_(pt5[k]), np_(pt1[k]), rtol=1e-12)
    assert len(it1["objective_trace"]) == len(it5["objective_trace"]) == 21
    np.testing.assert_allclose(it5["objective_trace"], it1["objective_trace"], rtol=RTOL)
    assert it5["steps_run"] == 20 and it5["rejected_steps"] == 0


def test_chained_dispatch_rollback_parity(tmp_path, steps):
    kw = dict(steps=8, trace=True, max_retries=6)
    pj, ij, pt1, it1 = _both(_wall(jnp), _wall(torch), {"w": np.asarray(0.0)}, ("sgd", 0.4),
                             tmp_path, tag="1", **kw)
    pj4, ij4, pt4, it4 = _both(_wall(jnp), _wall(torch), {"w": np.asarray(0.0)}, ("sgd", 0.4),
                               tmp_path, tag="4", steps_per_dispatch=4, **kw)
    _same(pj4, ij4, pt4, it4)
    assert it4["rejected_steps"] >= 1
    assert it1["rollback_steps"] == it4["rollback_steps"] == [1]
    np.testing.assert_allclose(float(pt4["w"]), float(pt1["w"]), rtol=RTOL)
    np.testing.assert_allclose(it4["objective_trace"], it1["objective_trace"], rtol=RTOL)


def test_chained_dispatch_resumes_from_checkpoint(tmp_path, steps):
    init = {"x": np.zeros(())}
    kw = dict(checkpoint_every=2, steps_per_dispatch=4)
    _both(_quad(jnp), _quad(torch), init, ("sgd", 0.05), tmp_path, steps=8, **kw)
    assert os.path.exists(tmp_path / "t.npz")
    pj, ij, pt, it = _both(_quad(jnp), _quad(torch), init, ("sgd", 0.05), tmp_path,
                           steps=16, **kw)
    _same(pj, ij, pt, it)
    assert it["resumed_from"] in (7, 8)
    ref, _ = trm(_quad(torch), {"x": _t(0.0)}, steps=16, optimizer=T.sgd(0.05),
                 checkpoint_path=str(tmp_path / "ref.npz"))
    np.testing.assert_allclose(float(pt["x"]), float(ref["x"]), rtol=1e-8)


# -- beyond the mirrors ------------------------------------------------------------------


def test_against_the_adam_driver_on_the_n2000_objective(tmp_path, steps):
    # The N=2000 objective at N=200: the loop's Adam against AdamDriver's
    # (torch.optim.Adam with optax's settings) from the same start.
    latent, info = E.resumable_n2000(str(tmp_path / "ck.npz"), 15, rate=5e-2, n=200,
                                     dtype=torch.float64, device="cpu", trace=True)
    f, vs = E.adam_n2000_objective("cpu", torch.float64, n=200)
    driver = AdamDriver(f, vs, rate=5e-2)
    driver.run(15)
    for k, v in vs.latent_dict().items():
        np.testing.assert_allclose(np_(latent[k]), np_(v), rtol=RTOL)
    assert info["steps_run"] == 15 and len(info["objective_trace"]) == 16
    np.testing.assert_allclose(info["objective_trace"][-1], driver.objective(), rtol=RTOL)


def _nlml(M, arr):
    """The N=2000 objective at 64 points, of ``{"ell", "s2"}`` (logs)."""
    exp = jnp.exp if M is sj else torch.exp
    x = np.linspace(0.0, 10.0, 64)
    x, y = arr(x), arr(np.sin(x) + 0.3 * np.cos(3.2 * x))

    def f(p):
        g = M.GP(exp(p["s2"]) * M.EQ().stretch(exp(p["ell"])))
        return -g.measure.logpdf(g(x, 0.1), y)

    return f


def test_resumes_from_a_jax_checkpoint(tmp_path, steps):
    path = str(tmp_path / "ck.npz")
    init = {"ell": 0.0, "s2": 0.0}
    kw = dict(checkpoint_every=2, trace=True)
    jrm(_nlml(sj, jnp.asarray), {k: jnp.asarray(v) for k, v in init.items()}, steps=6,
        checkpoint_path=path, optimizer=optax.adam(5e-2), **kw)
    with pytest.warns(UserWarning, match="repr"):
        pt, it = trm(_nlml(st, _t), {k: _t(v) for k, v in init.items()}, steps=12,
                     checkpoint_path=path, optimizer=T.adam(5e-2), **kw)
    pj, ij = jrm(_nlml(sj, jnp.asarray), {k: jnp.asarray(v) for k, v in init.items()},
                 steps=12, checkpoint_path=str(tmp_path / "ref.npz"),
                 optimizer=optax.adam(5e-2), **kw)
    assert it["resumed_from"] == 6 and it["steps_run"] == 6
    for k in init:
        np.testing.assert_allclose(np_(pt[k]), np.asarray(pj[k]), rtol=RTOL)
    np.testing.assert_allclose(it["objective_trace"], ij["objective_trace"][6:], rtol=RTOL)


def test_the_card_refuses_adaptive_jitter(tmp_path, monkeypatch):
    # The refusal is gone: with the probe on the device the graph buffers
    # are built and stepped with adaptive jitter on (the captures stood in
    # for), as eagerly.
    monkeypatch.setattr(resilience, "_capture", _fake_capture)
    config.set_adaptive_jitter(True)
    try:
        p0 = {k: torch.tensor(v, dtype=torch.float64) for k, v in (("ell", 0.1), ("s2", 0.2))}
        run = resilience._GraphSteps(_nlml(st, _t), T.adam(0.1), p0, T.adam(0.1).init(p0), 1)
        val, ok = run.value_and_grad()
        ref = _nlml(st, _t)(p0)
    finally:
        config.set_adaptive_jitter(False)
    assert ok
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-12)


class _Stream:
    def wait_stream(self, other):
        pass


def test_a_failed_capture_raises(tmp_path, monkeypatch):
    # The CUDA calls of a capture, stood in for on the CPU; the capture
    # itself fails. The loop raises and runs nothing eagerly instead.
    import contextlib

    def refuse(graph):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setattr(resilience, "_EagerSteps", resilience._GraphSteps)
    with pytest.raises(RuntimeError, match="capturing the value and gradient"):
        trm(_quad(torch), {"x": torch.zeros(2, dtype=torch.float64)}, steps=3,
            checkpoint_path=str(tmp_path / "ck.npz"))
    assert not os.path.exists(tmp_path / "ck.npz")


def test_the_graph_buffers_are_not_aliased(tmp_path, monkeypatch):
    # After a rollback the anchor is the validated state, untouched by the
    # rejected update (which went through the same buffers).
    monkeypatch.setattr(resilience, "_capture", _fake_capture)
    opt = T.sgd(0.4)
    p0 = {"w": torch.tensor(0.0, dtype=torch.float64)}
    run = resilience._GraphSteps(_wall(torch), opt, p0, opt.init(p0), 1)
    val, ok = run.value_and_grad()
    assert ok
    run.validate()
    run.apply(1.0)
    assert float(run.P["w"]) == pytest.approx(24.0)
    _, ok = run.value_and_grad()
    assert not ok
    assert float(run.AP["w"]) == 0.0
    run.apply(0.5)
    assert float(run.P["w"]) == pytest.approx(12.0) and float(run.AP["w"]) == 0.0
