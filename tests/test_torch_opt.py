"""The port's optimisers (``stheno_torch.opt``: ``Vars``, ``AdamDriver``,
``minimise_adam``, ``minimise_lbfgs``) against ``stheno_tpu.opt`` on the
same numpy inputs, float64 on the CPU; the hand-off of a run between the
packages (``convert.vars_from_jax``, ``adam_state_from_jax``); the
training entry points at a small size; and the branches that a CUDA graph
capture takes (a monkeypatched capture predicate, a faked CUDA device).

Tolerances: the bijections are one elementary function each, so rtol
1e-12. Adam is the same update (``torch.optim.Adam`` with optax's
defaults) on gradients that agree to rounding, so 20 steps agree to rtol
1e-8, the slice's tolerance. L-BFGS runs another line search (strong
Wolfe against optax's zoom), so only the optimum is compared: the NLML to
rel 1e-6 and ``ell`` and ``noise`` to 1e-3 (a converged fit of a smooth
objective).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu import opt as jopt
from stheno_torch import config
from stheno_torch import entry as E
from stheno_torch import opt as topt
from stheno_torch.convert import adam_state_from_jax, vars_from_jax
from stheno_torch.matrix import ops as tops
from stheno_torch.ops import gram as tgram
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

RTOL = 1e-8


def _bench_model(M, a, n=64):
    """``bench.py:bench_opt_steps``'s objective at ``n`` points, for the
    package ``M`` with array constructor ``a``."""
    x = np.linspace(0.0, 10.0, n)
    x, y = a(x), a(np.sin(x) + 0.3 * np.cos(3.2 * x))

    def f(v):
        ell = v.positive(1.0, name="ell")
        s2 = v.positive(1.0, name="s2")
        g = M.GP(s2 * M.EQ().stretch(ell))
        return -g.measure.logpdf(g(x, 0.1), y)

    return f


def _t64(v):
    return torch.tensor(v, dtype=torch.float64)


def _fj():
    return _bench_model(sj, jnp.asarray)


def _ft():
    return _bench_model(st, torch.tensor)


# -- Vars -------------------------------------------------------------------


@pytest.mark.parametrize(
    "kind, init",
    [("unbounded", [-3.0, 0.5]), ("positive", [2.0, 1e-3]), ("bounded", [0.5, 0.15])],
)
def test_bijections_and_inverses_match_jax(kind, init):
    def register(vs, a):
        if kind == "bounded":
            return vs.bounded(a(init), 0.1, 0.9, name="p", shape=(2,))
        return getattr(vs, kind)(a(init), name="p", shape=(2,))

    vj, vt = jopt.Vars(), topt.Vars(device="cpu")
    cj, ct = register(vj, jnp.asarray), register(vt, _t64)
    np.testing.assert_allclose(np_(ct), np_(cj), rtol=1e-12)
    np.testing.assert_allclose(np_(ct), init, rtol=1e-12)
    np.testing.assert_allclose(np_(vt.latent_dict()["p"]), np_(vj.latent_dict()["p"]), rtol=1e-12)
    # Get-or-create: a second call reads the stored value; a view reads
    # its own latent values.
    np.testing.assert_allclose(np_(register(vt, lambda v: _t64(v) + 7.0)), init, rtol=1e-12)
    z = np.asarray([0.3, -1.2])
    np.testing.assert_allclose(
        np_(vt.with_latent({"p": torch.tensor(z)})["p"]),
        np_(vj.with_latent({"p": jnp.asarray(z)})["p"]),
        rtol=1e-12,
    )
    assert vt.latent_dict()["p"].is_leaf and vt.names() == ["p"]
    assert str(vt).startswith("Vars(\n  p = [")


def test_unnamed_parameters_replay_positionally_as_in_jax():
    def f(v):
        return (v.unbounded(0.0) - 3.0) ** 2 + (v.positive(1.0) - 2.0) ** 2

    vj, vt = jopt.Vars(), topt.Vars(device="cpu")
    fj = jopt.minimise_adam(f, vj, iters=40, rate=0.1)
    ft = topt.minimise_adam(f, vt, iters=40, rate=0.1)
    assert sorted(vt.names()) == sorted(vj.names()) == ["var0", "var1"]
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    for k in ("var0", "var1"):
        np.testing.assert_allclose(np_(vt[k]), np_(vj[k]), rtol=RTOL)


def test_empty_vars_raises_as_in_jax():
    with pytest.raises(ValueError, match="no parameters"):
        jopt.minimise_lbfgs(lambda v: jnp.asarray(1.0), jopt.Vars(), iters=2)
    for fn in (topt.minimise_lbfgs, topt.minimise_adam):
        with pytest.raises(ValueError, match="no parameters"):
            fn(lambda v: torch.tensor(1.0), topt.Vars(device="cpu"), iters=2)
    with pytest.raises(ValueError, match="no parameters"):
        topt.AdamDriver(lambda v: torch.tensor(1.0), topt.Vars(device="cpu"))


# -- Adam -------------------------------------------------------------------


def _dispatches(k, total=20):
    """``run`` sizes that take ``total`` steps as the JAX driver's full
    chains of ``k`` and single steps for the remainder."""
    return [k] * (total // k) + [1] * (total % k)


@pytest.mark.parametrize("k", [1, 5, 7])
def test_adam_driver_trajectory_matches_jax(k):
    dj = jopt.AdamDriver(_fj(), jopt.Vars(), rate=1e-3, steps_per_dispatch=k)
    dt = topt.AdamDriver(_ft(), topt.Vars(device="cpu"), rate=1e-3, steps_per_dispatch=k)
    for size in _dispatches(k):
        np.testing.assert_allclose(float(dt.run(size)), float(dj.run(size)), rtol=RTOL)
        for name in ("ell", "s2"):
            np.testing.assert_allclose(np_(dt.vs[name]), np_(dj.vs[name]), rtol=RTOL)
    # k = 7 does not divide 20: for the JAX driver one run of 20 is two
    # chains and six single steps.
    dj2 = jopt.AdamDriver(_fj(), jopt.Vars(), rate=1e-3, steps_per_dispatch=k)
    dt2 = topt.AdamDriver(_ft(), topt.Vars(device="cpu"), rate=1e-3, steps_per_dispatch=k)
    np.testing.assert_allclose(float(dt2.run(20)), float(dj2.run(20)), rtol=RTOL)
    np.testing.assert_allclose(np_(dt2.vs["ell"]), np_(dt.vs["ell"]), rtol=RTOL)
    np.testing.assert_allclose(dt.objective(), dj.objective(), rtol=RTOL)


def test_adam_handoff_from_jax_mid_run():
    """10 JAX steps, carried across (latent values and optax's state),
    then 10 port steps: the same as 20 JAX steps."""
    ref = jopt.AdamDriver(_fj(), jopt.Vars(), rate=1e-3)
    ref.run(20)
    dj = jopt.AdamDriver(_fj(), jopt.Vars(), rate=1e-3)
    dj.run(10)
    adam = dj.state[0]
    vs = vars_from_jax({k: np.asarray(v) for k, v in dj.params.items()},
                       {"ell": "positive", "s2": "positive"}, device="cpu")
    dt = topt.AdamDriver(_ft(), vs, rate=1e-3)
    dt.load_state(adam_state_from_jax({k: np.asarray(v) for k, v in adam.mu.items()},
                                      {k: np.asarray(v) for k, v in adam.nu.items()},
                                      int(adam.count), device="cpu"))
    dt.run(10)
    for name in ("ell", "s2"):
        np.testing.assert_allclose(np_(dt.vs[name]), np_(ref.vs[name]), rtol=RTOL)


def test_vars_from_jax_gives_the_constrained_values():
    vj = jopt.Vars()
    vj.positive(2.5, name="a")
    vj.bounded(0.3, -1.0, 2.0, name="b", shape=(3,))
    vj.unbounded(-4.0, name="c")
    kinds = {"a": "positive", "b": ("bounded", -1.0, 2.0), "c": "unbounded"}
    vt = vars_from_jax({k: np.asarray(v) for k, v in vj.latent_dict().items()}, kinds,
                       device="cpu")
    for k in kinds:
        np.testing.assert_allclose(np_(vt[k]), np_(vj[k]), rtol=1e-12)
    with pytest.raises(ValueError, match="Unknown constraint"):
        vars_from_jax({"a": np.zeros(())}, {"a": "negative"}, device="cpu")


def test_minimise_adam_matches_jax_on_a_quadratic():
    def f(M, a):
        return lambda v: M.sum(
            (v.unbounded(a(np.zeros(3)), name="w", shape=(3,)) - a(np.asarray([1.0, -2.0, 0.5])))
            ** 2
        )

    vj, vt = jopt.Vars(), topt.Vars(device="cpu")
    fj = jopt.minimise_adam(f(jnp, jnp.asarray), vj, iters=25, rate=0.1, steps_per_dispatch=5)
    ft = topt.minimise_adam(f(torch, torch.tensor), vt, iters=25, rate=0.1,
                            steps_per_dispatch=5)
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    np.testing.assert_allclose(np_(vt["w"]), np_(vj["w"]), rtol=RTOL)


def test_adam_n2000_entry_at_a_small_size_matches_jax():
    dt = E.adam_n2000(5, device="cpu", dtype=torch.float64, n=64)
    dj = jopt.AdamDriver(_fj(), jopt.Vars(), rate=1e-3, steps_per_dispatch=5)
    np.testing.assert_allclose(float(dt.run(12)), float(dj.run(12)), rtol=RTOL)
    assert dt.vs.device.type == "cpu" and dt.vs["ell"].dtype == torch.float64


# -- L-BFGS -----------------------------------------------------------------


def _lbfgs_data(ell=1.5, s2=2.0, noise=0.05, n=150, seed=0):
    """``tests/test_opt.py:_data``'s model, its sample drawn with numpy."""
    x = np.linspace(0, 15, n)
    K = s2 * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / ell**2) + noise * np.eye(n)
    y = np.linalg.cholesky(K + 1e-10 * np.eye(n)) @ np.random.RandomState(seed).randn(n)
    return x, y


def _nlml(M, a, x, y):
    x, y = a(x), a(y)

    def f(vs):
        ell = vs.positive(1.0, name="ell")
        s2 = vs.positive(1.0, name="s2")
        noise = vs.positive(0.1, name="noise")
        g = M.GP(s2 * M.EQ().stretch(ell))
        return -g.measure.logpdf(g(x, noise), y)

    return f


def test_lbfgs_reaches_the_jax_optimum():
    x, y = _lbfgs_data()
    vj, vt = jopt.Vars(), topt.Vars(device="cpu")
    fj = jopt.minimise_lbfgs(_nlml(sj, jnp.asarray, x, y), vj, iters=60)
    ft = topt.minimise_l_bfgs_b(_nlml(st, torch.tensor, x, y), vt, iters=60)
    np.testing.assert_allclose(ft, fj, rtol=1e-6)
    for k in ("ell", "noise"):
        np.testing.assert_allclose(np_(vt[k]), np_(vj[k]), rtol=1e-3)
    assert 0.8 < float(vt["ell"]) < 2.8 and 0.01 < float(vt["noise"]) < 0.2


def test_lbfgs_stops_on_a_non_finite_objective():
    calls = []

    def f(v):
        calls.append(None)
        w = v.unbounded(1.0, name="w")
        return w * torch.tensor(float("nan"), dtype=w.dtype) if len(calls) > 2 else w**2

    vs = topt.Vars(device="cpu")
    assert not np.isfinite(topt.minimise_lbfgs(f, vs, iters=50))
    assert len(calls) < 10


# -- The capture branches ---------------------------------------------------


@pytest.fixture
def capturing(monkeypatch):
    monkeypatch.setattr(config, "capturing", lambda: True)


def test_nan_checks_are_skipped_while_capturing(capturing):
    x = torch.linspace(0.0, 1.0, 6, dtype=torch.float64)
    y = torch.sin(x)
    y[2] = float("nan")
    f = st.GP(st.EQ())
    # No NaN row dropped: the checks that read the data on the host are
    # skipped, so the NaN flows through.
    assert torch.isnan(f.measure.logpdf(f(x, 0.1), y))
    obs = st.Obs(f(x, 0.1), y)
    assert obs.y.shape == (6, 1) and bool(torch.isnan(obs.y).any())


def test_nan_checks_drop_missing_rows_when_not_capturing():
    x = torch.linspace(0.0, 1.0, 6, dtype=torch.float64)
    y = torch.sin(x)
    y[2] = float("nan")
    keep = torch.tensor([0, 1, 3, 4, 5])
    f = st.GP(st.EQ())
    np.testing.assert_allclose(float(f.measure.logpdf(f(x, 0.1), y)),
                               float(f.measure.logpdf(f(x[keep], 0.1), y[keep])), rtol=1e-12)
    assert st.Obs(f(x, 0.1), y).y.shape == (5, 1)


def test_adam_driver_on_the_card_refuses_adaptive_jitter():
    vs = topt.Vars(device="cpu")
    vs.device = torch.device("cuda")  # Faked: the refusal comes first.
    config.set_adaptive_jitter(True)
    try:
        with pytest.raises(NotImplementedError, match="adaptive-jitter"):
            topt.AdamDriver(lambda v: v.positive(1.0, name="a") ** 2, vs)
    finally:
        config.set_adaptive_jitter(False)


def test_adaptive_jitter_probe_raises_while_capturing(capturing):
    with pytest.raises(RuntimeError, match="adaptive-jitter probe"):
        tops.adaptive_jitter_eps(torch.eye(3, dtype=torch.float64), 1e-12)


def test_rq_tensor_alpha_raises_while_capturing(capturing):
    x = torch.randn(5, 1, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="alpha"):
        tgram.gram("rq", x, x, torch.tensor(2.0, dtype=torch.float64))
    # A number is a constant of the graph: allowed.
    assert tgram.gram("rq", x, x, 2.0).shape == (5, 5)


@pytest.mark.parametrize("noise", [0.1, np.float32(0.1), np.asarray(0.1)])
def test_scalar_noise_is_filled_on_the_device(noise, monkeypatch):
    def no_host_copy(*args, **kwargs):
        raise AssertionError("a raw scalar went through torch.as_tensor")

    from stheno_torch.model import fdd

    monkeypatch.setattr(fdd.torch, "as_tensor", no_host_copy)
    m = fdd.noise_as_matrix(noise, torch.float64, 4, torch.device("cpu"))
    np.testing.assert_allclose(np_(m.diag), np.full(4, 0.1), rtol=1e-7)
    assert m.diag.dtype == torch.float64


def test_capturing_holds_inside_no_host_sync_only():
    with config.no_host_sync():
        assert config.capturing()
        x = torch.tensor([0.0, float("nan")], dtype=torch.float64)
        f = st.GP(st.EQ())
        assert torch.isnan(f.measure.logpdf(f(x, 0.1), x))
    assert not config._no_host_sync
    if not torch.cuda.is_available():
        assert config.capturing() is False
