"""Parity of the port's pseudo-point path with the JAX package: the VFE,
FITC and DTC ELBOs and their gradients, the fitted state (``K_z``, ``mu``,
``A``) and the posterior after pseudo-conditioning, several observed
processes, the entry points of ``bench.py``'s two sparse sizes, sampling,
and the hand-off of a fitted JAX state; plus port-only mirrors of
``tests/model/test_model.py``'s pseudo-point cases, the
kernel-evaluation-count contract and the README's example 10. Both
packages run in one process on the same numpy float64 inputs (N <= 50,
M <= 10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_torch import config
from stheno_torch import entry as E
from stheno_torch.convert import params_from_jax, pseudo_obs_state_from_jax
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

CLASSES = {"vfe": "PseudoObs", "fitc": "PseudoObsFITC", "dtc": "PseudoObsDTC"}


def _data(n=40, m=8, seed=0):
    r = np.random.RandomState(seed)
    x = np.sort(r.rand(n)) * 10
    y = np.sin(x) + 0.1 * r.randn(n)
    z = np.linspace(0.3, 9.7, m)
    return x, y, z


def _noise(form, n):
    return 0.2 if form == "scalar" else 0.1 + 0.2 * np.random.RandomState(5).rand(n)


def _model(M, cls, x, y, z, ell, noise):
    f = M.GP(M.EQ().stretch(ell))
    return f, getattr(M, cls)(f(z), (f(x, noise), y))


def _elbo(M, cls, x, y, z, ell, noise):
    f, obs = _model(M, cls, x, y, z, ell, noise)
    return f.measure.logpdf(obs)


@pytest.mark.parametrize("form", ["scalar", "vector"])
@pytest.mark.parametrize("method", sorted(CLASSES))
def test_elbo_value_and_grads_match_jax(method, form):
    # torch.autograd against jax.grad, with respect to ell, noise and z.
    cls = CLASSES[method]
    x, y, z = _data()
    noise = _noise(form, len(x))
    vj, gj = jax.value_and_grad(
        lambda ell, noise, z: _elbo(sj, cls, jnp.asarray(x), jnp.asarray(y), z, ell, noise),
        argnums=(0, 1, 2),
    )(jnp.asarray(1.3), jnp.asarray(noise), jnp.asarray(z))
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (1.3, noise, z)]
    vt = _elbo(st, cls, torch.tensor(x), torch.tensor(y), leaves[2], leaves[0], leaves[1])
    gt = torch.autograd.grad(vt, leaves)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-8)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("method", sorted(CLASSES))
def test_fitted_state_and_posterior_match_jax(method):
    cls = CLASSES[method]
    x, y, z = _data(seed=1)
    x_new = np.linspace(-1.0, 11.0, 7)
    fj, oj = _model(sj, cls, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), 0.9, 0.15)
    ft, ot = _model(st, cls, torch.tensor(x), torch.tensor(y), torch.tensor(z), 0.9, 0.15)
    for name in ("K_z", "mu", "A"):
        a, b = getattr(ot, name)(ft.measure), getattr(oj, name)(fj.measure)
        np.testing.assert_allclose(np_(st.dense(a)), np_(sj.dense(b)), rtol=1e-8, atol=1e-12)
    pj, pt = (fj | oj)(jnp.asarray(x_new)), (ft | ot)(torch.tensor(x_new))
    for a, b in zip(pt.marginals(), pj.marginals()):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np_(st.dense(pt.var)), np_(sj.dense(pj.var)), rtol=1e-8,
                               atol=1e-12)


def test_several_processes_pseudo_obs_match_jax():
    # Inducing points on two correlated processes, data on both: the
    # combined (cross-process) pipeline.
    x, y, z = _data(n=30, m=6, seed=2)
    y2 = np.cos(x)

    def run(M, arr):
        m = M.Measure()
        f1 = M.GP(M.EQ(), measure=m)
        f2 = f1 + M.GP(0.3 * M.Matern32(), measure=m)
        obs = M.PseudoObs((f1(arr(z)), f2(arr(z[::2]))), (f1(arr(x), 0.1), arr(y)),
                          (f2(arr(x[::3]), 0.2), arr(y2[::3])))
        mean, var = m.condition(obs)(f2)(arr(np.linspace(0, 10, 5))).marginals()
        return m.logpdf(obs), mean, var

    for a, b in zip(run(st, torch.tensor), run(sj, jnp.asarray)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-8, atol=1e-12)


# --- port-only mirrors of tests/model/test_model.py ---------------------------


def _setup(n=10):
    x = torch.linspace(0.0, 10.0, n, dtype=torch.float64)
    return x, torch.sin(x)


@pytest.mark.parametrize("noise_form", ["scalar", "vector"])
@pytest.mark.parametrize("method", sorted(CLASSES))
def test_pseudo_equals_exact_when_inducing_at_data(method, noise_form):
    f = st.GP(st.EQ())
    x, y = _setup()
    noise = 0.1 if noise_form == "scalar" else torch.full((10,), 0.1, dtype=torch.float64)
    fdd = f(x, noise)
    obs = getattr(st, CLASSES[method])(f(x), (fdd, y))
    x_new = torch.linspace(0.0, 10.0, 6, dtype=torch.float64)
    post_pseudo = f.measure.condition(obs)(f)(x_new)
    post_exact = (f | (fdd, y))(x_new)
    np.testing.assert_allclose(np_(post_pseudo.mean), np_(post_exact.mean), atol=1e-5)
    np.testing.assert_allclose(np_(st.dense(post_pseudo.var)), np_(st.dense(post_exact.var)),
                               atol=1e-5)
    np.testing.assert_allclose(float(obs.elbo(f.measure)), float(f.measure.logpdf(fdd, y)),
                               atol=1e-6, rtol=1e-6)


def test_pseudo_dense_noise_rejected():
    f = st.GP(st.EQ())
    x, y = _setup()
    obs = st.PseudoObs(f(x), (f(x, st.Dense(0.1 * torch.eye(10, dtype=torch.float64))), y))
    with pytest.raises(RuntimeError, match="diagonal"):
        obs.elbo(f.measure)


def test_pseudo_caching_identity():
    f = st.GP(st.EQ())
    x, y = _setup()
    obs = st.PseudoObs(f(torch.linspace(0.0, 10.0, 5, dtype=torch.float64)), (f(x, 0.1), y))
    assert obs.elbo(f.measure) is obs.elbo(f.measure)
    assert obs.K_z(f.measure) is obs.K_z(f.measure)
    assert obs.mu(f.measure) is obs.mu(f.measure)
    assert obs.A(f.measure) is obs.A(f.measure)
    assert st.SparseObs is st.PseudoObs and st.SparseObservations is st.PseudoObservations


def test_elbo_lower_bounds_logpdf():
    f = st.GP(st.EQ())
    x, y = _setup(20)
    fdd = f(x, 0.1)
    lp = float(f.measure.logpdf(fdd, y))
    for m_ind in (3, 8, 15):
        z = torch.linspace(0.0, 10.0, m_ind, dtype=torch.float64)
        assert float(f.measure.logpdf(st.PseudoObs(f(z), (fdd, y)))) <= lp + 1e-6


class TrackingEQ(st.EQ):
    """EQ recording the inputs of every pairwise and elwise evaluation."""

    def __init__(self):
        self.pairwise_calls = []
        self.elwise_calls = []

    def _pairwise(self, x, y):
        self.pairwise_calls.append((_key(x), _key(y)))
        return super()._pairwise(x, y)

    def _elwise(self, x, y):
        self.elwise_calls.append((_key(x), _key(y)))
        return super()._elwise(x, y)

    def __eq__(self, other):
        return self is other

    __hash__ = object.__hash__


def _key(u):
    return tuple(np.round(np_(u).ravel(), 10))


def test_pseudo_posterior_kernel_evaluation_contract():
    # Posterior marginals after PseudoObs evaluate pairwise Grams only at
    # (x_obs, x_ind), (x_ind, x_ind) and (x_ind, x_new), elwise only at
    # (x_obs,) and (x_new,): never at (x_obs, x_obs), which at N=10^6
    # would be a 4 TB Gram.
    r = np.random.RandomState(0)
    x_obs = torch.linspace(0.0, 5.0, 10, dtype=torch.float64)
    x_ind = torch.linspace(0.0, 5.0, 5, dtype=torch.float64)
    x_new = torch.tensor(r.randn(3))
    k = TrackingEQ()
    p = st.GP(1, k)
    obs = st.PseudoObs(p(x_ind), (p(x_obs, 0.1), torch.tensor(r.randn(10))))
    float(p.measure.logpdf(obs))
    mean, var = (p | obs)(x_new).marginals()
    assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
    allowed_pairwise = {(_key(a), _key(b)) for a, b in [
        (x_obs, x_ind), (x_ind, x_obs), (x_ind, x_ind), (x_ind, x_new), (x_new, x_ind)]}
    allowed_elwise = {(_key(x_obs), _key(x_obs)), (_key(x_new), _key(x_new))}
    assert set(k.pairwise_calls) <= allowed_pairwise
    assert set(k.elwise_calls) <= allowed_elwise
    assert (_key(x_obs), _key(x_obs)) not in set(k.pairwise_calls)


def test_example10_sparse():
    # README example 10 on the port: data drawn from the prior, the ELBO
    # below the exact logpdf, the sparse posterior close to the exact one.
    x = torch.linspace(0.0, 10.0, 2000, dtype=torch.float64)
    x_ind = torch.linspace(0.0, 10.0, 20, dtype=torch.float64)
    f = st.GP(st.EQ().periodic(2.0))
    y = f.measure.sample(torch.Generator().manual_seed(6), f(x, 0.5))[:, 0]
    obs = st.PseudoObs(f(x_ind), (f(x, 0.5), y))
    elbo = float(f.measure.logpdf(obs))
    lp = float(f.measure.logpdf(f(x, 0.5), y))
    assert elbo <= lp
    mean, _ = f.measure.condition(obs)(f)(x).marginals()
    mean_ref, _ = (f | (f(x, 0.5), y))(x).marginals()
    np.testing.assert_allclose(np_(mean), np_(mean_ref), atol=0.1)


# --- sampling ------------------------------------------------------------------


def test_normal_sample_moments():
    # 40,000 draws of an FDD with a mean and of a Normal with extra noise.
    x = np.linspace(0.0, 3.0, 4)
    fj = sj.GP(1.5, sj.EQ())
    want_var = np_(sj.dense(fj(jnp.asarray(x), 0.1).var))
    f = st.GP(1.5, st.EQ())
    s = f(torch.tensor(x), 0.1).sample(torch.Generator().manual_seed(1), 40_000)
    assert s.shape == (4, 40_000)
    np.testing.assert_allclose(np_(s.mean(dim=1)), 1.5, atol=0.04)
    c = s - s.mean(dim=1, keepdim=True)
    np.testing.assert_allclose(np_(c @ c.T / s.shape[1]), want_var, atol=0.05)
    ones = torch.ones(4, dtype=torch.float64)
    d = st.Normal(torch.zeros(4, 1, dtype=torch.float64), st.Diagonal(ones))
    s = d.sample(torch.Generator().manual_seed(2), 40_000, noise=3.0)
    np.testing.assert_allclose(np_(s.var(dim=1)), 4.0, rtol=0.05)


def test_normal_sample_global_generator():
    st.set_global_seed(3)
    a = st.Normal(st.Diagonal(torch.ones(3, dtype=torch.float64))).sample(num=2)
    st.set_global_seed(3)
    b = st.Normal(st.Diagonal(torch.ones(3, dtype=torch.float64))).sample(num=2)
    assert a.shape == (3, 2) and torch.equal(a, b)


def test_measure_sample_joint_moments():
    # Two correlated processes sampled jointly: the cross-covariance is the
    # JAX package's cross-kernel.
    x = np.linspace(0.0, 2.0, 3)
    mj = sj.Measure()
    gj = sj.GP(sj.EQ(), measure=mj)
    hj = gj + sj.GP(0.5 * sj.Matern32(), measure=mj)
    want = np_(sj.dense(sj.pairwise(mj.kernels[gj, hj], jnp.asarray(x))))
    m = st.Measure()
    g = st.GP(st.EQ(), measure=m)
    h = g + st.GP(0.5 * st.Matern32(), measure=m)
    xt = torch.tensor(x)
    s1, s2 = m.sample(torch.Generator().manual_seed(4), 40_000, g(xt), h(xt))
    assert s1.shape == (3, 40_000) and s2.shape == (3, 40_000)
    np.testing.assert_allclose(np_(s1 @ s2.T / s1.shape[1]), want, atol=0.05)
    one = m.sample(torch.Generator().manual_seed(4), g(xt))
    assert one.shape == (3, 1)


# --- entry points and the hand-off from the JAX package ---------------------------


def _jax_sparse(method, x, y, z, log_ell, log_noise):
    f = sj.GP(sj.EQ().stretch(jnp.exp(log_ell)))
    obs = getattr(sj, CLASSES[method])(f(z), (f(jnp.asarray(np_(x)), jnp.exp(log_noise)),
                                              jnp.asarray(np_(y))))
    return f, obs


@pytest.mark.parametrize("method", sorted(CLASSES))
def test_sparse_entry_points_match_jax(method):
    # E.sparse_elbo (bench.py's vfe_elbo_n2000 / sparse_elbo_1m) at a small
    # size: the value and the gradient with respect to (log ell, log noise,
    # z), against the JAX package with the same jitter.
    x, y, z, ell = E.vfe_n2000_inputs(torch.float64, "cpu", n=50, m=10)
    jax_cfg = sj.config
    jax_cfg.set_epsilon(1e-9)
    try:
        def elbo(log_ell, log_noise, z):
            f, obs = _jax_sparse(method, x, y, z, log_ell, log_noise)
            return f.measure.logpdf(obs)

        vj, gj = jax.value_and_grad(elbo, argnums=(0, 1, 2))(
            jnp.asarray(0.0), jnp.asarray(np.log(E.SPARSE_NOISE)), jnp.asarray(np_(z)))
    finally:
        jax_cfg.set_epsilon(None)
    vt, gt = E.vfe_elbo_n2000(x, y, z, ell, grad=True, method=method, jitter=1e-9)
    assert E.sparse_elbo_1m is E.sparse_elbo
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-8)
    np.testing.assert_allclose(float(E.sparse_elbo(x, y, z, ell, method=method, jitter=1e-9)),
                               float(vj), rtol=1e-8)
    for name, g in zip(("log_ell", "log_noise", "z"), gj):
        np.testing.assert_allclose(np_(gt[name]), np_(g), rtol=1e-8, atol=1e-10)
    assert config.epsilon is None and not config.adaptive_jitter


def test_sparse_predict_matches_jax():
    # E.sparse_predict: the VFE posterior marginals against the JAX
    # package's with the same jitter.
    x, y, z, ell = E.vfe_n2000_inputs(torch.float64, "cpu", n=50, m=10)
    x_new = torch.linspace(0.0, 10.0, 9, dtype=torch.float64)
    jax_cfg = sj.config
    jax_cfg.set_epsilon(1e-9)
    try:
        fj, oj = _jax_sparse("vfe", x, y, jnp.asarray(np_(z)), jnp.asarray(0.0),
                             jnp.asarray(np.log(E.SPARSE_NOISE)))
        mj, varj = (fj | oj)(jnp.asarray(np_(x_new))).marginals()
    finally:
        jax_cfg.set_epsilon(None)
    mt, vart = E.sparse_predict(x, y, z, ell, x_new, jitter=1e-9)
    np.testing.assert_allclose(np_(mt), np_(mj), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np_(vart), np_(varj), rtol=1e-8, atol=1e-12)
    assert config.epsilon is None and not config.adaptive_jitter


def test_sparse_inputs_are_benchs():
    # bench.py's constructions, in numpy: bench_dist_elbo_1m's RandomState(1)
    # data and bench_vfe_n2000's grid.
    n = 1000
    r = np.random.RandomState(1)
    xb = np.sort(r.rand(n).astype(np.float32)) * 10
    yb = np.sin(xb) + np.float32(0.1) * r.randn(n).astype(np.float32)
    x, y, z, ell = E.sparse_1m_inputs(device="cpu", n=n)
    assert x.dtype == torch.float32 and float(ell) == 1.0
    np.testing.assert_array_equal(np_(x), xb)
    np.testing.assert_allclose(np_(y), yb, rtol=1e-6)
    np.testing.assert_allclose(np_(z), np.linspace(0.0, 10.0, 512), rtol=1e-6)
    x, y, z, _ = E.vfe_n2000_inputs(torch.float64, "cpu")
    assert x.shape == (2000,) and z.shape == (100,)
    np.testing.assert_allclose(np_(y), np.sin(np_(x)) + 0.3 * np.cos(3.2 * np_(x)), rtol=1e-12)


def test_adaptive_jitter_of_the_entry_points():
    # jitter=None factors with the adaptive probe's jitter, which
    # sparse_jitter reports, and leaves the configuration as it was.
    x, y, z, ell = E.vfe_n2000_inputs(torch.float64, "cpu", n=50, m=10)
    eps = E.sparse_jitter(z, ell)
    assert eps == config.jitter(torch.float64)
    v = E.sparse_elbo(x, y, z, ell)
    np.testing.assert_allclose(float(v), float(E.sparse_elbo(x, y, z, ell, jitter=eps)),
                               rtol=1e-12)
    assert config.epsilon is None and not config.adaptive_jitter


def test_pseudo_obs_state_from_jax_predicts_as_jax():
    x, y, z = _data(seed=3)
    x_new = np.linspace(0.0, 10.0, 6)
    fj, oj = _model(sj, "PseudoObs", jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), 1.1, 0.2)
    mj, vj = (fj | oj)(jnp.asarray(x_new)).marginals()
    state = {k: np.asarray(sj.dense(getattr(oj, k)(fj.measure))) for k in ("K_z", "mu", "A")}
    p = params_from_jax({"ell": np.asarray(1.1)}, device="cpu", dtype=torch.float64)
    f = st.GP(st.EQ().stretch(p["ell"]))
    obs = st.PseudoObs(f(torch.tensor(z)), (f(torch.tensor(x), 0.2), torch.tensor(y)))
    pseudo_obs_state_from_jax(obs, f.measure, state["K_z"], state["mu"], state["A"],
                              device="cpu")
    assert obs.A(f.measure).mat.dtype == torch.float64 and obs._elbo == {}
    mt, vt = (f | obs)(torch.tensor(x_new)).marginals()
    np.testing.assert_allclose(np_(mt), np_(mj), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np_(vt), np_(vj), rtol=1e-8, atol=1e-12)
