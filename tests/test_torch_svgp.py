"""Parity of the port's SVGP (``stheno_torch/model/svgp.py``) with
``stheno_tpu``, in float64 on the same numpy inputs: the minibatch ELBO
and its gradient in (theta, z, q_mu, q_sqrt), the predictive marginals
(with and without noise and a mean) and the natural-gradient step, from
the state that ``convert.svgp_params_from_jax`` carries across; the
stories of ``tests/model/test_svgp.py`` on the port (the collapsed-bound
identity, the collapsed posterior, unbiased minibatches, natural-gradient
and Adam training, the mean function); the batch sharded
over D = 1, 2 and 4 ranks against the replicated batch; and the N=10^6
entry points (``entry.svgp_1m_step``, ``svgp_1m_natgrad``) at a small N,
with and without a mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_torch import entry as E
from stheno_torch.convert import svgp_params_from_jax
import tests.torch_parallel_worker as W
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

N, M, NOISE = 60, 12, 0.05


def _close(got, want, rtol=1e-8, atol=1e-12):
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=rtol, atol=atol)


def _problem():
    r = np.random.RandomState(0)
    x = np.sort(r.rand(N) * 8.0)
    y = np.sin(x) + 0.2 * r.randn(N)
    return x, y, np.linspace(0.0, 8.0, M)


def _kernel(M_, theta):
    exp = jnp.exp if M_ is sj else torch.exp
    return exp(theta["log_s2"]) * M_.EQ().stretch(exp(theta["log_ell"]))


THETA = {"log_s2": np.log(1.3), "log_ell": np.log(0.9)}


def _mean(M_):
    return lambda t: 0.7 * t + 1.2


@pytest.fixture(scope="module")
def jax_state():
    """A non-trivial SVGP state of the JAX package: a full-batch rho=1
    step, then a rho=0.4 step on half the data (so S is not the optimum's)."""
    x, y, z = _problem()
    th = {k: jnp.asarray(v) for k, v in THETA.items()}
    k = _kernel(sj, th)
    p = sj.svgp_natgrad_step(k, sj.svgp_init(k, jnp.asarray(z)), jnp.asarray(x)[:, None],
                             jnp.asarray(y), NOISE, N, rho=1.0)
    p = sj.svgp_natgrad_step(k, p, jnp.asarray(x[:30])[:, None], jnp.asarray(y[:30]), NOISE,
                             N, rho=0.4)
    return {k: np.asarray(v) for k, v in p.items()}


def _port_state(jax_state):
    return svgp_params_from_jax(jax_state, device="cpu")


@pytest.mark.parametrize("mean", [None, "affine"])
@pytest.mark.parametrize("batch", [slice(None), slice(10, 40)])
def test_elbo_and_gradient_match_jax(jax_state, mean, batch):
    x, y, _ = _problem()
    xb, yb = x[batch], y[batch]
    out = {}
    for key, M_, arr in (("j", sj, jnp.asarray), ("t", st, torch.tensor)):
        m = None if mean is None else _mean(M_)

        def elbo(theta, p):
            return M_.svgp_elbo(_kernel(M_, theta), p, arr(xb)[:, None], arr(yb), NOISE, N,
                                mean=m)

        theta = {k: arr(v) for k, v in THETA.items()}
        if key == "j":
            p = {k: jnp.asarray(v) for k, v in jax_state.items()}
            v, (gt, gp) = jax.value_and_grad(elbo, argnums=(0, 1))(theta, p)
        else:
            p = _port_state(jax_state)
            leaves = {**theta, **p}
            for t in leaves.values():
                t.requires_grad_(True)
            v = elbo(theta, p)
            grads = torch.autograd.grad(v, list(leaves.values()))
            g = dict(zip(leaves, grads))
            gt = {k: g[k] for k in theta}
            gp = {k: g[k] for k in p}
        out[key] = (v, gt, gp)
    (vj, gtj, gpj), (vt, gtt, gpt) = out["j"], out["t"]
    _close(vt.detach(), vj)
    for k in THETA:
        _close(gtt[k], gtj[k])
    for k in ("z", "q_mu", "q_sqrt"):
        _close(gpt[k], gpj[k], atol=1e-10)


@pytest.mark.parametrize("noise", [None, NOISE])
@pytest.mark.parametrize("mean", [None, "affine"])
def test_predict_matches_jax(jax_state, noise, mean):
    x_new = np.linspace(-1.0, 9.0, 23)
    kj = _kernel(sj, {k: jnp.asarray(v) for k, v in THETA.items()})
    kt = _kernel(st, {k: torch.tensor(v) for k, v in THETA.items()})
    pj = {k: jnp.asarray(v) for k, v in jax_state.items()}
    mj, vj = sj.svgp_predict(kj, pj, jnp.asarray(x_new)[:, None], noise=noise,
                             mean=None if mean is None else _mean(sj))
    mt, vt = st.svgp_predict(kt, _port_state(jax_state), torch.tensor(x_new)[:, None],
                             noise=noise, mean=None if mean is None else _mean(st))
    _close(mt, mj)
    _close(vt, vj, atol=1e-12)


@pytest.mark.parametrize("rho", [1.0, 0.3])
@pytest.mark.parametrize("mean", [None, "affine"])
def test_natgrad_step_matches_jax(jax_state, rho, mean):
    x, y, _ = _problem()
    idx = np.random.RandomState(3).choice(N, size=20, replace=False)
    kj = _kernel(sj, {k: jnp.asarray(v) for k, v in THETA.items()})
    kt = _kernel(st, {k: torch.tensor(v) for k, v in THETA.items()})
    pj = sj.svgp_natgrad_step(kj, {k: jnp.asarray(v) for k, v in jax_state.items()},
                              jnp.asarray(x[idx])[:, None], jnp.asarray(y[idx]), NOISE, N,
                              rho, mean=None if mean is None else _mean(sj))
    pt = st.svgp_natgrad_step(kt, _port_state(jax_state), torch.tensor(x[idx])[:, None],
                              torch.tensor(y[idx]), NOISE, N, rho,
                              mean=None if mean is None else _mean(st))
    for k in ("z", "q_mu", "q_sqrt"):
        _close(pt[k], pj[k], atol=1e-10)


def test_svgp_params_from_jax_carries_init():
    z = np.linspace(0.0, 1.0, 5)
    pj = sj.svgp_init(sj.EQ(), jnp.asarray(z))
    pt = svgp_params_from_jax({k: np.asarray(v) for k, v in pj.items()}, device="cpu")
    ref = st.svgp_init(st.EQ(), torch.tensor(z))
    for k in ("z", "q_mu", "q_sqrt"):
        assert pt[k].shape == ref[k].shape
        _close(pt[k], np_(ref[k]), rtol=0, atol=0)


# --- the stories of tests/model/test_svgp.py, on the port ---------------------


@pytest.fixture()
def problem():
    x, y, z = _problem()
    return 1.3 * st.EQ().stretch(0.9), torch.tensor(x), torch.tensor(y), torch.tensor(z), NOISE


def _collapsed(k, x, y, z, noise, mean=None):
    f = st.GP(k) if mean is None else st.GP(mean, k)
    return f, st.PseudoObs(f(z), (f(x, noise), y))


def _optimal(k, x, y, z, noise, **kw):
    return st.svgp_natgrad_step(k, st.svgp_init(k, z), x[:, None], y, noise, N, rho=1.0, **kw)


def test_full_batch_natgrad_recovers_collapsed_elbo(problem):
    k, x, y, z, noise = problem
    params = _optimal(k, x, y, z, noise)
    elbo = st.svgp_elbo(k, params, x[:, None], y, noise, N)
    f, obs = _collapsed(k, x, y, z, noise)
    _close(elbo, np_(obs.elbo(f.measure)), rtol=1e-6)


def test_predictions_match_collapsed_posterior(problem):
    k, x, y, z, noise = problem
    params = _optimal(k, x, y, z, noise)
    x_new = torch.linspace(-1.0, 9.0, 40, dtype=torch.float64)
    f, obs = _collapsed(k, x, y, z, noise)
    mean_ref, var_ref = (f.measure | obs)(f(x_new)).marginals()
    mean, var = st.svgp_predict(k, params, x_new[:, None])
    _close(mean, np_(mean_ref), rtol=1e-5, atol=1e-8)
    _close(var, np_(var_ref), rtol=1e-4, atol=1e-8)
    _, var_n = st.svgp_predict(k, params, x_new[:, None], noise=noise)
    _close(var_n, np_(var + noise), rtol=1e-6)


def test_minibatch_elbo_is_unbiased_over_partition(problem):
    k, x, y, z, noise = problem
    params = _optimal(k, x, y, z, noise)
    full = st.svgp_elbo(k, params, x[:, None], y, noise, N)
    batches = [st.svgp_elbo(k, params, x[i:i + 20, None], y[i:i + 20], noise, N)
               for i in (0, 20, 40)]
    # The likelihood is scaled by N/B and the KL appears once per batch, so
    # the mean of a disjoint partition's batch ELBOs is the full ELBO.
    _close(torch.stack(batches).mean(), np_(full))


def test_minibatch_natgrad_training_converges_toward_optimum(problem):
    k, x, y, z, noise = problem
    params = st.svgp_init(k, z)
    r = np.random.RandomState(1)
    for step in range(60):
        idx = torch.as_tensor(r.choice(N, size=20, replace=False))
        rho = 0.5 / (1.0 + 0.2 * step)  # Robbins-Monro decay.
        params = st.svgp_natgrad_step(k, params, x[idx][:, None], y[idx], noise, N, rho=rho)
    elbo = float(st.svgp_elbo(k, params, x[:, None], y, noise, N))
    f, obs = _collapsed(k, x, y, z, noise)
    opt = float(obs.elbo(f.measure))
    assert elbo > opt - 1.0  # within a nat of the optimum
    assert elbo <= opt + 1e-6  # never above the optimal bound


def test_elbo_differentiable_in_hyperparameters_and_z(problem):
    k, x, y, z, noise = problem
    # At the whitened init the predictive is the prior for any kernel and
    # z, so their gradients vanish there: differentiate at the optimum's q.
    params = {kk: v.detach().requires_grad_(True)
              for kk, v in _optimal(k, x, y, z, noise).items()}
    theta = {kk: torch.zeros((), dtype=torch.float64, requires_grad=True)
             for kk in ("log_s2", "log_ell")}
    loss = -st.svgp_elbo(_kernel(st, theta), params, x[:, None], y, noise, N)
    grads = torch.autograd.grad(loss, [*theta.values(), *params.values()])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[2].abs().max()) > 0  # z's gradient flows


def test_adam_training_improves_elbo(problem):
    k, x, y, z, noise = problem
    params = {kk: v.clone().requires_grad_(True) for kk, v in st.svgp_init(k, z).items()}
    opt = torch.optim.Adam(list(params.values()), lr=5e-2)

    def loss():
        return -st.svgp_elbo(k, params, x[:, None], y, noise, N)

    before = -float(loss().detach())
    for _ in range(100):
        opt.zero_grad()
        loss().backward()
        opt.step()
    assert -float(loss().detach()) > before + 100.0  # a large improvement on the prior init


def test_mean_function_matches_collapsed(problem):
    k, x, y, z, noise = problem
    mean = lambda t: 0.7 * t + 1.2  # noqa: E731
    params = _optimal(k, x, y, z, noise, mean=mean)
    elbo = st.svgp_elbo(k, params, x[:, None], y, noise, N, mean=mean)
    f, obs = _collapsed(k, x, y, z, noise, mean=mean)
    _close(elbo, np_(obs.elbo(f.measure)), rtol=1e-6)
    x_new = torch.linspace(-1.0, 9.0, 40, dtype=torch.float64)
    mean_ref, var_ref = (f.measure | obs)(f(x_new)).marginals()
    m, v = st.svgp_predict(k, params, x_new[:, None], mean=mean)
    _close(m, np_(mean_ref), rtol=1e-5, atol=1e-8)
    _close(v, np_(var_ref), rtol=1e-4, atol=1e-8)


def test_batch_split_sum_matches_whole_batch(problem):
    # The sum a sharded batch computes (test_sharded_batch_matches_replicated
    # below), on one device: the batch of 40 split in two halves, whose
    # ELBOs (each N/20 times its half's likelihood, less the KL) average to
    # the batch's.
    k, x, y, z, noise = problem
    params = _optimal(k, x, y, z, noise)
    xb, yb = x[:40, None], y[:40]
    ref = st.svgp_elbo(k, params, xb, yb, noise, N)
    halves = [st.svgp_elbo(k, params, xb[s], yb[s], noise, N) for s in (slice(0, 20),
                                                                       slice(20, 40))]
    _close(0.5 * (halves[0] + halves[1]), np_(ref), rtol=1e-10)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_batch_matches_replicated(D, tmp_path_factory):
    """``tests/model/test_svgp.py``'s test of the same name: the batch of 40
    given as ``DTensor``s placed ``Shard(0)`` over D ranks (suite
    ``parallel``'s case ``iter_svgp``). The ELBO, its gradient in (theta,
    z, q_mu, q_sqrt) and a rho=0.4 natural-gradient step on every rank
    equal the replicated batch's to 1e-10, and the ELBO the JAX package's."""
    n, b, _, noise = W.SVGP_CASE
    x, y, z = W.svgp_data()
    T = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    k0 = 1.3 * st.EQ().stretch(0.9)
    params = st.svgp_natgrad_step(k0, st.svgp_init(k0, T(z)), T(x)[:, None], T(y), noise, n,
                                  rho=1.0)
    theta = {k: T(v).requires_grad_(True) for k, v in W.SVGP_THETA.items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xb, yb = T(x[:b])[:, None], T(y[:b])
    e = st.svgp_elbo(_kernel(st, theta), leaves, xb, yb, noise, n)
    want = {"elbo": e}
    want.update({f"grad_{k}": g for k, g in zip(
        [*theta, *leaves], torch.autograd.grad(e, [*theta.values(), *leaves.values()]))})
    with torch.no_grad():
        step = st.svgp_natgrad_step(_kernel(st, theta), params, xb, yb, noise, n, rho=0.4)
    want.update({f"step_{k}": v for k, v in step.items()})
    kj = 1.3 * sj.EQ().stretch(0.9)
    pj = sj.svgp_natgrad_step(kj, sj.svgp_init(kj, jnp.asarray(z)), jnp.asarray(x)[:, None],
                              jnp.asarray(y), noise, n, rho=1.0)
    ej = sj.svgp_elbo(_kernel(sj, {k: jnp.asarray(v) for k, v in W.SVGP_THETA.items()}), pj,
                      jnp.asarray(x[:b])[:, None], jnp.asarray(y[:b]), noise, n)
    res = W.iter_results("iter_svgp", D, tmp_path_factory)
    for key, ref in want.items():
        for r in res[1:]:
            np.testing.assert_array_equal(r[key], res[0][key], err_msg=key)
        _close(res[0][key], np_(ref), rtol=1e-10, atol=1e-13)
    _close(res[0]["elbo"], ej, rtol=1e-10)


def test_svgp_entry_points_take_a_mesh():
    """``svgp_1m_step`` and ``svgp_1m_natgrad`` with ``mesh=``: the
    minibatch sharded by rows, the same value, gradient and step as
    without."""
    from stheno_torch.parallel import make_data_mesh

    mesh = make_data_mesh()
    x, y, theta, params = E.svgp_1m_inputs(torch.float64, n=3000, m=12)
    kw = dict(batch=256, jitter=1e-8)
    p1, p1m = (E.svgp_1m_natgrad(x, y, theta, params, mesh=m, **kw) for m in (None, mesh))
    (v, g), (vm, gm) = (E.svgp_1m_step(x, y, theta, p1, grad=True, mesh=m, **kw)
                        for m in (None, mesh))
    for k in ("q_mu", "q_sqrt"):
        _close(p1m[k], np_(p1[k]), rtol=1e-12)
    _close(vm, np_(v), rtol=1e-12)
    for k in g:
        _close(gm[k], np_(g[k]), rtol=1e-10)


# --- the N=10^6 entry points, at a small N ----------------------------------


def test_svgp_entry_points_match_jax():
    n, m, b = 3000, 12, 256
    x, y, theta, params = E.svgp_1m_inputs(torch.float64, n=n, m=m)
    eps = 1e-8
    idx = np.random.RandomState(0).choice(n, size=b, replace=False)
    p1 = E.svgp_1m_natgrad(x, y, theta, params, batch=b, rho=1.0, jitter=eps)
    v, g = E.svgp_1m_step(x, y, theta, p1, batch=b, grad=True, jitter=eps)

    xa, ya = np_(x), np_(y)
    prev = sj.config.epsilon
    sj.config.set_epsilon(eps)
    try:
        kj = _kernel(sj, {k: jnp.asarray(0.0) for k in ("log_s2", "log_ell")})
        xb, yb = jnp.asarray(xa[idx])[:, None], jnp.asarray(ya[idx])
        pj = sj.svgp_natgrad_step(kj, sj.svgp_init(kj, jnp.asarray(np_(params["z"]))), xb, yb,
                                  0.1, n, 1.0)

        def f(theta, zz):
            return sj.svgp_elbo(_kernel(sj, theta), {**pj, "z": zz}, xb, yb, 0.1, n)

        vj, (gtj, gzj) = jax.value_and_grad(f, argnums=(0, 1))(
            {k: jnp.asarray(0.0) for k in ("log_s2", "log_ell")}, pj["z"])
    finally:
        sj.config.set_epsilon(prev)
    for k in ("q_mu", "q_sqrt"):
        _close(p1[k], pj[k], atol=1e-10)
    _close(v, vj)
    for k in ("log_s2", "log_ell"):
        _close(g[k], gtj[k])
    _close(g["z"], gzj, atol=1e-10)


def test_svgp_full_batch_entry_recovers_sparse_elbo():
    x, y, theta, params = E.svgp_1m_inputs(torch.float64, n=2000, m=24)
    eps = 1e-10
    p1 = E.svgp_1m_natgrad(x, y, theta, params, batch=None, rho=1.0, jitter=eps)
    v = E.svgp_1m_step(x, y, theta, p1, batch=None, jitter=eps)
    ref = E.sparse_elbo(x, y, params["z"][:, 0], torch.ones((), dtype=torch.float64), jitter=eps)
    _close(v, np_(ref), rtol=1e-6)


def test_item8_exports():
    import stheno_torch.kernels as K
    import stheno_torch.model as Mo

    names = ("svgp_init", "svgp_elbo", "svgp_predict", "svgp_natgrad_step", "pathwise_sampler")
    assert set(names) <= set(Mo.__all__) and "feature_map" in K.__all__
    for name in (*names, "feature_map", "register_matrix_type"):
        assert getattr(st, name) is not None and hasattr(sj, name)
