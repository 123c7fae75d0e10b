"""Parity of the port's modelling DSL with ``stheno_tpu``, in float64 on
the same numpy inputs: the GP and Measure input transforms (shift,
stretch, select, transform) and derivatives (``diff``, ``diff_approx``)
with their cross-kernel bookkeeping, the GP arithmetic sugar (mirroring
``tests/model/test_gp.py``), the reference's examples 2 (decomposition),
5 (derivatives and integration constants) and 6 (Bayesian linear
regression) run through both packages (mirroring
``tests/test_readme_examples.py``), and the entry points
``blr_logpdf``/``blr_predict``, ``decomposition_logpdf``,
``derivative_condition`` and ``kronecker_logpdf`` at small sizes against
the same models built with ``stheno_tpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_torch import entry as E
from tests.test_torch_helpers import LargestTensor, np_, torch_cpu  # noqa: F401

X = np.linspace(0.0, 3.0, 9)
X_NEW = np.linspace(-0.5, 3.5, 7)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol=1e-9, atol=1e-11):
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=rtol, atol=atol)


# --- transforms and derivatives of processes ----------------------------------


def _transformed(M, arr, name):
    """``(f, g)`` in one measure: ``g`` a transform of ``f``."""
    m = M.Measure()
    f = M.GP(lambda x: x[..., :1] ** 2, M.EQ().stretch(1.3), measure=m)
    g = {
        "shift": lambda: f.shift(0.4),
        "stretch": lambda: f.stretch(2.0),
        "select": lambda: f.select(1),
        "transform": lambda: f.transform(lambda x: x**2),
        "diff": lambda: f.diff(),
        "diff_approx": lambda: f.diff_approx(),
    }[name]()
    return m, f, g


@pytest.mark.parametrize("name", ["shift", "stretch", "select", "transform", "diff",
                                  "diff_approx"])
def test_process_transforms_match_jax(name):
    # g's inputs: for select, two columns of which g reads the second.
    xg = np.stack([X_NEW * 0.3, X_NEW], axis=1) if name == "select" else X_NEW
    out = {}
    for key, M, arr in (("t", st, _t), ("j", sj, jnp.asarray)):
        m, f, g = _transformed(M, arr, name)
        a, b = arr(X), arr(xg)
        # The process's own mean and kernel, and the two cross kernels.
        res = [g(b).mean, M.dense(g(b).var), M.dense(m.kernels[g, f](b, a)),
               M.dense(m.kernels[f, g](a, b))]
        # Conditioning through the cross kernels.
        post = m | (f(a, 0.05), arr(np.sin(X)))
        res += list(post(g)(b).marginals())
        out[key] = res
    rtol = 1e-6 if name == "diff_approx" else 1e-9
    for got, want in zip(out["t"], out["j"]):
        _close(got, want, rtol=rtol, atol=1e-9)


def test_diff_approx_approximates_diff():
    m = st.Measure()
    f = st.GP(st.EQ(), measure=m)
    df, df_approx = f.diff(), f.diff_approx()
    post = m | (f(_t(X), 0.01), _t(np.sin(X)))
    exact, approx = post(df)(_t(X_NEW)).marginals()[0], post(df_approx)(_t(X_NEW)).marginals()[0]
    _close(approx, exact, rtol=1e-4, atol=1e-4)
    from stheno_torch.model.gp import _central_fdm
    from stheno_tpu.model.gp import _central_fdm as j_fdm

    for order, deriv in ((6, 1), (5, 2), (3, 1)):
        for a, b in zip(_central_fdm(order, deriv), j_fdm(order, deriv)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gp_arithmetic_sugar_and_corner_cases():
    f = st.GP(st.EQ())
    x = _t(np.linspace(0, 3, 5))
    _close((1 + f)(x).mean[:, 0], np.ones(5))
    _close((f - 1)(x).mean[:, 0], -np.ones(5))
    _close((-f)(x).mean[:, 0], np.zeros(5))
    _close(torch.diagonal(st.dense((f / 2)(x).var)), 0.25 * np.ones(5))
    g = st.GP(st.EQ())
    with pytest.raises(AssertionError):
        f + g
    with pytest.raises(TypeError):
        f + f(x)
    with pytest.raises(TypeError):
        f * f(x)
    with pytest.raises((TypeError, NotImplementedError)):
        f + st.Normal(_t(np.eye(3)))
    with pytest.raises((TypeError, NotImplementedError)):
        st.Normal(_t(np.eye(3))) + f


def test_measure_transform_methods_register_processes():
    m = st.Measure()
    f = st.GP(st.EQ(), measure=m)
    for method, arg in (("shift", 0.5), ("stretch", 2.0), ("transform", lambda z: z),
                        ("diff", 0)):
        p = getattr(m, method)(st.GP(), f, arg)
        assert p in m.ps and m.kernels[p] is not None
    p = m.select(st.GP(), f, 0)
    assert isinstance(m.kernels[p, f], st.SelectedKernel)


# --- the reference's examples through both packages -------------------------


def test_example2_decomposition_matches_jax():
    x = np.linspace(0, 10, 100)
    y = np.random.RandomState(1).randn(100)
    out = {}
    for key, M, arr in (("t", st, _t), ("j", sj, jnp.asarray)):
        m = M.Measure()
        f_smooth = M.GP(M.EQ().stretch(2.0), measure=m)
        f_wiggly = M.GP(M.RQ(1e-1).stretch(0.5), measure=m)
        f = f_smooth + f_wiggly
        post = m.condition(f(arr(x), 1e-6), arr(y))
        out[key] = [post(p)(arr(x)).marginals()[0] for p in (f_smooth, f_wiggly, f)]
    mean_s, mean_w, mean_f = (np_(a) for a in out["t"])
    np.testing.assert_allclose(mean_s + mean_w, mean_f, atol=1e-5)
    np.testing.assert_allclose(mean_f, y, atol=1e-2)
    for got, want in zip(out["t"], out["j"]):
        _close(got, want, rtol=1e-7, atol=1e-8)


def test_example5_integration_matches_jax():
    out = {}
    for key, M, arr in (("t", st, _t), ("j", sj, jnp.asarray)):
        with M.Measure() as prior:
            f = 0.7 * M.GP(M.EQ()).stretch(1.5)
            df = f.diff()
            ddf = df.diff()
        zero = arr(np.zeros(1))
        prior2 = prior.condition((f(zero), arr(np.ones(1))), (df(zero), arr(np.zeros(1))))
        x_obs = np.linspace(0, 5, 30)
        post = prior2.condition(ddf(arr(x_obs), 1e-6), arr(-np.sin(x_obs)))
        out[key] = [*prior2(f)(zero).marginals(), prior2(df)(zero).marginals()[0],
                    *post(ddf)(arr(x_obs)).marginals(), post(f)(arr(x_obs)).marginals()[0]]
    mean_f0, var_f0, mean_df0, mean_ddf = (np_(a) for a in out["t"][:4])
    np.testing.assert_allclose(mean_f0[0], 1.0, atol=1e-4)
    assert var_f0[0] < 1e-6
    np.testing.assert_allclose(mean_df0[0], 0.0, atol=1e-4)
    np.testing.assert_allclose(mean_ddf, -np.sin(np.linspace(0, 5, 30)), atol=1e-2)
    for got, want in zip(out["t"], out["j"]):
        _close(got, want, rtol=1e-6, atol=1e-8)


def test_example6_blr_matches_jax():
    x, x_obs = np.linspace(0, 10, 100), np.linspace(0, 10, 30)
    y_obs = 0.8 * x_obs + 4.0 + 0.2 * np.random.RandomState(4).randn(30)
    out = {}
    for key, M, arr in (("t", st, _t), ("j", sj, jnp.asarray)):
        with M.Measure() as prior:
            slope = M.GP(1.0)
            intercept = M.GP(5.0)
            f = slope * (lambda z: z) + intercept
            e = 0.2 * M.GP(M.Delta())
            y = f + e
        assert isinstance(y(arr(x_obs)).var, M.Woodbury)
        assert isinstance(y(arr(x_obs)).var.diag, M.Diagonal)
        post = prior.condition(y(arr(x_obs)), arr(y_obs))
        out[key] = [post(f)(arr(x)).marginals()[0], post(slope)(arr(np.zeros(1))).marginals()[0],
                    prior.logpdf(y(arr(x_obs)), arr(y_obs))]
    mean = np_(out["t"][0])
    coef = np.polyfit(x, mean, 1)
    assert np.max(np.abs(mean - np.polyval(coef, x))) < 1e-6
    for got, want in zip(out["t"], out["j"]):
        _close(got, want, rtol=1e-9)


# --- the entry points at small sizes ------------------------------------------


def _jax_blr(x, y, log_params):
    ls, lb, ln = log_params
    with sj.Measure() as prior:
        slope = sj.GP(jnp.exp(ls))
        intercept = sj.GP(jnp.exp(lb))
        f = slope * (lambda z: z) + intercept
        yp = f + jnp.exp(0.5 * ln) * sj.GP(sj.Delta())
    return prior, slope, intercept, f, yp


def _params_np(params):
    return [float(params[k]) for k in params]


def _jax_grads(fn, params):
    vals = [jnp.asarray(v) for v in _params_np(params)]
    v, g = jax.value_and_grad(fn, argnums=tuple(range(len(vals))))(*vals)
    return float(v), np.asarray([float(t) for t in g])


def test_blr_entry_matches_jax():
    x, y, params = E.blr_inputs(n=3000, dtype=torch.float64)
    v, g = E.blr_logpdf(x, y, params, grad=True)
    xj, yj = jnp.asarray(np_(x)), jnp.asarray(np_(y))

    def lml(*p):
        prior, _, _, _, yp = _jax_blr(xj, yj, p)
        return prior.logpdf(yp(xj), yj)

    vj, gj = _jax_grads(lml, params)
    np.testing.assert_allclose(float(v), vj, rtol=1e-10)
    np.testing.assert_allclose(np.asarray([float(g[k]) for k in params]), gj, rtol=1e-8)
    np.testing.assert_allclose(float(E.blr_logpdf(x, y, params)), vj, rtol=1e-10)
    assert E._blr_model(params)[4](x).var.diag.__class__ is st.Diagonal

    # The posterior means at this N; the variances at the example's own 30
    # points. Each variance is the prior's less nearly all of it, a
    # difference of Woodbury terms up to 6e8 times larger here (f's at x =
    # 10), so float64 rounding leaves about 1e-7 of it: at N = 3000 the
    # slope's would keep no digit.
    for n, moments in ((3000, (0,)), (30, (0, 1))):
        x, y, params = E.blr_inputs(n=n, dtype=torch.float64)
        xj, yj = jnp.asarray(np_(x)), jnp.asarray(np_(y))
        pred = E.blr_predict(x, y, params, n_new=16)
        prior, slope, intercept, f, yp = _jax_blr(xj, yj, _params_np(params))
        post = prior | (yp(xj), yj)
        zero = jnp.zeros(1)
        want = {"slope": post(slope)(zero).marginals(),
                "intercept": post(intercept)(zero).marginals(),
                "f": post(f)(jnp.linspace(0.0, 10.0, 16)).marginals()}
        for k in want:
            for i in moments:
                _close(pred[k][i], want[k][i], rtol=(1e-8, 1e-6)[i], atol=(1e-10, 1e-14)[i])


def test_blr_value_and_grad_50k_never_densifies():
    x, y, params = E.blr_inputs(n=50_000, dtype=torch.float64)
    with LargestTensor() as big:
        v, g = E.blr_logpdf(x, y, params, grad=True)
    assert big.numel <= 64 * 50_000, (big.numel, big.op)
    assert np.isfinite(float(v)) and all(np.isfinite(float(t)) for t in g.values())


def test_decomposition_entry_matches_jax():
    x, y, params = E.decomposition_inputs(dtype=torch.float64)
    x, y = x[::10], y[::10]
    v, g, means = E.decomposition_logpdf(x, y, params, grad=True)
    xj, yj = jnp.asarray(np_(x)), jnp.asarray(np_(y))

    def model(l1, l2, ln):
        m = sj.Measure()
        fs = sj.GP(sj.EQ().stretch(jnp.exp(l1)), measure=m)
        fw = sj.GP(sj.RQ(0.1).stretch(jnp.exp(l2)), measure=m)
        e = sj.GP(jnp.exp(ln) * sj.Delta(), measure=m)
        return m, fs, fw, fs + fw, fs + fw + e

    def lml(*p):
        m, _, _, _, yp = model(*p)
        return m.logpdf(yp(xj), yj)

    vj, gj = _jax_grads(lml, params)
    np.testing.assert_allclose(float(v), vj, rtol=1e-9)
    np.testing.assert_allclose(np.asarray([float(g[k]) for k in params]), gj, rtol=1e-7)
    m, fs, fw, f, yp = model(*_params_np(params))
    post = m | (yp(xj), yj)
    for key, p in (("smooth", fs), ("wiggly", fw), ("f", f)):
        _close(means[key], post(p)(xj).marginals()[0], rtol=1e-7, atol=1e-9)
    _close(means["smooth"] + means["wiggly"], np_(means["f"]), atol=1e-9)
    v2, _ = E.decomposition_logpdf(x, y, params)
    np.testing.assert_allclose(float(v2), vj, rtol=1e-9)


def test_derivative_entry_matches_jax():
    x, y, params = E.derivative_inputs(n=60, dtype=torch.float64)
    v, g, (mean, var) = E.derivative_condition(x, y, params, grad=True)
    xj, yj = jnp.asarray(np_(x)), jnp.asarray(np_(y))

    def model(ls, le):
        with sj.Measure() as prior:
            f = jnp.exp(ls) * sj.GP(sj.EQ()).stretch(jnp.exp(le))
            df = f.diff()
            ddf = df.diff()
        zero = jnp.zeros(1)
        return prior | ((f(zero), jnp.ones(1)), (df(zero), jnp.zeros(1))), ddf

    def lp(ls, le, ln):
        prior2, ddf = model(ls, le)
        return prior2.logpdf(ddf(xj, jnp.exp(ln)), yj)

    vj, gj = _jax_grads(lp, params)
    np.testing.assert_allclose(float(v), vj, rtol=1e-9)
    np.testing.assert_allclose(np.asarray([float(g[k]) for k in params]), gj, rtol=1e-7)
    p = _params_np(params)
    prior2, ddf = model(p[0], p[1])
    post = prior2 | (ddf(xj, np.exp(p[2])), yj)
    mj, vj_ = post(ddf)(xj).marginals()
    _close(mean, mj, rtol=1e-7, atol=1e-9)
    _close(var, vj_, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("masked", [False, True])
def test_kronecker_entry_matches_jax(masked):
    ax1, ax2, y, params, masks = E.kronecker_inputs(24, 17, dtype=torch.float64)
    v, g = E.kronecker_logpdf(ax1, ax2, y, params, grad=True, mask=masks if masked else None)
    a1, a2, yj = (jnp.asarray(np_(t)) for t in (ax1, ax2, y))
    mj = tuple(jnp.asarray(np_(m)) for m in masks) if masked else None

    def lp(l1, l2):
        factors = [sj.Dense(sj.dense(sj.EQ().stretch(jnp.exp(l))(a)) + 0.1 * jnp.eye(a.shape[0]))
                   for l, a in ((l1, a1), (l2, a2))]
        return sj.Normal(sj.Kronecker(*factors)).logpdf(yj, mask=mj)

    vj, gj = _jax_grads(lp, params)
    np.testing.assert_allclose(float(v), vj, rtol=1e-10)
    np.testing.assert_allclose(np.asarray([float(g[k]) for k in params]), gj, rtol=1e-8)
