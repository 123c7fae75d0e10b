"""The reference's README workflows through both packages: the nine of
``tests/test_readme_examples.py`` not yet mirrored (1, 3, 4, 7, 8, 9, 11,
12 and 13; 2, 5, 6 and 10 are in ``tests/test_torch_dsl.py`` and
``tests/test_torch_sparse.py``). Each workflow runs in ``stheno_tpu`` and
in the port on the same data (drawn once, by the JAX package's sampler
or numpy, and handed to both as numpy arrays) in float64 on the CPU, and
each package's outcome is held to the statistical bound the JAX test
asserts.

Tolerances between the packages: conditioning is the same float64
linear algebra, so posteriors agree to rtol 1e-8; Adam is the same update
(``torch.optim.Adam`` with optax's settings), so a fit agrees to rtol
1e-6; L-BFGS runs another line search (strong Wolfe against optax's
zoom), so only the optimum's objective is compared, to rel 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu.opt import Vars as JVars
from stheno_tpu.opt import minimise_adam as j_adam
from stheno_tpu.opt import minimise_lbfgs as j_lbfgs
from stheno_torch.opt import Vars as TVars
from stheno_torch.opt import minimise_adam as t_adam
from stheno_torch.opt import minimise_lbfgs as t_lbfgs
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

#: Each package: its module, array constructor, Vars and optimisers.
PACKAGES = {
    "jax": (sj, jnp.asarray, JVars, j_adam, j_lbfgs),
    "torch": (st, lambda a: torch.tensor(np.asarray(a), dtype=torch.float64),
              lambda: TVars(dtype=torch.float64), t_adam, t_lbfgs),
}


def _jax_sample(key, m, *fdds):
    """Samples of the JAX package's sampler, as numpy arrays."""
    out = m.sample(jax.random.PRNGKey(key), *fdds)
    return [np.asarray(s) for s in out[1:]]


def _close(a, b, rtol=1e-8, atol=1e-10):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


def test_example1_simple_regression():
    x, x_obs = np.linspace(0, 10, 100), np.linspace(0, 7, 20)
    f = sj.GP(sj.EQ())
    f_true, y_obs = _jax_sample(0, f.measure, f(jnp.asarray(x)), f(jnp.asarray(x_obs), 0.1))
    out = {}
    for name, (M, a, *_) in PACKAGES.items():
        f = M.GP(M.EQ())
        post = f.measure.condition(f(a(x_obs), 0.1), a(y_obs[:, 0]))
        out[name] = [np_(v) for v in post(f)(a(x)).marginal_credible_bounds()]
        mean, lower, upper = out[name]
        inside = x <= 7
        assert np.mean(np.abs(mean - f_true[:, 0])[inside]) < 0.4
        assert np.mean((lower <= f_true[:, 0]) & (f_true[:, 0] <= upper)) > 0.8
    for got, want in zip(out["torch"], out["jax"]):
        _close(got, want)


def _fit(name, x, y, kernel, noise, iters, method="lbfgs", rate=None):
    """Fit ``GP(kernel(vs))`` with noise ``vs["noise"]`` (from ``noise``) to ``(x, y)``;
    returns ``(initial NLML, final NLML, vs, posterior mean at x)``."""
    M, a, Vars, adam, lbfgs = PACKAGES[name]
    x, y = a(x), a(y)

    def model(vs):
        return M.GP(kernel(M, vs))

    def objective(vs):
        f = model(vs)
        return -f.measure.logpdf(f(x, vs.positive(noise, name="noise")), y)

    vs = Vars()
    init = float(objective(vs))
    final = lbfgs(objective, vs, iters=iters) if method == "lbfgs" else adam(
        objective, vs, iters=iters, rate=rate)
    f = model(vs)
    mean, _ = (f | (f(x, vs["noise"]), y))(x).marginals()
    return init, float(final), vs, np_(mean)


def _eq_kernel(M, vs):
    return vs.positive(1.0, name="var") * M.EQ().stretch(vs.positive(1.0, name="scale"))


def test_example3_parametric():
    x = np.linspace(0, 10, 80)
    f = sj.GP(2.0 * sj.EQ().stretch(1.5))
    (y,) = _jax_sample(2, f.measure, f(jnp.asarray(x), 0.1))
    finals = {}
    for name in PACKAGES:
        _, finals[name], _, mean = _fit(name, x, y[:, 0], _eq_kernel, 0.1, 40)
        assert np.sqrt(np.mean((mean - y[:, 0]) ** 2)) < 0.4
    np.testing.assert_allclose(finals["torch"], finals["jax"], rtol=1e-3)


class _VGP:
    def __init__(self, ps):
        self.ps = ps

    def lmatmul(self, A):
        m, n = A.shape
        ps = [0 for _ in range(m)]
        for i in range(m):
            for j in range(n):
                ps[i] = A[i, j] * self.ps[j] + ps[i]
        return _VGP(ps)


def _mixed(M, H):
    with M.Measure() as prior:
        fs = _VGP([M.GP(M.EQ()) for _ in range(H.shape[1])]).lmatmul(H)
    return prior, fs


def test_example4_multi_output():
    H = np.random.RandomState(0).randn(4, 2)
    x_obs = np.linspace(0, 10, 10)
    prior, fs = _mixed(sj, H)
    samples = _jax_sample(3, prior, *[f(jnp.asarray(x_obs), 0.01) for f in fs.ps])
    means = {}
    for name, (M, a, *_) in PACKAGES.items():
        prior, fs = _mixed(M, H)
        fdds = [f(a(x_obs), 0.01) for f in fs.ps]
        post = prior.condition(*((fdd, a(s[:, 0])) for fdd, s in zip(fdds, samples)))
        means[name] = [np_(post(f)(a(x_obs)).marginals()[0]) for f in fs.ps]
        for mean, s in zip(means[name], samples):
            assert np.sqrt(np.mean((mean - s[:, 0]) ** 2)) < 0.3
    for got, want in zip(means["torch"], means["jax"]):
        _close(got, want)


def test_example7_gpar():
    x_obs1 = np.linspace(0, 10, 30)
    r = np.random.RandomState(1)
    inds2 = np.sort(r.permutation(30)[:10])
    x_obs2 = x_obs1[inds2]
    y1_obs = np.sin(x_obs1) + 0.05 * r.randn(30)
    y2_obs = np.sin(x_obs2) ** 2 + 0.05 * r.randn(10)
    x2 = np.stack([x_obs2, y1_obs[inds2]], axis=1)
    finals = {}
    for name, (M, a, Vars, _, lbfgs) in PACKAGES.items():
        def objective(vs):
            f1 = M.GP(vs.positive(1.0, name="var1") * M.EQ().stretch(vs.positive(1.0, name="scale1")))
            f2 = M.GP(vs.positive(1.0, name="var2") * M.EQ().stretch(vs.positive(1.0, name="scale2")))
            lp = f1(a(x_obs1), vs.positive(0.1, name="noise1")).logpdf(a(y1_obs))
            return -(lp + f2(a(x2), vs.positive(0.1, name="noise2")).logpdf(a(y2_obs)))

        vs = Vars()
        objective(vs)
        finals[name] = float(lbfgs(objective, vs, iters=30))
        assert np.isfinite(finals[name])
        f1 = M.GP(vs["var1"] * M.EQ().stretch(vs["scale1"]))
        mean, _ = (f1 | (f1(a(x_obs1), vs["noise1"]), a(y1_obs)))(a(x_obs1)).marginals()
        assert np.sqrt(np.mean((np_(mean) - np.sin(x_obs1)) ** 2)) < 0.15
    np.testing.assert_allclose(finals["torch"], finals["jax"], rtol=1e-3)


def _interp(M, z, xp, fp):
    if M is sj:
        return jnp.interp(z, xp, fp)
    i = torch.searchsorted(xp, z).clamp(1, xp.shape[0] - 1)
    w = ((z - xp[i - 1]) / (xp[i] - xp[i - 1])).clamp(0, 1)
    return fp[i - 1] + w * (fp[i] - fp[i - 1])


def test_example8_gp_rnn():
    x = np.linspace(0, 1, 60)[:, None]
    r = np.random.RandomState(2)
    f_true = (1 + 0.3 * np.sin(2 * np.pi * x[:, 0])) * np.sin(2 * np.pi * 3 * x[:, 0])
    y = f_true + 0.05 * r.randn(60)
    w1, w2 = 0.1 * r.randn(1, 8), 0.1 * r.randn(8, 1)
    out = {}
    for name, (M, a, Vars, adam, _) in PACKAGES.items():
        tanh = jnp.tanh if M is sj else torch.tanh
        xa, ya = a(x), a(y)

        def objective(vs):
            p = {"w1": vs.unbounded(a(w1), name="w1", shape=(1, 8)),
                 "b1": vs.unbounded(0.0, name="b1", shape=(8,)),
                 "w2": vs.unbounded(a(w2), name="w2", shape=(8, 1)),
                 "b2": vs.unbounded(0.0, name="b2", shape=(1,))}
            g = (tanh(xa @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])[:, 0]
            m = M.Measure()
            amod = M.GP(1e-1 * M.EQ().stretch(vs.positive(0.2, name="a_scale")), measure=m)
            f_mod = amod * (lambda z: _interp(M, z[..., 0], xa[:, 0], g))
            return -m.logpdf(f_mod(xa, vs.positive(0.05, name="noise")), ya - g)

        vs = Vars()
        init = float(objective(vs))
        final = float(adam(objective, vs, iters=100, rate=2e-2))
        assert np.isfinite(final) and final < init
        out[name] = (init, final, float(vs["a_scale"]), float(vs["noise"]))
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-6)


def test_example9_product():
    x = np.linspace(0, 10, 50)

    def model(M):
        with M.Measure() as prior:
            f1, f2 = M.GP(3.0, M.EQ()), M.GP(3.0, M.EQ())
        return prior, f1, f2

    prior, f1, f2 = model(sj)
    s1, s2 = _jax_sample(5, prior, f1(jnp.asarray(x)), f2(jnp.asarray(x)))
    true_prod = s1[:, 0] * s2[:, 0]
    out = {}
    for name, (M, a, *_) in PACKAGES.items():
        prior, f1, f2 = model(M)
        post = prior.condition((f1(a(x)), a(s1[:, 0])), (f2(a(x)), a(s2[:, 0])))
        out[name] = [np_(v) for v in post(f1 * f2)(a(x)).marginal_credible_bounds()]
        rel = np.sqrt(np.mean((out[name][0] - true_prod) ** 2)) / np.sqrt(np.mean(true_prod**2))
        assert rel < 0.15, rel
    for got, want in zip(out["torch"], out["jax"]):
        _close(got, want, rtol=1e-7)


def test_example11_nonparametric_basis():
    x, x_obs = np.linspace(0, 10, 50), np.linspace(0, 10, 10)

    def model(M):
        exp = jnp.exp if M is sj else torch.exp
        with M.Measure() as prior:
            w = lambda z: exp(-(z**2) / 0.5)
            b = [(w * M.GP(M.EQ())).shift(float(xi)) for xi in x_obs]
            f = sum(b)
        return prior, b, f

    prior, b, f = model(sj)
    f_true, y_obs = _jax_sample(7, prior, f(jnp.asarray(x)), f(jnp.asarray(x_obs), 0.2))
    out = {}
    for name, (M, a, *_) in PACKAGES.items():
        prior, b, f = model(M)
        post = prior.condition(f(a(x_obs), 0.2), a(y_obs[:, 0]))
        mean_f = np_(post(f)(a(x)).marginals()[0])
        total = sum(np_(post(bi)(a(x)).marginals()[0]) for bi in b)
        np.testing.assert_allclose(total, mean_f, atol=1e-5)
        out[name] = mean_f
    _close(out["torch"], out["jax"], rtol=1e-7)


def test_example12_optimisation_lbfgs():
    x = np.linspace(0, 10, 100)
    f = sj.GP(sj.EQ().periodic(1.3))
    (y,) = _jax_sample(8, f.measure, f(jnp.asarray(x), 0.2))

    def kernel(M, vs):
        return vs.positive(1.0, name="var") * M.EQ().stretch(
            vs.positive(1.0, name="scale")).periodic(vs.positive(1.0, name="period"))

    for name in PACKAGES:
        init, final, vs, mean = _fit(name, x, y[:, 0], kernel, 0.1, 40)
        assert final < init
        # Multimodal in the period: predictive quality, not the period.
        rmse = np.sqrt(np.mean((mean - y[:, 0]) ** 2))
        assert rmse < 3 * np.sqrt(float(vs["noise"])) + 0.2, (name, rmse)


def test_example13_optimisation_adam():
    x = np.linspace(0, 10, 100)
    f = sj.GP(2.0 * sj.EQ().stretch(1.0))
    (y,) = _jax_sample(9, f.measure, f(jnp.asarray(x), 0.1))
    out = {}
    for name in PACKAGES:
        init, final, vs, _ = _fit(name, x, y[:, 0], _eq_kernel, 0.2, 200,
                                  method="adam", rate=5e-2)
        assert final < init
        assert 0.02 < float(vs["noise"]) < 0.5
        out[name] = (final, float(vs["var"]), float(vs["scale"]), float(vs["noise"]))
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-6)
