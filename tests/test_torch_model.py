"""The model-DSL stories of ``tests/model/test_model.py`` on the port, in
float64: measure bookkeeping, conditioning sugar over every noise shape,
the closed-form posterior, posterior chaining, empty and missing data,
the pseudo-point approximations against exact conditioning, input
transforms checked by conditioning both ways, products and sums with
functions, constants and processes, the joint log-density's chain rule,
sampling, ``take`` and the pseudo-point posterior's evaluation
contract."""

import numpy as np
import pytest
import torch

import stheno_torch.matrix as M
from stheno_torch import (
    EQ,
    GP,
    Measure,
    Obs,
    Observations,
    PseudoObs,
    PseudoObsDTC,
    PseudoObsFITC,
)
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401


def approx(a, b, rtol=1e-7, atol=0.0):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=atol)


def _lin(a, b, n):
    return torch.linspace(a, b, n, dtype=torch.float64)


def _setup(n=10, seed=0):
    r = np.random.RandomState(seed)
    x = np.sort(r.rand(n) * 10)
    return torch.tensor(x), torch.tensor(np.sin(x) + 0.2 * r.randn(n))


def assert_equal_normals(d1, d2, atol=1e-7):
    approx(d1.mean, d2.mean, atol=atol, rtol=1e-6)
    approx(M.dense(d1.var), M.dense(d2.var), atol=atol, rtol=1e-6)


# -- measure bookkeeping ---------------------------------------------------


def test_measure_groups_and_backrefs():
    prior = Measure()
    f1 = GP(EQ(), measure=prior)
    f2 = GP(EQ().stretch(2.0), measure=prior)
    assert f1._measures == [prior]
    fsum = f1 + f2
    assert fsum.measure is prior
    x, y = _setup()
    post = prior.condition(fsum(x, 0.1), y)
    assert post in f1._measures and post in fsum._measures
    fdiff = f1 - f2  # Made after conditioning: the posterior extends to it.
    assert post in fdiff._measures
    post(fdiff)(x).marginals()


def test_default_measure_context():
    m = Measure()
    with m:
        f = GP(EQ())
        assert f.measure is m
        m2 = Measure()
        with m2:
            assert GP(EQ()).measure is m2
        assert GP(EQ()).measure is m
    assert GP(EQ()).measure is not m


def test_naming():
    m = Measure()
    f = GP(EQ(), measure=m, name="f")
    assert m["f"] is f and m[f] == "f" and f.name == "f"
    g = GP(EQ(), measure=m)
    with pytest.raises(RuntimeError):
        m.name(g, "f")
    g.name = "g"
    assert m["g"] is g


def test_mixed_measures_raise():
    with pytest.raises(AssertionError):
        GP(EQ()) + GP(EQ())


# -- conditioning sugar ----------------------------------------------------

NOISE_SHAPES = {
    "none": lambda n: None,
    "scalar": lambda n: 0.1,
    "vector": lambda n: torch.full((n,), 0.1, dtype=torch.float64),
    "diagonal": lambda n: M.Diagonal(torch.full((n,), 0.1, dtype=torch.float64)),
    "dense": lambda n: M.Dense(0.1 * torch.eye(n, dtype=torch.float64)),
}


@pytest.mark.parametrize("noise", list(NOISE_SHAPES))
def test_conditioning_sugar_equivalence(noise):
    f = GP(EQ())
    x, y = _setup()
    fdd = f(x, NOISE_SHAPES[noise](10))
    x_new = _lin(0, 10, 7)
    post1 = (f | (fdd, y))(x_new)
    for other in (f.condition(fdd, y)(x_new), f.measure.condition(fdd, y)(f)(x_new),
                  (f | Obs(fdd, y))(x_new), f.measure.condition(Observations((fdd, y)))(f)(x_new)):
        assert_equal_normals(post1, other)


def test_posterior_closed_form():
    f = GP(EQ())
    x, y = _setup()
    x_new = _lin(0, 10, 7)
    post = (f | (f(x, 0.1), y))(x_new)
    K, Ks, Kss = (np_(M.dense(EQ()(*a))) for a in ((x,), (x, x_new), (x_new,)))
    A = K + 0.1 * np.eye(10)
    approx(post.mean, Ks.T @ np.linalg.solve(A, np_(y)[:, None]), atol=1e-7, rtol=1e-6)
    approx(M.dense(post.var), Kss - Ks.T @ np.linalg.solve(A, Ks), atol=1e-7, rtol=1e-6)
    # Noise-free observations: the posterior mean interpolates the data.
    approx((f | (f(x, None), y))(x).mean[:, 0], y, atol=1e-5, rtol=1e-5)


def test_posterior_of_posterior():
    f = GP(EQ())
    x, y = _setup(10, 0)
    x2, y2 = _setup(8, 1)
    x_new = _lin(0, 10, 5)
    post1 = f | (f(x, 0.1), y)
    post2 = post1 | (post1(x2, 0.1), y2)
    joint = f | ((f(x, 0.1), y), (f(x2, 0.1), y2))
    assert_equal_normals(post2(x_new), joint(x_new), atol=1e-6)


def test_empty_observations():
    f = GP(EQ())
    x_new = _lin(0, 10, 5)
    empty = torch.zeros((0,), dtype=torch.float64)
    assert_equal_normals((f | (f(empty, None), empty))(x_new), f(x_new))


def test_nan_missing_data():
    f = GP(EQ())
    x, y = _setup()
    y_missing = y.clone()
    y_missing[3] = y_missing[7] = float("nan")
    keep = torch.tensor([i for i in range(10) if i not in (3, 7)])
    x_new = _lin(0, 10, 5)
    assert_equal_normals((f | (f(x, 0.1), y_missing))(x_new),
                         (f | (f(x[keep], 0.1), y[keep]))(x_new))


# -- pseudo-point approximations ------------------------------------------


@pytest.mark.parametrize("cls", [PseudoObs, PseudoObsFITC, PseudoObsDTC])
@pytest.mark.parametrize("noise", ["scalar", "vector"])
def test_pseudo_equals_exact_when_inducing_at_data(cls, noise):
    f = GP(EQ())
    x, y = _setup()
    fdd = f(x, NOISE_SHAPES[noise](10))
    obs = cls(f(x), (fdd, y))
    x_new = _lin(0, 10, 6)
    assert_equal_normals(f.measure.condition(obs)(f)(x_new), (f | (fdd, y))(x_new), atol=1e-5)
    # With the inducing points at the data the ELBO is the exact logpdf.
    approx(obs.elbo(f.measure), f.measure.logpdf(fdd, y), atol=1e-6, rtol=1e-6)


def test_pseudo_dense_noise_rejected():
    f = GP(EQ())
    x, y = _setup()
    obs = PseudoObs(f(x), (f(x, M.Dense(0.1 * torch.eye(10, dtype=torch.float64))), y))
    with pytest.raises(RuntimeError, match="diagonal"):
        obs.elbo(f.measure)


def test_pseudo_caching_identity():
    f = GP(EQ())
    x, y = _setup()
    obs = PseudoObs(f(_lin(0, 10, 5)), (f(x, 0.1), y))
    for what in ("elbo", "K_z", "mu", "A"):
        assert getattr(obs, what)(f.measure) is getattr(obs, what)(f.measure)


def test_elbo_lower_bounds_logpdf():
    f = GP(EQ())
    x, y = _setup(20)
    fdd = f(x, 0.1)
    lp = float(f.measure.logpdf(fdd, y))
    for m_ind in (3, 8, 15):
        assert float(f.measure.logpdf(PseudoObs(f(_lin(0, 10, m_ind)), (fdd, y)))) <= lp + 1e-6


# -- transforms checked by conditioning both ways ---------------------------


def _both_ways(make_transformed, make_manual, atol=1e-6):
    x, y = _setup()
    x_new = _lin(0, 10, 5)
    g1, g2 = make_transformed(GP(EQ())), make_manual()
    assert_equal_normals((g1 | (g1(x, 0.1), y))(x_new), (g2 | (g2(x, 0.1), y))(x_new), atol=atol)


def test_shift():
    _both_ways(lambda f: f.shift(2.0), lambda: GP(EQ().shift(2.0)))
    f = GP(EQ())
    g = f.shift(2.0)
    x, y = _setup()
    x_new = _lin(0, 10, 5)
    assert_equal_normals((g | (g(x, 0.1), y))(x_new), (f | (f(x - 2.0, 0.1), y))(x_new - 2.0),
                         atol=1e-6)


def test_stretch():
    _both_ways(lambda f: f.stretch(2.0), lambda: GP(EQ().stretch(2.0)))
    f = GP(EQ())
    g = f.stretch(2.0)
    x, y = _setup()
    x_new = _lin(0, 10, 5)
    assert_equal_normals((g | (g(x, 0.1), y))(x_new), (f | (f(x / 2.0, 0.1), y))(x_new / 2.0),
                         atol=1e-6)


def test_transform():
    warp = lambda z: 2 * z  # noqa: E731
    _both_ways(lambda f: f.transform(warp), lambda: GP(EQ().transform(warp)))


def test_select():
    x2d = torch.tensor(np.random.RandomState(0).randn(10, 2))
    y = torch.sin(x2d[:, 0])
    f = GP(EQ())
    g = f.select(0)
    assert_equal_normals((g | (g(x2d, 0.1), y))(x2d),
                         (f | (f(x2d[:, 0], 0.1), y))(x2d[:, 0]), atol=1e-6)


def test_sum_with_function_and_constant():
    f = GP(EQ())
    x, y = _setup()
    x_new = _lin(0, 10, 5)
    g = f + 5.0
    post, post_f = (g | (g(x, 0.1), y))(x_new), (f | (f(x, 0.1), y - 5.0))(x_new)
    approx(post.mean, post_f.mean + 5.0, atol=1e-6, rtol=1e-6)
    approx(M.dense(post.var), M.dense(post_f.var), atol=1e-7)
    h = f + (lambda z: torch.sin(z)[..., 0:1] if z.ndim > 1 else torch.sin(z))
    approx(h(x).mean[:, 0], torch.sin(x), atol=1e-8)


def test_mul_constant():
    f = GP(EQ())
    x, y = _setup()
    x_new = _lin(0, 10, 5)
    g = f * 2.0
    post_g, post_f = (g | (g(x, 0.1), y))(x_new), (f | (f(x, 0.1 / 4), y / 2.0))(x_new)
    approx(post_g.mean, 2 * post_f.mean, atol=1e-6, rtol=1e-5)
    approx(M.dense(post_g.var), 4 * M.dense(post_f.var), atol=1e-6)


def test_mul_function():
    f = GP(EQ())
    g = f * (lambda z: z**2 + 1.0)
    x, _ = _setup()
    s = np_(x) ** 2 + 1
    approx(M.dense(g(x).var), np_(M.dense(f(x).var)) * s[:, None] * s[None, :], rtol=1e-7)


def test_moment_matched_product():
    m = Measure()
    f1 = GP(lambda z: z**2 / 20.0, EQ(), measure=m)
    f2 = GP(lambda z: torch.sin(z), EQ().stretch(2.0), measure=m)
    g = f1 * f2
    x = _lin(0, 5, 6)
    mu1, mu2 = np_(x) ** 2 / 20, np.sin(np_(x))
    # Independent priors: E[f1 f2] = E f1 E f2.
    np.testing.assert_allclose(np_(g(x).mean)[:, 0], mu1 * mu2, atol=1e-6)
    # var = m1^2 var2 + m2^2 var1 + var1 var2 for independent factors.
    np.testing.assert_allclose(np.diag(np_(M.dense(g(x).var))), mu1**2 + mu2**2 + 1.0, rtol=5e-2)


def test_manual_add_gp():
    m = Measure()
    p1 = GP(1.0, EQ(), measure=m)
    p2 = GP(2.0, EQ().stretch(2.0), measure=m)
    p_sum = p1 + p2
    p_manual = m.add_gp(
        m.means[p1] + m.means[p2],
        m.kernels[p1] + m.kernels[p2] + m.kernels[p1, p2] + m.kernels[p2, p1],
        lambda j: m.kernels[p1, j] + m.kernels[p2, j],
    )
    x = _lin(0, 10, 8)
    assert_equal_normals(p_sum(x), p_manual(x))
    approx(M.dense(m.kernels[p_sum, p1](x, x)), M.dense(m.kernels[p_manual, p1](x, x)), rtol=1e-8)


def test_joint_logpdf_chain_rule():
    prior = Measure()
    f = GP(EQ(), measure=prior)
    x1, y1 = _setup(6, 0)
    x2, y2 = _setup(5, 1)
    joint = prior.logpdf((f(x1, 0.1), y1), (f(x2, 0.1), y2))
    post = prior.condition(f(x1, 0.1), y1)
    approx(joint, prior.logpdf(f(x1, 0.1), y1) + post.logpdf(post(f)(x2, 0.1), y2), rtol=1e-6)


def test_sample_under_correct_measure():
    prior = Measure()
    f = GP(EQ(), measure=prior)
    x, y = _setup()
    post = prior.condition(f(x, 0.001), y)
    gen = torch.Generator().manual_seed(0)
    s = post.sample(gen, f(x))
    np.testing.assert_allclose(np_(s)[:, 0], np_(y), atol=0.3)
    s1, s2 = post.sample(gen, 3, f(x), f(_lin(0, 10, 4)))
    assert s1.shape == (10, 3) and s2.shape == (4, 3)


def test_cross_sampling_consistency():
    m = Measure()
    f1, f2 = GP(EQ(), measure=m), GP(EQ(), measure=m)
    x = _lin(0, 3, 5)
    s1, s2, ssum = m.sample(torch.Generator().manual_seed(42), f1(x), f2(x), (f1 + f2)(x))
    # The joint covariance is singular: the jitter leaves ~sqrt(eps).
    np.testing.assert_allclose(np_(s1) + np_(s2), np_(ssum), atol=1e-4)


def test_fdd_take():
    from stheno_torch.model import take

    x, _ = _setup()
    sub = take(GP(EQ())(x, 0.1), np.array([True] * 5 + [False] * 5))
    assert tuple(sub.noise.shape) == (5, 5)
    approx(sub.x, x[:5])


def test_pseudo_posterior_kernel_evaluation_contract():
    """Posterior marginals after pseudo-point conditioning evaluate Grams
    only at (x_obs, x_ind), (x_ind, x_ind) and (x_ind, x_new), and columns
    at x_obs and x_new: never an O(n_obs^2) or O(n_new^2) Gram."""
    from stheno_torch.kernels import Kernel

    calls = {"pairwise": [], "elwise": []}

    class CountingEQ(Kernel):
        def __init__(self):
            self._inner = EQ()

        def _pairwise(self, x, y):
            calls["pairwise"].append((x.shape[-2], y.shape[-2]))
            return self._inner._pairwise(x, y)

        def _elwise(self, x, y):
            calls["elwise"].append(x.shape[-2])
            return self._inner._elwise(x, y)

        def _scalar(self, x, y):
            return self._inner._scalar(x, y)

        @property
        def stationary(self):
            return True

    n_obs, n_ind, n_new = 40, 7, 11
    x_obs = torch.tensor(np.sort(np.random.RandomState(4).rand(n_obs) * 10))
    f = GP(CountingEQ())
    post = f | PseudoObs(f(_lin(0, 10, n_ind)), (f(x_obs, 0.1), torch.sin(x_obs)))
    mean, _ = post(_lin(0, 10, n_new)).marginals()
    assert bool(torch.isfinite(mean).all())
    allowed = {(n_obs, n_ind), (n_ind, n_obs), (n_ind, n_ind), (n_ind, n_new), (n_new, n_ind)}
    assert set(calls["pairwise"]) <= allowed, calls["pairwise"]
    assert set(calls["elwise"]) <= {n_obs, n_new}, calls["elwise"]
