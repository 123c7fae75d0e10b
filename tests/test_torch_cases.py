"""The end-to-end stories of ``tests/model/test_cases.py``, on the port:
the additive decomposition in every conditioning order, derivative
conditioning recovering cos from sin (the scalar forms of the posterior
objects, ``stheno_torch/kernels/posterior.py``), Bayesian linear
regression, batched computation and the NLML gradient; and the
derivative of a conditioned process against ``stheno_tpu`` in float64
(its mean and variance, and those of a second derivative and of a
pseudo-point posterior, whose kernel holds a ``SubspaceKernel``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
import stheno_torch.matrix as M
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401


def _lin(a, b, n):
    return torch.linspace(a, b, n, dtype=torch.float64)


def test_additive_decomposition_all_orders():
    m = st.Measure()
    f1 = st.GP(st.EQ(), measure=m)
    f2 = st.GP(st.EQ().stretch(3.0), measure=m)
    f = f1 + f2
    x = _lin(0, 10, 20)
    y1, y2 = torch.sin(x), 0.3 * x
    y = y1 + y2

    post = m.condition(f(x, 1e-4), y)
    mean_sum, _ = post(f)(x).marginals()
    np.testing.assert_allclose(np_(mean_sum), np_(y), atol=1e-2)
    m1, _ = post(f1)(x).marginals()
    m2, _ = post(f2)(x).marginals()
    np.testing.assert_allclose(np_(m1) + np_(m2), np_(mean_sum), atol=1e-6)

    # Conditioning on the components pins the sum.
    post2 = m.condition((f1(x, 1e-6), y1), (f2(x, 1e-6), y2))
    ms, _ = post2(f)(x).marginals()
    np.testing.assert_allclose(np_(ms), np_(y), atol=1e-3)

    # Sequential conditioning in both orders agrees.
    post_a = m.condition(f1(x, 1e-6), y1).condition(f2(x, 1e-6), y2)
    post_b = m.condition(f2(x, 1e-6), y2).condition(f1(x, 1e-6), y1)
    ma, _ = post_a(f)(x).marginals()
    mb, _ = post_b(f)(x).marginals()
    np.testing.assert_allclose(np_(ma), np_(mb), atol=1e-6)


def test_derivative_conditioning_recovers_cos():
    # The GP conditioned on sin; its derivative predicts cos. This raised
    # NotImplementedError while the posterior objects had no _scalar.
    f = st.GP(st.EQ())
    x = _lin(0, 6, 50)
    post = f.measure.condition(f(x, 1e-8), torch.sin(x))
    x_check = _lin(1, 5, 10)
    mean_df, _ = post(f.diff(0))(x_check).marginals()
    np.testing.assert_allclose(np_(mean_df), np.cos(np_(x_check)), atol=1e-3)


def test_diff_approx():
    f = st.GP(st.EQ())
    x = _lin(0, 6, 50)
    post = f.measure.condition(f(x, 1e-8), torch.sin(x))
    x_check = _lin(1, 5, 10)
    mean_df, _ = post(f.diff_approx(1, order=6))(x_check).marginals()
    np.testing.assert_allclose(np_(mean_df), np.cos(np_(x_check)), atol=1e-3)


def test_blr_recovery():
    m = st.Measure()
    slope = st.GP(1.0, measure=m)
    intercept = st.GP(5.0, measure=m)
    f = slope * (lambda x: x) + intercept
    x = _lin(0, 10, 50)
    y = 1.2 * x + 4.8
    post = m.condition(f(x, 1e-6), y)
    zero = torch.zeros(1, dtype=torch.float64)
    mean_slope, var_slope = post(slope(zero)).marginals()
    mean_icept, var_icept = post(intercept(zero)).marginals()
    assert float(mean_slope[0]) == pytest.approx(1.2, abs=1e-3)
    assert float(mean_icept[0]) == pytest.approx(4.8, abs=1e-3)
    assert float(var_slope[0]) < 1e-4 and float(var_icept[0]) < 1e-4


def test_blr_uses_lowrank_structure():
    # The Linear kernel's Gram is LowRank, so with diagonal noise the
    # observations' variance is a Woodbury: the logpdf is O(N).
    f = st.GP(st.Linear())
    x = _lin(0, 1, 50_000)
    fdd = f(x, 0.1)
    assert isinstance(fdd.var, M.Woodbury)
    assert bool(torch.isfinite(f.measure.logpdf(fdd, 0.7 * x)))


def test_batched_logpdf_and_posterior():
    f = st.GP(st.EQ())
    r = np.random.RandomState(0)
    xb, yb = torch.tensor(r.randn(3, 10, 1)), torch.tensor(r.randn(3, 10, 1))
    lp = f(xb, 0.1).logpdf(yb)
    assert lp.shape == (3,)
    for i in range(3):
        np.testing.assert_allclose(np_(lp[i]), np_(f(xb[i], 0.1).logpdf(yb[i])), rtol=1e-8)


def test_batched_sampling():
    f = st.GP(st.EQ())
    xb = torch.tensor(np.random.RandomState(0).randn(3, 10, 1))
    _, s = f(xb, 0.1).sample(torch.Generator().manual_seed(0), 2)
    assert s.shape == (3, 10, 2)


def test_model_built_per_call_end_to_end():
    # The JAX test builds the model inside jax.jit (test_jit_end_to_end);
    # torch runs eagerly, so a model built inside a function at each call
    # must give what one built outside gives.
    x, x_new = _lin(0, 10, 20), _lin(0, 10, 7)

    def predict(y):
        f = st.GP(st.EQ())
        return (f | (f(x, 0.1), y))(x_new).marginals()

    y = torch.sin(x)
    mean, var = predict(y)
    f = st.GP(st.EQ())
    mean_ref, var_ref = (f | (f(x, 0.1), y))(x_new).marginals()
    np.testing.assert_allclose(np_(mean), np_(mean_ref), rtol=1e-8)
    np.testing.assert_allclose(np_(var), np_(var_ref), rtol=1e-8)
    again = predict(y)
    np.testing.assert_allclose(np_(again[0]), np_(mean), rtol=0, atol=0)


def test_grad_nlml_end_to_end():
    x = _lin(0, 10, 20)
    y = torch.sin(x)

    def nlml(params):
        f = st.GP(torch.exp(params[1]) * st.EQ().stretch(torch.exp(params[0])))
        return -f.measure.logpdf(f(x, 0.1), y)

    p = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(nlml(p), p)
    assert g.shape == (2,)
    eps = 1e-6
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros(2, dtype=torch.float64)
            e[i] = eps
            fd = (nlml(e) - nlml(-e)) / (2 * eps)
            np.testing.assert_allclose(np_(g[i]), np_(fd), rtol=1e-4)


# --- a derivative of a conditioned process, against the JAX package -----------


def _derivative_posterior(M_, arr, kind):
    x = np.linspace(0.0, 6.0, 40)
    m = M_.Measure()
    f = M_.GP(0.5 * M_.EQ().stretch(1.3), measure=m)
    if kind == "exact":
        post = m | (f(arr(x), 0.05), arr(np.sin(x)))
        return post, f
    z = np.linspace(0.0, 6.0, 9)
    obs = M_.PseudoObs(f(arr(z)), (f(arr(x), 0.05), arr(np.sin(x))))
    return m | obs, f


@pytest.mark.parametrize("kind", ["exact", "pseudo"])
@pytest.mark.parametrize("order", [1, 2])
def test_derivative_of_posterior_matches_jax(kind, order):
    # No point of x_new is an inducing input: there the JAX package's second
    # derivative is wrong (test_second_derivative_at_an_inducing_input).
    x_new = np.linspace(-0.4, 6.6, 12)
    out = {}
    for key, M_, arr in (("j", sj, jnp.asarray), ("t", st, torch.tensor)):
        post, f = _derivative_posterior(M_, arr, kind)
        g = f.diff(0) if order == 1 else f.diff(0).diff(0)
        fdd = post(g)(arr(x_new))
        out[key] = [fdd.mean, M_.dense(fdd.var), *fdd.marginals()]
    for got, want in zip(out["t"], out["j"]):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-7, atol=1e-9)


def _scalar_kept(kernel, mean):
    """The inverse factor kept in ``K_z``'s cache and the weights kept in
    the mean's."""
    factor = [v[0] for k, v in kernel.K_z._cache.items() if k[0][0] == "scalar_inv_factor"]
    weights = [v[0] for k, v in mean._cache.items() if k[0][0] == "weights"]
    return factor, weights


def test_posterior_scalar_caches_hold_no_transform_wrappers():
    # The factor and the weights are made outside torch.func's transforms
    # (prime_scalar), so the caches keep plain tensors, a second evaluation
    # reuses them, and nothing primed for one evaluation outlives it.
    f = st.GP(st.EQ())
    x = _lin(0, 6, 30)
    post = f.measure.condition(f(x, 0.01), torch.sin(x))
    g = post(f.diff(0))
    first = g(_lin(1, 5, 6)).marginals()
    kernel, mean = g.kernel.k, g.mean.m
    factor, weights = _scalar_kept(kernel, mean)
    assert len(factor) == 1 and len(weights) == 1
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    assert not any(wrapped(t) for t in factor + weights)
    assert "_scalar_primed" not in vars(kernel) and "_scalar_primed" not in vars(mean)
    second = g(_lin(1, 5, 6)).marginals()
    again = _scalar_kept(kernel, mean)
    assert again[0][0] is factor[0] and again[1][0] is weights[0]
    for a, b in zip(first, second):
        np.testing.assert_allclose(np_(a), np_(b), rtol=0, atol=0)


def _derivative_marginals(log_ell):
    f = st.GP(st.EQ().stretch(torch.exp(log_ell)))
    x = _lin(0, 6, 30)
    post = f.measure.condition(f(x, 0.01), torch.sin(x))
    return post, post(f.diff(0))


@pytest.mark.parametrize("warm", ["no_grad", "jitter"])
def test_posterior_scalar_inputs_follow_grad_mode_and_jitter(warm):
    # A factor or weights made under no_grad hold no graph, and one made
    # under another jitter is another factor: neither may stand in for the
    # inputs of a later evaluation (the keys of matrix/ops.py's caches).
    xs = _lin(1, 5, 6)

    def grad_and_value(warmed):
        log_ell = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
        _, g = _derivative_marginals(log_ell)
        if warmed:
            with torch.no_grad():
                g(xs).marginals()
        mean, var = g(xs).marginals()
        (mean.sum() + var.sum()).backward()
        return np_(log_ell.grad), np_(mean.detach()), np_(var.detach())

    if warm == "no_grad":
        got, want = grad_and_value(True), grad_and_value(False)
        assert want[0] != 0
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-12)
        return
    prev = st.config.epsilon
    log_ell = torch.tensor(0.2, dtype=torch.float64)
    try:
        st.config.set_epsilon(1e-12)
        _, g = _derivative_marginals(log_ell)
        g(xs).marginals()
        st.config.set_epsilon(1e-2)
        got = g(xs).marginals()
        want = _derivative_marginals(log_ell)[1](xs).marginals()
    finally:
        st.config.set_epsilon(prev)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12)


def test_posterior_scalar_memory_is_linear_in_the_points():
    # The mapped points fold into the columns of one product with the
    # stored inverse factor: no tensor grows as points x z x z (a batched
    # triangular solve would copy the factor once per point).
    from tests.test_torch_helpers import LargestTensor

    n = 120
    f = st.GP(st.EQ())
    x = _lin(0, 6, n)
    post = f.measure.condition(f(x, 0.01), torch.sin(x))
    with LargestTensor() as big:
        post(f.diff(0))(_lin(1, 5, n)).marginals()
    assert big.numel <= 4 * n * n, (big.numel, big.op)


def test_second_derivative_at_an_inducing_input():
    # The JAX package's scalar forms build k(z, x) through pairwise, whose
    # distance (the matmul identity clamped at 0) has no curvature where x
    # is one of the z: its second derivative of the pseudo-point posterior
    # there came out with a variance of -0.838 at x = 3.0 (a z). The port
    # builds the row from k._scalar (x - z differenced), so the value at
    # the inducing input is the limit of its neighbours'.
    post, f = _derivative_posterior(st, torch.tensor, "pseudo")
    g = f.diff(0).diff(0)
    at = post(g)(torch.tensor([3.0], dtype=torch.float64)).marginals()
    near = post(g)(torch.tensor([3.0 + 1e-6], dtype=torch.float64)).marginals()
    for a, b in zip(at, near):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5)
    assert float(at[1][0]) > 0
