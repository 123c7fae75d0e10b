"""Parity of the port's Kronecker tensor-grid path
(``stheno_torch.iterative.kron``) with ``stheno_tpu.iterative.kron`` on the
same numpy inputs, in float64, and the stories of ``tests/test_kron.py``
against the dense GP.

Tolerances: both packages run the same exact algorithm (per-factor
``eigh`` and the analytic VJP), so the NLML and every gradient (the
hyperparameters, the noise, ``y`` and the axes) agree at rtol 1e-10; the
posterior at 1e-10 of its largest entry; against the dense DSL the JAX
tests' own bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu import iterative as ji
from stheno_torch import iterative as ti
from stheno_torch.iterative import kron as tkron
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

EXACT = 1e-10

AX1 = np.linspace(0.0, 4.0, 11)
AX2 = np.sort(np.random.RandomState(0).rand(7) * 3.0)  # Deliberately non-uniform.


def T(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def J(a):
    return jnp.asarray(np.asarray(a))


def _dense_kron(kernels, axes):
    Ks = ti.kron_gram_factors(kernels, axes)
    K = np_(Ks[0])
    for Ki in Ks[1:]:
        K = np.kron(K, np_(Ki))
    return K


def test_kron_matvec_matches_dense_and_jax():
    kernels = (st.EQ().stretch(0.8), 1.7 * st.Matern32())
    v = np.random.RandomState(1).randn(77, 3)
    out = np_(ti.kron_matvec(kernels, (T(AX1), T(AX2)), T(v), noise=0.05))
    K = _dense_kron(kernels, (T(AX1), T(AX2))) + 0.05 * np.eye(77)
    np.testing.assert_allclose(out, K @ v, rtol=1e-9, atol=1e-9)
    out_j = ji.kron_matvec((sj.EQ().stretch(0.8), 1.7 * sj.Matern32()), (J(AX1), J(AX2)), J(v),
                           noise=0.05)
    np.testing.assert_allclose(out, np.asarray(out_j), rtol=EXACT, atol=1e-12)


def test_kron_matvec_3d_vector():
    axes = (np.linspace(0, 1, 4), np.linspace(0, 2, 5), np.linspace(0, 1, 3))
    kernels = (st.EQ(), st.Matern52(), st.EQ().stretch(0.5))
    v = np.random.RandomState(2).randn(60)
    out = ti.kron_matvec(kernels, tuple(map(T, axes)), T(v))
    assert out.shape == (60,)
    np.testing.assert_allclose(np_(out), _dense_kron(kernels, tuple(map(T, axes))) @ v,
                               rtol=1e-9, atol=1e-9)


def _kf_j(p):
    return (jnp.exp(p["log_s2"]) * sj.EQ().stretch(jnp.exp(p["log_ell"][0])),
            sj.EQ().stretch(jnp.exp(p["log_ell"][1])))


def _kf_t(p):
    return (torch.exp(p["log_s2"]) * st.EQ().stretch(torch.exp(p["log_ell"][0])),
            st.EQ().stretch(torch.exp(p["log_ell"][1])))


P0 = {"log_s2": 0.3, "log_ell": [-0.2, 0.4]}


def _pj():
    return {k: jnp.asarray(v) for k, v in P0.items()}


def _pt(grad=True):
    return {k: torch.tensor(v, dtype=torch.float64, requires_grad=grad) for k, v in P0.items()}


def _dsl_nlml(p, x, y, noise):
    f = st.GP(torch.exp(p["log_s2"]) * st.EQ().stretch(torch.exp(p["log_ell"])))
    return -f.measure.logpdf(f(x, noise), y)


def test_kron_nlml_exact_value_and_grads():
    """Against the dense DSL (the JAX test's bounds) and, at rtol 1e-10,
    the JAX package's value and gradients with respect to the
    hyperparameters, the noise, ``y`` and both axes."""
    y = np.random.RandomState(3).randn(77)
    p = _pt()
    noise = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    ax1, ax2, yt = T(AX1, True), T(AX2, True), T(y, True)
    val = ti.kron_nlml(_kf_t, p, (ax1, ax2), yt, noise)
    grads = torch.autograd.grad(val, [*p.values(), noise, yt, ax1, ax2])

    x = ti.grid_coords((T(AX1), T(AX2)))
    p_ref = _pt()
    n_ref = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    ref = _dsl_nlml(p_ref, x, T(y), n_ref)
    g_ref = torch.autograd.grad(ref, [*p_ref.values(), n_ref])
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-10)
    for a, b in zip(grads[:3], g_ref):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-7)

    def f_j(p, noise, yy, a1, a2):
        return ji.kron_nlml(_kf_j, p, (a1, a2), yy, noise)

    vj, gj = jax.value_and_grad(f_j, argnums=(0, 1, 2, 3, 4))(
        _pj(), jnp.asarray(0.1), J(y), J(AX1), J(AX2))
    np.testing.assert_allclose(float(val), float(vj), rtol=EXACT)
    refs = [gj[0]["log_s2"], gj[0]["log_ell"], gj[1], gj[2], gj[3], gj[4]]
    for name, a, b in zip(["log_s2", "log_ell", "noise", "y", "ax1", "ax2"], grads, refs):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=EXACT, atol=1e-12, err_msg=name)


def test_kron_nlml_y_gradient():
    y = np.random.RandomState(4).randn(77)
    yt = T(y, True)
    (g,) = torch.autograd.grad(ti.kron_nlml(_kf_t, _pt(False), (T(AX1), T(AX2)), yt, 0.1), [yt])
    x = ti.grid_coords((T(AX1), T(AX2)))
    y_ref = T(y, True)
    (g_ref,) = torch.autograd.grad(_dsl_nlml(_pt(False), x, y_ref, 0.1), [y_ref])
    np.testing.assert_allclose(np_(g), np_(g_ref), rtol=1e-7)


def test_kron_nlml_1d_reduces_to_dense():
    ax = np.linspace(0.0, 5.0, 30)
    kf = lambda p: (p["s2"] * st.EQ().stretch(p["ell"]),)  # noqa: E731
    params = {"s2": torch.tensor(1.4, dtype=torch.float64),
              "ell": torch.tensor(0.9, dtype=torch.float64)}
    val = ti.kron_nlml(kf, params, T(ax), torch.sin(T(ax)), 0.05)
    f = st.GP(params["s2"] * st.EQ().stretch(params["ell"]))
    np.testing.assert_allclose(float(val), float(-f.measure.logpdf(f(T(ax), 0.05),
                                                                  torch.sin(T(ax)))), rtol=1e-9)


def test_kron_posterior_matches_dsl_and_jax():
    y = np.random.RandomState(5).randn(77)
    x = ti.grid_coords((T(AX1), T(AX2)))
    x_new = np.random.RandomState(6).rand(13, 2) * 3.0
    mean, var = ti.kron_posterior(_kf_t, _pt(False), (T(AX1), T(AX2)), T(y), 0.1, T(x_new))
    p = _pt(False)
    f = st.GP(torch.exp(p["log_s2"]) * st.EQ().stretch(torch.exp(p["log_ell"])))
    post = f | (f(x, 0.1), T(y))
    mean_ref, var_ref = post(T(x_new)).marginals()
    np.testing.assert_allclose(np_(mean), np_(mean_ref), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np_(var), np_(var_ref), rtol=1e-6, atol=1e-10)
    mj, vj = ji.kron_posterior(_kf_j, _pj(), (J(AX1), J(AX2)), J(y), 0.1, J(x_new))
    np.testing.assert_allclose(np_(mean), np.asarray(mj), rtol=EXACT,
                               atol=EXACT * np.abs(np.asarray(mj)).max())
    np.testing.assert_allclose(np_(var), np.asarray(vj), rtol=EXACT,
                               atol=EXACT * np.abs(np.asarray(vj)).max())


def test_kron_rejects_vector_noise_and_mismatch():
    y = torch.zeros(77, dtype=torch.float64)
    with pytest.raises(ValueError, match="scalar"):
        ti.kron_nlml(_kf_t, _pt(False), (T(AX1), T(AX2)), y, torch.full((77,), 0.1,
                                                                        dtype=torch.float64))
    with pytest.raises(ValueError, match="kernels"):
        ti.kron_matvec((st.EQ(),), (T(AX1), T(AX2)), y)
    with pytest.raises(ValueError, match="columns"):
        ti.kron_posterior(_kf_t, _pt(False), (T(AX1), T(AX2)), y, 0.1,
                          torch.zeros((4, 3), dtype=torch.float64))


def test_kron_nlml_zero_noise_rank_deficient_finite():
    # Zero noise with numerically rank-deficient factors: the jitter floor
    # on D keeps the NLML and its gradients finite.
    axes = (T(np.linspace(0.0, 1.0, 16)), T(np.linspace(0.0, 1.0, 8)))
    y = T(np.random.RandomState(5).randn(128) * 1e-3)
    p = _pt()
    val = ti.kron_nlml(_kf_t, p, axes, y, 0.0)
    grads = torch.autograd.grad(val, list(p.values()))
    assert np.isfinite(float(val)) and all(bool(torch.isfinite(g).all()) for g in grads)


def test_kron_bwd_clamp_consistency_3d():
    """Three axes exercise the prefix and suffix products of the analytic
    backward: against the dense Cholesky NLML's gradient and the JAX
    package's."""
    axes = (np.linspace(0, 1, 4), np.linspace(0, 2, 5), np.linspace(0, 1, 3))

    def kf3_t(p):
        ell = torch.exp(p["log_ell"])
        return (torch.exp(p["log_s2"]) * st.EQ().stretch(ell[0]),
                st.Matern52().stretch(ell[1]), st.EQ().stretch(ell[0]))

    def kf3_j(p):
        ell = jnp.exp(p["log_ell"])
        return (jnp.exp(p["log_s2"]) * sj.EQ().stretch(ell[0]),
                sj.Matern52().stretch(ell[1]), sj.EQ().stretch(ell[0]))

    y = np.random.RandomState(6).randn(60)
    p = _pt()
    val = ti.kron_nlml(kf3_t, p, tuple(map(T, axes)), T(y), 0.1)
    grads = torch.autograd.grad(val, list(p.values()))

    p_ref = _pt()
    Ks = ti.kron_gram_factors(kf3_t(p_ref), tuple(map(T, axes)))
    K = torch.kron(torch.kron(Ks[0], Ks[1]), Ks[2]) + 0.1 * torch.eye(60, dtype=torch.float64)
    L = torch.linalg.cholesky(K)
    a = torch.cholesky_solve(T(y)[:, None], L)[:, 0]
    ref = 0.5 * (2 * torch.sum(torch.log(torch.diag(L))) + T(y) @ a + 60 * np.log(2 * np.pi))
    g_ref = torch.autograd.grad(ref, list(p_ref.values()))
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-9)
    for a_, b in zip(grads, g_ref):
        np.testing.assert_allclose(np_(a_), np_(b), rtol=1e-6)
    vj, gj = jax.value_and_grad(lambda pp: ji.kron_nlml(kf3_j, pp, tuple(map(J, axes)), J(y),
                                                        0.1))(_pj())
    np.testing.assert_allclose(float(val), float(vj), rtol=EXACT)
    for a_, k in zip(grads, P0):
        np.testing.assert_allclose(np_(a_), np.asarray(gj[k]), rtol=EXACT, atol=1e-12)


def test_kron_backward_does_not_differentiate_eigh(monkeypatch):
    # The gradient is the analytic partial-trace VJP: eigh runs once, in
    # the forward, and never under autograd.
    calls = []
    real = torch.linalg.eigh

    def spy(A, *a, **kw):
        calls.append(torch.is_grad_enabled() and A.requires_grad)
        return real(A, *a, **kw)

    monkeypatch.setattr(tkron.torch.linalg, "eigh", spy)
    p = _pt()
    val = ti.kron_nlml(_kf_t, p, (T(AX1), T(AX2)), T(np.ones(77)), 0.1)
    torch.autograd.grad(val, list(p.values()))
    assert calls == [False, False]


def test_kron_entry_points_small():
    from stheno_torch import entry as E

    ax1, ax2, y, params = E.kron_1m_inputs(16, 12, dtype=torch.float64)
    np.testing.assert_allclose(np_(ax2), np.linspace(0.0, 8.0, 12), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np_(y), np.random.RandomState(1).randn(16 * 12))
    val, grads = E.kron_nlml_1m_step(ax1, ax2, y, params)
    vj = ji.kron_nlml(
        lambda p: (jnp.exp(p["log_s2"]) * sj.EQ().stretch(jnp.exp(p["log_ell1"])),
                   sj.EQ().stretch(jnp.exp(p["log_ell2"]))),
        {k: jnp.asarray(0.0) for k in params}, (J(np_(ax1)), J(np_(ax2))), J(np_(y)), 0.1)
    np.testing.assert_allclose(float(val), float(vj), rtol=EXACT)
    assert set(grads) == {"log_s2", "log_ell1", "log_ell2"}
    mean, var = E.kron_posterior_1m(ax1, ax2, y, params, n_new=32)
    assert mean.shape == (32,) and var.shape == (32,) and bool((var >= 0).all())
