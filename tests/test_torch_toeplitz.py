"""Parity of the port's circulant-embedding grid path
(``stheno_torch.iterative.toeplitz``) with ``stheno_tpu.iterative.toeplitz``
on the same numpy inputs, in float64, and the stories of
``tests/test_toeplitz.py`` against the dense GP.

Tolerances: the FFT matvecs and spectra agree with the JAX package's to
rounding (1e-12 of the entries, as with the dense Gram in the JAX tests
at 1e-9). The NLML core with the grid matvec, from the same numpy probes,
agrees in value and every gradient at ``SOLVE`` (1e-7, the iterative
parity tests' tolerance for tight solves); posterior means and variances
at tight CG tolerances agree to the solve's accuracy (1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu import iterative as ji
from stheno_tpu.iterative import nlml as jnlml
from stheno_tpu.iterative import toeplitz as jtoe
from stheno_torch import iterative as ti
from stheno_torch.iterative import nlml as tnlml
from stheno_torch.iterative import toeplitz as ttoe
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

SOLVE = 1e-7


def T(a):
    return torch.tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _dense_K(k, x, noise=0.0):
    K = np_(st.dense(st.pairwise(k, T(x))))
    return K + noise * np.eye(K.shape[0])


KERNELS = [
    ("eq", lambda m: m.EQ()),
    ("scaled_stretched", lambda m: 2.0 * m.EQ().stretch(0.7)),
    ("matern32_plus_eq", lambda m: m.Matern32() + 0.5 * m.EQ()),
    ("periodic", lambda m: m.EQ().periodic(2.0)),
]


@pytest.mark.parametrize("case", KERNELS, ids=[c[0] for c in KERNELS])
def test_grid_matvec_1d(case):
    _, make = case
    x = np.linspace(-3.0, 3.0, 64)
    v = np.random.RandomState(0).randn(64, 3)
    out = np_(ti.grid_matvec(make(st), T(x), T(v), noise=0.1))
    np.testing.assert_allclose(out, _dense_K(make(st), x[:, None], 0.1) @ v, rtol=1e-9,
                               atol=1e-9)
    out_j = np.asarray(ji.grid_matvec(make(sj), J(x), J(v), noise=0.1))
    np.testing.assert_allclose(out, out_j, rtol=1e-12, atol=1e-12)


def test_grid_matvec_1d_vector_and_vector_noise():
    x = np.linspace(0.0, 5.0, 33)  # Odd length exercises padding.
    v = np.random.RandomState(1).randn(33)
    nz = np.random.RandomState(2).rand(33) + 0.1
    out = ti.grid_matvec(st.EQ(), T(x), T(v), noise=T(nz))
    K = _dense_K(st.EQ(), x[:, None]) + np.diag(nz)
    assert out.shape == (33,)
    np.testing.assert_allclose(np_(out), K @ v, rtol=1e-9, atol=1e-9)


def test_grid_matvec_2d():
    ax = (np.linspace(0.0, 4.0, 12), np.linspace(-1.0, 1.0, 9))
    x = ti.grid_coords(tuple(map(T, ax)))
    assert x.shape == (108, 2)
    np.testing.assert_array_equal(np_(x), np.asarray(ji.grid_coords(tuple(map(J, ax)))))
    k = 1.3 * st.EQ().stretch(0.8)
    v = np.random.RandomState(3).randn(108, 2)
    out = np_(ti.grid_matvec(k, tuple(map(T, ax)), T(v), noise=0.05))
    np.testing.assert_allclose(out, _dense_K(k, np_(x), 0.05) @ v, rtol=1e-9, atol=1e-9)
    out_j = ji.grid_matvec(1.3 * sj.EQ().stretch(0.8), tuple(map(J, ax)), J(v), noise=0.05)
    np.testing.assert_allclose(out, np.asarray(out_j), rtol=1e-12, atol=1e-12)


def test_grid_matvec_anisotropic_stretch_2d():
    ax = (np.linspace(0.0, 3.0, 8), np.linspace(0.0, 2.0, 6))
    k = st.EQ().stretch(T([0.5, 1.5]))
    x = np_(ti.grid_coords(tuple(map(T, ax))))
    v = np.random.RandomState(4).randn(48)
    out = ti.grid_matvec(k, tuple(map(T, ax)), T(v))
    np.testing.assert_allclose(np_(out), _dense_K(k, x) @ v, rtol=1e-9, atol=1e-9)


def test_precomputed_spectrum_matches():
    x = np.linspace(0.0, 1.0, 16)
    spec = ti.circulant_spectrum(st.EQ(), T(x))
    np.testing.assert_allclose(np_(spec), np.asarray(ji.circulant_spectrum(sj.EQ(), J(x))),
                               rtol=1e-12, atol=1e-12)
    v = torch.ones(16, dtype=torch.float64)
    np.testing.assert_allclose(np_(ti.grid_matvec(st.EQ(), T(x), v, spectrum=spec)),
                               np_(ti.grid_matvec(st.EQ(), T(x), v)), rtol=1e-12)


def test_non_stationary_rejected():
    with pytest.raises(ValueError, match="stationary"):
        ti.grid_matvec(st.Linear(), torch.linspace(0, 1, 8, dtype=torch.float64),
                       torch.ones(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="rows"):
        ti.grid_matvec(st.EQ(), torch.linspace(0, 1, 8, dtype=torch.float64),
                       torch.ones(9, dtype=torch.float64))


def _kf_j(p):
    return jnp.exp(p["log_s2"]) * sj.EQ().stretch(jnp.exp(p["log_ell"]))


def _kf_t(p):
    return torch.exp(p["log_s2"]) * st.EQ().stretch(torch.exp(p["log_ell"]))


def _pt(params, grad=True):
    return {k: torch.tensor(v, dtype=torch.float64, requires_grad=grad)
            for k, v in params.items()}


def test_grid_nlml_matches_dense_logpdf():
    n = 256
    x = np.linspace(0.0, 10.0, n)
    y = np.sin(x) + 0.1 * np.random.RandomState(5).randn(n)
    params = _pt({"log_s2": 0.2, "log_ell": -0.3})
    val = ti.grid_iterative_nlml(_kf_t, params, T(x), T(y), 0.1,
                                 torch.Generator().manual_seed(0), num_probes=16, cg_tol=1e-8,
                                 slq_steps=30, precond_rank=48)
    grads = torch.autograd.grad(val, list(params.values()))
    p_ref = _pt({"log_s2": 0.2, "log_ell": -0.3})
    f = st.GP(_kf_t(p_ref))
    ref = -f.measure.logpdf(f(T(x), 0.1), T(y))
    g_ref = torch.autograd.grad(ref, list(p_ref.values()))
    # The SLQ logdet is stochastic; the quadratic term is CG-exact.
    np.testing.assert_allclose(float(val), float(ref), rtol=2e-3)
    for a, b in zip(grads, g_ref):
        np.testing.assert_allclose(float(a), float(b), rtol=0.25, atol=0.5)


def test_grid_nlml_agrees_with_dense_iterative():
    """Same estimator, same generator: the FFT matvec agrees with the
    blocked dense sweep to matvec rounding."""
    n = 128
    x = np.linspace(0.0, 6.0, n)
    y = np.cos(x)
    kf = lambda p: torch.exp(p["log_s2"]) * st.EQ()  # noqa: E731
    params = {"log_s2": torch.tensor(0.1, dtype=torch.float64)}
    kwargs = dict(num_probes=4, cg_tol=1e-10, slq_steps=20, precond_rank=32)
    v_grid = ti.grid_iterative_nlml(kf, params, T(x), T(y), 0.2,
                                    torch.Generator().manual_seed(7), **kwargs)
    v_dense = ti.iterative_nlml(kf, params, T(x), T(y), 0.2, torch.Generator().manual_seed(7),
                                **kwargs)
    np.testing.assert_allclose(float(v_grid), float(v_dense), rtol=1e-7)


def _grid_mv_j(shape):
    def mv(k, xx, v, nz):
        return jtoe.grid_matvec(k, jtoe._axes_from_coords(xx, shape), v, noise=nz)

    return mv


@pytest.mark.parametrize("precond", ["eig", "pivoted"])
def test_grid_nlml_core_matches_jax(precond):
    """The NLML core with the grid ``matvec_fn``, from the same numpy
    probes: value and gradients with respect to the hyperparameters, the
    noise, ``y`` and the grid coordinates, against the JAX package's
    ``_nlml`` at ``SOLVE``. The surrogate takes the bilinear form through
    the FFT matvec, and the forward solves never the blocked sweep."""
    ax = (np.linspace(0.0, 3.0, 10), np.linspace(0.0, 2.0, 8))
    shape = (10, 8)
    xg = np.asarray(ji.grid_coords(tuple(map(J, ax))))
    n = xg.shape[0]
    r = np.random.RandomState(11)
    y = np.sin(xg.sum(1)) + 0.1 * r.randn(n)
    u = r.randn(n, 5)
    om = r.randn(n, 30) if precond == "eig" else None
    common = (1e-10, 400, 60, 30)  # cg_tol, max_cg_iters, quad_steps, precond_rank
    p0 = {"log_s2": 0.1, "log_ell": -0.2}

    def value_j(p, noise, xx, yy):
        return jnlml._nlml(p, yy, noise, xx, J(u), None if om is None else J(om), None, _kf_j,
                           _grid_mv_j(shape), None, *common, precond, 1, None)

    (vj, hj), gj = jax.value_and_grad(value_j, argnums=(0, 1, 2, 3), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p0.items()}, jnp.asarray(0.1), J(xg), J(y))
    p_t = _pt(p0)
    nt = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    xt, yt = T(xg).requires_grad_(True), T(y).requires_grad_(True)

    def mv_t(k, xx, v, nz):
        return ti.grid_matvec(k, ttoe._axes_from_coords(xx, shape), v, noise=nz)

    vt, ht = tnlml._nlml(p_t, yt, nt, xt, T(u), None if om is None else T(om), None, _kf_t,
                         *common, precond, 1, matvec_fn=mv_t)
    gt = torch.autograd.grad(vt, [*p_t.values(), nt, xt, yt])
    assert ht["cg_iters"] == int(hj["cg_iters"]) and ht["cg_converged"]
    np.testing.assert_allclose(float(vt), float(vj), rtol=SOLVE)
    refs = [gj[0][k] for k in p_t] + [gj[1], gj[2], gj[3]]
    for name, a, b in zip(["log_s2", "log_ell", "noise", "x", "y"], gt, refs):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=SOLVE, atol=1e-9, err_msg=name)


def test_grid_nlml_axes_gradient_matches_jax():
    """Gradients reach the axes through ``grid_coords`` and
    ``_axes_from_coords``, as in the JAX package (same probes: the port's
    generator's draws are replayed into the JAX core)."""
    x = np.linspace(0.0, 6.0, 64)
    y = np.cos(x)
    p0 = {"log_s2": 0.1, "log_ell": 0.2}
    xt = T(x).requires_grad_(True)
    gen = torch.Generator().manual_seed(3)
    val = ti.grid_iterative_nlml(_kf_t, _pt(p0, grad=False), xt, T(y), 0.2, gen,
                                 num_probes=4, cg_tol=1e-10, precond_rank=16)
    (gx,) = torch.autograd.grad(val, [xt])
    g2 = torch.Generator().manual_seed(3)
    u = torch.randn((64, 4), generator=g2, dtype=torch.float64)
    om = torch.randn((64, 16), generator=g2, dtype=torch.float64)

    def value_j(axis):
        xx = jtoe.grid_coords((axis,))
        return jnlml._nlml({k: jnp.asarray(v) for k, v in p0.items()}, J(y), jnp.asarray(0.2),
                           xx, J(np_(u)), J(np_(om)), None, _kf_j, _grid_mv_j((64,)), None,
                           1e-10, 500, 20, 16, "eig", 1, None)[0]

    vj, gxj = jax.value_and_grad(value_j)(J(x))
    np.testing.assert_allclose(float(val), float(vj), rtol=SOLVE)
    np.testing.assert_allclose(np_(gx), np.asarray(gxj), rtol=SOLVE, atol=1e-9)


def test_grid_posterior_mean():
    n = 200
    x = np.linspace(0.0, 10.0, n)
    y = np.sin(x)
    x_new = np.linspace(0.5, 9.5, 17)
    kf = lambda p: st.EQ().stretch(p["ell"])  # noqa: E731
    params = {"ell": torch.tensor(1.0, dtype=torch.float64)}
    mean, info = ti.grid_posterior_mean(kf, params, T(x), T(y), 0.01, T(x_new), cg_tol=1e-10)
    f = st.GP(kf(params))
    post = f | (f(T(x), 0.01), T(y))
    ref = np_(st.dense(post(T(x_new)).mean))[:, 0]
    np.testing.assert_allclose(np_(mean), ref, rtol=1e-6, atol=1e-8)
    mean_j, info_j = ji.grid_posterior_mean(lambda p: sj.EQ().stretch(p["ell"]),
                                            {"ell": jnp.asarray(1.0)}, J(x), J(y), 0.01,
                                            J(x_new), cg_tol=1e-10)
    np.testing.assert_allclose(np_(mean), np.asarray(mean_j), rtol=SOLVE, atol=1e-9)
    # Per-point noise takes the plain CG.
    mean_v, _ = ti.grid_posterior_mean(kf, params, T(x), T(y), T(np.full(n, 0.01)), T(x_new),
                                       cg_tol=1e-10, max_cg_iters=2000)
    np.testing.assert_allclose(np_(mean_v), ref, rtol=1e-5, atol=1e-6)


def test_grid_nlml_2d():
    ax = (np.linspace(0.0, 3.0, 10), np.linspace(0.0, 3.0, 10))
    x = ti.grid_coords(tuple(map(T, ax)))
    y = np.random.RandomState(8).randn(100)
    params = _pt({"log_s2": 0.0, "log_ell": 0.0})
    val = ti.grid_iterative_nlml(_kf_t, params, tuple(map(T, ax)), T(y), 0.1,
                                 torch.Generator().manual_seed(1), num_probes=4, cg_tol=1e-6,
                                 slq_steps=10, precond_rank=16)
    grads = torch.autograd.grad(val, list(params.values()))
    assert np.isfinite(float(val)) and all(np.isfinite(float(g)) for g in grads)
    p_ref = _pt({"log_s2": 0.0, "log_ell": 0.0}, grad=False)
    f = st.GP(_kf_t(p_ref))
    ref = -f.measure.logpdf(f(x, 0.1), T(y))
    np.testing.assert_allclose(float(val), float(ref), rtol=5e-2)


def test_grid_posterior_var_matches_dsl_and_jax():
    axes = (np.linspace(0.0, 6.0, 16), np.linspace(0.0, 3.0, 8))
    x = ti.grid_coords(tuple(map(T, axes)))
    r = np.random.RandomState(8)
    y = np.sin(np_(x).sum(axis=1)) + 0.05 * r.randn(128)
    x_new = r.rand(41, 2) * [[6.0, 3.0]]
    var = ti.grid_posterior_var(lambda p: 1.3 * st.EQ().stretch(0.9), None,
                                tuple(map(T, axes)), T(y), 0.1, T(x_new), cg_tol=1e-10,
                                precond_rank=40, chunk=16)
    f = st.GP(1.3 * st.EQ().stretch(0.9))
    post = f | (f(x, 0.1), T(y))
    _, var_ref = post(T(x_new)).marginals()
    np.testing.assert_allclose(np_(var), np_(var_ref), rtol=1e-4, atol=1e-8)
    var_j = ji.grid_posterior_var(lambda p: 1.3 * sj.EQ().stretch(0.9), None,
                                  tuple(map(J, axes)), J(y), 0.1, J(x_new), cg_tol=1e-10,
                                  precond_rank=40, chunk=16)
    np.testing.assert_allclose(np_(var), np.asarray(var_j), rtol=SOLVE, atol=1e-9)


def test_grid_entry_points_small():
    """The N=2^20 entry points' code at a small grid: the inputs as
    ``bench.py`` makes them, the step's value and gradient finite, the
    posterior's shapes."""
    from stheno_torch import entry as E

    axis, y, params = E.grid_1m_inputs(n=512, dtype=torch.float64)
    np.testing.assert_allclose(np_(axis), np.linspace(0.0, 100.0, 512), rtol=1e-12, atol=1e-12)
    ref_y = np.sin(np.linspace(0.0, 100.0, 512)) + 0.1 * np.random.RandomState(0).randn(512)
    np.testing.assert_allclose(np_(y), ref_y, rtol=1e-12, atol=1e-12)
    val, grads = E.grid_nlml_1m_step(axis, y, params, torch.Generator().manual_seed(0))
    assert np.isfinite(float(val)) and all(np.isfinite(float(g)) for g in grads.values())
    mean, var, info = E.grid_posterior_1m(axis, y, params, n_mean=64, n_var=32)
    assert mean.shape == (64,) and var.shape == (32,) and bool((var >= 0).all())
