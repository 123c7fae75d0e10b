"""Parity of the port's remaining kernels and means with
``stheno_tpu.kernels`` (mirroring ``tests/kernels/test_kernels.py``):
``Delta``, ``FixedDelta``, ``Coregion``, ``DecayingKernel``,
``LogKernel``, ``pw_sums2``/``ew_sums2``, the one-pair form ``_scalar`` of
every kernel, derivative kernels (the closed form of a scaled or stretched
EQ, and ``torch.func`` through ``_scalar`` for any other kernel, against
``jax.grad`` to 1e-10), the input transforms of means and
``DerivativeMean``, in float64 on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_torch.kernels.kernel import DerivativeKernel
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

R = np.random.RandomState(3)
X = R.randn(6, 2)
Y = R.randn(4, 2)
B_CO = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, -0.2], [0.1, -0.2, 1.0]])


def _t(a):
    return torch.tensor(np.asarray(a))


def _kernels(M, arr):
    """The same kernel expressions in each package (``M``: its module)."""
    return {
        "eq": M.EQ(),
        "rq": M.RQ(0.7),
        "matern12": M.Matern12(),
        "matern32": M.Matern32(),
        "matern52": M.Matern52(),
        "linear": M.Linear(),
        "log": M.LogKernel(),
        "decaying": M.DecayingKernel(1.5, arr(np.array([0.5, 1.0]))),
        "delta": M.Delta(),
        "scaled_sum": 2.0 * M.EQ().stretch(0.8) + M.Matern32().stretch(arr(np.array([0.5, 1.5]))),
        "product": M.RQ(1.3) * M.Linear().shift(0.2),
        "selected": M.EQ().select([1]) * M.Matern52().select([0]),
        "periodic": M.EQ().periodic(2.0),
        "transformed": M.Matern32().transform(lambda x: x**2),
        "tensor_product": M.TensorProductKernel(lambda x: x[..., 0] ** 2),
    }


@pytest.mark.parametrize("name", list(_kernels(st, _t)))
def test_pairwise_elwise_scalar_match_jax(name):
    kt, kj = _kernels(st, _t)[name], _kernels(sj, jnp.asarray)[name]
    x, y = _t(X), _t(Y)
    np.testing.assert_allclose(np_(st.dense(kt(x, y))), np.asarray(sj.dense(kj(X, Y))),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(st.dense(kt(x))), np.asarray(sj.dense(kj(X))),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(kt.elwise(x, torch.flip(x, [0]))),
                               np.asarray(kj.elwise(X, X[::-1].copy())), rtol=1e-10, atol=1e-12)
    # The one-pair form agrees with the elementwise one.
    for i in range(3):
        np.testing.assert_allclose(float(kt._scalar(x[i], x[i + 1])),
                                   float(kj._scalar(jnp.asarray(X[i]), jnp.asarray(X[i + 1]))),
                                   rtol=1e-10, atol=1e-14)


def test_sums2():
    np.testing.assert_allclose(np_(st.pw_sums2(_t(X), _t(Y))), np.asarray(sj.pw_sums2(X, Y)),
                               rtol=1e-12)
    np.testing.assert_allclose(np_(st.ew_sums2(_t(X), _t(X))), np.asarray(sj.ew_sums2(X, X)),
                               rtol=1e-12)


def test_delta_structure_and_exactness():
    x = _t(X)
    assert isinstance(st.Delta()(x), st.Diagonal)
    y = torch.cat([x[2:4], _t(R.randn(3, 2))])
    expect = np.zeros((6, 5))
    expect[2, 0] = expect[3, 1] = 1.0
    np.testing.assert_array_equal(np_(st.dense(st.Delta()(x, y))), expect)
    # More than 8 input dimensions, and batches.
    xb = _t(np.random.RandomState(1).randn(2, 5, 12))
    Kb = st.dense(st.Delta()(xb, xb[:, :3]))
    assert Kb.shape == (2, 5, 3)
    np.testing.assert_array_equal(np_(Kb[:, :3, :3]), np.broadcast_to(np.eye(3), (2, 3, 3)))
    # A sum with a dense Gram stays dense; the Delta of one object adds as
    # a diagonal.
    s = st.EQ()(x) + st.Delta()(x)
    np.testing.assert_allclose(np_(st.dense(s)), np_(st.dense(st.EQ()(x))) + np.eye(6))
    assert st.Delta() == st.Delta() and st.Delta() != st.Delta(1e-3)
    assert st.Delta().stationary and str(st.Delta()) == "Delta()"


def test_fixed_delta():
    noises = np.array([0.1, 0.2, 0.3])
    k = st.FixedDelta(_t(noises))
    x = _t(np.linspace(0, 1, 3))
    K = k(x)
    assert isinstance(K, st.Diagonal)
    np.testing.assert_allclose(np_(K.diag), noises)
    assert isinstance(k(x, _t(np.linspace(0, 1, 3))), st.Zero)
    np.testing.assert_allclose(np_(k.elwise(x))[:, 0], noises)
    assert st.FixedDelta(_t(noises)) == st.FixedDelta(_t(noises))
    assert st.FixedDelta(_t(noises)) != st.FixedDelta(_t(noises + 1))
    assert "FixedDelta" in str(k)


def test_coregion_matches_jax_and_clips():
    k_t, k_j = st.Coregion(_t(B_CO)), sj.Coregion(jnp.asarray(B_CO))
    idx = np.array([0.0, 1.0, 2.0, 1.0, 5.0, -1.0])[:, None]
    jdx = np.array([2.0, 0.0, 1.0])[:, None]
    np.testing.assert_allclose(np_(st.dense(k_t(_t(idx), _t(jdx)))),
                               np.asarray(sj.dense(k_j(idx, jdx))), rtol=1e-12)
    np.testing.assert_allclose(np_(k_t.elwise(_t(idx))), np.asarray(k_j.elwise(idx)), rtol=1e-12)
    # Integer task indices keep a float B.
    K_int = st.dense(k_t(torch.tensor([[0], [1]]), torch.tensor([[1], [2]])))
    np.testing.assert_allclose(np_(K_int), B_CO[[0, 1]][:, [1, 2]])
    # ICM: EQ on column 0 times Coregion on column 1, differentiable in B.
    xs = np.stack([np.linspace(0, 1, 5), np.array([0, 1, 2, 0, 1.0])], axis=1)
    Bt = _t(B_CO).requires_grad_(True)
    K = st.dense((st.EQ().select([0]) * st.Coregion(Bt).select([1]))(_t(xs)))
    K.sum().backward()
    gj = jax.grad(lambda B: jnp.sum(sj.dense(
        (sj.EQ().select([0]) * sj.Coregion(B).select([1]))(jnp.asarray(xs)))))(jnp.asarray(B_CO))
    np.testing.assert_allclose(np_(Bt.grad), np.asarray(gj), rtol=1e-10)


def test_new_kernel_flags_and_display():
    assert st.LogKernel().stationary and not st.DecayingKernel(1.0, 1.0).stationary
    assert st.LogKernel() == st.LogKernel()
    assert st.DecayingKernel(1.0, 2.0) == st.DecayingKernel(1.0, 2.0)
    assert st.DecayingKernel(1.0, 2.0) != st.DecayingKernel(1.0, 3.0)
    assert str(st.LogKernel()) == "LogKernel()"
    assert "DecayingKernel" in str(st.DecayingKernel(1.0, 2.0))
    assert str(st.EQ().diff(0)) == str(sj.EQ().diff(0)) == "d(0, 0) EQ()"
    assert st.EQ().diff(0) == st.EQ().diff(0) and st.EQ().diff(0) != st.EQ().diff(0, None)
    assert st.EQ().diff(0).stationary and not st.EQ().diff(0, None).stationary


# --- derivative kernels --------------------------------------------------------


def _deriv_cases(M, arr):
    return [
        M.EQ(),
        2.5 * M.EQ(),
        M.EQ().stretch(0.7),
        M.EQ().stretch(arr(np.array([0.5, 1.3]))),
        (1.7 * M.EQ()).stretch(0.9),
        3.0 * M.EQ().stretch(arr(np.array([0.8, 2.0]))).stretch(1.1),
    ]


@pytest.mark.parametrize("d1,d2", [(0, 0), (0, 1), (1, 0), (0, None), (None, 1)])
@pytest.mark.parametrize("case", range(6))
def test_derivative_closed_form_matches_jax_and_autodiff(case, d1, d2):
    kt = DerivativeKernel(_deriv_cases(st, _t)[case], d1, d2)
    kj = sj.DerivativeKernel(_deriv_cases(sj, jnp.asarray)[case], d1, d2)
    assert kt._eq_parts(_t(X)) is not None
    x, y = _t(X), _t(Y)
    K = np_(st.dense(kt(x, y)))
    np.testing.assert_allclose(K, np.asarray(sj.dense(kj(X, Y))), rtol=1e-10, atol=1e-12)
    # The closed form against torch.func through _scalar.
    fm = torch.func.vmap(torch.func.vmap(kt._deriv_scalar_fn(), in_dims=(None, 0)),
                         in_dims=(0, None))
    np.testing.assert_allclose(K, np_(fm(x, y)), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np_(kt.elwise(x, x))[:, 0], np.diag(np_(st.dense(kt(x, x)))),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name", ["matern52", "rq", "matern32_x_eq", "second_eq", "log",
                                  "decaying", "periodic"])
@pytest.mark.parametrize("dims", [(0, 0), (1, None), (None, 0)])
def test_derivative_generic_path_matches_jax(name, dims):
    # Kernels with no closed form: torch.func against jax.grad, 1e-10.
    def make(M, arr):
        return {
            "matern52": M.Matern52().stretch(1.3),
            "rq": 0.8 * M.RQ(0.6),
            "matern32_x_eq": M.Matern32() * M.EQ().stretch(arr(np.array([0.7, 1.2]))),
            "second_eq": M.EQ().stretch(1.5).diff(0),
            "log": M.LogKernel(),
            "decaying": M.DecayingKernel(1.2, arr(np.array([2.0, 3.0]))),
            "periodic": M.EQ().periodic(1.5),
        }[name].diff(*dims)

    kt, kj = make(st, _t), make(sj, jnp.asarray)
    assert kt._eq_parts(_t(X)) is None
    Xp = np.abs(X) if name == "decaying" else X
    Yp = np.abs(Y) if name == "decaying" else Y
    np.testing.assert_allclose(np_(st.dense(kt(_t(Xp), _t(Yp)))),
                               np.asarray(sj.dense(kj(Xp, Yp))), rtol=1e-10, atol=1e-12)
    # Elementwise at distinct points: at coincident ones the derivatives of
    # a Matern kernel go through the regularised sqrt of _safe_sqrt, whose
    # rounding neither package resolves.
    np.testing.assert_allclose(np_(kt.elwise(_t(Xp), _t(Xp + 0.25))),
                               np.asarray(kj.elwise(Xp, Xp + 0.25)), rtol=1e-10, atol=1e-12)


def test_derivative_of_noisy_expression_is_flat():
    x = _t(np.linspace(0.0, 4.0, 6)[:, None])
    for noise_k in (0.1 * st.Delta(), st.FixedDelta(_t(np.ones(6)))):
        K = np_(st.dense((st.EQ() + noise_k).diff(0, 0)(x)))
        K_eq = np_(st.dense(st.EQ().diff(0, 0)(x)))
        off = ~np.eye(6, dtype=bool)
        np.testing.assert_allclose(K[off], K_eq[off], rtol=1e-10)
        assert np.all(np.isfinite(K))


def test_derivative_kernel_batched():
    r = np.random.RandomState(8)
    xb, yb = r.randn(3, 5, 2), r.randn(3, 4, 2)
    for make in (lambda M: M.EQ(), lambda M: M.Matern52() * M.EQ()):
        kt, kj = make(st).diff(0, 0), make(sj).diff(0, 0)
        K = np_(st.dense(kt(_t(xb), _t(yb))))
        assert K.shape == (3, 5, 4)
        np.testing.assert_allclose(K, np.asarray(sj.dense(kj(xb, yb))), rtol=1e-10, atol=1e-12)
        el = np_(kt.elwise(_t(xb), _t(xb + 0.25)))
        assert el.shape == (3, 5, 1)
        np.testing.assert_allclose(el, np.asarray(kj.elwise(xb, xb + 0.25)), rtol=1e-10,
                                   atol=1e-12)


def test_derivative_gradient_through_parameters_matches_jax():
    # The generic path under autograd: d/d(ell) of the sum of a second
    # derivative's Gram (torch.func inside, autograd outside).
    x = np.linspace(0, 2, 7)[:, None]
    gj = jax.grad(lambda ell: jnp.sum(sj.dense(
        sj.EQ().stretch(ell).diff(0).diff(0)(jnp.asarray(x)))))(1.3)
    ell = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    st.dense(st.EQ().stretch(ell).diff(0).diff(0)(_t(x))).sum().backward()
    np.testing.assert_allclose(float(ell.grad), float(gj), rtol=1e-10)


# --- means -------------------------------------------------------------------


def _means(M, arr):
    f = lambda x: x[..., :1] ** 2 + x[..., 1:]  # noqa: E731
    return {
        "stretch": M.TensorProductMean(f).stretch(2.0),
        "shift": M.TensorProductMean(f).shift(arr(np.array([0.5, -0.5]))),
        "select": M.TensorProductMean(lambda x: x ** 3).select([1]),
        "transform": M.TensorProductMean(f).transform(lambda x: x * 3),
        "periodic": M.TensorProductMean(lambda x: x[..., :1] * x[..., 1:2]).periodic(1.5),
        "diff0": M.TensorProductMean(f).diff(0),
        "diff1_scaled": (2.0 * M.TensorProductMean(f) + M.OneMean()).diff(1),
        "diff_stretch": M.TensorProductMean(f).stretch(0.5).diff(0),
    }


@pytest.mark.parametrize("name", list(_means(st, _t)))
def test_mean_transforms_match_jax(name):
    mt, mj = _means(st, _t)[name], _means(sj, jnp.asarray)[name]
    np.testing.assert_allclose(np_(mt(_t(X))), np.asarray(mj(X)), rtol=1e-12, atol=1e-14)
    if name != "shift":  # an array parameter prints as its package's array
        assert str(mt) == str(mj)


def test_derivative_mean_values():
    x = _t(np.linspace(0, 2, 5))
    m = st.TensorProductMean(lambda z: z**2)
    np.testing.assert_allclose(np_(m.diff(0)(x))[:, 0], 2 * np.linspace(0, 2, 5), rtol=1e-12)
    np.testing.assert_allclose(np_(st.OneMean().diff(0)(x)), np.zeros((5, 1)))
    assert m.stretch(2.0) == m.stretch(2.0) and m.diff(0) == m.diff(0)
    assert m.diff(0) != m.diff(1)
    with pytest.raises(NotImplementedError):
        m.diff(0)(_t(np.zeros((2, 3, 1))))
