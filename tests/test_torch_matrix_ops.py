"""Parity of the port's matrix ops of the pseudo-point path with
``stheno_tpu.matrix``: ``ratio`` (values and gradients through its
closed-form adjoint), ``matmul3``, ``matmul_diag``, ``trace``,
``eye_like``, ``block_diag``, ``block``, ``root``, ``shape_matrix``,
``dtype_of``, and ``sample`` by moments and by the same normals, in
float64 on numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu import config as jconfig
from stheno_torch.matrix import ops as tops
from tests.test_torch_helpers import both_impls, np_, spd, torch_cpu  # noqa: F401


@pytest.fixture(params=["auto", "fast"])
def impl(request):
    both_impls(jconfig, request.param)
    yield request.param
    jconfig.set_cholesky_impl("auto")


def _t(a):
    return torch.tensor(a)


# --- ratio -------------------------------------------------------------------


def test_ratio_dense_value_and_grads_match_jax(impl):
    # tr(B^{-1} A) for a free-form A: the closed-form adjoint, rtol 1e-9.
    n = 30
    r = np.random.RandomState(0)
    A, B = r.randn(n, n), spd(n, seed=3)
    vj, (gA, gB) = jax.value_and_grad(
        lambda A, B: sj.ratio(sj.Dense(A), sj.Dense(B)), argnums=(0, 1)
    )(jnp.asarray(A), jnp.asarray(B))
    tA, tB = _t(A).requires_grad_(True), _t(B).requires_grad_(True)
    vt = st.ratio(st.Dense(tA), st.Dense(tB))
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-9)
    np.testing.assert_allclose(np_(tA.grad), np_(gA), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(tB.grad), np_(gB), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(vt.detach()), np.trace(np.linalg.solve(B, A)), rtol=1e-9)


@pytest.mark.parametrize("case", ["diag_diag", "dense_diag", "dense_woodbury", "diag_dense"])
def test_ratio_structured_branches_match_jax(case):
    n = 12
    r = np.random.RandomState(1)
    d1, d2 = r.rand(n) + 0.5, r.rand(n) + 0.5
    A, U = spd(n, seed=4), r.randn(n, 3)

    def build(M, arr):
        a = {"diag_diag": M.Diagonal(arr(d1)), "dense_diag": M.Dense(arr(A)),
             "dense_woodbury": M.Dense(arr(A)), "diag_dense": M.Diagonal(arr(d1))}[case]
        b = {"diag_diag": M.Diagonal(arr(d2)), "dense_diag": M.Diagonal(arr(d2)),
             "dense_woodbury": M.Woodbury(M.Diagonal(arr(d2)), M.LowRank(arr(U))),
             "diag_dense": M.Dense(arr(spd(n, seed=5)))}[case]
        return M.ratio(a, b)

    got, want = build(st, _t), build(sj, jnp.asarray)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


# --- products, trace, construction --------------------------------------------


@pytest.mark.parametrize("n", [96, 100])
def test_long_contraction_runs_in_chunks(monkeypatch, n):
    # iqf with a Diagonal matrix contracts over its length in chunks (with
    # a remainder when the chunk does not divide it): the same value and
    # gradients as the JAX package's single product, float64.
    monkeypatch.setattr(tops, "_CHUNK", 16)
    r = np.random.RandomState(13)
    d, B, y = r.rand(n) + 0.5, r.randn(5, n), r.randn(n, 1)

    def f(M, d, B, y):
        D = M.Diagonal(d)
        return (M.dense(M.iqf(D, B.T)) ** 2).sum() + M.dense(M.iqf(D, B.T, y)).sum()

    vj, gj = jax.value_and_grad(lambda *a: f(sj, *a), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (d, B, y)))
    ts = [torch.tensor(a, requires_grad=True) for a in (d, B, y)]
    vt = f(st, *ts)
    gt = torch.autograd.grad(vt, ts)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-12)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("tr_a, tr_c", [(False, False), (True, False), (False, True), (True, True)])
def test_matmul3_matches_jax(tr_a, tr_c):
    r = np.random.RandomState(2)
    a, b, c = r.randn(5, 5), r.randn(5, 5), r.randn(5, 5)
    got = st.dense(st.matmul3(st.Dense(_t(a)), _t(b), st.Diagonal(_t(c[0])), tr_a, tr_c))
    want = sj.dense(sj.matmul3(sj.Dense(jnp.asarray(a)), jnp.asarray(b),
                               sj.Diagonal(jnp.asarray(c[0])), tr_a, tr_c))
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-12)


@pytest.mark.parametrize("tr_a", [False, True])
def test_matmul_diag_matches_jax(tr_a):
    r = np.random.RandomState(3)
    a, b = r.randn(4, 7), r.randn(4, 7) if tr_a else r.randn(7, 4)
    got = st.matmul_diag(st.Dense(_t(a)), _t(b), tr_a=tr_a)
    want = sj.matmul_diag(sj.Dense(jnp.asarray(a)), jnp.asarray(b), tr_a=tr_a)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-12)
    full = (a.T @ b) if tr_a else (a @ b)
    np.testing.assert_allclose(np_(got), np.diag(full), rtol=1e-12)


def test_trace_eye_like_shape_dtype():
    A = spd(6, seed=6)
    want = float(sj.trace(sj.Dense(jnp.asarray(A))))
    assert float(st.trace(st.Dense(_t(A)))) == pytest.approx(want, rel=1e-14)
    assert float(st.trace(st.Diagonal(_t(np.arange(4.0))))) == 6.0
    eye = st.eye_like(st.Dense(_t(A)))
    assert isinstance(eye, st.Diagonal) and eye.dtype == torch.float64
    np.testing.assert_array_equal(np_(st.dense(eye)), np_(sj.dense(sj.eye_like(jnp.asarray(A)))))
    assert tuple(st.shape_matrix(_t(A[:, :4]))) == tuple(sj.shape_matrix(jnp.asarray(A[:, :4])))
    assert st.dtype_of(st.Dense(_t(A))) == torch.float64
    assert st.dtype_of(_t(A).float()) == torch.float32


def _blocks(M, arr):
    r = np.random.RandomState(7)
    return {
        "diag": [M.Diagonal(arr(r.rand(3))), M.Zero(arr(np.zeros(1)).dtype, 2, 2),
                 M.Diagonal(arr(r.rand(4)))],
        "mixed": [M.Dense(arr(r.randn(3, 2))), M.Diagonal(arr(r.rand(2))),
                  M.Zero(arr(np.zeros(1)).dtype, 1, 3)],
        "zeros": [M.Zero(arr(np.zeros(1)).dtype, 2, 3), M.Zero(arr(np.zeros(1)).dtype, 1, 1)],
    }


@pytest.mark.parametrize("case", ["diag", "mixed", "zeros"])
def test_block_diag_matches_jax(case):
    got = st.block_diag(*_blocks(st, _t)[case])
    want = sj.block_diag(*_blocks(sj, jnp.asarray)[case])
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_allclose(np_(st.dense(got)), np_(sj.dense(want)), rtol=1e-14)


@pytest.mark.parametrize("case", ["diagonal", "dense"])
def test_block_matches_jax(case):
    r = np.random.RandomState(8)
    d1, d2, g = r.rand(3), r.rand(2), r.randn(3, 2)

    def grid(M, arr):
        z32 = M.Zero(arr(d1).dtype, 3, 2)
        z23 = M.Zero(arr(d1).dtype, 2, 3)
        upper = z32 if case == "diagonal" else M.Dense(arr(g))
        return [[M.Diagonal(arr(d1)), upper], [z23, M.Diagonal(arr(d2))]]

    got, want = st.block(grid(st, _t)), sj.block(grid(sj, jnp.asarray))
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_allclose(np_(st.dense(got)), np_(sj.dense(want)), rtol=1e-14)


def test_root_matches_jax():
    A = spd(8, seed=9)
    got = st.dense(st.root(st.Dense(_t(A))))
    np.testing.assert_allclose(np_(got), np_(sj.dense(sj.root(sj.Dense(jnp.asarray(A))))),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np_(got @ got), A, rtol=1e-10, atol=1e-12)
    d = np.array([4.0, -1.0, 9.0])
    np.testing.assert_array_equal(np_(st.dense(st.root(st.Diagonal(_t(d))))),
                                  np.diag([2.0, 0, 3.0]))
    z = st.Zero(torch.float64, 3, 3)
    assert st.root(z) is z


# --- sampling -------------------------------------------------------------------


def _covariances(M, arr):
    r = np.random.RandomState(10)
    U = r.randn(4, 2)
    d = r.rand(4) + 0.2
    return {
        "dense": M.Dense(arr(spd(4, seed=11))),
        "diagonal": M.Diagonal(arr(d)),
        "lowrank": M.LowRank(arr(U), None, arr(np.array([[2.0, 0.3], [0.3, 1.0]]))),
        "constant": M.Constant(arr(np.array(1.5)), 4, 4),
        "woodbury": M.Woodbury(M.Diagonal(arr(d)), M.LowRank(arr(U))),
        "zero": M.Zero(arr(d).dtype, 4, 4),
    }


@pytest.mark.parametrize("case", ["dense", "diagonal", "lowrank", "constant", "woodbury", "zero"])
def test_sample_moments(case):
    # 40,000 draws: the sample covariance within 0.06 of the JAX package's
    # dense covariance (a few standard errors at these entries).
    var = _covariances(st, _t)[case]
    want = np_(sj.dense(_covariances(sj, jnp.asarray)[case]))
    s = st.sample(torch.Generator().manual_seed(0), var, 40_000)
    assert s.shape == (4, 40_000) and s.dtype == torch.float64
    np.testing.assert_allclose(np_(s.mean(dim=1)), 0.0, atol=0.04)
    np.testing.assert_allclose(np_(s @ s.T / s.shape[1]), want, atol=0.06)


def test_dense_sample_is_the_jax_factor_times_the_same_normals():
    A = spd(5, seed=12)
    eps = torch.randn((5, 2), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    got = st.sample(torch.Generator().manual_seed(3), st.Dense(_t(A)), 2)
    L = np_(sj.dense(sj.cholesky(sj.Dense(jnp.asarray(A)))))
    np.testing.assert_allclose(np_(got), L @ np_(eps), rtol=1e-12)
