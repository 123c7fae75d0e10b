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


# --- Woodbury closed forms --------------------------------------------------------


def _woodbury(M, arr, sym=True, seed=20, n=12, k=3):
    r = np.random.RandomState(seed)
    d, left, right = r.rand(n) + 1.0, r.randn(n, k), r.randn(n, k)
    mid = r.randn(k, k) + 3 * np.eye(k)
    if sym:
        return M.Woodbury(M.Diagonal(arr(d)), M.LowRank(arr(left), None, arr(mid @ mid.T)))
    return M.Woodbury(M.Diagonal(arr(d)), M.LowRank(arr(left), arr(right), arr(mid)))


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("op", ["solve", "iqf", "iqf_diag", "logdet", "ratio"])
def test_woodbury_closed_forms_match_jax_and_dense(sym, op):
    # The Woodbury identity and the determinant lemma, for a symmetric and
    # a non-symmetric low-rank part (the capacitance pairs R^T D^{-1} with L).
    b = np.random.RandomState(21).randn(12, 2)

    def run(M, arr):
        a = _woodbury(M, arr, sym)
        return {"solve": lambda: M.solve(a, arr(b)),
                "iqf": lambda: M.dense(M.iqf(a, arr(b))),
                "iqf_diag": lambda: M.iqf_diag(a, arr(b)),
                "logdet": lambda: M.logdet(a),
                "ratio": lambda: M.ratio(M.Dense(arr(spd(12, 3))), a)}[op]()

    got, want = run(st, _t), run(sj, jnp.asarray)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-10, atol=1e-12)
    W = np_(st.dense(_woodbury(st, _t, sym)))
    ref = {"solve": lambda: np.linalg.solve(W, b), "iqf": lambda: b.T @ np.linalg.solve(W, b),
           "iqf_diag": lambda: np.diag(b.T @ np.linalg.solve(W, b)),
           "logdet": lambda: np.linalg.slogdet(W)[1],
           "ratio": lambda: np.trace(np.linalg.solve(W, spd(12, 3)))}[op]()
    np.testing.assert_allclose(np_(got), ref, rtol=1e-9)


def test_woodbury_logpdf_gradients_match_jax():
    # Autograd through the closed forms against jax.grad through the JAX
    # package's plain jnp.
    r = np.random.RandomState(22)
    n = 30
    d, left, b = r.rand(n) + 0.5, r.randn(n, 2), r.randn(n, 1)

    def f(M, d, left, b):
        a = M.Woodbury(M.Diagonal(d), M.LowRank(left))
        return M.logdet(a) + M.iqf_diag(a, b)[0] + M.dense(M.iqf(a, b))[0, 0]

    gj = jax.grad(lambda *a: f(sj, *a), argnums=(0, 1, 2))(*(jnp.asarray(v) for v in (d, left, b)))
    ts = [_t(v).requires_grad_(True) for v in (d, left, b)]
    f(st, *ts).backward()
    for t, g in zip(ts, gj):
        np.testing.assert_allclose(np_(t.grad), np.asarray(g), rtol=1e-9, atol=1e-12)


def test_woodbury_logdet_of_indefinite_core_is_nan():
    # det(I + M R^T D^{-1} L) <= 0: no real log-determinant, NaN on the
    # device rather than the log of |det|.
    a = st.Woodbury(st.Diagonal(_t(np.ones(3))), st.LowRank(_t(np.ones((3, 1))), None,
                                                          _t(np.array([[-1.0]]))))
    assert bool(torch.isnan(st.logdet(a)))


def test_woodbury_core_cache_only_without_a_graph():
    a = _woodbury(st, _t)
    st.solve(a, _t(np.ones((12, 1))))
    assert ("wb_core", True) in a._cache
    b = _t(np.random.RandomState(25).randn(12, 1))
    grads = []
    for passes in (1, 2):
        d = _t(np.arange(12.0) + 1.0).requires_grad_(True)
        g = st.Woodbury(st.Diagonal(d), st.LowRank(_t(np.ones((12, 2)))))
        for _ in range(passes):  # each pass builds and frees its own graph
            st.iqf_diag(g, b)[0].backward()
        assert ("wb_core", True) not in g._cache
        grads.append(np_(d.grad))
    np.testing.assert_allclose(grads[1], 2 * grads[0], rtol=1e-12)


def test_woodbury_core_cached_without_grad_keeps_the_gradient():
    # A core made under no_grad holds no graph; a later differentiated call
    # on the same matrix must not take it, or the correction term's gradient
    # in the diagonal and the middle is lost. The factors are constant, as
    # in Bayesian linear regression, so nothing in the core requires grad.
    r = np.random.RandomState(26)
    b, left = _t(r.randn(12, 1)), _t(r.randn(12, 2))
    arrays = [np.arange(12.0) + 1.0, spd(2, 27)]

    def grads(warm):
        leaves = [_t(v).requires_grad_(True) for v in arrays]
        w = st.Woodbury(st.Diagonal(leaves[0]), st.LowRank(left, None, leaves[1]))
        if warm:
            with torch.no_grad():
                st.solve(w, b)
            assert w._cache  # the core made without a graph is kept
        st.iqf_diag(w, b)[0].backward()
        return [np_(t.grad) for t in leaves]

    for got, want in zip(grads(True), grads(False)):
        assert np.any(want != 0)
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_woodbury_contractions_run_in_chunks(monkeypatch):
    # The N-long products of the capacitance and the right-hand side go
    # through _contract: in chunks, the same float64 values.
    monkeypatch.setattr(tops, "_CHUNK", 16)
    a = _woodbury(st, _t, n=100)
    b = np.random.RandomState(23).randn(100, 1)
    want = sj.logdet(_woodbury(sj, jnp.asarray, n=100)) + sj.iqf_diag(
        _woodbury(sj, jnp.asarray, n=100), jnp.asarray(b))[0]
    np.testing.assert_allclose(float(st.logdet(a) + st.iqf_diag(a, _t(b))[0]), float(want),
                               rtol=1e-12)


def test_batched_lowrank_sum():
    r = np.random.RandomState(24)
    l1, l2 = r.randn(2, 5, 2), r.randn(5, 3)
    m1 = np.stack([spd(2, 1), spd(2, 2)])

    def run(M, arr):
        return M.dense(M.add(M.LowRank(arr(l1), None, arr(m1)), M.LowRank(arr(l2), None,
                                                                        arr(spd(3, 4)))))

    got = np_(run(st, _t))
    np.testing.assert_allclose(got, np.asarray(run(sj, jnp.asarray)), rtol=1e-12)
    ref = l1 @ m1 @ np.swapaxes(l1, -1, -2) + l2 @ spd(3, 4) @ l2.T
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_submatrix_keeps_lowrank_and_woodbury():
    mask = np.array([True, False, True, True, False, True, True, True, False, True, True, True])
    for sym in (True, False):
        a = _woodbury(st, _t, sym)
        for m in (a, a.lr):
            s = st.submatrix(m, mask)
            assert type(s) is type(m)
            np.testing.assert_allclose(np_(st.dense(s)), np_(st.dense(m))[np.ix_(mask, mask)])


# --- Kronecker ----------------------------------------------------------------------


def _kron_factors(seed=50, na=3, nb=4):
    r = np.random.RandomState(seed)
    A, B = r.randn(na, na), r.randn(nb, nb)
    return A @ A.T + na * np.eye(na), B @ B.T + nb * np.eye(nb)


@pytest.mark.parametrize("op", ["solve", "logdet", "iqf", "iqf_diag", "cholesky", "dense",
                                "transpose", "scale", "matmul"])
def test_kronecker_ops_match_jax_and_dense(op):
    # A != B and rows(A) != rows(B): a column-major vec trick would fail.
    A, B = _kron_factors()
    C, D = _kron_factors(seed=51)
    b = np.random.RandomState(52).randn(12, 2)

    def run(M, arr):
        K = M.Kronecker(M.Dense(arr(A)), M.Dense(arr(B)))
        return {"solve": lambda: M.solve(K, arr(b)), "logdet": lambda: M.logdet(K),
                "iqf": lambda: M.dense(M.iqf(K, arr(b))), "iqf_diag": lambda: M.iqf_diag(K, arr(b)),
                "cholesky": lambda: M.dense(M.cholesky(K)), "dense": lambda: M.dense(K),
                "transpose": lambda: M.dense(M.transpose(M.Kronecker(M.Dense(arr(A[:, :2])),
                                                                     M.Dense(arr(B))))),
                "scale": lambda: M.dense(M.scale(K, 2.5)),
                "matmul": lambda: M.dense(M.matmul(K, M.Kronecker(M.Dense(arr(C)),
                                                                  M.Dense(arr(D)))))}[op]()

    got, want = run(st, _t), run(sj, jnp.asarray)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-10, atol=1e-12)
    K = np.kron(A, B)
    ref = {"solve": lambda: np.linalg.solve(K, b), "logdet": lambda: np.linalg.slogdet(K)[1],
           "iqf": lambda: b.T @ np.linalg.solve(K, b),
           "iqf_diag": lambda: np.diag(b.T @ np.linalg.solve(K, b)),
           "cholesky": lambda: np.linalg.cholesky(K), "dense": lambda: K,
           "transpose": lambda: np.kron(A[:, :2], B).T, "scale": lambda: 2.5 * K,
           "matmul": lambda: K @ np.kron(C, D)}[op]()
    np.testing.assert_allclose(np_(got), ref, rtol=1e-9, atol=1e-12)


def test_kronecker_logpdf_gradient_matches_jax():
    A, B = _kron_factors(seed=53, na=4, nb=3)
    x = np.random.RandomState(54).randn(12, 1)

    def f(M, A, B):
        return M.Normal(M.Kronecker(M.Dense(A), M.Dense(B))).logpdf(x)

    gj = jax.grad(lambda A, B: f(sj, A, B), argnums=(0, 1))(jnp.asarray(A), jnp.asarray(B))
    tA, tB = _t(A).requires_grad_(True), _t(B).requires_grad_(True)
    f(st, tA, tB).backward()
    np.testing.assert_allclose(np_(tA.grad), np.asarray(gj[0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(tB.grad), np.asarray(gj[1]), rtol=1e-9, atol=1e-12)
