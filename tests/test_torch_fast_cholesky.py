"""The recursive Cholesky stories of ``tests/test_fast_cholesky.py`` on
the port (``stheno_torch/ops/chol.py`` and the Cholesky policy of
``stheno_torch/matrix/ops.py``), in float64 on the CPU: the factor and
the carried inverse against LAPACK, batching and ``torch.func.vmap``,
gradients, the ``"fast"``/``"xla"``/``"auto"`` policies through the
structured layer, and the analytic backwards of the dense reductions
against finite differences and across the policies."""

import types

import numpy as np
import pytest
import torch

import stheno_torch.matrix as M
from stheno_torch import EQ, GP, config
from stheno_torch.kernels import pairwise
from stheno_torch.matrix import ops as mops
from stheno_torch.ops.chol import cholesky_with_inv, fast_cholesky, tri_inv_lower
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401


def _spd(n, seed=0, cond=1e4):
    r = np.random.RandomState(seed)
    q, _ = np.linalg.qr(r.randn(n, n))
    evals = np.logspace(0, -np.log10(cond), n)
    return torch.tensor((q * evals) @ q.T)


def _f64(v):
    return torch.tensor(v, dtype=torch.float64)


def _impl(impl, fn):
    config.set_cholesky_impl(impl)
    try:
        return fn()
    finally:
        config.set_cholesky_impl("auto")


@pytest.mark.parametrize("n", [64, 513, 1200])
def test_fast_cholesky_matches_lapack(n):
    A = _spd(n, seed=n)
    L = np_(fast_cholesky(A))
    assert np.allclose(L, np.tril(L))
    resid = np.max(np.abs(L @ L.T - np_(A)))
    assert resid < 1e-9 * float(A.abs().max()) * n, resid


def test_tri_inv_lower():
    n = 1500
    L = torch.linalg.cholesky(_spd(n, seed=7))
    assert float((tri_inv_lower(L) @ L - torch.eye(n, dtype=torch.float64)).abs().max()) < 1e-8 * n


def test_fast_cholesky_batched_and_vmapped():
    A = torch.stack([_spd(300, seed=i) for i in range(3)])
    L = fast_cholesky(A)
    assert L.shape == A.shape
    for i in range(3):
        assert float((L[i] @ L[i].T - A[i]).abs().max()) < 1e-9
    np.testing.assert_allclose(np_(torch.func.vmap(fast_cholesky)(A)), np_(L), rtol=1e-10)


def test_fast_cholesky_grad():
    """Gradients agree with torch.linalg.cholesky's for a symmetric
    construction of the input."""
    A = _spd(600, seed=3, cond=1e3)

    def grad_of(chol):
        a = A.clone().requires_grad_(True)
        s = (a + a.T) / 2
        (g,) = torch.autograd.grad(torch.sum(torch.log(torch.diagonal(chol(s)))), a)
        return np_(g)

    np.testing.assert_allclose(grad_of(fast_cholesky), grad_of(torch.linalg.cholesky),
                               rtol=1e-6, atol=1e-9)


def test_structured_cholesky_uses_fast_path_consistently():
    A = _spd(1100, seed=9)
    L = M.dense(M.cholesky(M.Dense(A)))
    assert float((L @ L.T - A).abs().max()) < 1e-9


def test_cholesky_impl_policy():
    A = _spd(700, seed=11)
    L_xla = _impl("xla", lambda: np_(M.dense(M.cholesky(M.Dense(A)))))
    L_fast = _impl("fast", lambda: np_(M.dense(M.cholesky(M.Dense(A)))))
    np.testing.assert_allclose(L_fast, L_xla, rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError):
        config.set_cholesky_impl("nope")


def test_fast_policy_solve_via_carried_inverse():
    A = _spd(600, seed=13)
    b = torch.tensor(np.random.RandomState(1).randn(600, 2))

    def run():
        Af = M.Dense(A)
        assert M.cholesky(Af)._cache.get("inv") is not None
        return np_(M.solve(Af, b)), np_(M.dense(M.iqf(M.Dense(A), b)))

    x_fast, iqf_fast = _impl("fast", run)
    x_ref = np.linalg.solve(np_(A) + 1e-12 * np.eye(600), np_(b))
    np.testing.assert_allclose(x_fast, x_ref, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(iqf_fast, np_(b).T @ x_ref, rtol=1e-6, atol=1e-8)


def test_under_autodiff_detection():
    # torch's counterpart of the JAX test's transforms: a tensor that
    # requires grad, with grad mode on, is under autodiff; no_grad,
    # detached tensors and inference mode are not.
    x = torch.ones(4, requires_grad=True)
    assert mops._under_autodiff(x * 2)
    with torch.no_grad():
        assert not mops._under_autodiff(x * 2)
    assert not mops._under_autodiff(torch.ones(4))
    assert not mops._under_autodiff(x.detach())
    with torch.inference_mode():
        assert not mops._under_autodiff(torch.ones(4))


def test_auto_policy_selects_fast_under_grad():
    # The "auto" policy takes the recursion for a CUDA tensor of n >= 1024
    # under autodiff. A stand-in with is_cuda set probes the predicate here.
    def probe(n, grad):
        t = types.SimpleNamespace(is_cuda=True, shape=(n, n), requires_grad=grad)
        return mops._auto_policy_use_fast(t)

    assert probe(1100, True)
    assert not probe(1100, False)
    assert not probe(64, True)
    with torch.no_grad():
        assert not probe(1100, True)
    assert not mops._auto_policy_use_fast(_spd(1100).requires_grad_(True))  # A CPU tensor.


def test_auto_policy_value_grad_consistency():
    A = _spd(1100, seed=17)
    b = torch.tensor(np.random.RandomState(3).randn(1100))

    def nlml(s):
        Af = M.Dense(A * s)
        return 0.5 * (M.logdet(Af) + M.dense(M.iqf(Af, b[:, None])).reshape(()))

    one = torch.ones((), dtype=torch.float64)
    with torch.no_grad():
        v_only = nlml(one)
    s = one.clone().requires_grad_(True)
    v = nlml(s)
    (g,) = torch.autograd.grad(v, s)
    np.testing.assert_allclose(float(v_only), float(v.detach()), rtol=1e-8)
    assert np.isfinite(float(g))


def test_dense_nlml_grad_analytic_vjp_stops_at_the_reduction():
    """The dense reductions' backwards stop the cotangent at the reduction
    (the JAX test holds value+grad to 3.5x the value's flops): under the
    "fast" policy the NLML's autograd graph holds the reductions' own
    backwards and none of the factorisation recursion's products."""
    n = 1100  # Above the recursion base.
    x = torch.linspace(0.0, 10.0, n, dtype=torch.float64)
    y = torch.sin(x)

    def graph():
        p = torch.full((), 0.3, dtype=torch.float64, requires_grad=True)
        f = GP(EQ().stretch(torch.exp(p)))
        v = -f.measure.logpdf(f(x, 0.1), y)
        seen, todo = set(), [v.grad_fn]
        while todo:
            node = todo.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            todo.extend(nxt for nxt, _ in node.next_functions)
        return [type(node).__name__ for node in seen]

    names = _impl("fast", graph)
    assert {"_LogdetCholBackward", "_IqfDiagCholBackward"} <= set(names), names
    # No factorisation, triangular solve or block assembly is differentiated,
    # and the graph is the kernel's few elementwise nodes (one product: the
    # distances' x y^T) around the two reductions.
    assert not any(w in k for k in names for w in ("Cholesky", "Triangular", "Cat")), names
    assert names.count("MmBackward0") <= 1 and len(names) < 40, names


def test_dense_grad_parity_fast_vs_xla_paths():
    n = 300
    x = torch.linspace(0.0, 10.0, n, dtype=torch.float64)
    y = torch.sin(x) + 0.1 * torch.cos(3.0 * x)

    def grad(impl):
        def run():
            p = torch.full((), 0.3, dtype=torch.float64, requires_grad=True)
            f = GP(EQ().stretch(torch.exp(p)))
            return float(torch.autograd.grad(-f.measure.logpdf(f(x, 0.1), y), p)[0])

        return _impl(impl, run)

    g_fast, g_xla = grad("fast"), grad("xla")
    np.testing.assert_allclose(g_fast, g_xla, rtol=1e-8)
    # dNLML/dK = (K^{-1} - alpha alpha^T) / 2, chained through dK/dlog_ell.
    x2 = x[:, None]
    K = np_(M.dense(pairwise(EQ().stretch(np.exp(0.3)), x2))) + 0.1 * np.eye(n)
    Kinv = np.linalg.inv(K)
    alpha = Kinv @ np_(y)
    eps = 1e-6
    dK = (np_(M.dense(pairwise(EQ().stretch(np.exp(0.3 + eps)), x2)))
          - np_(M.dense(pairwise(EQ().stretch(np.exp(0.3 - eps)), x2)))) / (2 * eps)
    np.testing.assert_allclose(g_fast, float(np.sum(0.5 * (Kinv - np.outer(alpha, alpha)) * dK)),
                               rtol=1e-4)


def test_solve_analytic_vjp_parity():
    n = 120
    r = np.random.RandomState(3)
    base = torch.tensor(r.randn(n, n))
    yv = torch.tensor(r.randn(n, 2))
    wts = torch.arange(2 * n, dtype=torch.float64).reshape(n, 2) / n

    def loss(s):
        A = base @ base.T + (n + s) * torch.eye(n, dtype=torch.float64)
        return torch.sum(M.solve(M.Dense(A), yv) * wts)

    def grad(impl):
        def run():
            s = torch.full((), 0.7, dtype=torch.float64, requires_grad=True)
            return float(torch.autograd.grad(loss(s), s)[0])

        return _impl(impl, run)

    g_fast, g_xla = grad("fast"), grad("xla")
    np.testing.assert_allclose(g_fast, g_xla, rtol=1e-9)
    with torch.no_grad():
        fd = (float(loss(_f64(0.7 + 1e-6))) - float(loss(_f64(0.7 - 1e-6)))) / 2e-6
    np.testing.assert_allclose(g_fast, fd, rtol=1e-5)


def test_ratio_analytic_vjp_parity():
    n = 80
    r = np.random.RandomState(9)
    qa, qb = torch.tensor(r.randn(n, n)), torch.tensor(r.randn(n, n))
    eye = torch.eye(n, dtype=torch.float64)

    def loss(s):
        A = qa @ qa.T + 2.0 * eye
        B = qb @ qb.T + (n + s) * eye
        return M.ratio(M.Dense(A * (1.0 + 0.1 * s)), M.Dense(B))

    s = torch.full((), 0.5, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(s), s)
    with torch.no_grad():
        fd = (float(loss(_f64(0.5 + 1e-6))) - float(loss(_f64(0.5 - 1e-6)))) / 2e-6
    np.testing.assert_allclose(float(g), fd, rtol=1e-6)


def test_matrix_cotangents_symmetrised_freeform_entries():
    """Gradients of the dense reductions with respect to free-form matrix
    entries match central differences entry by entry."""
    n = 10
    r = np.random.RandomState(11)
    q = r.randn(n, n)
    A0 = torch.tensor(q @ q.T + n * np.eye(n))
    b, c = torch.tensor(r.randn(n, 2)), torch.tensor(r.randn(n, 2))
    Araw = torch.tensor(r.randn(n, n))
    w = torch.tensor(r.randn(n, 2))
    cases = {
        "solve": lambda A: torch.sum(M.solve(M.Dense(A), b) * w),
        "iqf_bc": lambda A: torch.sum(M.dense(M.iqf(M.Dense(A), b, c))),
        "iqf_diag": lambda A: torch.sum(M.iqf_diag(M.Dense(A), b, c)),
        "logdet": lambda A: M.logdet(M.Dense(A)),
        "ratio": lambda A: M.ratio(M.Dense(Araw), M.Dense(A)),
    }
    for name, f in cases.items():
        a = A0.clone().requires_grad_(True)
        (G,) = torch.autograd.grad(f(a), a)
        eps = 1e-6
        for i, j in [(2, 5), (5, 2), (0, 7), (3, 3)]:
            E = torch.zeros(n, n, dtype=torch.float64)
            E[i, j] = eps
            with torch.no_grad():
                fd = (float(f(A0 + E)) - float(f(A0 - E))) / (2 * eps)
            np.testing.assert_allclose(float(G[i, j]), fd, rtol=2e-4, atol=1e-8,
                                       err_msg=f"{name} d/dA[{i},{j}]")


def test_cholesky_with_inv_batched():
    A = torch.stack([_spd(700, seed=10 + i) for i in range(3)])
    L, Linv = cholesky_with_inv(A)
    assert L.shape == A.shape and Linv.shape == A.shape
    for i in range(3):
        Li, Ii = cholesky_with_inv(A[i])
        np.testing.assert_allclose(np_(L[i]), np_(Li), rtol=1e-12)
        np.testing.assert_allclose(np_(Linv[i]), np_(Ii), rtol=1e-12)
        assert float((L[i] @ Linv[i] - torch.eye(700, dtype=torch.float64)).abs().max()) < 1e-8


def test_batched_fast_policy_carries_inverse_and_grad_parity():
    batch = torch.stack([_spd(600, seed=20 + i) for i in range(2)])
    ys = torch.tensor(np.random.RandomState(5).randn(2, 600))

    def value_grad(impl):
        def run():
            s = torch.ones((), dtype=torch.float64, requires_grad=True)
            A = M.Dense(s * batch)
            v = torch.sum(M.logdet(A) + M.iqf_diag(A, ys[..., None])[..., 0])
            return float(v.detach()), float(torch.autograd.grad(v, s)[0])

        return _impl(impl, run)

    inv = _impl("fast", lambda: M.cholesky(M.Dense(batch))._cache.get("inv"))
    assert inv is not None and inv.shape == batch.shape
    (v_f, g_f), (v_x, g_x) = value_grad("fast"), value_grad("xla")
    assert np.isfinite(v_f)
    np.testing.assert_allclose(v_f, v_x, rtol=1e-9)
    np.testing.assert_allclose(g_f, g_x, rtol=1e-7)
