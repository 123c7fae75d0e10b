"""The plain references against float64 dense mathematics at small sizes."""

import math

import numpy as np
import pytest
import torch

from gpbench.reference import cg as cgmod
from gpbench.reference import dense, gram, matrix_free

F64 = torch.float64


def _data(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.rand(n, generator=g, dtype=torch.float64)).values * 10
    return x, torch.sin(x) + 0.1 * torch.randn(n, generator=g, dtype=torch.float64)


def _K(x, s2, ell, xs=None):
    xs = x if xs is None else xs
    return s2 * torch.exp(-0.5 * (x[:, None] - xs[None, :]) ** 2 / ell ** 2)


def test_blocked_products_match_the_dense_gram(monkeypatch):
    monkeypatch.setattr(gram, "BLOCK_BYTES", 8 * 50 * 7)  # 7 rows a block
    x, _ = _data(50)
    V = torch.randn(50, 3, dtype=F64)
    s2, ell = 1.7, 0.8
    torch.testing.assert_close(gram.matmul(x, V, s2, ell), _K(x, s2, ell) @ V)
    torch.testing.assert_close(gram.matmul(x, V, s2, ell, 8 * 50 * 3), _K(x, s2, ell) @ V)
    A = torch.randn(50, 3, dtype=F64)
    th = torch.tensor([math.log(s2), math.log(ell)], dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(A * (_K(x, th[0].exp(), th[1].exp()) @ V)), th)
    got = gram.bilinear_grads(x, A, V, s2, ell)
    torch.testing.assert_close(torch.stack(got), g)


def test_cg_and_its_quadrature_are_exact_at_full_steps():
    n = 30
    x, _ = _data(n, 1)
    A = _K(x, 1.0, 1.5) + 0.5 * torch.eye(n, dtype=F64)
    B = torch.randn(n, 4, dtype=F64)
    X, iters, (a, b, s) = cgmod.cg(lambda V: A @ V, B, 1e-13, 200, track=n)
    torch.testing.assert_close(X, torch.linalg.solve(A, B))
    lam, Q = torch.linalg.eigh(A)
    logA = Q @ torch.diag(torch.log(lam)) @ Q.T
    exact = torch.mean(torch.sum(B * (logA @ B), dim=0))
    assert float(cgmod.quadrature_logdet(a, b, s, torch.sum(B * B, dim=0))) == \
        pytest.approx(float(exact), rel=1e-8)


def test_eig_preconditioner_is_exact_in_its_basis():
    n = 40
    x, _ = _data(n, 2)
    K = _K(x, 1.0, 1.0)
    U, lam = cgmod.eig_factors(lambda V: K @ V, torch.randn(n, n, dtype=F64), 1)
    torch.testing.assert_close(U @ torch.diag(lam) @ U.T, K, atol=1e-10, rtol=0)
    half_inv, logdet = cgmod.eig_precond(U, lam, 0.1, n)
    eye = torch.eye(n, dtype=F64)
    P = K + 0.1 * eye
    torch.testing.assert_close(half_inv(half_inv(eye)), torch.linalg.inv(P), atol=1e-8, rtol=1e-8)
    assert float(logdet) == pytest.approx(float(torch.logdet(P)))


def _config(**kw):
    c = {"noise": 0.1, "log_s2": math.log(1.3), "log_ell": math.log(0.9), "cg_tol": 1e-13,
         "max_cg_iters": 500, "slq_steps": 200, "precond_power_iters": 1}
    c.update(kw)
    return c


def test_matrix_free_step_is_the_estimator_in_dense_float64():
    n, p, r = 60, 5, 8
    x, y = _data(n, 3)
    c = _config()
    s2, ell = math.exp(c["log_s2"]), math.exp(c["log_ell"])
    K = _K(x, s2, ell)
    A = K + 0.1 * torch.eye(n, dtype=F64)
    state = matrix_free.precond_state(c, x, s2, ell, torch.randn(n, r, dtype=F64))
    u = torch.randn(n, p, dtype=F64)
    value, (g_s2, g_ell) = matrix_free.step(c, x, y, state, u)
    # The same estimator, densely: P from the same basis, exact solves.
    U, lam = state
    P = 0.1 * torch.eye(n, dtype=F64) + U @ torch.diag(lam) @ U.T
    Pl, Pq = torch.linalg.eigh(P)
    Ph, Phi = Pq @ torch.diag(Pl.sqrt()) @ Pq.T, Pq @ torch.diag(Pl.rsqrt()) @ Pq.T
    At = Phi @ A @ Phi
    al, aq = torch.linalg.eigh(At)
    quad = torch.mean(torch.sum(u * ((aq @ torch.diag(torch.log(al)) @ aq.T) @ u), dim=0))
    alpha = torch.linalg.solve(A, y)
    expect = 0.5 * (torch.logdet(P) + quad + y @ alpha + n * math.log(2 * math.pi))
    assert value == pytest.approx(float(expect), rel=1e-10)
    Ainv = torch.linalg.inv(A)
    D = K * (x[:, None] - x[None, :]) ** 2 / ell ** 2
    for dA, got in ((K, g_s2), (D, g_ell)):
        tr = torch.mean(torch.sum((Ph @ Ainv @ dA @ Phi @ u) * u, dim=0))
        assert got == pytest.approx(float(0.5 * (tr - alpha @ dA @ alpha)), rel=1e-9)


def test_the_input_preconditioner_is_the_plain_build_rounded():
    n, r = 300, 12
    x = torch.sort(torch.rand(n, generator=torch.Generator().manual_seed(1))).values * 10
    c = _config(precond_rank=r)
    U, lam = matrix_free.precond_input(c, x, 77)
    assert U.dtype == lam.dtype == torch.float32 and U.shape == (n, r)
    U2, lam2 = matrix_free.precond_input(c, x, 77)
    assert torch.equal(U, U2) and torch.equal(lam, lam2)
    assert not torch.equal(lam, matrix_free.precond_input(c, x, 78)[1])
    # Orthonormal to float32's rounding; after one sweep the top Ritz values are
    # the Gram's to about 1e-5.
    torch.testing.assert_close(U.double().T @ U.double(), torch.eye(r, dtype=F64), atol=1e-6,
                               rtol=0)
    s2, ell = math.exp(c["log_s2"]), math.exp(c["log_ell"])
    top = torch.linalg.eigvalsh(_K(x.double(), s2, ell))[-3:]
    torch.testing.assert_close(lam.double()[-3:], top, rtol=1e-4, atol=0)


def test_dense_nlml_and_adam():
    n = 50
    x, y = _data(n, 5)
    c = {"noise": 0.1, "jitter": 1e-8, "ell": 1.0, "s2": 1.0, "rate": 1e-2,
         "adam_betas": [0.9, 0.999], "adam_eps": 1e-8}
    th = torch.tensor([0.3, -0.2], dtype=F64)
    cov = np.asarray(_K(x, math.exp(-0.2), math.exp(0.3))) + (0.1 + 1e-8) * np.eye(n)
    sign, logdet = np.linalg.slogdet(cov)
    expect = 0.5 * (y.numpy() @ np.linalg.solve(cov, y.numpy()) + logdet + n * np.log(2 * np.pi))
    assert float(dense.nlml(th, x, y, c)) == pytest.approx(expect, rel=1e-12)
    losses, g1, change = dense.follow_adam(x, y, c, 3)
    # Adam's first steps move each leaf by about the rate against its gradient.
    assert len(losses) == 3 and losses[2] < losses[0]
    for g, d in zip(g1, change):
        assert d == pytest.approx(-3 * c["rate"] * math.copysign(1, g), rel=0.05)
