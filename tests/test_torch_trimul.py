"""The structure-aware products of ``tests/test_trimul.py`` on the port
(``stheno_torch/ops/trimul.py``): against the dense products through the
odd-size recursion splits and batches, differentiated, and wired into the
carried-inverse Cholesky and the dense logdet's backward, in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_torch.matrix as M
from stheno_tpu.ops import trimul as jtrimul
from stheno_torch import config
from stheno_torch.ops.chol import cholesky_with_inv
from stheno_torch.ops.trimul import auto_nb, mul_at, mul_att, mul_ta, syrk_nt, syrk_tn_lower
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401


def _tril(n, seed, batch=()):
    r = np.random.RandomState(seed)
    return torch.tensor(np.tril(r.randn(*batch, n, n)) + 2 * np.eye(n))


@pytest.mark.parametrize("m", [64, 300, 1100])
def test_triangular_products_match_dense(m):
    r = np.random.RandomState(0)
    T = _tril(m, 1)
    A = torch.tensor(r.randn(97, m))
    leaf = 256  # Force the recursion for the larger cases.
    # rtol 1e-8: the recursion sums leaf products in another order than one GEMM.
    kw = dict(rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np_(mul_att(A, T, leaf=leaf)), np_(A @ T.T), **kw)
    np.testing.assert_allclose(np_(mul_at(A, T, leaf=leaf)), np_(A @ T), **kw)
    B = torch.tensor(r.randn(m, 53))
    np.testing.assert_allclose(np_(mul_ta(T, B, leaf=leaf)), np_(T @ B), **kw)


def test_syrk_variants_match_dense():
    r = np.random.RandomState(2)
    A = torch.tensor(r.randn(1100, 300))
    got = np_(syrk_nt(A, leaf=256))
    np.testing.assert_allclose(got, np_(A @ A.T), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, got.T)  # Exactly symmetric by mirror.
    T = _tril(1024, 3)
    got2 = np_(syrk_tn_lower(T, nb=8))
    np.testing.assert_allclose(got2, np_(T.T @ T), rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(got2, got2.T)
    T3 = _tril(300, 4)  # Not divisible by nb: one dense GEMM.
    np.testing.assert_allclose(np_(syrk_tn_lower(T3, nb=8)), np_(T3.T @ T3), rtol=1e-10)
    ref = jtrimul.syrk_tn_lower(jnp.asarray(np_(T)), nb=8)
    np.testing.assert_allclose(got2, np.asarray(ref), rtol=1e-11, atol=1e-9)


def test_batched_and_grad():
    T = _tril(512, 5, batch=(3,))
    A = torch.tensor(np.random.RandomState(6).randn(3, 40, 512))
    got = np_(mul_att(A, T, leaf=128))
    for i in range(3):
        np.testing.assert_allclose(got[i], np_(A[i] @ T[i].T), rtol=1e-10)
    t0 = T[0].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(syrk_tn_lower(t0, nb=2)), t0)
    with torch.no_grad():
        num = (torch.sum(syrk_tn_lower(T[0] + 1e-6, nb=2))
               - torch.sum(syrk_tn_lower(T[0] - 1e-6, nb=2))) / 2e-6
    np.testing.assert_allclose(float(g.sum()), float(num), rtol=1e-4)


def test_auto_nb():
    assert auto_nb(16384) == 16
    assert auto_nb(8192) == 8
    assert auto_nb(2048) == 2
    assert auto_nb(1500) == 1
    assert auto_nb(1024) == 1
    assert all(auto_nb(n) == jtrimul.auto_nb(n) for n in (1024, 1500, 2048, 4096, 8192, 16384))


def test_recursion_matches_dense_factorisation():
    # The JAX test also toggles its structure-aware products off
    # (_TRI_AWARE); the port's recursion has only the structure-aware form.
    r = np.random.RandomState(7)
    n = 1600  # Above the base (1024): one recursion level runs.
    A = r.randn(n, n)
    A = torch.tensor(A @ A.T + n * np.eye(n))
    L, Linv = cholesky_with_inv(A)
    np.testing.assert_allclose(np_(L), np.linalg.cholesky(np_(A)), rtol=1e-7, atol=1e-7)
    assert float((L @ Linv - torch.eye(n, dtype=torch.float64)).abs().max()) < 1e-8


def test_kinv_syrk_wiring_grad_parity():
    # The dense logdet backward (K^{-1} times the cotangent) under both
    # policies: d/ds logdet(s A) = n / s.
    r = np.random.RandomState(8)
    n = 1100
    A0 = r.randn(n, n)
    A0 = torch.tensor(A0 @ A0.T + n * np.eye(n))
    for impl in ("fast", "xla"):
        config.set_cholesky_impl(impl)
        s = torch.ones((), dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(M.logdet(M.Dense(s * A0)), s)
        np.testing.assert_allclose(float(g), n, rtol=1e-8, err_msg=impl)
