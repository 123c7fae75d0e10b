"""The randomised structure-against-dense fuzz of
``tests/matrix/test_fuzz.py`` on the port's matrix algebra
(``stheno_torch/matrix``), with a ``Kronecker`` kind added: every
structured op, and every pair of kinds through ``add``, ``matmul`` (plain
and transposed) and ``multiply``, agrees with the same op on the
densified operands; the SPD-ised kinds agree with dense linear algebra
for ``solve``, ``iqf``, ``iqf_diag``, ``logdet`` and ``cholesky``."""

import itertools
import zlib

import numpy as np
import pytest
import torch

import stheno_torch.matrix as M
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

N = 8


def approx(a, b, rtol=1e-7, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _np(a):
    return np_(M.dense(a)) if M.is_structured(a) else np_(a)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _make(kind, r, n=N):
    if kind == "dense":
        return M.Dense(_t(r.randn(n, n)))
    if kind == "diag":
        return M.Diagonal(_t(r.rand(n) + 0.5))
    if kind == "zero":
        return M.Zero(torch.float64, n, n, device="cpu")
    if kind == "const":
        return M.Constant(_t(r.randn()), n, n)
    if kind == "lowrank":
        return M.LowRank(_t(r.randn(n, 2)))
    if kind == "lowrank_asym":
        return M.LowRank(_t(r.randn(n, 2)), _t(r.randn(n, 2)), _t(r.randn(2, 2)))
    if kind == "woodbury":
        return M.Woodbury(M.Diagonal(_t(r.rand(n) + 0.5)), M.LowRank(_t(r.randn(n, 2))))
    if kind == "woodbury_asym":
        return M.Woodbury(
            M.Diagonal(_t(r.rand(n) + 0.5)),
            M.LowRank(_t(r.randn(n, 2)), _t(r.randn(n, 2)), _t(r.randn(2, 2) + 3 * np.eye(2))),
        )
    if kind == "lower":
        return M.LowerTriangular(_t(np.tril(r.randn(n, n)) + 2 * np.eye(n)))
    if kind == "upper":
        return M.UpperTriangular(_t(np.triu(r.randn(n, n)) + 2 * np.eye(n)))
    if kind == "kron":
        return M.Kronecker(M.Dense(_t(r.randn(2, 2))), M.Dense(_t(r.randn(n // 2, n // 2))))
    raise ValueError(kind)


KINDS = ["dense", "diag", "zero", "const", "lowrank", "lowrank_asym", "woodbury",
         "woodbury_asym", "lower", "upper", "kron"]


@pytest.mark.parametrize("ka,kb", list(itertools.product(KINDS, KINDS)))
def test_fuzz_binary(ka, kb):
    r = np.random.RandomState(zlib.crc32(f"{ka}|{kb}".encode()) % 2**31)
    a, b = _make(ka, r), _make(kb, r)
    da, db = _np(a), _np(b)
    approx(_np(M.add(a, b)), da + db, rtol=1e-9, atol=1e-12)
    approx(_np(M.matmul(a, b)), da @ db, rtol=1e-9, atol=1e-12)
    approx(_np(M.matmul(a, b, tr_a=True, tr_b=True)), da.T @ db.T, rtol=1e-9, atol=1e-12)
    approx(_np(M.multiply(a, b)), da * db, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_fuzz_unary(kind):
    r = np.random.RandomState(zlib.crc32(kind.encode()) % 2**31)
    a = _make(kind, r)
    da = _np(a)
    approx(_np(M.transpose(a)), da.T, rtol=1e-12)
    approx(_np(M.scale(a, -1.7)), -1.7 * da, rtol=1e-12)
    approx(_np(M.diag_of(a)), np.diag(da), rtol=1e-12)
    approx(np_(M.trace(a)), np.trace(da), rtol=1e-10)
    v = _t(r.randn(N))
    approx(_np(M.matmul(a, v)), da @ np_(v), rtol=1e-9, atol=1e-12)
    approx(_np(M.matmul(v, a)), np_(v) @ da, rtol=1e-9, atol=1e-12)


SPD_KINDS = ["dense", "diag", "const", "lowrank", "woodbury", "woodbury_asym", "kron"]


def _spd(kind, r):
    """An SPD matrix of each structure."""
    a = _make(kind, r)
    if kind == "dense":
        m = np_(a.mat)
        return M.Dense(_t(m @ m.T + N * np.eye(N)))
    if kind == "const":
        a = M.add(M.Diagonal(_t(r.rand(N) + 1.0)), _make("const", r))
        return M.add(a, M.Diagonal(torch.zeros(N, dtype=torch.float64)))
    if kind == "lowrank":
        return M.Woodbury(M.Diagonal(_t(r.rand(N) + 1.0)), _make("lowrank", r))
    if kind == "woodbury_asym":
        # A symmetric middle, with left and right stored apart.
        left = _make("lowrank", r).left
        return M.Woodbury(M.Diagonal(_t(r.rand(N) + 1.0)),
                          M.LowRank(left, left.clone(), torch.eye(2, dtype=torch.float64)))
    if kind == "kron":
        f1, f2 = r.randn(2, 2), r.randn(N // 2, N // 2)
        return M.Kronecker(M.Dense(_t(f1 @ f1.T + 2 * np.eye(2))),
                           M.Dense(_t(f2 @ f2.T + N * np.eye(N // 2))))
    return a


@pytest.mark.parametrize("kind", SPD_KINDS)
def test_fuzz_spd(kind):
    r = np.random.RandomState(zlib.crc32(f"spd|{kind}".encode()) % 2**31)
    a = _spd(kind, r)
    da = _np(a)
    assert np.linalg.eigvalsh(da).min() > 0, kind
    b = _t(r.randn(N, 3))
    sol = np.linalg.solve(da, np_(b))
    approx(_np(M.solve(a, b)), sol, rtol=1e-7)
    approx(_np(M.iqf(a, b)), np_(b).T @ sol, rtol=1e-7)
    approx(np_(M.iqf_diag(a, b)), np.diag(np_(b).T @ sol), rtol=1e-7)
    approx(np_(M.logdet(a)), np.linalg.slogdet(da)[1], rtol=1e-8)
    L = _np(M.cholesky(a))
    approx(L @ L.T, da, rtol=1e-7, atol=1e-9)
