"""Parity of the port's ``Normal`` with ``stheno_tpu.dist.normal``: the
second moment, ``diagonalise``, ``entropy``, ``kl``, ``w2``, ``cast``, the
affine arithmetic with ``lmatmul``/``rmatmul``, ``mean_is_zero`` and the
rendering, and the structured masked ``logpdf`` (Woodbury, LowRank as a
jittered Woodbury, Kronecker under a mask of each axis), in float64 on
the same numpy inputs (mirroring ``tests/test_normal.py``). The masked and
the plain ``logpdf`` of a Woodbury variance at N=50,000, value and
gradient, are held to never creating a tensor larger than 64 N elements
(:class:`tests.test_torch_helpers.LargestTensor`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal

import stheno_tpu as sj
import stheno_torch as st
from tests.test_torch_helpers import LargestTensor, np_, spd, torch_cpu  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _both(build):
    """``build(M, arr)`` run with each package's module and array maker."""
    return build(st, _t), build(sj, jnp.asarray)


def _case(n, seed):
    r = np.random.RandomState(seed)
    return r.randn(n, 1), spd(n, seed + 1)


def _dists(M, arr, n=5):
    (m1, v1), (m2, v2) = _case(n, 0), _case(n, 3)
    return M.Normal(arr(m1), M.Dense(arr(v1))), M.Normal(arr(m2), M.Dense(arr(v2)))


# --- entropy, kl, w2, m2, diagonalise, cast -----------------------------------


@pytest.mark.parametrize("what", ["entropy", "kl", "w2", "m2", "diagonalise"])
def test_moments_and_divergences_match_jax(what):
    def build(M, arr):
        d1, d2 = _dists(M, arr)
        if what == "entropy":
            return d1.entropy()
        if what == "kl":
            return d1.kl(d2)
        if what == "w2":
            return d1.w2(d2)
        if what == "m2":
            return M.dense(d1.m2)
        d = d1.diagonalise()
        return M.dense(d.var), d.mean

    got, want = _both(build)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-10, atol=1e-12)


def test_entropy_kl_against_closed_forms():
    (m1, v1), (m2, v2) = _case(4, 0), _case(4, 3)
    d1 = st.Normal(_t(m1), st.Dense(_t(v1)))
    d2 = st.Normal(_t(m2), st.Dense(_t(v2)))
    ent = 0.5 * (np.linalg.slogdet(v1)[1] + 4 * (np.log(2 * np.pi) + 1))
    np.testing.assert_allclose(float(d1.entropy()), ent, rtol=1e-10)
    dm = m2 - m1
    kl = 0.5 * (np.trace(np.linalg.solve(v2, v1)) + float((dm.T @ np.linalg.solve(v2, dm))[0, 0])
                - 4 + np.linalg.slogdet(v2)[1] - np.linalg.slogdet(v1)[1])
    np.testing.assert_allclose(float(d1.kl(d2)), kl, rtol=1e-10)
    np.testing.assert_allclose(float(d1.kl(d1)), 0.0, atol=1e-10)
    np.testing.assert_allclose(float(d1.w2(d1)), 0.0, atol=1e-6)


def test_structured_entropy_kl_match_jax():
    # Woodbury and Diagonal variances take their closed forms in both.
    r = np.random.RandomState(2)
    n = 7

    def build(M, arr):
        wb = M.Woodbury(M.Diagonal(arr(r.rand(n) + 0.5)), M.LowRank(arr(r.randn(n, 2))))
        dg = M.Diagonal(arr(r.rand(n) + 0.5))
        a, b = M.Normal(arr(r.randn(n, 1)), wb), M.Normal(dg)
        return a.entropy(), a.kl(b), b.kl(a)

    r = np.random.RandomState(2)
    got = build(st, _t)
    r = np.random.RandomState(2)
    want = build(sj, jnp.asarray)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-10)


def test_cast():
    m, v = _case(3, 5)
    d = st.Normal(_t(m), st.Woodbury(st.Diagonal(_t(np.ones(3))), st.LowRank(_t(v[:, :1]))))
    c = d.cast(torch.float32)
    assert c.mean.dtype == torch.float32 and c.var.dtype == torch.float32
    assert isinstance(c.var, st.Woodbury) and c.var.lr.left.dtype == torch.float32
    np.testing.assert_allclose(np_(st.dense(c.var)), np_(st.dense(d.var)), rtol=1e-6)
    z = st.Normal(st.Zero(torch.float64, 3, 3, device="cpu")).cast(torch.float32)
    assert z.var.dtype == torch.float32


# --- affine arithmetic --------------------------------------------------------


def test_affine_matches_jax():
    a = np.random.RandomState(5).randn(2, 4)

    def build(M, arr):
        d, e = _dists(M, arr, n=4)
        outs = [d + 2.0, 2.0 + d, d * 3.0, 3.0 * d, d - d * 0.5, d + e, -d, d / 2, d - 1.0,
                d + arr(np.arange(4.0)), d.lmatmul(arr(a)), d.rmatmul(arr(a.T))]
        return [(o.mean, M.dense(o.var)) for o in outs]

    for (gm, gv), (wm, wv) in zip(*_both(build)):
        np.testing.assert_allclose(np_(gm), np.asarray(wm), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np_(gv), np.asarray(wv), rtol=1e-10, atol=1e-12)


def test_affine_errors_and_zero_mean():
    d, _ = _dists(st, _t)
    with pytest.raises(NotImplementedError):
        d * d
    with pytest.raises(NotImplementedError):
        d * _t(np.ones((5, 5)))
    with pytest.raises(NotImplementedError):
        d + st.GP(st.EQ())
    z = st.Normal(st.Diagonal(_t([1.0, 2.0, 3.0])))
    assert z.mean_is_zero and not d.mean_is_zero
    np.testing.assert_allclose(np_(z.mean), np.zeros((3, 1)))
    ref = multivariate_normal.logpdf(np.zeros(3), np.zeros(3), np.diag([1, 2, 3.0]))
    np.testing.assert_allclose(float(z.logpdf(_t(np.zeros(3)))), ref, rtol=1e-10)


def test_rendering_indented_kv():
    d = st.Normal(_t(np.zeros((2, 1))), _t(np.eye(2)))
    s = str(d)
    assert s.startswith("<Normal:\n")
    assert "    mean=" in s and "    var=" in s and s.endswith(">")
    calls = []
    lazy = st.Normal(lambda: calls.append("m") or _t(np.zeros((2, 1))),
                     lambda: calls.append("v") or _t(np.eye(2)))
    s = str(lazy)
    assert "mean=unresolved" in s and "var=unresolved" in s and calls == []
    assert repr(lazy).startswith("<Normal:\n") and calls == []
    fdd = st.GP(st.EQ())(_t(np.linspace(0, 1, 3)), 0.1)
    s = str(fdd)
    assert s.startswith("<FDD:\n")
    assert "    process=" in s and "    input=" in s and "    noise=" in s
    assert repr(fdd).startswith("<FDD:\n")
    from stheno_torch.dist.normal import _indented_kv

    assert _indented_kv("k", "a\nb", suffix=",") == "    k=a\n      b,"


# --- the structured masked logpdf ---------------------------------------------


def test_masked_logpdf_woodbury_matches_scipy_and_jax():
    r = np.random.RandomState(11)
    n, rank = 60, 3
    left = r.randn(n, rank)
    mid = r.randn(rank, rank)
    mid = mid @ mid.T + rank * np.eye(rank)
    d = r.rand(n) + 0.5
    mean = r.randn(n, 1)
    mask = r.rand(n) > 0.3
    x = r.randn(n, 1)

    def build(M, arr):
        var = M.Woodbury(M.Diagonal(arr(d)), M.LowRank(arr(left), middle=arr(mid)))
        return M.Normal(arr(mean), var).logpdf(arr(x), mask=arr(mask)), var

    (got, var), (want, _) = _both(build)
    keep = np.flatnonzero(mask)
    ref = multivariate_normal.logpdf(x[keep, 0], mean[keep, 0],
                                     np_(st.dense(var))[np.ix_(keep, keep)])
    np.testing.assert_allclose(float(got), ref, rtol=1e-8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


def test_masked_logpdf_woodbury_gradient_matches_jax():
    r = np.random.RandomState(12)
    n = 40
    left, d, x = r.randn(n, 2), r.rand(n) + 0.5, r.randn(n, 1)
    mask = r.rand(n) > 0.25

    def lp(M, left, d, x, mask):
        return M.Normal(M.Woodbury(M.Diagonal(d), M.LowRank(left))).logpdf(x, mask=mask)

    gj = jax.grad(lambda a, b: lp(sj, a, b, jnp.asarray(x), jnp.asarray(mask)), argnums=(0, 1))(
        jnp.asarray(left), jnp.asarray(d))
    tl, td = _t(left).requires_grad_(True), _t(d).requires_grad_(True)
    lp(st, tl, td, _t(x), _t(mask)).backward()
    np.testing.assert_allclose(np_(tl.grad), np.asarray(gj[0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(td.grad), np.asarray(gj[1]), rtol=1e-9, atol=1e-12)


def test_masked_logpdf_lowrank_matches_jax_and_dense():
    r = np.random.RandomState(5)
    n, rank = 40, 6
    left = r.randn(n, rank)
    mid = r.randn(rank, rank)
    middle = mid @ mid.T + np.eye(rank)
    mean = r.randn(n, 1)
    mask = r.rand(n) < 0.1  # fewer observed rows than the rank
    x = r.randn(n, 1)

    def build(M, arr):
        var = M.LowRank(arr(left), middle=arr(middle))
        got = M.Normal(arr(mean), var).logpdf(arr(x), mask=arr(mask))
        dense = M.Normal(arr(mean), M.Dense(M.dense(var))).logpdf(arr(x), mask=arr(mask))
        return got, dense, var

    (got, dense, var), (want, _, _) = _both(build)
    assert isinstance(var, st.LowRank)
    # The same regularised matrix as the dense path's: agreement is limited
    # by the 1/eps cancellation of the lemma (as in the JAX package's test).
    # The JAX package's value is limited alike.
    np.testing.assert_allclose(float(got), float(dense), rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(float(got), float(want), rtol=5e-4, atol=5e-3)


@pytest.mark.parametrize("nonsym", [False, True])
def test_masked_logpdf_kron_factorised_mask(nonsym):
    # A != B and non-square-count masks: a transposed vec convention would
    # fail here.
    r = np.random.RandomState(6)
    na, nb = 5, 7
    a, b = r.randn(na, na), r.randn(nb, nb)
    A, B = a @ a.T + na * np.eye(na), b @ b.T + nb * np.eye(nb)
    if nonsym:
        A, B = B[:na, :na] + np.diag(np.arange(na)), A[:, :] + 0.5 * np.eye(na)
        nb = na
    n = na * nb
    mean, x = r.randn(n, 1), r.randn(n, 1)
    ma = np.asarray([True, False, True, True, False])
    mb = np.asarray([True, True, False, True, True, False, True])[:nb]
    m = np.kron(ma, mb)

    def build(M, arr):
        var = M.Kronecker(M.Dense(arr(A)), M.Dense(arr(B)))
        dist = M.Normal(arr(mean), var)
        got = dist.logpdf(arr(x), mask=(arr(ma), arr(mb)))
        dense = M.Normal(arr(mean), M.Dense(M.dense(var))).logpdf(arr(x), mask=arr(m))
        arb = dist.logpdf(arr(x), mask=arr(r2.rand(n) < 0.7))
        return got, dense, arb

    r2 = np.random.RandomState(1)
    got, dense, arb = build(st, _t)
    r2 = np.random.RandomState(1)
    want, _, arb_j = build(sj, jnp.asarray)
    obs = np.flatnonzero(m)
    ref = multivariate_normal.logpdf(x[obs, 0], mean[obs, 0], np.kron(A, B)[np.ix_(obs, obs)])
    np.testing.assert_allclose(float(got), ref, rtol=1e-9)
    np.testing.assert_allclose(float(got), float(dense), rtol=1e-9)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    np.testing.assert_allclose(float(arb), float(arb_j), rtol=1e-10)


def test_masked_logpdf_kron_gradient_matches_jax():
    r = np.random.RandomState(8)
    na, nb = 4, 6
    a, b = r.randn(na, na), r.randn(nb, nb)
    A, B = a @ a.T + na * np.eye(na), b @ b.T + nb * np.eye(nb)
    x = r.randn(na * nb, 1)
    ma, mb = np.asarray([1, 0, 1, 1], bool), np.asarray([1, 1, 0, 1, 1, 1], bool)

    def lp(M, A, B):
        return M.Normal(M.Kronecker(M.Dense(A), M.Dense(B))).logpdf(x, mask=(ma, mb))

    gj = jax.grad(lambda A, B: lp(sj, A, B), argnums=(0, 1))(jnp.asarray(A), jnp.asarray(B))
    tA, tB = _t(A).requires_grad_(True), _t(B).requires_grad_(True)
    lp(st, tA, tB).backward()
    np.testing.assert_allclose(np_(tA.grad), np.asarray(gj[0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(tB.grad), np.asarray(gj[1]), rtol=1e-9, atol=1e-12)


# --- never densifies -----------------------------------------------------------

N_BIG = 50_000


@pytest.mark.parametrize("masked", [False, True])
def test_woodbury_logpdf_50k_never_densifies(masked):
    # A BLR-shaped variance (a rank-3 Gram plus noise): value and gradient
    # create nothing larger than 64 N elements.
    r = np.random.RandomState(7)
    left = _t(r.randn(N_BIG, 3)).requires_grad_(True)
    noise = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    x = _t(r.randn(N_BIG, 1))
    mask = _t(r.rand(N_BIG) < 0.9) if masked else None
    with LargestTensor() as big:
        var = st.Woodbury(st.Diagonal(noise * torch.ones(N_BIG, dtype=torch.float64)),
                          st.LowRank(left))
        val = st.Normal(var).logpdf(x, mask=mask)
        val.backward()
    assert big.numel <= 64 * N_BIG, (big.numel, big.op)
    assert np.isfinite(float(val.detach())) and np.isfinite(float(noise.grad))
    # The same value as the JAX package's.
    want = sj.Normal(sj.Woodbury(sj.Diagonal(jnp.full((N_BIG,), 0.1)),
                                 sj.LowRank(jnp.asarray(np_(left))))).logpdf(
        jnp.asarray(np_(x)), mask=None if mask is None else jnp.asarray(np_(mask)))
    np.testing.assert_allclose(float(val.detach()), float(want), rtol=1e-10)


def test_lowrank_masked_logpdf_50k_never_densifies():
    r = np.random.RandomState(9)
    left = _t(r.randn(N_BIG, 4))
    x = _t(left.numpy() @ r.randn(4, 1))
    with LargestTensor() as big:
        val = st.Normal(st.LowRank(left)).logpdf(x, mask=_t(r.rand(N_BIG) < 0.5))
    assert big.numel <= 64 * N_BIG, (big.numel, big.op)
    assert np.isfinite(float(val))
