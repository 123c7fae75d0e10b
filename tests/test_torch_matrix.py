"""Parity of the port's structured-matrix algebra with the JAX package:
the Cholesky-backed reductions (values and gradients through their
closed-form adjoints) and the structural ops, in float64 on numpy
inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu import config as jconfig
from stheno_torch import config as tconfig
from tests.test_torch_helpers import both_impls, np_, spd, torch_cpu  # noqa: F401


@pytest.fixture(params=["auto", "fast"])
def impl(request):
    both_impls(jconfig, request.param)
    yield request.param
    jconfig.set_cholesky_impl("auto")


def _reductions():
    """name -> f(M, A, b, c) over a package ``M`` (all values reduced to a
    weighted sum so the gradient sees a general cotangent)."""
    return {
        "logdet": lambda M, A, b, c, w: M.logdet(M.Dense(A)),
        "iqf_diag_sym": lambda M, A, b, c, w: (M.iqf_diag(M.Dense(A), b) * w[0]).sum(),
        "iqf_diag": lambda M, A, b, c, w: (M.iqf_diag(M.Dense(A), b, c) * w[0]).sum(),
        "iqf_sym": lambda M, A, b, c, w: (M.dense(M.iqf(M.Dense(A), b)) * w).sum(),
        "iqf": lambda M, A, b, c, w: (M.dense(M.iqf(M.Dense(A), b, c)) * w).sum(),
        "solve": lambda M, A, b, c, w: (M.solve(M.Dense(A), b) * c).sum(),
    }


@pytest.mark.parametrize("name", sorted(_reductions()))
def test_reduction_value_and_grads_match_jax(name, impl):
    # float64, rtol 1e-9: the same closed forms on the same factor.
    f = _reductions()[name]
    n = 40
    r = np.random.RandomState(0)
    A, b, c, w = spd(n, seed=1), r.randn(n, 3), r.randn(n, 3), r.randn(3, 3)
    vj, gj = jax.value_and_grad(
        lambda A, b, c: f(sj, A, b, c, jnp.asarray(w)), argnums=(0, 1, 2)
    )(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    ts = [torch.tensor(a, requires_grad=True) for a in (A, b, c)]
    vt = f(st, *ts, torch.tensor(w))
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-9)
    for t, g in zip(ts, gj):
        got = np.zeros_like(np_(g)) if t.grad is None else np_(t.grad)
        np.testing.assert_allclose(got, np_(g), rtol=1e-9, atol=1e-11)


def test_fast_factor_carries_its_inverse(impl):
    L = st.cholesky(st.Dense(torch.tensor(spd(30, seed=2))))
    assert isinstance(L, st.LowerTriangular)
    assert ("inv" in L._cache) == (impl == "fast")


def test_cholesky_cache_is_keyed_on_the_jitter():
    a = st.Dense(torch.tensor(spd(20, seed=3)))
    L1 = st.cholesky(a)
    assert st.cholesky(a) is L1
    tconfig.set_epsilon(1e-1)
    L2 = st.cholesky(a)
    assert L2 is not L1
    assert not torch.allclose(L1.mat, L2.mat)


def _structural():
    """name -> build(M, arr) returning a matrix of package ``M``; ``arr``
    turns a numpy array into the package's array type."""
    r = np.random.RandomState(4)
    D, E = r.randn(6, 6), r.randn(6, 6)
    d, e, lr, lr2 = r.rand(6) + 1, r.rand(6) + 1, r.randn(6, 2), r.randn(6, 3)
    return {
        "dense+diag": lambda M, a: M.add(M.Dense(a(D)), M.Diagonal(a(d))),
        "diag+diag": lambda M, a: M.add(M.Diagonal(a(d)), M.Diagonal(a(e))),
        "const+const": lambda M, a: M.add(M.Constant(a(1.5), 6), M.Constant(a(0.5), 6)),
        "diag+const": lambda M, a: M.add(M.Diagonal(a(d)), M.Constant(a(0.5), 6)),
        "lowrank+lowrank": lambda M, a: M.add(M.LowRank(a(lr)), M.LowRank(a(lr2))),
        "woodbury+diag": lambda M, a: M.add(
            M.add(M.Diagonal(a(d)), M.LowRank(a(lr))), M.Diagonal(a(e))
        ),
        "zero+dense": lambda M, a: M.add(M.Zero(a(D).dtype, 6, 6), M.Dense(a(D))),
        "dense+scalar": lambda M, a: M.add(M.Dense(a(D)), 2.0),
        "scale_dense": lambda M, a: M.scale(M.Dense(a(D)), 3.0),
        "scale_lowrank": lambda M, a: M.scale(M.LowRank(a(lr), a(lr2[:, :2])), -2.0),
        "dense*diag": lambda M, a: M.multiply(M.Dense(a(D)), M.Diagonal(a(d))),
        "const*dense": lambda M, a: M.multiply(M.Constant(a(2.0), 6), M.Dense(a(E))),
        "dense*dense": lambda M, a: M.multiply(M.Dense(a(D)), M.Dense(a(E))),
        "diag@dense": lambda M, a: M.matmul(M.Diagonal(a(d)), M.Dense(a(D))),
        "lowrank@dense": lambda M, a: M.matmul(M.LowRank(a(lr)), M.Dense(a(E))),
        "dense@lowrank": lambda M, a: M.matmul(M.Dense(a(D)), M.LowRank(a(lr))),
        "dense@dense_tr": lambda M, a: M.matmul(M.Dense(a(D)), M.Dense(a(E)), tr_a=True, tr_b=True),
        "woodbury@array": lambda M, a: M.matmul(M.add(M.Diagonal(a(d)), M.LowRank(a(lr))), a(E)),
        "transpose_lowrank": lambda M, a: M.transpose(M.LowRank(a(lr), a(lr2[:, :2]))),
        "diag_of_woodbury": lambda M, a: M.diag(M.add(M.Diagonal(a(d)), M.LowRank(a(lr)))),
        "diag_of_const": lambda M, a: M.diag(M.Constant(a(1.5), 6)),
        "fill_diag": lambda M, a: M.fill_diag(a(0.3), 6),
    }


@pytest.mark.parametrize("name", sorted(_structural()))
def test_structural_op_matches_jax(name):
    build = _structural()[name]
    out_t = build(st, lambda v: torch.tensor(v, dtype=torch.float64))
    out_j = build(sj, lambda v: jnp.asarray(v, jnp.float64))
    assert st.is_structured(out_t) == sj.is_structured(out_j)
    if st.is_structured(out_t):
        assert type(out_t).__name__ == type(out_j).__name__
    dense_t = st.dense(out_t) if st.is_structured(out_t) else out_t
    dense_j = sj.dense(out_j) if sj.is_structured(out_j) else out_j
    np.testing.assert_allclose(np_(dense_t), np_(dense_j), rtol=1e-12, atol=1e-13)


def test_normal_logpdf_drops_nan_rows_like_jax():
    n = 12
    A = spd(n, seed=5)
    r = np.random.RandomState(6)
    mean, y = r.randn(n, 1), r.randn(n)
    y[[2, 7]] = np.nan
    lj = sj.Normal(jnp.asarray(mean), sj.Dense(jnp.asarray(A))).logpdf(jnp.asarray(y))
    lt = st.Normal(torch.tensor(mean), st.Dense(torch.tensor(A))).logpdf(torch.tensor(y))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)


@pytest.mark.parametrize("var", ["dense", "diagonal"])
def test_normal_masked_logpdf_matches_jax(var):
    n = 10
    r = np.random.RandomState(7)
    mask = r.rand(n) > 0.3
    y = r.randn(n)
    if var == "dense":
        A = spd(n, seed=8)
        vj, vt = sj.Dense(jnp.asarray(A)), st.Dense(torch.tensor(A))
    else:
        dg = r.rand(n) + 0.5
        vj, vt = sj.Diagonal(jnp.asarray(dg)), st.Diagonal(torch.tensor(dg))
    lj = sj.Normal(vj).logpdf(jnp.asarray(y), mask=jnp.asarray(mask))
    lt = st.Normal(vt).logpdf(torch.tensor(y), mask=torch.tensor(mask))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)


def test_extension_rules_dispatch_and_clear():
    # The port's registry on its own: a new type enabled by rules, later
    # registrations winning, and clear_rules restoring the built-in chain.
    class ScaledIdentity(st.AbstractMatrix):
        def __init__(self, c, n):
            self.c, self.n, self._cache = torch.tensor(c, dtype=torch.float64), n, {}

        shape = property(lambda self: (self.n, self.n))
        dtype = property(lambda self: self.c.dtype)
        device = property(lambda self: self.c.device)

    def is_si(a, *rest):
        return isinstance(a, ScaledIdentity)

    a = ScaledIdentity(3.0, 5)
    st.register_rule("logdet", is_si, lambda a: a.n * torch.log(a.c))
    st.register_rule("dense", is_si, lambda a: a.c * torch.eye(a.n, dtype=a.dtype))
    try:
        np.testing.assert_allclose(float(st.logdet(a)), 5 * np.log(3.0), rtol=1e-15)
        np.testing.assert_allclose(np_(st.dense(a)), 3 * np.eye(5))
        st.register_rule("logdet", is_si, lambda a: torch.zeros((), dtype=a.dtype))
        assert float(st.logdet(a)) == 0.0
    finally:
        st.clear_rules("logdet")
        st.clear_rules("dense")
    with pytest.raises(TypeError):
        st.dense(a)
