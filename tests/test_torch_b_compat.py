"""The port's LAB-compatible ``B`` namespace (``stheno_torch/b.py``)
against ``stheno_tpu.B``: the 15 tests of ``tests/test_b_compat.py``, each
running both namespaces on the same numpy inputs in float64 on the CPU,
plus the import shim ``stheno_torch.torch``.

Tolerances: the linear algebra of both packages is float64 LAPACK on the
same matrices, so the values agree to rtol 1e-10; the tests' own bounds
against numpy are kept as the JAX test has them.
"""

import subprocess
import sys
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_torch import B, Dense, Diagonal, EQ, GP, Zero, config
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

JB = sj.B
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol=1e-10, atol=0.0):
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=rtol, atol=atol)


def test_epsilon_is_the_global_jitter():
    try:
        B.epsilon = 1e-6
        assert config.epsilon == 1e-6
        assert B.epsilon == 1e-6
        # The knob reaches the factorisation.
        L = B.cholesky(Dense(torch.eye(3, dtype=torch.float64)))
        np.testing.assert_allclose(np.diag(np_(B.dense(L))), np.sqrt(1 + 1e-6), rtol=1e-9)
    finally:
        B.epsilon = None
    assert config.epsilon is None
    # The default reads as the JAX package's.
    assert B.epsilon == JB.epsilon == 1e-12


def test_linalg_surface():
    r = np.random.RandomState(0)
    A_ = r.randn(5, 5)
    a = A_ @ A_.T + 5 * np.eye(5)
    b_ = r.randn(5, 2)
    A, b = Dense(_t(a)), _t(b_)
    Aj, bj = sj.Dense(jnp.asarray(a)), jnp.asarray(b_)
    dense = np_(B.dense(A))
    _close(B.solve(B.cholesky(A), b),
           np.linalg.solve(np.linalg.cholesky(dense + B.epsilon * np.eye(5)), b_), rtol=1e-6)
    _close(B.solve(B.cholesky(A), b), JB.solve(JB.cholesky(Aj), bj))
    _close(B.logdet(A), np.linalg.slogdet(dense)[1], rtol=1e-6)
    _close(B.logdet(A), JB.logdet(Aj))
    _close(B.dense(B.iqf(A, b)), JB.dense(JB.iqf(Aj, bj)))
    _close(B.iqf_diag(A, b), np.diag(b_.T @ np.linalg.solve(dense, b_)), rtol=1e-5)
    _close(B.ratio(A, A), 5.0, rtol=1e-6)
    _close(B.dense(B.matmul(A, b, tr_a=True)), dense.T @ b_, rtol=1e-6)


def test_structure_surface():
    d = Diagonal(_t([1.0, 2.0]))
    assert isinstance(B.diag(_t([3.0, 4.0])), Diagonal)
    _close(B.diag(d), [1.0, 2.0])
    bd = B.block_diag(d, d)
    assert B.shape_matrix(bd) == JB.shape_matrix(JB.block_diag(*[sj.Diagonal(jnp.asarray([1.0, 2.0]))] * 2)) == (4, 4)
    fd = B.fill_diag(_t(2.5), 3)
    _close(B.dense(fd), 2.5 * np.eye(3))
    z = torch.zeros(2, 2, dtype=torch.float64)
    M = B.block([[B.dense(d), z], [z, B.dense(d)]])
    _close(B.dense(M), np_(B.dense(bd)))


def test_shaping_dtype_rng():
    x = torch.ones(3, dtype=torch.float64)
    assert B.uprank(x).shape == (3, 1) == JB.uprank(jnp.ones(3)).shape
    assert B.rank(x) == 1 and B.is_scalar(1.0 * 0)
    assert B.shape(torch.zeros(2, 3), 1) == 3
    assert B.dtype(x) == x.dtype
    assert B.cast(torch.float32, x).dtype == torch.float32
    state = B.create_random_state(seed=7)
    assert isinstance(state, B.RandomState) and isinstance(state, torch.Generator)
    before = state.get_state().clone()
    state2, draws = B.sample(state, Diagonal(torch.ones(4, dtype=torch.float64)), 3)
    assert draws.shape == (4, 3)
    # The state is the generator, advanced by the draw.
    assert state2 is state and not torch.equal(state2.get_state(), before)
    state3, z = B.randn(state2, torch.float64, 2, 2)
    assert z.shape == (2, 2) and z.dtype == torch.float64
    # Seeded states repeat.
    _, z1 = B.randn(B.create_random_state(seed=3), torch.float64, 4)
    _, z2 = B.randn(B.create_random_state(seed=3), torch.float64, 4)
    assert torch.equal(z1, z2)


def test_epsilon_change_invalidates_cached_factor():
    A = Dense(torch.eye(3, dtype=torch.float64))
    try:
        B.epsilon = None
        B.cholesky(A)
        B.epsilon = 1e-2
        L2 = B.cholesky(A)
        np.testing.assert_allclose(np.diag(np_(B.dense(L2))), np.sqrt(1.01), rtol=1e-9)
    finally:
        B.epsilon = None


def test_matmul_three_arg_form():
    r = np.random.RandomState(0)
    a, v = r.randn(3, 4), r.randn(4, 4)
    for f in (B.matmul, B.mm):
        _close(B.dense(f(_t(a), _t(v), _t(a), tr_c=True)), a @ v @ a.T)
    _close(B.dense(B.matmul(_t(a), _t(v), _t(a), tr_c=True)),
           JB.dense(JB.matmul(jnp.asarray(a), jnp.asarray(v), jnp.asarray(a), tr_c=True)))


def test_scalar_and_rank_semantics_for_structured():
    d = Diagonal(torch.ones(3, dtype=torch.float64))
    assert not B.is_scalar(d)
    assert B.rank(d) == 2
    assert B.is_scalar(torch.tensor(0.1))
    assert B.rank(torch.ones(3)) == 1


def test_zero_one_accept_tensor_references():
    assert B.zero(torch.ones(3, dtype=torch.float32)).dtype == torch.float32
    assert float(B.one(torch.ones(2))) == 1.0
    assert B.zero(torch.float64).dtype == torch.float64


def test_dtype_promotes_across_args():
    a32 = torch.ones(2, dtype=torch.float32)
    a64 = torch.ones(2, dtype=torch.float64)
    assert B.dtype(a32, a64) == torch.float64
    assert B.dtype(a32) == torch.float32
    assert B.dtype(1.0) == torch.float64
    assert B.dtype_float(torch.ones(2, dtype=torch.int64)) == torch.float64


def test_cast_zero_matrix():
    z = Zero(torch.float64, 2, 2)
    assert B.cast(torch.float32, z).dtype == torch.float32


def test_eye_matches_reference_tensor():
    assert B.eye(torch.ones(2, 3)).shape == (2, 3)
    assert B.eye(torch.ones(4, 2, 2)).shape == (4, 2, 2)
    _close(B.eye(torch.ones(3, 3)), np.eye(3))


def test_multiply_keeps_structure():
    d = Diagonal(_t([1.0, 2.0]))
    out = B.multiply(d, 3.0)
    assert isinstance(out, Diagonal)
    _close(out.diag, [3.0, 6.0])


def test_drives_the_model_dsl_like_the_reference_readme():
    # The reference README's pattern through B.*: build a GP, sample with a
    # functional random state, condition, inspect marginals.
    f = GP(EQ())
    x = B.linspace(torch.float64, 0, 5, 30)
    state = B.create_random_state(torch.float64, seed=0)
    state, y = f.measure.sample(state, f(x, 0.1))
    assert isinstance(state, torch.Generator)
    post = f | (f(x, 0.1), y[:, 0])
    mean, var = post(x).marginals()
    assert B.shape(mean, 0) == 30
    assert bool(B.all(var > 0))
    # The same data through the JAX package's B: the same posterior.
    fj = sj.GP(sj.EQ())
    xj = JB.linspace(jnp.float64, 0, 5, 30)
    postj = fj | (fj(xj, 0.1), jnp.asarray(np_(y[:, 0])))
    mj, vj = postj(xj).marginals()
    _close(mean, mj, rtol=1e-8, atol=1e-12)
    _close(var, vj, rtol=1e-8, atol=1e-12)


def test_distance_ops():
    rs = np.random.RandomState(0)
    x, y = rs.randn(5, 2), rs.randn(4, 2)
    d2 = np.sum((x[:, None, :] - y[None, :, :]) ** 2, axis=-1)
    _close(B.pw_dists2(x, y), d2, atol=1e-10)
    _close(B.pw_dists(x, y), np.sqrt(d2), atol=1e-10)
    s2 = np.sum((x[:, None, :] + y[None, :, :]) ** 2, axis=-1)
    _close(B.pw_sums2(x, y), s2, atol=1e-10)
    xe, ye = rs.randn(5, 2), rs.randn(5, 2)
    _close(B.ew_dists2(xe, ye), np.sum((xe - ye) ** 2, axis=-1, keepdims=True), atol=1e-12)
    _close(B.ew_sums(xe, ye), np.linalg.norm(xe + ye, axis=-1, keepdims=True), atol=1e-10)
    for name in ("pw_dists2", "pw_dists", "pw_sums2", "pw_sums"):
        _close(getattr(B, name)(x, y), getattr(JB, name)(x, y), rtol=1e-10, atol=1e-12)
    assert B.pw_dists2(np.arange(3.0)).shape == (3, 3)


def test_torch_fallback():
    # Any op not shimmed falls back to torch, with numbers, numpy arrays
    # and numpy's keywords accepted.
    np.testing.assert_allclose(float(B.sin(0.0)), 0.0)
    _close(B.abs(torch.tensor([-1.0, 2.0])), [1.0, 2.0])
    assert B.where.__wrapped__ is torch.where
    _close(B.where(torch.tensor([True, False]), _t([1.0, 2.0]), _t([3.0, 4.0])), [1.0, 4.0])
    a = np.arange(6.0).reshape(2, 3)
    _close(B.mean(a, axis=0), np.mean(a, axis=0))
    _close(B.sum(a, axis=1), JB.sum(jnp.asarray(a), axis=1))
    _close(B.concat(_t([1.0]), _t([2.0]), axis=0), [1.0, 2.0])
    assert bool(B.all(_t([1.0, 2.0]) > 0))
    with pytest.raises(AttributeError):
        B.definitely_not_an_op


def test_b_is_a_module_and_the_package_exports_match():
    import stheno_torch.B as module_b

    assert module_b is B
    assert issubclass(st.BreakingChangeWarning, UserWarning)
    # Every public name of the JAX package that the port has, it exports.
    assert {"B", "BreakingChangeWarning", "config", "GP", "Measure"} <= set(st.__all__)
    assert set(sj.__all__) - set(st.__all__) <= {"jax", "parallel", "utils", "iterative"}


def test_generator_state_forms_of_sample():
    # The JAX package's key form with a generator: the generator comes back,
    # advanced; the keyword form returns the samples only; both draw alike.
    f = GP(EQ())
    x = B.linspace(torch.float64, 0, 1, 4)
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state().clone()
    out, s = f(x, 0.1).sample(gen, 2)
    assert out is gen and not torch.equal(gen.get_state(), before)
    s_kw = f(x, 0.1).sample(2, generator=torch.Generator().manual_seed(3))
    assert torch.equal(s, s_kw) and s.shape == (4, 2)
    out, s1, s2 = f.measure.sample(torch.Generator().manual_seed(5), 3, f(x), f(x, 0.1))
    assert isinstance(out, torch.Generator) and s1.shape == s2.shape == (4, 3)
    one = f.measure.sample(f(x), generator=torch.Generator().manual_seed(5))
    assert torch.is_tensor(one) and one.shape == (4, 1)
    with pytest.raises(TypeError):
        f(x).sample(gen, generator=gen)
    # The global "key": a seed or a generator; a draw advances it.
    st.set_global_key(7)
    a = f(x).sample()
    st.set_global_key(7)
    assert torch.equal(f(x).sample(), a)
    g = torch.Generator().manual_seed(1)
    st.set_global_key(g)
    assert st.next_global_key() is g
    with pytest.raises(TypeError):
        st.set_global_key("seven")


def test_the_torch_shim_re_exports_and_leaves_torch_alone():
    # The shim is importable as the reference's backend path, and a module
    # named ``torch`` inside the package does not hide the real one.
    code = (
        "import stheno_torch, stheno_torch.torch as shim;"
        "import torch;"
        "assert hasattr(torch, 'cuda') and hasattr(torch, 'Tensor');"
        "assert shim.GP is stheno_torch.GP and shim.B is stheno_torch.B;"
        "assert set(shim.__all__) == set(stheno_torch.__all__)"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
