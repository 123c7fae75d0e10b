"""The extension story of ``tests/test_extension.py``, on the port: a
user-defined structured matrix type registered with
``register_matrix_type`` and taught the core ops by ``register_rule``
(the manual's example, ``docs/manual.md`` "Extending the library",
included), and a user-defined kernel whose ``_scalar`` powers its
derivatives. Each result is held to the JAX package's on the same
numbers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch.matrix as M
from stheno_torch import GP, Normal
from stheno_torch.kernels import Kernel, pairwise
from stheno_torch.kernels.kernel import ew_dists2, pw_dists2
from stheno_torch.matrix import (
    AbstractMatrix,
    Dense,
    Diagonal,
    clear_rules,
    register_matrix_type,
    register_rule,
)
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


class ScaledIdentity(AbstractMatrix):
    """``c * I_n``: one tensor leaf and a static size (the manual's type,
    which defines no ``device``: registration gives it one)."""

    def __init__(self, c, n):
        self.c = _t(c)
        self.n = int(n)
        self._cache = {}

    @property
    def shape(self):
        return tuple(self.c.shape) + (self.n, self.n)

    @property
    def dtype(self):
        return self.c.dtype


def _is_si(a, *rest):
    return isinstance(a, ScaledIdentity)


@pytest.fixture
def scaled_identity_rules():
    assert register_matrix_type(ScaledIdentity, leaf_names=("c",), aux_names=("n",)) \
        is ScaledIdentity
    register_rule("dense", _is_si, lambda a: a.c[..., None, None] * torch.eye(a.n, dtype=a.dtype))
    register_rule("diag_of", _is_si, lambda a: a.c[..., None].expand(a.c.shape + (a.n,)))
    register_rule("transpose", _is_si, lambda a: a)
    register_rule("scale", _is_si, lambda a, s: ScaledIdentity(a.c * s, a.n))
    register_rule("cholesky", _is_si, lambda a: ScaledIdentity(torch.sqrt(a.c), a.n))
    register_rule("logdet", _is_si, lambda a: a.n * torch.log(a.c))
    register_rule("solve", _is_si,
                  lambda a, b: (M.dense(b) if M.is_structured(b) else _t(b)) / a.c[..., None, None])
    # Fast paths for combinations of existing types.
    register_rule("add", lambda a, b: _is_si(a) and _is_si(b) and a.n == b.n,
                  lambda a, b: ScaledIdentity(a.c + b.c, a.n))
    register_rule("add", lambda a, b: _is_si(a) and isinstance(b, Diagonal),
                  lambda a, b: Diagonal(b.diag + a.c[..., None]))
    register_rule("matmul", lambda a, b: _is_si(a),
                  lambda a, b, tr_a=False, tr_b=False: M.scale(M.transpose(b) if tr_b else b, a.c))
    yield
    clear_rules()


def test_register_matrix_type_records_the_type(scaled_identity_rules):
    assert (ScaledIdentity._leaf_names, ScaledIdentity._aux_names) == (("c",), ("n",))
    assert ScaledIdentity(2.0, 3).device == torch.device("cpu")


def test_custom_type_flows_through_ops(scaled_identity_rules):
    a = ScaledIdentity(2.0, 4)
    np.testing.assert_allclose(np_(M.dense(a)), 2.0 * np.eye(4))
    np.testing.assert_allclose(np_(M.diag_of(a)), 2.0 * np.ones(4))
    assert float(M.logdet(a)) == pytest.approx(4 * np.log(2.0))
    L = M.cholesky(a)
    assert isinstance(L, ScaledIdentity) and float(L.c) == pytest.approx(np.sqrt(2.0))
    b = torch.arange(8.0, dtype=torch.float64).reshape(4, 2)
    np.testing.assert_allclose(np_(M.solve(a, b)), np_(b) / 2.0)
    s = M.add(a, ScaledIdentity(0.5, 4))
    assert isinstance(s, ScaledIdentity) and float(s.c) == pytest.approx(2.5)
    d = M.add(a, Diagonal(_t([1.0, 2.0, 3.0, 4.0])))
    assert isinstance(d, Diagonal)
    np.testing.assert_allclose(np_(d.diag), [3.0, 4.0, 5.0, 6.0])
    np.testing.assert_allclose(np_(M.dense(M.matmul(a, Dense(b)))), 2.0 * np_(b))
    # An unregistered combination densifies, through the custom dense rule.
    mix = M.add(Dense(torch.ones(4, 4, dtype=torch.float64)), a)
    np.testing.assert_allclose(np_(M.dense(mix)), np.ones((4, 4)) + 2.0 * np.eye(4))


def test_custom_type_differentiates_and_maps(scaled_identity_rules):
    # The JAX test holds the type under jit, grad and vmap; torch runs
    # eagerly, so autograd and torch.func.vmap.
    def f(c):
        return M.logdet(M.add(ScaledIdentity(c, 5), ScaledIdentity(1.0, 5)))

    assert float(f(_t(2.0))) == pytest.approx(5 * np.log(3.0))
    c = _t(2.0).requires_grad_(True)
    (g,) = torch.autograd.grad(f(c), c)
    assert float(g) == pytest.approx(5.0 / 3.0)
    vals = torch.func.vmap(f)(_t([1.0, 2.0]))
    np.testing.assert_allclose(np_(vals), [5 * np.log(2.0), 5 * np.log(3.0)], rtol=1e-12)


def test_custom_type_feeds_normal_logpdf(scaled_identity_rules):
    n = 6
    y = np.random.RandomState(0).randn(n, 1)
    got = Normal(ScaledIdentity(2.0, n)).logpdf(_t(y))
    ref = sj.Normal(sj.Dense(2.0 * jnp.eye(n))).logpdf(jnp.asarray(y))
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=1e-10)


def test_rule_registry_validation_and_clearing(scaled_identity_rules):
    with pytest.raises(ValueError, match="not extendable"):
        register_rule("iqf_diag", lambda a: True, lambda a: a)
    clear_rules("add")
    # Without the add rules the type still works, through its dense rule.
    out = M.add(ScaledIdentity(1.0, 3), ScaledIdentity(2.0, 3))
    np.testing.assert_allclose(np_(M.dense(out)), 3.0 * np.eye(3))


def test_manual_extension_example():
    """``docs/manual.md:510-533`` on the port: the type, its registration
    and its rules as the manual writes them (``torch`` for ``jnp``), and a
    ``Normal`` over it, against the JAX package's run of the same example."""
    class ManualScaledIdentity(AbstractMatrix):
        def __init__(self, c, n):
            self.c, self.n, self._cache = _t(c), int(n), {}

        @property
        def shape(self):
            return tuple(self.c.shape) + (self.n, self.n)

        @property
        def dtype(self):
            return self.c.dtype

    cls = ManualScaledIdentity
    register_matrix_type(cls, leaf_names=("c",), aux_names=("n",))
    is_si = lambda a, *rest: isinstance(a, cls)  # noqa: E731
    try:
        register_rule("dense", is_si, lambda a: a.c[..., None, None] * torch.eye(a.n, dtype=a.dtype))
        register_rule("cholesky", is_si, lambda a: cls(torch.sqrt(a.c), a.n))
        register_rule("logdet", is_si, lambda a: a.n * torch.log(a.c))
        register_rule("solve", is_si, lambda a, b: M.dense(b) / a.c[..., None, None])
        register_rule("add", lambda a, b: isinstance(a, cls) and isinstance(b, cls),
                      lambda a, b: cls(a.c + b.c, a.n))
        y = torch.ones((100, 1), dtype=torch.float64)
        got = Normal(cls(2.0, 100)).logpdf(y)
        summed = Normal(M.add(cls(1.5, 100), cls(0.5, 100))).logpdf(y)
    finally:
        clear_rules()
    ref = sj.Normal(sj.Dense(2.0 * jnp.eye(100))).logpdf(jnp.ones((100, 1)))
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=1e-10)
    np.testing.assert_allclose(np_(summed), np.asarray(ref), rtol=1e-10)


def test_custom_kernel_with_scalar_supports_derivatives():
    """A kernel subclass with ``_pairwise``, ``_elwise`` and ``_scalar``:
    it composes with the algebra, its ``_scalar`` gives ``.diff`` through
    ``torch.func``, and it runs in the GP DSL."""

    class Cosine(Kernel):
        """k(x, y) = cos(w |x - y|) (positive definite in 1-D)."""

        def __init__(self, w=1.0):
            self.w = w

        def _pairwise(self, x, y):
            return Dense(torch.cos(self.w * torch.sqrt(pw_dists2(x, y) + 1e-30)))

        def _elwise(self, x, y):
            return torch.cos(self.w * torch.sqrt(ew_dists2(x, y) + 1e-30))

        def _scalar(self, x, y):
            return torch.cos(self.w * torch.sqrt(torch.sum((x - y) ** 2) + 1e-30))

        @property
        def stationary(self):
            return True

    k = Cosine(1.3)
    x = torch.linspace(0, 3, 7, dtype=torch.float64)[:, None]
    ref = np.cos(1.3 * np.abs(np_(x) - np_(x).T))
    np.testing.assert_allclose(np_(M.dense(pairwise(k, x))), ref, rtol=1e-6, atol=1e-8)
    K2 = np_(M.dense(pairwise(2.0 * k + Cosine(0.5), x)))
    np.testing.assert_allclose(K2, 2.0 * ref + np.cos(0.5 * np.abs(np_(x) - np_(x).T)), rtol=1e-6)
    Kd = np_(M.dense(pairwise(k.diff(0, 0), x + 5.0)))
    # d2/dx dy cos(w (x - y)) = w^2 cos(w (x - y)) away from coincidence.
    off = ~np.eye(7, dtype=bool)
    np.testing.assert_allclose(Kd[off], (1.3**2 * ref)[off], rtol=1e-4, atol=1e-6)
    f = GP(k)
    post = f | (f(x, 0.1), torch.sin(x[:, 0]))
    mean, var = post(x).marginals()
    assert bool(torch.isfinite(mean).all()) and bool((var >= -1e-9).all())
