"""The port's float32 matmul-precision pin (``config.matmul_precision``),
mirroring ``tests/test_precision.py``.

The JAX package pins full float32 on its own products at each numeric
chokepoint, whatever the ambient JAX default. The port does the same with
torch's process-wide flags (``torch.set_float32_matmul_precision`` and the
cuBLAS and cuDNN TF32 switches): each chokepoint sets them on entry and
restores the caller's on exit, its autograd backwards included, which run
outside the forward's scope. On the CPU the flags change no value, so
these tests read the flags from inside each chokepoint with a spy, under
an ambient TF32 setting, and check the caller's values afterwards.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_torch import config
from stheno_torch import iterative as tit
from stheno_torch.iterative import nlml as tnlml
from stheno_torch.matrix import ops as tops
from tests.test_torch_helpers import spd, torch_cpu  # noqa: F401

PINNED = ("highest", False, False)
AMBIENT = ("high", True, True)


def _flags():
    return (
        torch.get_float32_matmul_precision(),
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
    )


@pytest.fixture(autouse=True)
def ambient_tf32():
    """TF32 on in cuBLAS and cuDNN for the test; torch's settings and the
    library's precision restored afterwards."""
    saved, saved_lib = _flags(), config.matmul_precision
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert _flags() == AMBIENT
    yield
    config.set_matmul_precision(saved_lib)
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cuda.matmul.allow_tf32 = saved[1]
    torch.backends.cudnn.allow_tf32 = saved[2]


class _Spy:
    """Wraps ``owner.name`` to record the flags at each call."""

    def __init__(self, monkeypatch, owner, name):
        self.seen = []
        inner = getattr(owner, name)

        def spy(*args, **kwargs):
            self.seen.append(_flags())
            return inner(*args, **kwargs)

        monkeypatch.setattr(owner, name, spy)


def _mat(n=12, seed=0, requires_grad=False):
    return torch.tensor(spd(n, seed=seed), requires_grad=requires_grad)


def test_default_is_highest():
    assert config.matmul_precision == "highest"


def test_set_matmul_precision_validates():
    with pytest.raises(ValueError):
        config.set_matmul_precision("fp8")
    for value in ("high", "medium", None, "default", "highest"):
        config.set_matmul_precision(value)
        assert config.matmul_precision == value


def test_ctx_sets_and_restores_the_callers_flags():
    with config.matmul_precision_ctx():
        assert _flags() == PINNED
        with config.matmul_precision_ctx():
            assert _flags() == PINNED
        assert _flags() == PINNED
    assert _flags() == AMBIENT
    with pytest.raises(KeyError):
        with config.matmul_precision_ctx():
            raise KeyError("the flags come back on an exception too")
    assert _flags() == AMBIENT
    config.set_matmul_precision(None)
    with config.matmul_precision_ctx():
        assert _flags() == AMBIENT
    config.set_matmul_precision("medium")
    with config.matmul_precision_ctx():
        assert _flags() == ("medium", True, True)
    assert _flags() == AMBIENT


def test_decorator_keeps_the_name_and_pins():
    @config.pin_matmul_precision
    def probe(a, b=1):
        """Doc."""
        return _flags(), a + b

    assert probe.__name__ == "probe" and probe.__doc__ == "Doc."
    assert probe(1, b=2) == (PINNED, 3)
    assert _flags() == AMBIENT


@pytest.mark.parametrize(
    "chokepoint, spied, call",
    [
        ("cholesky", "_chol_dense", lambda A, b: st.cholesky(st.Dense(A))),
        ("solve", "_chol_apply_inv", lambda A, b: st.solve(st.Dense(A), b)),
        ("iqf", "_half_solve", lambda A, b: st.iqf(st.Dense(A), b)),
        ("iqf_diag", "_half_solve", lambda A, b: st.iqf_diag(st.Dense(A), b)),
        ("logdet", "_chol_arrays", lambda A, b: st.logdet(st.Dense(A))),
        ("ratio", "_half_solve", lambda A, b: st.ratio(st.Dense(b @ b.T), st.Dense(A))),
        ("matmul3", "matmul", lambda A, b: st.matmul3(st.Dense(A), b, b, tr_c=True)),
        ("matmul_diag", "dense", lambda A, b: st.matmul_diag(st.Dense(A), st.Dense(A))),
        ("root", "dense", lambda A, b: st.root(st.Dense(A))),
        ("sample", "dense", lambda A, b: st.sample(torch.Generator().manual_seed(0),
                                                  st.Dense(A), 2)),
    ],
)
def test_matrix_chokepoints_are_pinned(monkeypatch, chokepoint, spied, call):
    spy = _Spy(monkeypatch, tops, spied)
    A, b = _mat(), torch.tensor(np.random.RandomState(1).randn(12, 2))
    call(A, b)
    assert spy.seen and all(s == PINNED for s in spy.seen), (chokepoint, spy.seen)
    assert _flags() == AMBIENT


@pytest.mark.parametrize(
    "name, spied, f",
    [
        ("logdet", "_kinv_from_chol", lambda A, b: st.logdet(st.Dense(A))),
        ("solve", "_chol_apply_inv", lambda A, b: st.solve(st.Dense(A), b).sum()),
        ("iqf", "_chol_apply_inv", lambda A, b: st.dense(st.iqf(st.Dense(A), b)).sum()),
        ("iqf_diag", "_chol_apply_inv", lambda A, b: st.iqf_diag(st.Dense(A), b).sum()),
        ("ratio", "_kinv_from_chol", lambda A, b: st.ratio(st.Dense(b @ b.T), st.Dense(A))),
    ],
)
def test_backwards_are_pinned(monkeypatch, name, spied, f):
    # The backward runs outside the forward's scope: spy only on what the
    # backward calls, after the forward has run.
    A = _mat(requires_grad=True)
    b = torch.tensor(np.random.RandomState(2).randn(12, 2), requires_grad=True)
    out = f(A, b)
    assert _flags() == AMBIENT
    spy = _Spy(monkeypatch, tops, spied)
    out.backward()
    assert spy.seen and all(s == PINNED for s in spy.seen), (name, spy.seen)
    assert A.grad is not None and _flags() == AMBIENT


class _SpyEQ(st.EQ):
    """An EQ kernel that records the flags when it is evaluated."""

    seen = []

    def _pairwise(self, x, y):
        _SpyEQ.seen.append(_flags())
        return super()._pairwise(x, y)

    def _elwise(self, x, y):
        _SpyEQ.seen.append(_flags())
        return super()._elwise(x, y)


@pytest.mark.parametrize("fn", [st.pairwise, st.elwise])
def test_kernel_evaluation_is_pinned(fn):
    _SpyEQ.seen = []
    fn(_SpyEQ(), torch.linspace(0.0, 1.0, 6, dtype=torch.float64))
    assert _SpyEQ.seen == [PINNED]
    assert _flags() == AMBIENT


def _iterative_problem(n=40):
    r = np.random.RandomState(3)
    x = torch.tensor(np.sort(r.rand(n)) * 5)
    y = torch.sin(x) + 0.1 * torch.tensor(r.randn(n))
    params = {"log_ell": torch.tensor(0.0, dtype=torch.float64)}
    seen = []

    def kernel_fn(p):
        seen.append(_flags())
        return st.EQ().stretch(torch.exp(p["log_ell"]))

    return x, y, params, kernel_fn, seen


@pytest.mark.parametrize(
    "name",
    ["eig_precond_state", "posterior_weights", "cached_posterior_mean",
     "iterative_posterior_mean", "iterative_posterior_var", "variance_cache",
     "cached_posterior_var", "cached_posterior_mean_var"],
)
def test_iterative_entry_points_are_pinned(name):
    x, y, params, kernel_fn, seen = _iterative_problem()
    gen = torch.Generator().manual_seed(0)
    xn = torch.linspace(0.0, 5.0, 7, dtype=torch.float64)
    alpha = torch.ones(40, dtype=torch.float64)
    calls = {
        "eig_precond_state": lambda: tit.eig_precond_state(kernel_fn, params, x, 8, gen),
        "posterior_weights": lambda: tit.posterior_weights(kernel_fn, params, x, y, 0.1,
                                                           precond_rank=8),
        "cached_posterior_mean": lambda: tit.cached_posterior_mean(kernel_fn, params, x, alpha,
                                                                   xn),
        "iterative_posterior_mean": lambda: tit.iterative_posterior_mean(
            kernel_fn, params, x, y, 0.1, xn, precond_rank=8),
        "iterative_posterior_var": lambda: tit.iterative_posterior_var(
            kernel_fn, params, x, y, 0.1, xn, precond_rank=8),
        "variance_cache": lambda: tit.variance_cache(kernel_fn, params, x, 0.1, rank=8,
                                                     generator=gen),
    }
    if name in ("cached_posterior_var", "cached_posterior_mean_var"):
        cache = tit.variance_cache(kernel_fn, params, x, 0.1, rank=8, generator=gen)
        seen.clear()
        calls[name] = {
            "cached_posterior_var": lambda: tit.cached_posterior_var(kernel_fn, params, x,
                                                                     cache, xn),
            "cached_posterior_mean_var": lambda: tit.cached_posterior_mean_var(
                kernel_fn, params, x, alpha, cache, xn),
        }[name]
    calls[name]()
    assert seen and all(s == PINNED for s in seen), (name, seen)
    assert _flags() == AMBIENT


def test_iterative_nlml_and_its_backward_are_pinned(monkeypatch):
    x, y, params, kernel_fn, seen = _iterative_problem()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    val = tit.iterative_nlml(kernel_fn, leaves, x, y, 0.1, torch.Generator().manual_seed(1),
                             precond_rank=8)
    assert seen and all(s == PINNED for s in seen)
    spy = _Spy(monkeypatch, tnlml, "_surrogate_grads")
    val.backward()
    assert spy.seen == [PINNED]
    assert leaves["log_ell"].grad is not None and _flags() == AMBIENT


def test_entry_points_leave_the_callers_flags():
    from stheno_torch import entry as E

    fn, args = E.entry(device="cpu")
    fn(*args)
    xb, yb, ell = E.n2000_inputs(dtype=torch.float64, device="cpu")
    E.nlml_n2000(xb[:200], yb[:200], ell, grad=True)
    config.resolve_device("cpu")
    assert _flags() == AMBIENT


@pytest.mark.parametrize("name", ["sparse_elbo", "sparse_predict"])
def test_sparse_entry_points_are_pinned(monkeypatch, name):
    from stheno_torch import entry as E

    x, y, z, ell = E.vfe_n2000_inputs(torch.float64, "cpu", n=40, m=6)
    spy = _Spy(monkeypatch, E, "_sparse_obs")
    if name == "sparse_elbo":
        E.sparse_elbo(x, y, z, ell, grad=True)
    else:
        E.sparse_predict(x, y, z, ell, x[:5])
    assert spy.seen == [PINNED]
    assert _flags() == AMBIENT


def test_no_module_writes_the_flags_outside_the_pin():
    # Every write of torch's float32 precision flags in the port is in
    # config.py, inside the pin's save-and-restore.
    pattern = re.compile(r"allow_tf32\s*=[^=]|set_float32_matmul_precision\(")
    root = Path(st.__file__).parent
    writers = sorted(
        str(p.relative_to(root)) for p in root.rglob("*.py") if pattern.search(p.read_text())
    )
    assert writers == ["config.py"]


def test_values_unchanged_on_cpu():
    # On the CPU the flags change no value: the pinned NLML equals the one
    # under the caller's settings, and the JAX package's.
    x = np.linspace(0.0, 10.0, 32)
    y = np.sin(x)

    def nlml(M, x, y):
        f = M.GP(M.EQ())
        return -f.measure.logpdf(f(x, 0.1), y)

    pinned = float(nlml(st, torch.tensor(x), torch.tensor(y)))
    config.set_matmul_precision(None)
    plain = float(nlml(st, torch.tensor(x), torch.tensor(y)))
    assert pinned == plain
    assert pinned == pytest.approx(float(nlml(sj, jnp.asarray(x), jnp.asarray(y))), rel=1e-12)
