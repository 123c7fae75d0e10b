"""Forward-mode derivatives in the port (``torch.func.jvp``, ``jacfwd``,
``hessian`` and ``torch.autograd.forward_ad``) against the JAX package's
(``jax.jvp``, ``jax.jacfwd``, ``jax.hessian``) on the same numpy float64
inputs, mirroring ``tests/matrix/test_ops.py``'s forward-mode fallback test
and ``tests/test_fast_cholesky.py``'s autodiff detection.

The five Cholesky-backed reductions run their plain bodies on the
undetached factor under a forward level (``matrix/ops.py:_reduce``): their
``jacfwd`` equals their reverse gradient at rtol 1e-9 and JAX's at 1e-8.
K2's forward rule (``ops/chol_tile.py:_CholTile.jvp``) is held to
``jax.jvp`` of ``jnp.linalg.cholesky`` in float32 (it factors in float32:
rtol 1e-4 of the largest entry), K1's plain tangent (``gram_jvp_plain``)
to ``jax.jvp`` of ``stheno_tpu/ops/gram.py:_xla_gram`` at rtol 1e-10, and
the flagship NLML's ``jacfwd`` and ``hessian`` to JAX's at rtol 1e-8."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_tpu.matrix.ops as jops
from stheno_torch import entry as E
from stheno_torch.matrix import ops as tops
from stheno_torch.ops import chol_tile as tct
from stheno_torch.ops import gram as tgram
from stheno_torch.ops import gram_jvp as tjvp
from tests.test_torch_helpers import np_, spd, torch_cpu  # noqa: F401

jgram = importlib.import_module("stheno_tpu.ops.gram")

FWD_REV = 1e-9
PARITY = 1e-8
EXACT = 1e-10
ALPHA = 1.7

_rng = np.random.RandomState(0)
N = 6
A0 = spd(N, 1) * N
B0 = _rng.randn(N, 2)
C0 = _rng.randn(N, N)
S0 = 1.3


def _reductions(pkg, ops, asarray, total):
    A, b, C = (asarray(a) for a in (A0, B0, C0))
    return {
        "logdet": lambda s: ops.logdet(ops.as_matrix(s * A)),
        "iqf": lambda s: total(ops.dense(ops.iqf(ops.as_matrix(s * A), b))),
        "iqf_diag": lambda s: total(ops.iqf_diag(ops.as_matrix(s * A), b)),
        "solve": lambda s: total(ops.solve(ops.as_matrix(s * A), b)),
        "ratio": lambda s: ops.ratio(C, ops.as_matrix(s * A)),
    }


def _port():
    return _reductions("torch", tops, lambda a: torch.tensor(a), torch.sum)


def _jax():
    return _reductions("jax", jops, jnp.asarray, jnp.sum)


@pytest.mark.parametrize("name", ["logdet", "iqf", "iqf_diag", "solve", "ratio"])
def test_reduction_jacfwd_equals_reverse_and_jax(name):
    f = _port()[name]
    s = torch.tensor(S0, dtype=torch.float64)
    fwd = torch.func.jacfwd(f)(s)
    np.testing.assert_allclose(np_(fwd), np_(torch.func.grad(f)(s)), rtol=FWD_REV)
    leaf = s.clone().requires_grad_(True)
    (rev,) = torch.autograd.grad(f(leaf), leaf)
    np.testing.assert_allclose(np_(fwd), np_(rev), rtol=FWD_REV)
    want = jax.jacfwd(_jax()[name])(jnp.asarray(S0))
    np.testing.assert_allclose(np_(fwd), np.asarray(want), rtol=PARITY)


@pytest.mark.parametrize("name", ["logdet", "iqf", "iqf_diag", "solve", "ratio"])
def test_reduction_jvp_matches_jax(name):
    val, tan = torch.func.jvp(_port()[name], (torch.tensor(S0, dtype=torch.float64),),
                              (torch.tensor(0.7, dtype=torch.float64),))
    jval, jtan = jax.jvp(_jax()[name], (jnp.asarray(S0),), (jnp.asarray(0.7),))
    np.testing.assert_allclose(np_(val), np.asarray(jval), rtol=PARITY)
    np.testing.assert_allclose(np_(tan), np.asarray(jtan), rtol=PARITY)


def test_logdet_hessian():
    f = _port()["logdet"]
    hess = torch.func.hessian(f)(torch.tensor(S0, dtype=torch.float64))
    # d^2/ds^2 logdet(s A) = d/ds (n / s) = -n / s^2.
    np.testing.assert_allclose(float(hess), -N / S0**2, rtol=FWD_REV)
    np.testing.assert_allclose(float(hess), float(jax.hessian(_jax()["logdet"])(jnp.asarray(S0))),
                               rtol=PARITY)


def test_reverse_results_unchanged_by_the_forward_rules():
    # The analytic adjoints stay the reverse path: no forward level, so the
    # Functions (not the plain bodies) run, and the factor holds no graph.
    A = torch.tensor(A0).requires_grad_(True)
    val = tops.logdet(tops.as_matrix(A))
    assert type(val.grad_fn).__name__.startswith("_LogdetChol")
    (g,) = torch.autograd.grad(val, A)
    np.testing.assert_allclose(np_(g), np.linalg.inv(A0), rtol=1e-10)


def test_forward_ad_dual_tensor_through_logdet():
    import torch.autograd.forward_ad as fwAD

    f = _port()["logdet"]
    with fwAD.dual_level():
        out = f(fwAD.make_dual(torch.tensor(S0, dtype=torch.float64),
                               torch.tensor(1.0, dtype=torch.float64)))
        tan = fwAD.unpack_dual(out).tangent
    np.testing.assert_allclose(float(tan), N / S0, rtol=FWD_REV)
    _, jtan = jax.jvp(_jax()["logdet"], (jnp.asarray(S0),), (jnp.asarray(1.0),))
    np.testing.assert_allclose(float(tan), float(jtan), rtol=PARITY)


# --- _under_autodiff under each transform -----------------------------------

def _seen_under(transform):
    seen = []

    def g(x):
        seen.append(tops._under_autodiff(x * 1.0))
        return torch.sum(x * x)

    x = torch.ones(4, dtype=torch.float64)
    transform(g, x)
    return seen[-1]


_ON = {
    "grad": lambda g, x: torch.func.grad(g)(x),
    "vmap_grad": lambda g, x: torch.func.vmap(torch.func.grad(g))(torch.ones(2, 4,
                                                                             dtype=x.dtype)),
    "jacrev": lambda g, x: torch.func.jacrev(g)(x),
    "jvp": lambda g, x: torch.func.jvp(g, (x,), (x,)),
    "jacfwd": lambda g, x: torch.func.jacfwd(g)(x),
    "hessian": lambda g, x: torch.func.hessian(g)(x),
    "autograd": lambda g, x: g(x.clone().requires_grad_(True)),
    "forward_ad": lambda g, x: _dual(g, x),
}
_OFF = {
    "eager": lambda g, x: g(x),
    "no_grad": lambda g, x: _no_grad(g, x),
    "vmap": lambda g, x: torch.func.vmap(g)(torch.ones(2, 4, dtype=x.dtype)),
}


def _dual(g, x):
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        return g(fwAD.make_dual(x, torch.ones_like(x)))


def _no_grad(g, x):
    with torch.no_grad():
        return g(x.clone().requires_grad_(True))


@pytest.mark.parametrize("name", sorted(_ON))
def test_under_autodiff_fires_under(name):
    assert _seen_under(_ON[name]), f"autodiff not detected under {name}"


@pytest.mark.parametrize("name", sorted(_OFF))
def test_under_autodiff_stays_off_under(name):
    assert not _seen_under(_OFF[name])


def test_auto_policy_takes_the_recursion_under_forward_mode(monkeypatch):
    # On the card the auto policy's predicate needs a CUDA tensor; on the
    # CPU its autodiff half must fire under jacfwd alone.
    seen = []
    monkeypatch.setattr(tops, "_auto_policy_use_fast",
                        lambda mat: seen.append(tops._under_autodiff(mat)) or False)
    torch.func.jacfwd(_port()["logdet"])(torch.tensor(S0, dtype=torch.float64))
    assert seen and all(seen)


# --- K2's forward rule -------------------------------------------------------

def _chol_jax(a):
    L = jnp.linalg.cholesky(a)
    return L, jax.scipy.linalg.solve_triangular(L, jnp.eye(a.shape[0]), lower=True)


def _rel_close(got, want, rtol):
    got, want = np_(got).astype(np.float64), np.asarray(want, dtype=np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


@pytest.mark.parametrize("n", [40, 200])
def test_chol_tile_jvp_matches_jax(n):
    A = spd(n, 3)
    D = np.random.RandomState(4).randn(n, n)
    D = D + D.T
    (L, Linv), (dL, dLinv) = torch.func.jvp(
        tct.chol_tile, (torch.tensor(A, dtype=torch.float32),), (torch.tensor(D,
                                                                              dtype=torch.float32),))
    (jL, jLinv), (jdL, jdLinv) = jax.jvp(_chol_jax, (jnp.asarray(A),), (jnp.asarray(D),))
    _rel_close(L, jL, 1e-5)
    _rel_close(dL, jdL, 1e-4)
    _rel_close(dLinv, jdLinv, 1e-4)


def test_chol_tile_vmap_and_jacfwd_match_jax():
    A = spd(5, 5)
    J = torch.func.jacfwd(lambda a: tct.chol_tile(a)[0])(torch.tensor(A, dtype=torch.float32))
    jJ = jax.jacfwd(lambda a: jnp.linalg.cholesky(a))(jnp.asarray(A))
    _rel_close(J, jJ, 1e-4)
    batch = np.stack([spd(7, s) for s in (6, 7, 8)])
    Ls, Linvs = torch.func.vmap(tct.chol_tile)(torch.tensor(batch, dtype=torch.float32))
    for i in range(3):
        _rel_close(Ls[i], np.linalg.cholesky(batch[i]), 1e-5)
        _rel_close(Linvs[i], np.linalg.inv(np.linalg.cholesky(batch[i])), 1e-5)


def test_chol_tile_hessian_through_the_recursion():
    # torch.func.hessian (forward over reverse) of logdet through the
    # carried-inverse recursion, whose base tiles are K2's Function.
    tgt = torch.tensor(spd(1100, 9), dtype=torch.float32)
    from stheno_torch import config

    config.set_cholesky_impl("fast")
    f = lambda s: tops.logdet(tops.as_matrix(s * tgt))  # noqa: E731
    hess = torch.func.hessian(f)(torch.tensor(S0))
    np.testing.assert_allclose(float(hess), -1100 / S0**2, rtol=1e-4)
    np.testing.assert_allclose(float(torch.func.jacfwd(f)(torch.tensor(S0))), 1100 / S0,
                               rtol=1e-4)


# --- K1's forward rule -------------------------------------------------------

def _jax_gram_tangents(kind, x, y, xt, yt, at):
    def one(a, b, c):
        return jax.jvp(lambda x, y, al: jgram._xla_gram(kind, x, y, al),
                       (jnp.asarray(x), jnp.asarray(y), jnp.asarray(ALPHA)), (a, b, c))[1]

    return jax.vmap(one)(jnp.asarray(xt), jnp.asarray(yt), jnp.asarray(at))


# x is y puts d2 = 0 on the diagonal, where Matérn-1/2's g' is infinite
# (and its tangent 0 * inf in either package): that case is left out.
@pytest.mark.parametrize("kind, same", [(k, False) for k in tgram.KINDS]
                         + [(k, True) for k in tgram.KINDS if k != "matern12"])
def test_gram_jvp_plain_matches_jax(kind, same):
    r = np.random.RandomState(11)
    x = r.randn(9, 3)
    y = x if same else r.randn(7, 3)
    xt = r.randn(4, 9, 3)
    yt = xt if same else r.randn(4, 7, 3)
    at = r.randn(4)
    got = tjvp.gram_jvp_plain(kind, *(torch.tensor(a) for a in (x, y, xt, yt)),
                              torch.tensor(ALPHA, dtype=torch.float64), torch.tensor(at))
    want = _jax_gram_tangents(kind, x, y, xt, yt, at if kind == "rq" else np.zeros(4))
    _rel_close(got, want, EXACT)


@pytest.mark.parametrize("kind", tgram.KINDS)
def test_gram_forward_rule_under_jacfwd(kind):
    # torch.func.jacfwd through gram(): _Gram's jvp hands the directions to
    # _GramJvp, whose vmap rule takes them in one call of gram_jvp.
    r = np.random.RandomState(12)
    x, y = r.randn(5, 2), r.randn(4, 2)
    J = torch.func.jacfwd(lambda a, b, al: tgram.gram(kind, a, b, al), argnums=(0, 1, 2))(
        torch.tensor(x), torch.tensor(y), torch.tensor(ALPHA, dtype=torch.float64))
    jJ = jax.jacfwd(lambda a, b, al: jgram._xla_gram(kind, a, b, al), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(ALPHA))
    for g, w in zip(J, jJ):
        if kind != "rq" and g.ndim == 2:
            assert not np.any(np.asarray(w))  # no alpha in the other kinds
            continue
        _rel_close(g, w, EXACT)


def test_gram_jvp_one_call_for_all_directions(monkeypatch):
    calls = []
    plain = tjvp.gram_jvp_plain

    def spy(*args, **kwargs):
        calls.append(args[3].shape if args[3] is not None else None)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tjvp, "gram_jvp_plain", spy)
    x = torch.tensor(np.random.RandomState(13).randn(6, 2))
    torch.func.jacfwd(lambda a: tgram.gram("eq", a, a))(x)
    assert calls == [(12, 6, 2)]


# --- The flagship NLML --------------------------------------------------------

def _flagship_data(n=60):
    x = np.linspace(0.0, 10.0, n)
    return x, np.sin(x) + 0.3 * np.cos(3.2 * x)


P0 = np.array([0.2, -0.1, -2.0])  # log ell, log s2, log noise


def _jax_nlml(x, y):
    def nlml(p):
        f = sj.GP(jnp.exp(p[1]) * sj.EQ().stretch(jnp.exp(p[0])))
        return -f.measure.logpdf(f(x, jnp.exp(p[2])), y)

    return nlml


def test_flagship_jacfwd_matches_jax_and_reverse():
    x, y = _flagship_data()
    params = dict(zip(("log_ell", "log_s2", "log_noise"),
                      (torch.tensor(v, dtype=torch.float64) for v in P0)))
    val, grads = E.flagship_jacfwd(torch.tensor(x), torch.tensor(y), params)
    nlml = _jax_nlml(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(val), float(nlml(jnp.asarray(P0))), rtol=PARITY)
    want = jax.jacfwd(nlml)(jnp.asarray(P0))
    got = np.array([float(grads[k]) for k in ("log_ell", "log_s2", "log_noise")])
    np.testing.assert_allclose(got, np.asarray(want), rtol=PARITY)
    _, rev, _, _ = E.flagship_step(torch.tensor(x), torch.tensor(y), torch.tensor(x[:2]),
                                   params)
    np.testing.assert_allclose(got, [float(rev[k]) for k in grads], rtol=FWD_REV)


def test_flagship_hessian_matches_jax():
    from stheno_torch import EQ, GP

    x, y = (torch.tensor(a) for a in _flagship_data())

    def nlml(p):
        f = GP(torch.exp(p[1]) * EQ().stretch(torch.exp(p[0])))
        return -f.measure.logpdf(f(x, torch.exp(p[2])), y)

    got = torch.func.hessian(nlml)(torch.tensor(P0))
    want = jax.hessian(_jax_nlml(jnp.asarray(np_(x)), jnp.asarray(np_(y))))(jnp.asarray(P0))
    _rel_close(got, want, PARITY)


def test_gram_rules_under_vmap_over_data():
    # A batch of inputs (not of directions): K1's and the tangent's vmap
    # rules take one call per member.
    r = np.random.RandomState(14)
    xs, ts = torch.tensor(r.randn(3, 5, 2)), torch.tensor(r.randn(3, 5, 2))
    K = torch.func.vmap(lambda a: tgram.gram("matern32", a, a))(xs)
    tan = torch.func.vmap(lambda a, t: torch.func.jvp(
        lambda z: tgram.gram("matern32", z, z), (a,), (t,))[1])(xs, ts)
    for i in range(3):
        _rel_close(K[i], tgram.gram_plain("matern32", xs[i], xs[i]), EXACT)
        want = tjvp.gram_jvp_plain("matern32", xs[i], xs[i], ts[i][None], ts[i][None])[0]
        _rel_close(tan[i], want, EXACT)
