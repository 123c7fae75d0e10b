"""Item 7's device-side pieces on the CPU: the adaptive-jitter probe
(``matrix/ops.py:adaptive_jitter_eps``) against the JAX package's
``while_loop`` probe, with no host read; the Adam driver and
``resumable_minimise`` with the adaptive jitter on against the JAX
optimisers (eager, and through the graph buffers with the captures stood
in for); and rq's alpha as a device operand (``ops/gram.py:device_alpha``):
a tensor alpha and a number alpha give the same bits in all four
launchers' plain versions and wrappers.

The probe's rungs are float64 (each the previous times 10, as the JAX
loop multiplies); the JAX loop multiplies in the matrix's dtype, so a
float32 probe's eps is compared after rounding to float32."""

import contextlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import stheno_tpu as sj
import stheno_tpu.matrix.ops as jops
import stheno_torch as st
from stheno_tpu import opt as jopt
from stheno_tpu.utils import resumable_minimise as jrm
from stheno_torch import config
from stheno_torch import opt as topt
from stheno_torch.matrix import ops as tops
from stheno_torch.opt import transform as T
from stheno_torch.ops import gram as tgram
from stheno_torch.ops import gram_bwd as tbwd
from stheno_torch.ops import gram_matvec as tgmv
from stheno_torch.ops import gram_matvec_vjp as tvjp
from stheno_torch.utils import resilience
from stheno_torch.utils import resumable_minimise as trm
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401
from tests.test_torch_resilience import _fake_capture

RTOL = 1e-8


def _eq_gram(n, ell):
    x = np.linspace(0.0, 10.0, n)
    return np.exp(-0.5 * (x[:, None] - x[None]) ** 2 / ell**2).astype(np.float32)


def _needs_k3():
    # A symmetric matrix with least eigenvalue -5e-10: jitters 1e-12 to
    # 1e-10 leave it indefinite, 1e-9 does not.
    r = np.random.RandomState(0)
    Q, _ = np.linalg.qr(r.randn(30, 30))
    lam = np.linspace(1.0, 2.0, 30)
    lam[0] = -5e-10
    return (Q * lam) @ Q.T


CASES = {
    "spd": (lambda: np.eye(30) + 0.1 * np.ones((30, 30)), 1e-12, 0),
    "rank_deficient_f32_gram": (lambda: _eq_gram(200, 2.0), 1e-8, 3),
    "needs_k3": (_needs_k3, 1e-12, 3),
}


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the probe read a tensor on the host")

    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__float__", "__int__", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        yield


@pytest.mark.parametrize("case", sorted(CASES))
def test_probe_matches_jax_without_host_reads(case, monkeypatch):
    make, base, k = CASES[case]
    M = make()
    with _no_host_reads(monkeypatch):
        eps = tops.adaptive_jitter_eps(torch.tensor(M), base)
    want = jops.adaptive_jitter_eps(jnp.asarray(M), base)
    assert eps.dtype == torch.float64 and eps.shape == ()
    assert np.asarray(float(eps), dtype=M.dtype) == np.asarray(want)
    assert round(np.log10(float(eps) / base)) == k


def test_probe_returns_the_cap_when_nothing_factors():
    # Every rung leaves -I indefinite: the JAX loop returns the first rung
    # at or above base * 1e12. Twelve float64 products of 1e-12 by 10 fall
    # just short of 1e12 * 1e-12, so that rung is tried too and the cap is
    # the next, 10.
    M = -np.eye(4)
    eps = tops.adaptive_jitter_eps(torch.tensor(M), 1e-12)
    assert float(eps) == float(jops.adaptive_jitter_eps(jnp.asarray(M), 1e-12))
    np.testing.assert_allclose(float(eps), 10.0, rtol=1e-12)


def test_probe_of_a_batch_takes_the_jitter_all_factor_under():
    M = np.stack([np.eye(30), _needs_k3()])
    eps = tops.adaptive_jitter_eps(torch.tensor(M), 1e-12)
    assert float(eps) == float(jops.adaptive_jitter_eps(jnp.asarray(M), 1e-12))


# --- The optimisers with the adaptive jitter on ------------------------------

def _model(M, a, n=48):
    x = np.linspace(0.0, 10.0, n)
    x, y = a(x), a(np.sin(x) + 0.3 * np.cos(3.2 * x))

    def f(v):
        g = M.GP(v.positive(1.0, name="s2") * M.EQ().stretch(v.positive(1.0, name="ell")))
        return -g.measure.logpdf(g(x, 1e-2), y)

    return f


@pytest.fixture
def adaptive():
    import stheno_tpu.config as jconfig

    jconfig.set_adaptive_jitter(True)
    config.set_adaptive_jitter(True)
    yield
    jconfig.set_adaptive_jitter(False)
    config.set_adaptive_jitter(False)


def test_adam_driver_with_adaptive_jitter_matches_jax(adaptive):
    dj = jopt.AdamDriver(_model(sj, jnp.asarray), jopt.Vars(), rate=1e-2)
    dt = topt.AdamDriver(_model(st, torch.tensor), topt.Vars(device="cpu"), rate=1e-2)
    for _ in range(4):
        np.testing.assert_allclose(float(dt.run(5)), float(dj.run(5)), rtol=RTOL)
        for name in ("ell", "s2"):
            np.testing.assert_allclose(np_(dt.vs[name]), np_(dj.vs[name]), rtol=RTOL)


def _nlml(M, arr):
    exp = jnp.exp if M is sj else torch.exp
    x = np.linspace(0.0, 10.0, 48)
    x, y = arr(x), arr(np.sin(x) + 0.3 * np.cos(3.2 * x))

    def f(p):
        g = M.GP(exp(p["s2"]) * M.EQ().stretch(exp(p["ell"])))
        return -g.measure.logpdf(g(x, 1e-2), y)

    return f


@pytest.mark.parametrize("route", ["eager", "graphs"])
def test_resumable_minimise_with_adaptive_jitter_matches_jax(route, adaptive, tmp_path,
                                                              monkeypatch):
    if route == "graphs":
        monkeypatch.setattr(resilience, "_capture", _fake_capture)
        monkeypatch.setattr(resilience, "_EagerSteps", resilience._GraphSteps)
    init = {"ell": 0.1, "s2": 0.2}
    pj, ij = jrm(_nlml(sj, jnp.asarray), {k: jnp.asarray(v) for k, v in init.items()},
                 steps=12, checkpoint_path=str(tmp_path / "j.npz"), optimizer=optax.adam(5e-2))
    pt, it = trm(_nlml(st, lambda v: torch.tensor(np.asarray(v), dtype=torch.float64)),
                 {k: torch.tensor(v, dtype=torch.float64) for k, v in init.items()}, steps=12,
                 checkpoint_path=str(tmp_path / "t.npz"), optimizer=T.adam(5e-2))
    for k in init:
        np.testing.assert_allclose(np_(pt[k]), np.asarray(pj[k]), rtol=RTOL)
    np.testing.assert_allclose(it["objective_trace"], ij["objective_trace"], rtol=RTOL)


# --- rq's alpha as a device operand ------------------------------------------

def _inputs():
    r = np.random.RandomState(5)
    x, y = (torch.tensor(r.randn(n, 2)) for n in (9, 7))
    return x, y, torch.tensor(r.randn(9, 7)), torch.tensor(r.randn(7, 3)), torch.tensor(
        r.randn(9, 3))


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    assert (a is None) == (b is None)
    if a is not None:
        assert torch.equal(a, b)


ALPHAS = (1.7, torch.tensor(1.7, dtype=torch.float64))


@pytest.mark.parametrize("launcher", ["gram", "gram_bwd", "gram_matvec", "gram_matvec_vjp"])
def test_tensor_and_number_alpha_agree_bit_for_bit(launcher):
    x, y, gbar, V, A = _inputs()
    calls = {
        "gram": lambda a: (tgram.gram_plain("rq", x, y, a), tgram.gram("rq", x, y, a)),
        "gram_bwd": lambda a: (
            tbwd.gram_bwd_plain("rq", x, y, gbar, a, want_alpha=True),
            tbwd.gram_bwd("rq", x, y, gbar, a, want_alpha=True)),
        "gram_matvec": lambda a: (tgmv.gram_matvec_plain("rq", x, y, V, a),
                                  tgmv.gram_matvec("rq", x, y, V, a)),
        "gram_matvec_vjp": lambda a: (
            tvjp.gram_matvec_vjp_plain("rq", x, y, A, V, a, alpha_grad=True, value=True),
            tvjp.gram_matvec_vjp("rq", x, y, A, V, a, alpha_grad=True, value=True)),
    }[launcher]
    _same(calls(ALPHAS[0]), calls(ALPHAS[1]))


def test_gram_gradient_in_alpha_takes_a_tensor_alpha():
    x, y, gbar, _, _ = _inputs()
    a = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad((tgram.gram("rq", x, y, a) * gbar).sum(), a)
    _, _, want = tbwd.gram_bwd_plain("rq", x, y, gbar, 1.7, want_alpha=True)
    np.testing.assert_allclose(float(g), float(want), rtol=1e-12)


def test_device_alpha_is_kept_per_number_and_cast_per_tensor(monkeypatch):
    dev = torch.device("cpu")
    a = tgram.device_alpha("rq", 2.5, torch.float32, dev)
    assert a is tgram.device_alpha("rq", 2.5, torch.float32, dev)
    assert a.dtype == torch.float32 and float(a) == 2.5
    assert tgram.device_alpha("eq", 2.5, torch.float32, dev) is None
    t = torch.tensor(2.5, dtype=torch.float64, requires_grad=True)
    cast = tgram.device_alpha("rq", t, torch.float32, dev)
    assert cast.dtype == torch.float32 and not cast.requires_grad
    # While a graph is captured a number is filled anew (a kept tensor
    # made there would hold what the fill had not yet written).
    monkeypatch.setattr(config, "capturing", lambda: True)
    assert tgram.device_alpha("rq", 2.5, torch.float32, dev) is not a
