"""NUTS's and HMC's chains batched on one device (``opt/_flat.py``): each
chain a coroutine, every round's pending positions one batched evaluation
and one host read.

Float64 on the CPU, numpy-seeded data (``entry._nuts_target``'s at small
N). The batched chains are held to the same chains one at a time
(``_flat._drive_in_turn``, each evaluation alone) at rtol 1e-9: every
sample, HMC's log-densities, NUTS's accept statistics and tree depths
(equal). Also: one batched evaluation serves every pending chain and a
finished chain drops out; a member's bits do not depend on the batch it
shares; the NLML path under ``torch.func.vmap`` of ``grad`` over chains'
positions (the JAX package's form: the adaptive jitter's probe, the auto
policy's recursion through K2's vmap rule, K1 and its backward through
their vmap rules) agrees with the unbatched gradient."""

import numpy as np
import pytest
import torch

from stheno_torch import config
from stheno_torch import entry as E
from stheno_torch.kernels import kernel as tkernel
from stheno_torch.matrix import ops as tops
from stheno_torch.ops import chol_tile as tct
from stheno_torch.ops import gram as tgram
from stheno_torch.ops import gram_bwd as tbwd
from stheno_torch.opt import _flat, sample_hmc, sample_nuts
from stheno_torch.opt.hmc import _sample_hmc
from stheno_torch.opt.nuts import _sample_nuts
from tests.test_torch_helpers import np_, spd, torch_cpu  # noqa: F401

RTOL = 1e-9


@pytest.fixture
def adaptive_jitter():
    prev = config.adaptive_jitter
    config.set_adaptive_jitter(True)
    yield
    config.set_adaptive_jitter(prev)


def _close(a, b):
    a, b = np.asarray(np_(torch.as_tensor(a))), np.asarray(np_(torch.as_tensor(b)))
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * float(np.abs(b).max()))


@pytest.mark.parametrize("adapt_mass", ["dense", "diag"])
def test_batched_nuts_matches_chains_in_turn(adapt_mass):
    logpost, init = E._nuts_target(30, torch.device("cpu"), torch.float64)
    kw = dict(num_samples=6, num_warmup=25, step_size=0.1, num_chains=3, max_depth=4,
              target_accept=0.8, adapt_mass=adapt_mass, mesh=None, chain_axis="chains")

    def fn(drive):
        return _sample_nuts(logpost, init, torch.Generator().manual_seed(3), drive, **kw)

    got, acc, accepts, depths = fn(None)
    ref, acc_ref, accepts_ref, depths_ref = fn(_flat._drive_in_turn)
    for k in ref:
        assert got[k].shape == (3, 6)
        _close(got[k], ref[k])
    _close(acc, acc_ref)
    _close(accepts, accepts_ref)
    assert torch.equal(depths, depths_ref)
    assert depths.shape == (3, 31)
    # The public sampler is the batched driver.
    pub, pub_acc = sample_nuts(logpost, init, torch.Generator().manual_seed(3),
                               **{k: v for k, v in kw.items() if k not in ("mesh", "chain_axis")})
    for k in ref:
        assert torch.equal(pub[k], got[k])
    assert pub_acc == acc


def test_batched_hmc_matches_chains_in_turn(adaptive_jitter):
    logpost, init = E._nuts_target(30, torch.device("cpu"), torch.float64)

    def fn(drive):
        return _sample_hmc(logpost, init, torch.Generator().manual_seed(4), drive,
                           num_samples=5, num_warmup=5, step_size=0.05, n_leapfrog=4,
                           num_chains=3, target_accept=0.8, mesh=None, chain_axis="chains")

    got = fn(None)
    ref = fn(_flat._drive_in_turn)
    for k in ref[0]:
        _close(got[0][k], ref[0][k])
    _close(got[1], ref[1])
    _close(got[2], ref[2])


def test_entry_samplers_batched_match_in_turn():
    # The entry points as chip_smoke.py's float64 check drives them (there
    # at N=2000 on the card).
    kw = dict(n=25, num_chains=2, num_warmup=6, num_samples=6, dtype=torch.float64)
    for fn, extra in ((E._nuts_n2000, {"max_depth": 3}), (E._hmc_n2000, {})):
        got = fn(1, "cpu", None, **kw, **extra)
        ref = fn(1, "cpu", _flat._drive_in_turn, **kw, **extra)
        for k in ref[0]:
            _close(got[0][k], ref[0][k])
            assert got[0][k].dtype == torch.float64
        for a, b in zip(got[1:], ref[1:]):
            _close(a, b)


def _gaussian():
    prec = torch.linalg.inv(torch.tensor([[1.0, 0.6], [0.6, 1.0]], dtype=torch.float64))

    def lp(p):
        return -0.5 * p["w"] @ prec @ p["w"]

    return lp, {"w": torch.zeros(2, dtype=torch.float64)}


def test_one_batched_evaluation_serves_all_pending_chains(monkeypatch):
    # Each round evaluates every pending chain at once; the rounds' sizes
    # add up to the evaluations the chains take one at a time, and shrink
    # as chains finish.
    lp, init = _gaussian()
    sizes = []
    real = _flat.Target.batch_value_and_grad

    def spy(self, qs):
        sizes.append(qs.shape[0])
        return real(self, qs)

    monkeypatch.setattr(_flat.Target, "batch_value_and_grad", spy)
    calls0 = _flat.batch_calls
    sample_nuts(lp, init, torch.Generator().manual_seed(7), num_samples=8, num_warmup=8,
                num_chains=4, max_depth=5)
    assert sizes[0] == 4 and max(sizes) == 4
    assert _flat.batch_calls - calls0 == len(sizes)
    turn = []
    real_one = _flat.Target.value_and_grad
    monkeypatch.setattr(_flat.Target, "value_and_grad",
                        lambda self, q: turn.append(1) or real_one(self, q))
    _sample_nuts(lp, init, torch.Generator().manual_seed(7), _flat._drive_in_turn,
                 num_samples=8, num_warmup=8, step_size=0.1, num_chains=4, max_depth=5,
                 target_accept=0.8, adapt_mass=True, mesh=None, chain_axis="chains")
    assert sum(sizes) == len(turn)
    assert len(sizes) < len(turn)
    # NUTS's trees differ in size, so some rounds run fewer chains.
    assert min(sizes) < 4


def test_hmc_rounds_are_lockstep(monkeypatch):
    # HMC's chains take n_leapfrog + 1 evaluations a transition each, so
    # every round holds every chain.
    lp, init = _gaussian()
    sizes = []
    real = _flat.Target.batch_value_and_grad
    monkeypatch.setattr(_flat.Target, "batch_value_and_grad",
                        lambda self, qs: sizes.append(qs.shape[0]) or real(self, qs))
    sample_hmc(lp, init, torch.Generator().manual_seed(8), num_samples=3, num_warmup=2,
               n_leapfrog=4, num_chains=3)
    assert sizes == [3] * (1 + 5 * 5)


def test_batched_evaluation_is_independent_of_the_batch():
    # A member's bits do not depend on which other positions share its
    # batch and are those of an evaluation alone, so a chain draws the same
    # wherever it runs: with or without a mesh, as chains finish.
    logpost, init = E._nuts_target(40, torch.device("cpu"), torch.float64)
    t = _flat.Target(logpost, init)
    qs = t.q0 + 0.1 * torch.tensor(np.random.RandomState(0).randn(4, 3))
    v4, g4 = t.batch_value_and_grad(qs)
    for i in range(4):
        v1, g1 = t.batch_value_and_grad(qs[i:i + 1])
        assert torch.equal(v1[0], v4[i]) and torch.equal(g1[0], g4[i])
        v, g = t.value_and_grad(qs[i])
        assert float(v4[i]) == v and torch.equal(g4[i], g)


# --- The NLML path under vmap of grad ------------------------------------------


def test_adaptive_jitter_probe_under_vmap():
    # The probe's masked bisection batches: each member gets its own rung.
    mats = torch.stack([torch.tensor(spd(6, s)) - c * torch.eye(6, dtype=torch.float64)
                        for s, c in ((1, 0.0), (2, 1.0 + 1e-7), (3, 0.0))])
    got = torch.func.vmap(lambda m: tops.adaptive_jitter_eps(m, 1e-12))(mats)
    want = torch.stack([tops.adaptive_jitter_eps(m, 1e-12) for m in mats])
    assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ["auto", "fast"])
def test_nlml_gradient_under_vmap_matches_unbatched(impl, adaptive_jitter, monkeypatch):
    # vmap(grad) of bench_nuts's log posterior over chains' positions, as
    # the JAX package evaluates its chains: with "fast" the recursion
    # (K2's vmap rule per member; the auto policy takes it on the card at n
    # >= 1024), and K1 and its backward routed through their Functions as on
    # the card (their vmap rules: one call per member).
    config.set_cholesky_impl(impl)
    calls = {"gram": 0, "bwd": 0, "tile": 0}
    real_gram, real_bwd, real_tile = tgram.gram_plain, tbwd.gram_bwd_plain, tct._factor_plain

    def gram_plain(*a, **k):
        calls["gram"] += 1
        return real_gram(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    def tile(*a, **k):
        calls["tile"] += 1
        return real_tile(*a, **k)

    monkeypatch.setattr(tkernel, "_fused_gram", lambda kind, x, y, alpha=1.0: tgram.gram(
        kind, x, y, alpha) if x.ndim == 2 and y.ndim == 2 else None)
    monkeypatch.setattr(tgram, "gram_plain", gram_plain)
    monkeypatch.setattr(tbwd, "gram_bwd_plain", bwd)
    monkeypatch.setattr(tct, "_factor_plain", tile)
    logpost, init = E._nuts_target(40, torch.device("cpu"), torch.float32)
    t = _flat.Target(logpost, init)
    qs = t.q0 + 0.1 * torch.tensor(np.random.RandomState(1).randn(3, 3), dtype=torch.float32)
    g, v = torch.func.vmap(torch.func.grad_and_value(lambda q: logpost(t.unravel(q))))(qs)
    assert calls["gram"] == 3 and calls["bwd"] == 3
    assert (calls["tile"] >= 3) == (impl == "fast")
    for i in range(3):
        vi, gi = t.value_and_grad(qs[i])
        np.testing.assert_allclose(float(v[i]), vi, rtol=1e-6)
        np.testing.assert_allclose(np_(g[i]), np_(gi), rtol=1e-5, atol=1e-5 * float(gi.abs().max()))
