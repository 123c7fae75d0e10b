"""The port's samplers (``stheno_torch.opt``: ``sample_hmc``,
``sample_nuts``) and their diagnostics against ``stheno_tpu.opt``, float64
on the CPU.

The two packages draw different random numbers (a JAX key against a
``torch.Generator``), so the samplers are compared by moments, each with
its Monte Carlo standard error: the standard error of a mean is the draws'
standard deviation over the square root of their effective sample size
(ESS, the package's own diagnostic); that of a variance is computed the
same way from the squared deviations. On Gaussian targets both packages'
means and variances must lie within 4 standard errors of the exact values;
on a tiny GP posterior both packages' posterior means must agree within 4
combined standard errors. The diagnostics are the same numpy code on the
same arrays: rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu import opt as jopt
from stheno_torch import entry as E
from stheno_torch import opt as topt
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

SIGMAS = 4.0


def _mc_se(draws):
    """``(mean, se of the mean, variance, se of the variance)`` of scalar
    draws ``(chains, samples)``."""
    draws = np.asarray(draws, dtype=np.float64)
    mean, var = draws.mean(), draws.var()
    sq = (draws - mean) ** 2
    se_mean = np.sqrt(var / topt.effective_sample_size(draws))
    se_var = np.sqrt(sq.var() / topt.effective_sample_size(sq))
    return mean, se_mean, var, se_var


def _hold_moments(w, mean, var, who):
    """Each coordinate of ``w (chains, samples, dim)`` within ``SIGMAS``
    standard errors of the exact ``mean`` and ``var``."""
    for i in range(w.shape[-1]):
        m, se_m, v, se_v = _mc_se(w[..., i])
        assert abs(m - mean[i]) <= SIGMAS * se_m, (who, i, m, se_m)
        assert abs(v - var[i]) <= SIGMAS * se_v, (who, i, v, se_v)


def _gaussian(cov, M):
    prec = np.linalg.inv(cov)
    if M is jnp:
        P = jnp.asarray(prec)
        return lambda p: -0.5 * p["w"] @ (P @ p["w"])
    P = torch.tensor(prec)
    return lambda p: -0.5 * p["w"] @ (P @ p["w"])


_STANDARD = np.eye(3)
# rho ~ 0.99, scales 1 and 0.1 (tests/test_nuts.py's dense-mass target).
_L = np.asarray([[1.0, 0.0], [0.099, 0.0141]])
_CORRELATED = _L @ _L.T


def _nuts_both(cov, **kw):
    d = cov.shape[0]
    sj_, _ = jopt.sample_nuts(_gaussian(cov, jnp), {"w": jnp.zeros(d)}, jax.random.PRNGKey(3),
                              **kw)
    st_, accept = topt.sample_nuts(_gaussian(cov, torch), {"w": torch.zeros(d, dtype=torch.float64)},
                                   torch.Generator().manual_seed(3), **kw)
    assert st_["w"].shape == (kw["num_chains"], kw["num_samples"], d)
    assert 0.5 < accept <= 1.0, accept
    return np.asarray(sj_["w"]), np_(st_["w"])


@pytest.mark.parametrize(
    "name, cov, adapt_mass",
    [("standard", _STANDARD, True), ("correlated", _CORRELATED, "dense"),
     ("correlated", _CORRELATED, "diag")],
)
def test_nuts_moments_match_exact_in_both_packages(name, cov, adapt_mass):
    wj, wt = _nuts_both(cov, num_samples=300, num_warmup=150, num_chains=2, max_depth=6,
                        adapt_mass=adapt_mass)
    for who, w in (("jax", wj), ("torch", wt)):
        _hold_moments(w, np.zeros(cov.shape[0]), np.diag(cov), f"{who} {name}")


def test_nuts_dense_metric_whitens_the_correlated_target():
    """The dense metric's ESS beats the diagonal one's on the correlated
    target, in the port as in the JAX package (tests/test_nuts.py)."""
    kw = dict(num_samples=200, num_warmup=200, num_chains=4, max_depth=6)
    ess = {}
    for m in ("dense", "diag"):
        s, _ = topt.sample_nuts(_gaussian(_CORRELATED, torch),
                                {"w": torch.zeros(2, dtype=torch.float64)},
                                torch.Generator().manual_seed(0), adapt_mass=m, **kw)
        ess[m] = min(topt.effective_sample_size(s["w"][..., i]) for i in range(2))
        if m == "dense":
            for i in range(2):
                assert topt.potential_scale_reduction(s["w"][..., i]) < 1.05
    assert ess["dense"] > 1.5 * ess["diag"], ess


def test_hmc_moments_match_exact_in_both_packages():
    kw = dict(num_samples=300, num_warmup=100, n_leapfrog=8, num_chains=2)
    for cov in (_STANDARD, np.asarray([[1.0, 0.6], [0.6, 1.0]])):
        d = cov.shape[0]
        sj_, lpj, aj = jopt.sample_hmc(_gaussian(cov, jnp), {"w": jnp.zeros(d)},
                                       jax.random.PRNGKey(1), **kw)
        st_, lpt, at = topt.sample_hmc(_gaussian(cov, torch),
                                       {"w": torch.zeros(d, dtype=torch.float64)},
                                       torch.Generator().manual_seed(1), **kw)
        assert lpt.shape == lpj.shape == (2, 300) and st_["w"].shape == (2, 300, d)
        assert 0.2 < at <= 1.0 and 0.2 < aj <= 1.0
        for who, w in (("jax", np.asarray(sj_["w"])), ("torch", np_(st_["w"]))):
            _hold_moments(w, np.zeros(d), np.diag(cov), f"{who} hmc d={d}")


def _gp_logpost(M, B, x, y):
    """``bench.py:bench_nuts``'s log-posterior for the package ``M`` with
    the array module ``B``."""
    x, y = B.asarray(x), B.asarray(y)

    def logpost(p):
        f = M.GP(B.exp(p["log_s2"]) * M.EQ().stretch(B.exp(p["log_ell"])))
        lp = f.measure.logpdf(f(x, B.exp(p["log_noise"])), y)
        return lp - 0.5 * (p["log_ell"] ** 2 + p["log_s2"] ** 2 + p["log_noise"] ** 2)

    return logpost


def test_nuts_gp_posterior_means_agree_between_packages():
    r = np.random.RandomState(0)
    n = 25
    x = np.sort(r.rand(n)) * 6
    y = np.sin(x) + 0.15 * r.randn(n)
    init = {"log_ell": 0.0, "log_s2": 0.0, "log_noise": np.log(0.15)}
    kw = dict(num_samples=120, num_warmup=100, num_chains=2, max_depth=5, adapt_mass="dense")
    sj_, _ = jopt.sample_nuts(_gp_logpost(sj, jnp, x, y),
                              {k: jnp.asarray(v) for k, v in init.items()},
                              jax.random.PRNGKey(0), **kw)
    st_, accept = topt.sample_nuts(_gp_logpost(st, torch, x, y),
                                   {k: torch.tensor(v, dtype=torch.float64)
                                    for k, v in init.items()},
                                   torch.Generator().manual_seed(0), **kw)
    assert accept > 0.4
    for k in init:
        mj, se_j, _, _ = _mc_se(np.asarray(sj_[k]))
        mt, se_t, _, _ = _mc_se(np_(st_[k]))
        assert abs(mj - mt) <= SIGMAS * np.hypot(se_j, se_t), (k, mj, mt, se_j, se_t)
        assert topt.potential_scale_reduction(st_[k]) < 1.2, k


def test_nuts_n2000_entry_runs_at_a_small_size():
    samples, accept = E.nuts_n2000(0, device="cpu", n=20, num_chains=2, num_warmup=30,
                                   num_samples=10, max_depth=3)
    assert set(samples) == {"log_ell", "log_s2", "log_noise"}
    assert all(v.shape == (2, 10) and bool(torch.isfinite(v).all()) for v in samples.values())
    assert 0.0 < accept <= 1.0
    assert st.config.adaptive_jitter is False  # Restored after the run.


def test_samplers_refuse_a_mesh():
    lp = lambda p: -0.5 * torch.sum(p["w"] ** 2)  # noqa: E731
    init = {"w": torch.zeros(2, dtype=torch.float64)}
    with pytest.raises(NotImplementedError, match="item 12"):
        topt.sample_nuts(lp, init, torch.Generator(), mesh=object())
    with pytest.raises(NotImplementedError, match="item 12"):
        topt.sample_hmc(lp, init, torch.Generator(), mesh=object())


def test_nuts_warmup_schedule_matches_jax():
    from stheno_tpu.opt import nuts as jnuts
    from stheno_torch.opt import nuts as tnuts

    for w in (10, 40, 150, 192, 300, 1000):
        for a, b in zip(tnuts._warmup_schedule(w), jnuts._warmup_schedule(w)):
            np.testing.assert_array_equal(a, b)


def _diagnostic_arrays():
    r = np.random.RandomState(0)
    ar = np.zeros((4, 2000))
    eps = r.randn(4, 2000)
    for t in range(1, 2000):
        ar[:, t] = 0.9 * ar[:, t - 1] + np.sqrt(1 - 0.81) * eps[:, t]
    anti = np.empty((1, 2000))
    anti[0, 0::2], anti[0, 1::2] = ar[0, :1000], -ar[0, :1000]
    return {
        "iid": r.randn(4, 800),
        "ar1": ar,
        "split": np.concatenate([r.randn(2, 500) - 5.0, r.randn(2, 500) + 5.0]),
        "one_chain": r.randn(300),
        "antithetic": anti,
        "stuck_diff": np.stack([np.full(100, 1.0), np.full(100, 3.0)]),
        "stuck_same": np.stack([np.full(100, 2.0), np.full(100, 2.0)]),
    }


@pytest.mark.parametrize("name", sorted(_diagnostic_arrays()))
def test_diagnostics_match_jax(name):
    x = _diagnostic_arrays()[name]
    for fn in ("effective_sample_size", "potential_scale_reduction"):
        want = getattr(jopt, fn)(x)
        np.testing.assert_allclose(getattr(topt, fn)(x), want, rtol=1e-12)
        np.testing.assert_allclose(getattr(topt, fn)(torch.tensor(x)), want, rtol=1e-12)
