"""The port's amortised serving (variance cache, cached posterior queries,
``AmortisedPosterior``) against the JAX package on the same state; the
slice's entry points (``stheno_torch.entry``, the matrix-free path of
``bench.py:bench_iterative_262k``) against the JAX calls of that benchmark
at a small N; and the guard that the port imports without JAX.

float64 throughout. With the same basis both packages solve the same
systems: agreement to the solves' accuracy (rtol 1e-7). Where each
package draws its own random numbers (the benchmark's keys against the
port's generators), both are held to the dense exact posterior and NLML
instead, with the tolerance of the estimator stated where it is used.
"""

import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
from stheno_tpu import iterative as jit_
from stheno_torch import entry as E
from stheno_torch import iterative as tit
from stheno_torch.convert import precond_state_from_jax, variance_cache_from_jax
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401
from tests.test_torch_iterative import BLOCK, N, J, T, _data, kf_j, kf_t, pj, pt

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOLVE = 1e-7


@pytest.fixture(scope="module")
def jserving():
    """The JAX package's state (rank 60), cache on that basis, and
    weights, at the shared parameters."""
    x, y = _data()
    state = jit_.eig_precond_state(kf_j, pj(), J(x), 60, jax.random.PRNGKey(5), block=BLOCK)
    cache = jit_.variance_cache(kf_j, pj(), J(x), 0.1, rank=60, precond_state=state,
                                cg_tol=1e-10, max_cg_iters=100, block=BLOCK)
    alpha, _ = jit_.posterior_weights(kf_j, pj(), J(x), J(y), 0.1, cg_tol=1e-10,
                                      precond_state=state, block=BLOCK)
    return state, cache, alpha


def _state(jstate):
    return precond_state_from_jax([np.asarray(a) for a in jstate], device="cpu")


@pytest.mark.parametrize("tail", ["conservative", "zero"])
@pytest.mark.parametrize("refine", [True, False])
def test_variance_cache_on_the_same_basis_matches_jax(tail, refine, jserving):
    x, _ = _data()
    state = jserving[0]
    cj = jit_.variance_cache(kf_j, pj(), J(x), 0.1, rank=60, precond_state=state,
                             refine=refine, cg_tol=1e-10, max_cg_iters=100, block=BLOCK,
                             tail=tail)
    ct = tit.variance_cache(kf_t, pt(), T(x), 0.1, rank=60, precond_state=_state(state),
                            refine=refine, cg_tol=1e-10, max_cg_iters=100, block=BLOCK,
                            tail=tail)
    for name in ("U", "S", "M", "noise", "tau"):
        np.testing.assert_allclose(np_(getattr(ct, name)), np_(getattr(cj, name)),
                                   rtol=SOLVE, atol=1e-9, err_msg=name)


def test_variance_cache_widens_a_narrow_state_and_needs_a_generator(jserving):
    x, _ = _data()
    st_ = _state(jserving[0])
    with pytest.warns(UserWarning, match="rank 60 < requested rank 80"):
        narrow = tit.variance_cache(kf_t, pt(), T(x), 0.1, rank=80, precond_state=st_,
                                    block=BLOCK)
    assert narrow.U.shape == (N, 60)
    wide = tit.variance_cache(kf_t, pt(), T(x), 0.1, rank=80, precond_state=st_,
                              generator=torch.Generator().manual_seed(1), block=BLOCK)
    assert wide.U.shape == (N, 80)
    with pytest.raises(ValueError, match="generator"):
        tit.variance_cache(kf_t, pt(), T(x), 0.1, rank=8)


@pytest.mark.parametrize("chunk", [1024, 16])
def test_cached_posterior_queries_match_jax(chunk, jserving):
    x, _ = _data()
    _, cache, alpha = jserving
    ct = variance_cache_from_jax([np.asarray(a) for a in cache], device="cpu")
    xn = np.linspace(-1.0, 11.0, 41)
    vj = jit_.cached_posterior_var(kf_j, pj(), J(x), cache, J(xn), chunk=chunk)
    vt = tit.cached_posterior_var(kf_t, pt(), T(x), ct, T(xn), chunk=chunk)
    np.testing.assert_allclose(np_(vt), np_(vj), rtol=1e-9, atol=1e-12)
    vj_raw = jit_.cached_posterior_var(kf_j, pj(), J(x), cache, J(xn), chunk=chunk, clamp=False)
    vt_raw = tit.cached_posterior_var(kf_t, pt(), T(x), ct, T(xn), chunk=chunk, clamp=False)
    np.testing.assert_allclose(np_(vt_raw), np_(vj_raw), rtol=1e-9, atol=1e-12)
    mj, vj2 = jit_.cached_posterior_mean_var(kf_j, pj(), J(x), alpha, cache, J(xn), chunk=chunk)
    mt, vt2 = tit.cached_posterior_mean_var(kf_t, pt(), T(x), T(alpha), ct, T(xn), chunk=chunk)
    np.testing.assert_allclose(np_(mt), np_(mj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(vt2), np_(vj2), rtol=1e-9, atol=1e-12)


def test_amortised_posterior_matches_jax(jserving):
    x, y = _data()
    state = jserving[0]
    kw = dict(rank=60, cg_tol=1e-10, var_cg_tol=1e-10, var_max_cg_iters=100, block=BLOCK,
              chunk=32)
    pj_ = jit_.AmortisedPosterior(kf_j, pj(), J(x), J(y), 0.1, precond_state=state, **kw)
    pt_ = tit.AmortisedPosterior(kf_t, pt(), T(x), T(y), 0.1, precond_state=_state(state), **kw)
    assert pt_.solve_info["iters"] == int(pj_.solve_info["iters"])
    xn = np.linspace(-0.5, 10.5, 50)  # not a multiple of the buckets
    for name in ("mean", "var"):
        np.testing.assert_allclose(np_(getattr(pt_, name)(T(xn))), np_(getattr(pj_, name)(J(xn))),
                                   rtol=SOLVE, atol=1e-9, err_msg=name)
    for a, b in zip(pt_.marginal_credible_bounds(T(xn)), pj_.marginal_credible_bounds(J(xn))):
        np.testing.assert_allclose(np_(a), np_(b), rtol=SOLVE, atol=1e-8)
    assert pt_.mean(T(xn[:3])).shape == (3,)


# ---------------------------------------------------------------------------
# The slice: the entry points against bench.py's calls at a small N.

SMALL_N = 300


def _dense_exact(x, y, params, x_new):
    """The exact NLML with its gradient, and the posterior, by dense
    float64 linear algebra on the same model."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    s2, ell = torch.exp(p["log_s2"]), torch.exp(p["log_ell"])

    def gram(a, b):
        return s2 * torch.exp(-0.5 * (a[:, None] - b[None, :]) ** 2 / ell**2)

    A = gram(x, x) + 0.1 * torch.eye(len(x), dtype=x.dtype)
    L = torch.linalg.cholesky(A)
    a = torch.cholesky_solve(y[:, None], L)[:, 0]
    nlml = 0.5 * (y @ a + 2 * torch.log(torch.diagonal(L)).sum() + len(x) * math.log(2 * math.pi))
    grads = torch.autograd.grad(nlml, list(p.values()))
    with torch.no_grad():
        Ks = gram(x_new, x)
        mean = Ks @ a
        var = s2 - torch.sum(Ks * torch.cholesky_solve(Ks.T, L).T, dim=1)
    return nlml.detach(), dict(zip(p, grads)), mean, var


@pytest.fixture(scope="module")
def jbench():
    """bench.py:bench_iterative_262k's calls, at N = 300 in float64."""
    n = SMALL_N
    r = np.random.RandomState(0)
    x = jnp.asarray(np.sort(r.rand(n).astype(np.float64)) * 10)
    y = jnp.sin(x) + 0.1 * jnp.asarray(r.randn(n).astype(np.float64))
    kf = lambda p: jnp.exp(p["log_s2"]) * sj.EQ().stretch(jnp.exp(p["log_ell"]))  # noqa: E731
    params = {"log_s2": jnp.asarray(0.0), "log_ell": jnp.asarray(0.0)}
    state = jit_.eig_precond_state(kf, params, x, 64, jax.random.PRNGKey(7), block=128)
    out = {"x": x, "y": y, "state": state}
    steps = (("fresh", 16, dict(precond_rank=64)), ("amortised", 16, dict(precond_state=state)),
             ("probes512", 512, dict(precond_state=state)))
    for name, probes, kw in steps:
        out[name] = jax.value_and_grad(
            lambda p: jit_.iterative_nlml(kf, p, x, y, 0.1, jax.random.PRNGKey(0),
                                          num_probes=probes, cg_tol=1e-2, max_cg_iters=200,
                                          slq_steps=30, block=128, **kw)
        )(params)
    out["alpha"] = jit_.posterior_weights(kf, params, x, y, 0.1, cg_tol=1e-4, max_cg_iters=200,
                                          precond_state=state, block=128)[0]
    x_new = jnp.linspace(0.0, 10.0, 64)
    out["mean"] = jit_.cached_posterior_mean(kf, params, x, out["alpha"], x_new, block=128)
    cache = jit_.variance_cache(kf, params, x, 0.1, rank=256, key=jax.random.PRNGKey(11),
                                power_iters=2, refine=True, cg_tol=1e-3, max_cg_iters=20,
                                block=128)
    out["var"] = jit_.cached_posterior_var(kf, params, x, cache, x_new, chunk=1024)
    return out


def test_iterative_inputs_are_the_benchmark_data(jbench):
    x, y, params = E.iterative_inputs(SMALL_N, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(np_(x), np_(jbench["x"]))
    np.testing.assert_allclose(np_(y), np_(jbench["y"]), rtol=1e-15, atol=1e-15)
    assert set(params) == {"log_s2", "log_ell"} and all(float(v) == 0.0 for v in params.values())
    x32, y32, _ = E.iterative_inputs(SMALL_N, device="cpu")
    assert x32.dtype == y32.dtype == torch.float32


def test_training_steps_match_the_benchmark_and_the_exact_nlml(jbench):
    # Each package draws its own probes, so each is held to the dense
    # exact NLML. The rank-64 eig preconditioner captures this EQ Gram's
    # spectrum above the noise, so the logdet estimate is exact to
    # rounding (value rtol 1e-6; measured 3e-14). The gradients keep the
    # Hutchinson noise of the probes: with the benchmark's 16, rtol 0.5
    # (measured up to 0.26 over seeds); with 512, rtol 0.1 (measured up to
    # 0.055).
    x, y, params = E.iterative_inputs(SMALL_N, device="cpu", dtype=torch.float64)
    ref_v, ref_g, _, _ = _dense_exact(x, y, params, x[:2])
    g = torch.Generator().manual_seed(0)
    state = E.iterative_precond_state(x, params, g, block=128)
    steps = (("fresh", 16, {}, 0.5), ("amortised", 16, {"precond_state": state}, 0.5),
             ("probes512", 512, {"precond_state": state}, 0.1))
    for name, probes, kw, grad_rtol in steps:
        v, grads, info = E.iterative_step(x, y, params, g, block=128, num_probes=probes, **kw)
        vj, gj = jbench[name]
        assert info["cg_converged"]
        for val in (float(v), float(vj)):
            np.testing.assert_allclose(val, float(ref_v), rtol=1e-6, err_msg=name)
        for k in grads:
            for gr in (float(grads[k]), float(gj[k])):
                np.testing.assert_allclose(gr, float(ref_g[k]), rtol=grad_rtol,
                                           err_msg=f"{name} {k}")
    # The top of the state's spectrum is the Gram's, in both packages.
    np.testing.assert_allclose(np_(state[1])[-8:], np.asarray(jbench["state"][1])[-8:], rtol=1e-6)


def test_serving_matches_the_benchmark_and_the_exact_posterior(jbench):
    x, y, params = E.iterative_inputs(SMALL_N, device="cpu", dtype=torch.float64)
    x_new = torch.linspace(0.0, 10.0, 64, dtype=torch.float64)
    state = _state(jbench["state"])
    # The weights on the same state: the same solve (rtol 1e-7).
    alpha, info = E.serving_weights(x, y, params, state, block=128)
    np.testing.assert_allclose(np_(alpha), np_(jbench["alpha"]), rtol=SOLVE, atol=1e-9)
    mean = E.serving_mean(x, params, alpha, x_new, block=128)
    np.testing.assert_allclose(np_(mean), np_(jbench["mean"]), rtol=SOLVE, atol=1e-9)
    # The variance caches come from each package's own probes; a rank-256
    # basis of this Gram leaves a tail far below the noise, so both match
    # the dense posterior variance to atol 1e-6.
    cache = E.serving_variance_cache(x, params, torch.Generator().manual_seed(11), block=128)
    var = E.serving_var(x, params, cache, x_new)
    _, _, ref_mean, ref_var = _dense_exact(x, y, params, x_new)
    for v in (var, jbench["var"]):
        np.testing.assert_allclose(np_(v), np_(ref_var), atol=1e-6)
    # cg_tol 1e-4 on the whitened weights solve: the mean to 1e-4.
    np.testing.assert_allclose(np_(mean), np_(ref_mean), atol=1e-4)
    bundle = E.serving_bundle(x, y, params, torch.Generator().manual_seed(2),
                              precond_state=state, block=128)
    np.testing.assert_allclose(np_(bundle.mean(x_new)), np_(mean), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np_(bundle.var(x_new)), np_(ref_var), atol=1e-6)


def test_the_port_imports_without_jax():
    # jax and the JAX package are made unimportable before the port loads.
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['stheno_tpu'] = None;"
        "import stheno_torch, stheno_torch.iterative, stheno_torch.entry, stheno_torch.convert;"
        "from stheno_torch.ops import gram_matvec, _build;"
        "assert stheno_torch.iterative.kernel_matvec and gram_matvec.gram_matvec"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
