"""Parity of the port's random features (``stheno_torch/kernels/features.py``)
and pathwise posterior draws (``stheno_torch/model/pathwise.py``) with
``stheno_tpu``, in float64.

``jax.random`` is deterministic, so the tests draw what the JAX package
draws (its frequencies, ``w`` and ``eps``) from the same key splits, here
in the test, and hand those draws to the port's private build-from-draws
functions (``_plan``'s ``build``, ``pathwise._build``): with the same
draws the feature maps agree at rtol 1e-10 for every family the JAX
module covers, and the pathwise draws at rtol 1e-8 under both solvers.
Then the stories of ``tests/test_pathwise.py`` on the port: feature maps
reproduce their kernels, the draws have the closed-form posterior's
moments and are fixed functions, a starved CG warns and reports, the
small-noise solve runs on the compensated operator where the policy asks
for it. With a ``mesh`` (D = 1, 2 and 4 ranks) the draws match the
mesh-free build's, and ``compensated=True`` raises."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu.kernels import features as JF
from stheno_torch.kernels.features import _feature_map_from_draws
from stheno_torch.model import pathwise as TP
import tests.torch_parallel_worker as W
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401


def _close(got, want, rtol, atol=1e-12):
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=rtol, atol=atol)


def jax_feature_draws(k, key, budget, d, dtype=jnp.float64):
    """What ``stheno_tpu.kernels.features.feature_map(k, key, budget, d)``
    draws, nested as the port's ``_plan`` nests its draws: ``_plan``'s
    recursion, with its key splits."""
    from stheno_tpu.kernels import kernel as JK

    if isinstance(k, (JK.ZeroKernel, JK.OneKernel, JK.Linear)):
        return None
    if isinstance(k, JK.SumKernel):
        k1, k2 = jax.random.split(key)
        b = max(2, budget // 2)
        return (jax_feature_draws(k.k1, k1, b, d, dtype), jax_feature_draws(k.k2, k2, b, d, dtype))
    spectral = JF._freq_sampler(k)
    if spectral is None and isinstance(k, JK.ScaledKernel):
        return jax_feature_draws(k.k, key, budget, d, dtype)
    if spectral is not None:
        return spectral[0](key, max(1, budget // 2), d, dtype)
    return jax_feature_draws(k.k, key, budget, JF._warped_dim(k, d, dtype), dtype)


def _torch_draws(draws):
    if draws is None:
        return None
    if isinstance(draws, tuple):
        return tuple(_torch_draws(t) for t in draws)
    return torch.tensor(np.asarray(draws))


FAMILIES = {
    "eq": lambda M: M.EQ(),
    "matern12": lambda M: M.Matern12(),
    "matern32": lambda M: M.Matern32(),
    "matern52": lambda M: M.Matern52(),
    "rq": lambda M: M.RQ(1.5),
    "scaled": lambda M: 2.0 * M.EQ(),
    "stretched": lambda M: M.EQ().stretch(1.5),
    "stretched_per_dim": lambda M: M.Matern32().stretch(np.array([0.7, 1.9])),
    "shifted": lambda M: M.EQ().shift(3.0),
    "product": lambda M: M.EQ() * M.Matern32(),
    "rq_product_scaled": lambda M: 1.3 * (M.RQ(0.7).stretch(2.0) * M.Matern52()),
    "sum_mixed": lambda M: 0.5 * M.EQ() + 0.1 * M.Linear() + 0.2,
    "linear": lambda M: M.Linear(),
    "scaled_linear": lambda M: 3.0 * M.Linear(),
    "one": lambda M: M.OneKernel(),
    "zero": lambda M: M.ZeroKernel(),
    "periodic": lambda M: M.EQ().stretch(1.4).periodic(2.0),
    "select": lambda M: M.Matern12().select(1),
    "transform": lambda M: M.EQ().transform(_square),
}


def _square(x):
    return x**2


@pytest.mark.parametrize("name", list(FAMILIES))
def test_feature_map_matches_jax_with_replayed_draws(name):
    d, budget = 2, 64
    x = np.random.RandomState(0).randn(17, d)
    kj, kt = FAMILIES[name](sj), FAMILIES[name](st)
    key = jax.random.PRNGKey(3)
    if name == "transform":
        # The JAX module lists transform among its warps, but its
        # InputTransformedKernel defines no _warp, so feature_map raises
        # there. The port follows the documented intent: the features of
        # the base kernel at the transformed inputs, held here to the JAX
        # package's EQ features at x**2 from the same draws.
        with pytest.raises(NotImplementedError):
            sj.feature_map(kj, key, budget, d=d, dtype=jnp.float64)
        phi_eq, n_j = sj.feature_map(sj.EQ(), key, budget, d=d, dtype=jnp.float64)
        phi_j = lambda t: phi_eq(_square(t))  # noqa: E731
        kj = sj.EQ()
    else:
        phi_j, n_j = sj.feature_map(kj, key, budget, d=d, dtype=jnp.float64)
    draws = _torch_draws(jax_feature_draws(kj, key, budget, d))
    phi_t, n_t = _feature_map_from_draws(kt, draws, budget, d, torch.float64, "cpu")
    assert n_t == n_j
    out_t, out_j = phi_t(torch.tensor(x)), phi_j(jnp.asarray(x))
    assert tuple(out_t.shape) == out_j.shape == (17, n_j)
    _close(out_t, out_j, rtol=1e-10)


def test_feature_map_draws_from_generator():
    gen = torch.Generator().manual_seed(0)
    phi, n = st.feature_map(st.EQ() + st.Linear(), gen, 32, d=3, dtype=torch.float64)
    x = torch.randn(5, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    # The sum halves the budget: 16 spectral features, then 3 linear ones.
    assert n == 16 + 3 and phi(x).shape == (5, 19) and phi(x).dtype == torch.float64
    again, _ = st.feature_map(st.EQ() + st.Linear(), torch.Generator().manual_seed(0), 32, d=3,
                              dtype=torch.float64)
    _close(again(x), np_(phi(x)), rtol=0, atol=0)  # The generator fixes the map.


def _jax_pathwise_draws(kj, key, n, d, num_samples, num_features):
    """``pathwise_sampler``'s draws from ``key``: the features', ``w`` and
    the unit ``eps``."""
    _, k_feat, k_w, k_eps = jax.random.split(key, 4)
    _, n_feat = sj.feature_map(kj, k_feat, num_features, d, dtype=jnp.float64)
    feats = jax_feature_draws(kj, k_feat, num_features, d)
    w = jax.random.normal(k_w, (n_feat, num_samples), jnp.float64)
    eps = jax.random.normal(k_eps, (n, num_samples), jnp.float64)
    return _torch_draws(feats), torch.tensor(np.asarray(w)), torch.tensor(np.asarray(eps))


@pytest.mark.parametrize("name", ["eq", "sum_mixed", "periodic"])
@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_pathwise_matches_jax_with_replayed_draws(solver, name):
    r = np.random.RandomState(2)
    n, noise = 80, 0.05
    x = np.sort(r.rand(n) * 10)
    y = np.sin(x) + 0.1 * r.randn(n)
    x_new = np.linspace(-1.0, 11.0, 25)
    kj, kt = FAMILIES[name](sj), FAMILIES[name](st)
    opts = dict(num_samples=3, num_features=256, solver=solver, block=32, cg_tol=1e-12,
                max_cg_iters=500, precond_rank=20)
    key = jax.random.PRNGKey(7)
    fn_j, _ = sj.pathwise_sampler(kj, jnp.asarray(x), jnp.asarray(y), noise, key, **opts)
    draws = _jax_pathwise_draws(kj, key, n, 1, 3, 256)
    fn_t, info = TP._build(kt, torch.tensor(x), torch.tensor(y), noise, draws,
                           compensated="auto", **{k: v for k, v in opts.items()
                                                  if k != "num_samples"})
    assert (info is None) == (solver == "chol")
    _close(fn_t(torch.tensor(x_new)), fn_j(jnp.asarray(x_new)), rtol=1e-8, atol=1e-10)


def test_pathwise_sampler_returns_its_generator_and_info():
    x = torch.linspace(0, 10, 30, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    fn, out_gen, info = st.pathwise_sampler(st.EQ(), x, torch.sin(x), 0.1, gen, num_samples=2,
                                            num_features=64, solver="cg", precond_rank=10,
                                            return_info=True)
    assert out_gen is gen and info["rel_residual"] <= 1e-6
    assert fn(torch.linspace(0, 10, 7, dtype=torch.float64)).shape == (7, 2)
    _, _, info = st.pathwise_sampler(st.EQ(), x, torch.sin(x), 0.1, gen, num_features=64,
                                     return_info=True)
    assert info is None  # The dense solver reports nothing.


# --- the stories of tests/test_pathwise.py, on the port ------------------------

KERNELS = ["eq", "scaled", "matern32", "matern12", "rq", "sum_mixed", "product", "periodic",
           "shifted"]
STORY_KERNELS = {
    "scaled": lambda M: 2.0 * M.EQ().stretch(1.5),
    "matern12": lambda M: M.Matern12().stretch(2.0),
}


@pytest.mark.parametrize("name", KERNELS)
def test_feature_map_approximates_kernel(name):
    k = STORY_KERNELS.get(name, FAMILIES[name])(st)
    x = torch.tensor(np.random.RandomState(0).randn(25, 2))
    phi, n_feat = st.feature_map(k, torch.Generator().manual_seed(0), 16384, d=2,
                                 dtype=torch.float64)
    F = phi(x)
    assert F.shape == (25, n_feat)
    err = float((F @ F.T - st.dense(st.pairwise(k, x))).abs().max())
    assert err < 0.08, (name, err)


def test_feature_map_exact_for_finite_bases():
    k = st.Linear() + 2.0
    x = torch.tensor(np.random.RandomState(1).randn(10, 3))
    phi, n_feat = st.feature_map(k, torch.Generator().manual_seed(0), 64, d=3,
                                 dtype=torch.float64)
    assert n_feat == 4  # 3 linear + 1 constant.
    _close(phi(x) @ phi(x).T, np_(st.dense(st.pairwise(k, x))), rtol=1e-10, atol=1e-10)


def test_feature_map_rejects_unsupported():
    with pytest.raises(ValueError, match="random-feature"):
        st.feature_map(st.Delta(), torch.Generator(), 128, d=1)


@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_pathwise_posterior_moments(solver):
    """Empirical moments of many draws against the closed-form posterior
    (the feature and Monte-Carlo tolerances of the JAX test)."""
    r = np.random.RandomState(2)
    x = torch.tensor(np.sort(r.rand(40) * 10))
    noise = 0.1
    k = 1.5 * st.EQ().stretch(1.2)
    f = st.GP(k)
    gen = torch.Generator().manual_seed(0)
    gen, y = f(x, noise).sample(gen)
    y = y[:, 0]
    x_new = torch.linspace(0, 10, 15, dtype=torch.float64)
    sample_fn, gen = st.pathwise_sampler(k, x, y, noise, gen, num_samples=3000,
                                         num_features=4096, solver=solver, block=64)
    draws = np_(sample_fn(x_new))
    assert draws.shape == (15, 3000)
    post = f | (f(x, noise), y)
    mean_ref, var_ref = post(x_new).marginals()
    np.testing.assert_allclose(draws.mean(axis=1), np_(mean_ref), atol=0.08)
    np.testing.assert_allclose(draws.var(axis=1), np_(var_ref), atol=0.08)
    # The off-diagonal covariance too: draws are functions, not marginals.
    assert np.max(np.abs(np.cov(draws) - np_(st.dense(post(x_new).var)))) < 0.1


def test_pathwise_draws_are_functions():
    r = np.random.RandomState(3)
    x = torch.tensor(np.sort(r.rand(30) * 10))
    y = torch.sin(x)
    sample_fn, _ = st.pathwise_sampler(st.EQ(), x, y, 1e-4, torch.Generator().manual_seed(1),
                                       num_samples=3, num_features=2048)
    x_new = torch.linspace(0, 10, 7, dtype=torch.float64)
    _close(sample_fn(x_new), np_(sample_fn(x_new)), rtol=1e-12)  # The same functions.
    _close(sample_fn(x), np_(y)[:, None] * np.ones((1, 3)), rtol=0, atol=0.05)


def test_pathwise_small_build_is_finite():
    # The JAX test builds and evaluates under one jax.jit (test_pathwise_jits);
    # torch runs eagerly, so this is the same build at its sizes.
    x = torch.linspace(0, 10, 20, dtype=torch.float64)
    fn, _ = st.pathwise_sampler(st.EQ(), x, torch.sin(x), 0.01, torch.Generator().manual_seed(0),
                                num_samples=2, num_features=256)
    out = fn(torch.linspace(0, 10, 9, dtype=torch.float64))
    assert out.shape == (9, 2) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("D", [1, 2, 4])
def test_pathwise_mesh_matches_the_mesh_free_build(D, tmp_path_factory):
    """``pathwise_sampler(mesh=...)`` at D ranks (the CG solve's matvecs and
    the evaluation row-sharded, and with the dense solver the evaluation)
    against the mesh-free build on the same draws (rtol 1e-8), the same on
    every rank; ``compensated=True`` raises over a mesh."""
    x = torch.linspace(0.0, 10.0, 64, dtype=torch.float64)
    xn = torch.linspace(-1.0, 11.0, 50, dtype=torch.float64)
    res = W.iter_results("iter_pathwise", D, tmp_path_factory)
    for solver in ("cg", "chol"):
        fn, _ = st.pathwise_sampler(st.EQ(), x, torch.sin(x), 0.1,
                                    torch.Generator().manual_seed(3), num_samples=4,
                                    num_features=256, solver=solver, block=16, cg_tol=1e-10,
                                    max_cg_iters=500, precond_rank=16)
        for r in res:
            np.testing.assert_array_equal(r[f"draws_{solver}"], res[0][f"draws_{solver}"])
        _close(res[0][f"draws_{solver}"], np_(fn(xn)), rtol=1e-8, atol=1e-10)
    assert all("no compensated sharded matvec" in str(r["raised"]) for r in res)


def test_pathwise_mesh_refuses_compensated():
    from stheno_torch.parallel import make_data_mesh

    x = torch.linspace(0, 10, 48, dtype=torch.float64)
    with pytest.raises(ValueError, match="no compensated sharded matvec"):
        st.pathwise_sampler(st.EQ(), x, torch.sin(x), 0.01, torch.Generator(), solver="cg",
                            mesh=make_data_mesh(), compensated=True)


def test_pathwise_small_noise_compensated_is_not_ported():
    # The name is kept from before the compensated solve was ported. In
    # float32 at noise 1e-6 the "auto" policy resolves to the compensated
    # solve (below 1/64 of ||K|| eps sqrt(N)), which now runs, as does an
    # explicit compensated=True at ordinary noise; neither stalls at tol
    # 1e-2. (At n=300 the float32 rounding of K v, about eps ||K||, is
    # above noise 1e-6, so no float32 solve gets much further here; the
    # small-noise story at n=512 is in test_torch_compensated.py.)
    from stheno_torch.iterative import pchol

    x = torch.linspace(0, 10, 300, dtype=torch.float32)
    seen = []
    real = pchol.make_whitened_solver

    def spy(*a, **kw):
        solve = real(*a, **kw)
        seen.append(solve.compensated)
        return solve

    for noise, comp in ((1e-6, "auto"), (0.1, True)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            TP.make_whitened_solver = spy
            try:
                fn, _, info = st.pathwise_sampler(
                    st.EQ(), x, torch.sin(x), noise, torch.Generator().manual_seed(0),
                    solver="cg", num_features=64, precond_rank=64, cg_tol=1e-2,
                    max_cg_iters=300, compensated=comp, return_info=True)
            finally:
                TP.make_whitened_solver = real
        out = fn(torch.linspace(0, 10, 9))
        assert out.shape == (9, 1) and bool(torch.isfinite(out).all())
    assert seen == [True, True]


def test_pathwise_cg_stall_warns_and_returns_info():
    """A stalled solve warns and ``return_info`` reports it; a healthy one
    does not warn. The reference's message advises ``compensated=True``
    even on a solve that is already compensated (``ADVICE.md``,
    ``model/pathwise.py:166``); the port's advises it only on a plain
    solve."""
    r = np.random.RandomState(0)
    x = torch.tensor(np.sort(r.rand(120)) * 10)
    y = torch.sin(x)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, _, info = st.pathwise_sampler(
            st.EQ(), x, y, 0.1, torch.Generator().manual_seed(0), num_samples=2, solver="cg",
            cg_tol=1e-14, max_cg_iters=1, precond_rank=0, return_info=True)
    stalls = [str(w.message) for w in rec if "STALLED" in str(w.message)]
    assert stalls and all("compensated=True" in m for m in stalls)
    assert float(info["rel_residual"]) > 1e-14

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        st.pathwise_sampler(
            st.EQ(), x, y, 0.1, torch.Generator().manual_seed(0), num_samples=2, solver="cg",
            cg_tol=1e-30, max_cg_iters=1, precond_rank=16, compensated=True)
    stalls = [str(w.message) for w in rec if "STALLED" in str(w.message)]
    assert stalls and not any("compensated=True" in m for m in stalls)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn, _, info = st.pathwise_sampler(
            st.EQ(), x, y, 0.1, torch.Generator().manual_seed(0), num_samples=2, solver="cg",
            cg_tol=1e-8, max_cg_iters=500, precond_rank=40, return_info=True)
    assert not any("STALLED" in str(w.message) for w in rec)
    assert float(info["rel_residual"]) <= 1e-8
    assert fn(torch.linspace(0, 10, 7, dtype=torch.float64)).shape == (7, 2)


def test_pathwise_stall_warning_trips_on_nan():
    # `not (rel <= tol)`: a NaN residual (a diverged solve) warns too.
    with pytest.warns(UserWarning, match="STALLED"):
        TP._stall_warning({"rel_residual": torch.tensor(float("nan")), "iters": 3}, 1e-6)


def test_pathwise_entry_points():
    from stheno_torch import entry as E

    x, y = E.pathwise_262k_inputs(n=300, dtype=torch.float64)
    xr = np.sort(np.random.RandomState(0).rand(300)) * 10
    _close(x, xr, rtol=0, atol=0)
    fn, info = E.pathwise_build(x, y, torch.Generator().manual_seed(0), block=128)
    assert info["rel_residual"] <= 1e-4
    fn_chol, _ = E.pathwise_build(x, y, torch.Generator().manual_seed(0), solver="chol")
    x_new = torch.linspace(-1.0, 11.0, 64, dtype=torch.float64)
    a, b = fn(x_new), fn_chol(x_new)
    assert a.shape == (64, 8)
    # The same draws, two solvers: they agree to the CG's tolerance.
    assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max())
