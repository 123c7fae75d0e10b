"""Parity of the port's matrix-free path (``stheno_torch.iterative``) with
``stheno_tpu.iterative``: each function against its JAX counterpart on the
same numpy inputs, in float64 at small sizes (n <= 300, block 64 with a
ragged tail), and the stochastic NLML core with the same probes drawn by
numpy. Where randomness is involved, both packages get the same draws.

Tolerances: the two packages run the same float64 algorithms, so direct
computations agree to rounding (rtol 1e-10). Iterative solves at a tight
tolerance agree to the solve's accuracy (rtol 1e-7); their iteration
counts and recorded CG coefficients agree exactly or to rounding.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu import iterative as jit_
from stheno_tpu.iterative import nlml as jnlml
from stheno_torch import iterative as tit
from stheno_torch.convert import precond_state_from_jax
from stheno_torch.iterative import nlml as tnlml
from stheno_torch.ops import gram_matvec as tgmv
from stheno_torch.ops import gram_matvec_vjp as tvjp
from tests.test_torch_helpers import np_, spd, torch_cpu  # noqa: F401

EXACT = 1e-10
SOLVE = 1e-7
N, BLOCK = 150, 64  # three row blocks, the last ragged


def _data(n=N, seed=0):
    r = np.random.RandomState(seed)
    x = np.sort(r.rand(n) * 10)
    return x, np.sin(x) + 0.1 * r.randn(n)


def kf_j(p):
    return jnp.exp(p["log_s2"]) * sj.EQ().stretch(jnp.exp(p["log_ell"]))


def kf_t(p):
    return torch.exp(p["log_s2"]) * st.EQ().stretch(torch.exp(p["log_ell"]))


PARAMS = {"log_s2": 0.2, "log_ell": -0.1}


def pj(params=PARAMS):
    return {k: jnp.asarray(v) for k, v in params.items()}


def pt(params=PARAMS, grad=False):
    return {k: torch.tensor(v, dtype=torch.float64, requires_grad=grad) for k, v in params.items()}


def T(a):
    return torch.tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _mv(pkg, k, x, block=BLOCK, noise=None):
    return lambda v: pkg.kernel_matvec(k, x, v, noise=noise, block=block)


@pytest.fixture(scope="module")
def jstate():
    """The JAX package's eig-preconditioner state at PARAMS (rank 40)."""
    x, _ = _data()
    return jit_.eig_precond_state(kf_j, pj(), J(x), 40, jax.random.PRNGKey(3), block=BLOCK)


# ---------------------------------------------------------------------------
# kernel_matvec


KERNELS = {
    # Fused form (K3 on the card, its plain version here): scale over
    # stretch over EQ, a periodic warp to d = 2, and a Matérn leaf.
    "scaled_eq": (lambda M: 1.7 * M.EQ().stretch(0.8)),
    "periodic": (lambda M: M.EQ().stretch(2.0).periodic(1.3)),
    "matern32": (lambda M: 0.5 * M.Matern32().shift(0.2)),
    # Not fused: a sum takes the blocked sweep.
    "sum": (lambda M: M.Matern52() + 0.3 * M.EQ()),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("noise", [None, "scalar", "vector"])
def test_kernel_matvec_square_matches_jax(name, noise):
    x, _ = _data()
    r = np.random.RandomState(1)
    v = r.randn(N, 3)
    nz = {None: None, "scalar": 0.1, "vector": 0.05 + r.rand(N)}[noise]
    ref = jit_.kernel_matvec(KERNELS[name](sj), J(x), J(v), noise=None if nz is None else J(nz),
                             block=BLOCK)
    out = tit.kernel_matvec(KERNELS[name](st), T(x), T(v), noise=None if nz is None else T(nz),
                            block=BLOCK)
    np.testing.assert_allclose(np_(out), np_(ref), rtol=EXACT, atol=1e-12)
    # A 1-D v round-trips its shape.
    out1 = tit.kernel_matvec(KERNELS[name](st), T(x), T(v[:, 0]), block=BLOCK)
    ref1 = jit_.kernel_matvec(KERNELS[name](sj), J(x), J(v[:, 0]), block=BLOCK)
    assert out1.shape == (N,)
    np.testing.assert_allclose(np_(out1), np_(ref1), rtol=EXACT, atol=1e-12)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matvec_cross_matches_jax(name):
    x, _ = _data()
    xc = np.linspace(-1.0, 11.0, 70)
    v = np.random.RandomState(2).randn(70, 2)
    ref = jit_.kernel_matvec(KERNELS[name](sj), J(x), J(v), x_cols=J(xc), block=BLOCK)
    out = tit.kernel_matvec(KERNELS[name](st), T(x), T(v), x_cols=T(xc), block=BLOCK)
    np.testing.assert_allclose(np_(out), np_(ref), rtol=EXACT, atol=1e-12)


@pytest.fixture
def route_spies(monkeypatch):
    """Records of the fused routes: the kinds K3 ran for a product with no
    gradient (``gram_matvec`` in ``iterative.matvec``), the kinds
    ``_GramMatvecFn`` ran for a differentiable one, the kinds
    ``_GramBilinearFn`` ran for a bilinear form, and the calls of the
    fused Gram-gradient wrapper in their backward or forward."""
    from stheno_torch.iterative import matvec as tmv

    calls = {"k3": [], "fn": [], "vjp": [], "bil": []}
    real_k3, real_vjp, real_fn = tgmv.gram_matvec, tvjp.gram_matvec_vjp, tvjp._GramMatvecFn
    real_bil = tvjp._GramBilinearFn

    def k3(*a, **kw):
        calls["k3"].append(a[0])
        return real_k3(*a, **kw)

    def vjp(*a, **kw):
        calls["vjp"].append(a[0])
        return real_vjp(*a, **kw)

    class Fn(real_fn):
        @staticmethod
        def forward(ctx, *a):
            calls["fn"].append(a[-1])
            return real_fn.forward(ctx, *a)

    class Bil(real_bil):
        @staticmethod
        def forward(ctx, *a):
            calls["bil"].append(a[-1])
            return real_bil.forward(ctx, *a)

    monkeypatch.setattr(tmv, "gram_matvec", k3)
    monkeypatch.setattr(tmv, "_GramMatvecFn", Fn)
    monkeypatch.setattr(tmv, "_GramBilinearFn", Bil)
    monkeypatch.setattr(tvjp, "gram_matvec_vjp", vjp)
    return calls


def test_kernel_matvec_dispatch_by_expression_and_gradient(route_spies):
    calls = route_spies
    x, v = T(_data()[0]), T(np.ones((N, 2)))
    tit.kernel_matvec(KERNELS["scaled_eq"](st), x, v, block=BLOCK)
    tit.kernel_matvec(KERNELS["periodic"](st), x, v, block=BLOCK)
    assert calls == {"k3": ["eq", "eq"], "fn": [], "vjp": [], "bil": []}
    tit.kernel_matvec(KERNELS["sum"](st), x, v, block=BLOCK)  # Not a fused form.
    with st.config.accurate_dists():
        tit.kernel_matvec(KERNELS["scaled_eq"](st), x, v, block=BLOCK)
    assert calls == {"k3": ["eq", "eq"], "fn": [], "vjp": [], "bil": []}
    # A gradient is needed: the fused form takes _GramMatvecFn, whose
    # backward sweeps both roles of the square Gram in one call.
    ell = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    out = tit.kernel_matvec(st.EQ().stretch(ell), x, v, block=BLOCK)
    assert calls == {"k3": ["eq", "eq"], "fn": ["eq"], "vjp": [], "bil": []}
    torch.autograd.grad(out.sum(), ell)
    assert calls["vjp"] == ["eq"]
    # Under a gradient too, a sum and accurate distances take the blocked
    # sweep, and so do warped inputs wider than the gradient kernel takes.
    tit.kernel_matvec(st.EQ().stretch(ell) + st.Matern32(), x, v, block=BLOCK)
    with st.config.accurate_dists():
        tit.kernel_matvec(st.EQ().stretch(ell), x, v, block=BLOCK)
    wide = T(np.random.RandomState(3).randn(20, tvjp.MAX_DEPTH + 1))
    tit.kernel_matvec(st.EQ().stretch(ell), wide, T(np.ones((20, 1))), block=BLOCK)
    assert calls == {"k3": ["eq", "eq"], "fn": ["eq"], "vjp": ["eq"], "bil": []}
    with torch.no_grad():
        tit.kernel_matvec(st.EQ().stretch(ell), x, v, block=BLOCK)
    assert calls["k3"] == ["eq", "eq", "eq"] and calls["fn"] == ["eq"]


GRAD_KERNELS = {
    # The parameter leaves of kf (scale and stretch), then every entry of
    # KERNELS and an RQ leaf whose alpha is a leaf too; the leaves of kf
    # once more under accurate distances.
    "params": lambda M, p: kf_j(p) if M is sj else kf_t(p),
    **{k: (lambda M, p, k=k: KERNELS[k](M)) for k in sorted(KERNELS)},
    "rq": lambda M, p: 0.9 * M.RQ(p["log_s2"]).stretch(1.1),
    "params_accurate_dists": lambda M, p: kf_j(p) if M is sj else kf_t(p),
}
# The cases the checkpointed blocked sweep differentiates: a sum (no fused
# form) and accurate distances.
BLOCKED = {"sum", "params_accurate_dists"}


@pytest.mark.parametrize("name", sorted(GRAD_KERNELS))
def test_kernel_matvec_gradients_match_jax(name, route_spies):
    # The differentiable product against jax.grad through the JAX package's
    # checkpointed scan: parameter leaves, x and noise. Fused forms take
    # _GramMatvecFn (K3 forward, the fused Gram-gradient plain version
    # backward); the BLOCKED cases take the checkpointed blocked sweep.
    x, _ = _data()
    r = np.random.RandomState(4)
    v, w = r.randn(N, 2), r.randn(N, 2)
    accurate = name == "params_accurate_dists"

    def loss_j(p, xx, noise):
        k = GRAD_KERNELS[name](sj, p)
        return jnp.sum(J(w) * jit_.kernel_matvec(k, xx, J(v), noise=noise, block=BLOCK))

    with sj.config.accurate_dists(accurate):
        gj = jax.grad(loss_j, argnums=(0, 1, 2))(pj(), J(x), jnp.asarray(0.1))
    p_t = pt(grad=True)
    xt = T(x).requires_grad_(True)
    nt = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    with st.config.accurate_dists(accurate):
        out = tit.kernel_matvec(GRAD_KERNELS[name](st, p_t), xt, T(v), noise=nt, block=BLOCK)
        gt = torch.autograd.grad(torch.sum(T(w) * out), [*p_t.values(), xt, nt],
                                 allow_unused=True)
    if name in BLOCKED:
        assert route_spies == {"k3": [], "fn": [], "vjp": [], "bil": []}
    else:
        assert route_spies["fn"] and route_spies["vjp"]
    for a, b in zip(gt, [gj[0][k] for k in p_t] + [gj[1], gj[2]]):
        a = torch.zeros(()) if a is None else a
        np.testing.assert_allclose(np_(a), np_(b), rtol=EXACT, atol=1e-11)


@pytest.mark.parametrize("name", sorted(GRAD_KERNELS))
def test_kernel_bilinear_value_and_gradients_match_jax(name, route_spies):
    # sum(A * ((K + noise I) V)), the form the surrogate differentiates,
    # against jax.value_and_grad of the same sum through the JAX package's
    # checkpointed scan: the value, the parameter leaves, x and noise.
    # Fused forms take _GramBilinearFn (one sweep of the fused
    # Gram-gradient plain version gives value and gradients, no K3
    # product); the BLOCKED cases take the checkpointed blocked sweep.
    from stheno_torch.iterative import matvec as tmv

    x, _ = _data()
    r = np.random.RandomState(16)
    A, V = r.randn(N, 3), r.randn(N, 3)
    accurate = name == "params_accurate_dists"

    def loss_j(p, xx, noise):
        k = GRAD_KERNELS[name](sj, p)
        return jnp.sum(J(A) * jit_.kernel_matvec(k, xx, J(V), noise=noise, block=BLOCK))

    with sj.config.accurate_dists(accurate):
        vj, gj = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(pj(), J(x), jnp.asarray(0.1))
    p_t = pt(grad=True)
    xt = T(x).requires_grad_(True)
    nt = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    with st.config.accurate_dists(accurate):
        out = tmv._kernel_bilinear(GRAD_KERNELS[name](st, p_t), xt, T(A), T(V), noise=nt,
                                   block=BLOCK)
        gt = torch.autograd.grad(out, [*p_t.values(), xt, nt], allow_unused=True)
    if name in BLOCKED:
        assert route_spies == {"k3": [], "fn": [], "vjp": [], "bil": []}
    else:
        kind = "matern32" if name == "matern32" else "rq" if name == "rq" else "eq"
        assert route_spies == {"k3": [], "fn": [], "vjp": [kind], "bil": [kind]}
    np.testing.assert_allclose(float(out.detach()), float(vj), rtol=EXACT)
    for a, b in zip(gt, [gj[0][k] for k in p_t] + [gj[1], gj[2]]):
        a = torch.zeros(()) if a is None else a
        np.testing.assert_allclose(np_(a), np_(b), rtol=EXACT, atol=1e-11)


# ---------------------------------------------------------------------------
# CG and quadrature


def _spd_operator(n=120, noise=0.3):
    x, _ = _data(n, seed=5)
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + noise * np.eye(n)
    return K


@pytest.mark.parametrize("precond", [False, True])
def test_batched_cg_matches_jax(precond):
    K = _spd_operator()
    b = np.random.RandomState(6).randn(120, 4)
    D = 1.0 / np.diag(K)
    kw = dict(tol=1e-10, max_iters=300, track_tridiag=12)
    sj_, ij = jit_.batched_cg(lambda v: J(K) @ v, J(b),
                              precond=(lambda r: J(D)[:, None] * r) if precond else None, **kw)
    st_, it_ = tit.batched_cg(lambda v: T(K) @ v, T(b),
                              precond=(lambda r: T(D)[:, None] * r) if precond else None, **kw)
    np.testing.assert_allclose(np_(st_), np_(sj_), rtol=SOLVE, atol=1e-10)
    assert it_["iters"] == int(ij["iters"])
    # The final residual sits in the rounding regime: both below tol.
    assert float(it_["rel_residual"]) <= 1e-10 and float(ij["rel_residual"]) <= 1e-10
    for a, b_ in zip(it_["tridiag"][:2], ij["tridiag"][:2]):
        np.testing.assert_allclose(np_(a), np_(b_), rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(np_(it_["tridiag"][2]), np_(ij["tridiag"][2]))


def test_batched_cg_vector_rhs_warm_start_and_min_iters():
    K = _spd_operator(60)
    b = np.random.RandomState(7).randn(60)
    x0 = 0.1 * np.ones(60)
    kw = dict(tol=1e-3, max_iters=100, min_iters=9)
    sj_, ij = jit_.batched_cg(lambda v: J(K) @ v, J(b), x0=J(x0), **kw)
    st_, it_ = tit.batched_cg(lambda v: T(K) @ v, T(b), x0=T(x0), **kw)
    assert st_.shape == (60,)
    assert it_["iters"] == int(ij["iters"]) >= 9
    np.testing.assert_allclose(np_(st_), np_(sj_), rtol=1e-9, atol=1e-12)


def test_lanczos_and_slq_logdet_match_jax():
    # A spread spectrum (B B^T / n + I) keeps 12 steps away from Krylov
    # exhaustion, where Lanczos amplifies rounding differences.
    K = spd(100, seed=8)
    z = np.random.RandomState(8).randn(100, 5)
    aj, bj = jit_.lanczos(lambda v: J(K) @ v, J(z), 12)
    at, bt = tit.lanczos(lambda v: T(K) @ v, T(z), 12)
    np.testing.assert_allclose(np_(at), np_(aj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_(bt), np_(bj), rtol=1e-9, atol=1e-12)
    lj = jit_.slq_logdet(lambda v: J(K) @ v, J(z), num_steps=12)
    lt = tit.slq_logdet(lambda v: T(K) @ v, T(z), num_steps=12)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-9)


def test_cg_quadrature_logdet_matches_jax():
    from stheno_tpu.iterative.slq import cg_quadrature_logdet as jcq
    from stheno_torch.iterative.slq import cg_quadrature_logdet as tcq

    r = np.random.RandomState(9)
    a = 0.5 + r.rand(10, 4)
    b = 0.3 * r.rand(10, 4)
    steps = np.array([10, 7, 3, 1], np.int32)
    norms = 1.0 + r.rand(4)
    ref = jcq(J(a), J(b), jnp.asarray(steps), J(norms))
    out = tcq(T(a), T(b), torch.tensor(steps), T(norms))
    np.testing.assert_allclose(float(out), float(ref), rtol=EXACT)


# ---------------------------------------------------------------------------
# Preconditioners and the whitened solver


def test_pivoted_cholesky_and_woodbury_match_jax():
    x, _ = _data()
    Lj = jit_.pivoted_cholesky(sj.EQ(), J(x), 25)
    Lt = tit.pivoted_cholesky(st.EQ(), T(x), 25)
    # Entries of order 1: atol 1e-10 covers the rounding of the residual
    # rows that both subtract.
    np.testing.assert_allclose(np_(Lt), np_(Lj), rtol=1e-9, atol=1e-10)
    r = np.random.RandomState(10).randn(N, 2)
    Pj = jit_.woodbury_preconditioner(Lj, 0.1)(J(r))
    Pt = tit.woodbury_preconditioner(Lt, 0.1)(T(r))
    np.testing.assert_allclose(np_(Pt), np_(Pj), rtol=1e-8, atol=1e-10)
    from stheno_tpu.iterative.pchol import preconditioner_sqrt_ops as jsq
    from stheno_torch.iterative.pchol import preconditioner_sqrt_ops as tsq

    for a, b in zip(tsq(Lt, 0.1)[:2], jsq(Lj, 0.1)[:2]):
        np.testing.assert_allclose(np_(a(T(r))), np_(b(J(r))), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(tsq(Lt, 0.1)[2]), float(jsq(Lj, 0.1)[2]), rtol=EXACT)


def test_eig_preconditioner_factors_and_ops_match_jax():
    x, _ = _data()
    om = np.random.RandomState(11).randn(N, 20)
    Uj, lj = jit_.eig_preconditioner_factors(_mv(jit_, sj.EQ(), J(x)), J(om), 2)
    Ut, lt = tit.eig_preconditioner_factors(_mv(tit, st.EQ(), T(x)), T(om), 2)
    np.testing.assert_allclose(np_(lt), np_(lj), rtol=1e-9, atol=1e-12)
    # The eigenvectors are defined up to sign: compare the projector.
    np.testing.assert_allclose(np_(Ut @ Ut.T), np_(Uj @ Uj.T), atol=1e-9)
    v = np.random.RandomState(12).randn(N, 3)
    ops_j = jit_.eig_preconditioner_ops(Uj, lj, 0.1, N)
    ops_t = tit.eig_preconditioner_ops(Ut, lt, 0.1, N)
    for a, b in zip(ops_t[:3], ops_j[:3]):
        np.testing.assert_allclose(np_(a(T(v))), np_(b(J(v))), rtol=1e-8, atol=1e-10)
        assert a(T(v[:, 0])).shape == (N,)
    np.testing.assert_allclose(float(ops_t[3]), float(ops_j[3]), rtol=EXACT)


def test_make_whitened_solver_matches_jax(jstate):
    x, y = _data()
    state = precond_state_from_jax([np.asarray(a) for a in jstate], device="cpu")
    sol_j, info_j = jit_.make_whitened_solver(
        _mv(jit_, kf_j(pj()), J(x)), N, jnp.asarray(0.1), 40, state=jstate
    )(J(np.c_[y, np.cos(x)]), tol=1e-10, max_iters=200, true_residual=True)
    solve_t = tit.make_whitened_solver(
        _mv(tit, kf_t(pt()), T(x)), N, torch.tensor(0.1, dtype=torch.float64), 40, state=state
    )
    sol_t, info_t = solve_t(T(np.c_[y, np.cos(x)]), tol=1e-10, max_iters=200, true_residual=True)
    assert solve_t.compensated is False
    np.testing.assert_allclose(np_(sol_t), np_(sol_j), rtol=SOLVE, atol=1e-9)
    assert info_t["iters"] == int(info_j["iters"])
    assert float(info_t["rel_residual_true"]) < 1e-8


# ---------------------------------------------------------------------------
# The NLML core with shared probes


def _core_case(precond, jstate):
    x, y = _data()
    r = np.random.RandomState(13)
    u = r.randn(N, 6)
    om = r.randn(N, 40) if precond == "eig" else None
    pstate = jstate if precond == "state" else None
    method = "pivoted" if precond == "pivoted" else "eig"
    return x, y, u, om, pstate, method


@pytest.mark.parametrize("precond", ["eig", "state", "pivoted"])
def test_nlml_core_value_and_gradients_match_jax(precond, jstate, route_spies):
    x, y, u, om, pstate, method = _core_case(precond, jstate)
    common = (1e-10, 400, 60, 40)  # cg_tol, max_cg_iters, quad_steps, precond_rank

    def mv_fn(k, xx, v, nz):
        return jit_.kernel_matvec(k, xx, v, noise=nz, block=BLOCK)

    def value_j(p, noise, xx, yy):
        val, info = jnlml._nlml(
            p, yy, noise, xx, J(u), None if om is None else J(om), pstate, kf_j, mv_fn, None,
            *common, method, 1, None,
        )
        return val, info

    (vj, hj), gj = jax.value_and_grad(value_j, argnums=(0, 1, 2, 3), has_aux=True)(
        pj(), jnp.asarray(0.1), J(x), J(y)
    )
    p_t = pt(grad=True)
    nt = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    xt, yt = T(x).requires_grad_(True), T(y).requires_grad_(True)
    st_state = None if pstate is None else precond_state_from_jax(
        [np.asarray(a) for a in pstate], device="cpu")
    vt, ht = tnlml._nlml(
        p_t, yt, nt, xt, T(u), None if om is None else T(om), st_state, kf_t, *common, method, 1,
        block=BLOCK,
    )
    assert route_spies["fn"] == []  # The forward solves need no gradient.
    k3_forward = len(route_spies["k3"])
    gt = torch.autograd.grad(vt, [*p_t.values(), nt, xt, yt])
    # The surrogate took the fused route: one bilinear form, one sweep over
    # both roles of the square Gram for its value and its gradients, and
    # no K3 product (neither a plain one nor _GramMatvecFn's forward).
    assert route_spies["bil"] == ["eq"] and route_spies["vjp"] == ["eq"]
    assert route_spies["fn"] == [] and len(route_spies["k3"]) == k3_forward
    # The value and every gradient to the solves' accuracy (rtol 1e-7);
    # the CG ran the same number of steps.
    assert ht["cg_iters"] == int(hj["cg_iters"]) and ht["cg_converged"]
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=SOLVE)
    refs = [gj[0][k] for k in p_t] + [gj[1], gj[2], gj[3]]
    for name, a, b in zip(["log_s2", "log_ell", "noise", "x", "y"], gt, refs):
        np.testing.assert_allclose(np_(a), np_(b), rtol=SOLVE, atol=1e-9, err_msg=name)


def test_iterative_nlml_runs_with_a_generator_and_reports_health():
    x, y = _data()
    p_t = pt(grad=True)
    g = torch.Generator().manual_seed(0)
    val, info = tit.iterative_nlml(kf_t, p_t, T(x), T(y), 0.1, g, num_probes=4, cg_tol=1e-8,
                                   precond_rank=30, block=BLOCK, return_info=True)
    grads = torch.autograd.grad(val, list(p_t.values()))
    assert info["cg_converged"] and info["cg_iters"] > 0
    assert torch.isfinite(val) and all(torch.isfinite(t) for t in grads)


def test_stalled_cg_warns():
    x, y = _data()
    with pytest.warns(RuntimeWarning, match="CG STALLED"):
        _, info = tit.iterative_nlml(kf_t, pt(), T(x), T(y), 0.1, torch.Generator(),
                                     cg_tol=1e-14, max_cg_iters=1, precond_rank=0,
                                     block=BLOCK, return_info=True)
    assert not info["cg_converged"]


# ---------------------------------------------------------------------------
# The posterior


@pytest.fixture(scope="module")
def jweights(jstate):
    x, y = _data()
    return jit_.posterior_weights(kf_j, pj(), J(x), J(y), 0.1, cg_tol=1e-10,
                                  precond_state=jstate, block=BLOCK)


def test_posterior_weights_and_cached_mean_match_jax(jstate, jweights):
    x, y = _data()
    state = precond_state_from_jax([np.asarray(a) for a in jstate], device="cpu")
    alpha_t, info_t = tit.posterior_weights(kf_t, pt(), T(x), T(y), 0.1, cg_tol=1e-10,
                                            precond_state=state, block=BLOCK)
    alpha_j, info_j = jweights
    np.testing.assert_allclose(np_(alpha_t), np_(alpha_j), rtol=SOLVE, atol=1e-8)
    assert info_t["iters"] == int(info_j["iters"])
    xn = np.linspace(-1.0, 11.0, 77)
    mj = jit_.cached_posterior_mean(kf_j, pj(), J(x), alpha_j, J(xn), block=BLOCK)
    mt = tit.cached_posterior_mean(kf_t, pt(), T(x), alpha_t, T(xn), block=BLOCK)
    np.testing.assert_allclose(np_(mt), np_(mj), rtol=SOLVE, atol=1e-8)


@pytest.mark.parametrize("precond", ["rank", "none"])
def test_posterior_weights_fresh_and_plain_cg_match_jax(precond):
    # Without a state the whitened solver draws its own subspace block
    # (different numbers in the two packages); at cg_tol 1e-10 both land
    # on the same weights. Vector noise takes plain CG in both.
    x, y = _data()
    noise = 0.1 if precond == "rank" else 0.05 + 0.1 * np.random.RandomState(14).rand(N)
    aj, _ = jit_.posterior_weights(kf_j, pj(), J(x), J(y), J(noise), cg_tol=1e-10,
                                   precond_rank=30, block=BLOCK)
    at, _ = tit.posterior_weights(kf_t, pt(), T(x), T(y), T(noise), cg_tol=1e-10,
                                  precond_rank=30, block=BLOCK)
    np.testing.assert_allclose(np_(at), np_(aj), rtol=1e-6, atol=1e-7)


def test_iterative_posterior_mean_matches_jax(jstate):
    x, y = _data()
    xn = np.linspace(0.0, 10.0, 33)
    state = precond_state_from_jax([np.asarray(a) for a in jstate], device="cpu")
    mj, _ = jit_.iterative_posterior_mean(kf_j, pj(), J(x), J(y), 0.1, J(xn), cg_tol=1e-10,
                                          precond_state=jstate, block=BLOCK)
    mt, _ = tit.iterative_posterior_mean(kf_t, pt(), T(x), T(y), 0.1, T(xn), cg_tol=1e-10,
                                         precond_state=state, block=BLOCK)
    np.testing.assert_allclose(np_(mt), np_(mj), rtol=SOLVE, atol=1e-8)


@pytest.mark.parametrize("mode", ["scan", "host"])
def test_iterative_posterior_var_matches_jax(mode, jstate):
    x, y = _data()
    xn = np.linspace(-1.0, 11.0, 45)  # chunk 20: two full chunks and a padded one
    state = precond_state_from_jax([np.asarray(a) for a in jstate], device="cpu")
    vj = jit_.iterative_posterior_var(kf_j, pj(), J(x), J(y), 0.1, J(xn), cg_tol=1e-10,
                                      precond_state=jstate, block=BLOCK, chunk=20, mode=mode)
    vt = tit.iterative_posterior_var(kf_t, pt(), T(x), T(y), 0.1, T(xn), cg_tol=1e-10,
                                     precond_state=state, block=BLOCK, chunk=20, mode=mode)
    np.testing.assert_allclose(np_(vt), np_(vj), rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# The compensated policy and what is not ported


def test_compensated_policy_matches_jax():
    from stheno_tpu.iterative import compensated as jc

    lam = np.array([3.0, 6.3e4])
    for noise in (0.1, 0.01, 1e-4):
        for comp in ("auto", False, None, True):
            ref = jc.resolve_compensated(comp, noise, J(lam), 262_144, jnp.float32, True)
            out = tit.resolve_compensated(comp, noise, T(lam), 262_144, torch.float32, True)
            assert out == bool(ref)
    assert tit.plain_noise_wall(6.3e4, 262_144, torch.float32) == pytest.approx(
        jc.plain_noise_wall(6.3e4, 262_144, jnp.float32), rel=1e-12)
    assert tit.AUTO_WALL_FACTOR == jc.AUTO_WALL_FACTOR
    assert tit.resolve_compensated("auto", 1e-9, T(lam), 100, torch.float32, False) is False
    with pytest.raises(ValueError):
        tit.resolve_compensated(True, 0.1, T(lam), 100, torch.float32, False)
    with pytest.raises(ValueError):
        tit.resolve_compensated("sometimes", 0.1, T(lam), 100, torch.float32, True)


def test_options_not_ported_raise():
    """The options that raised before this slice ported them now run (the
    name is kept from then); the ``ValueError`` checks stay."""
    x, y = _data(40)
    xt, yt = T(x), T(y)
    v = torch.ones(40, 1, dtype=torch.float64)
    k = st.EQ()
    ref = tit.kernel_matvec(k, xt, v)
    for kw in ({"compensated": True}, {"tile_dtype": torch.bfloat16},
               {"symmetric": True, "block": 16}, {"precision": "default"},
               {"precision": "bfloat16"}, {"precision": "tensorfloat32"}):
        out = tit.kernel_matvec(k, xt, v, **kw)
        assert out.shape == ref.shape
        np.testing.assert_allclose(np_(out), np_(ref), rtol=2e-2, atol=2e-2, err_msg=str(kw))
    with pytest.raises(ValueError):
        tit.kernel_matvec(k, xt, v, precision="fast")
    with pytest.raises(ValueError, match="incompatible"):
        tit.kernel_matvec(k, xt, v, compensated=True, tile_dtype=torch.bfloat16)
    U = torch.linalg.qr(torch.randn(40, 4, dtype=torch.float64))[0]
    lam = torch.ones(4, dtype=torch.float64)
    ops = tit.eig_preconditioner_ops(U, lam, 0.1, 40, compensated=True)
    plain = tit.eig_preconditioner_ops(U, lam, 0.1, 40)
    for a, b in zip(ops[:3], plain[:3]):
        np.testing.assert_allclose(np_(a(v)), np_(b(v)), rtol=1e-12)
    val = tit.iterative_nlml(kf_t, pt(), xt, yt, 0.1, torch.Generator(), compensated=True)
    assert np.isfinite(float(val))
    val = tit.iterative_nlml(kf_t, pt(), xt, yt, 0.1, torch.Generator(),
                             surrogate_tile_dtype=torch.bfloat16)
    assert np.isfinite(float(val))
    # "auto" resolving True (noise far below the wall of the state's Ritz
    # values) runs the compensated solve.
    big = (U, torch.full((4,), 1e12, dtype=torch.float64))
    solver = tit.make_whitened_solver(lambda v_: tit.kernel_matvec(k, xt, v_), 40, 1e-6, 4,
                                      state=big, mv_raw_comp=lambda v_: v_)
    assert solver.compensated is True
    with pytest.raises(ValueError, match="compensated"):
        tit.make_whitened_solver(lambda v_: v_, 40, 1e-6, 4, state=big, compensated=True)
    cache = tit.variance_cache(kf_t, pt(), xt, 0.1, rank=4, generator=torch.Generator(),
                               basis_tile_dtype=torch.bfloat16)
    assert cache.U.shape == (40, 4)


# ---------------------------------------------------------------------------
# The tile options


def test_tile_dtype_matvec_matches_jax():
    """``tile_dtype=bfloat16``: the tile rounded once, ``v`` rounded, the
    product of the rounded operands accumulated in float64, as the JAX
    package's CPU ``matmul(..., preferred_element_type)``; scaled and
    unscaled forms (the latter takes K1's rounded output directly), and a
    cross product."""
    x, _ = _data(120, seed=4)
    v = np.random.RandomState(5).randn(120, 3)
    xq = np.linspace(-1.0, 11.0, 37)
    for kj, kt in ((sj.EQ().stretch(0.9), st.EQ().stretch(0.9)),
                   (1.3 * sj.Matern52(), 1.3 * st.Matern52())):
        out = tit.kernel_matvec(kt, T(x), T(v), block=BLOCK, tile_dtype=torch.bfloat16)
        out_j = jit_.kernel_matvec(kj, J(x), J(v), block=BLOCK, tile_dtype=jnp.bfloat16)
        np.testing.assert_allclose(np_(out), np.asarray(out_j), rtol=1e-12, atol=1e-12)
        cross = tit.kernel_matvec(kt, T(xq), T(v), x_cols=T(x), tile_dtype=torch.bfloat16)
        cross_j = jit_.kernel_matvec(kj, J(xq), J(v), x_cols=J(x), tile_dtype=jnp.bfloat16)
        np.testing.assert_allclose(np_(cross), np.asarray(cross_j), rtol=1e-12, atol=1e-12)
    # About bfloat16's relative rounding of the full product.
    full = np_(tit.kernel_matvec(st.EQ(), T(x), T(v), block=BLOCK))
    low = np_(tit.kernel_matvec(st.EQ(), T(x), T(v), block=BLOCK, tile_dtype=torch.bfloat16))
    err = np.abs(low - full).max() / np.abs(full).max()
    assert 1e-5 < err < 2e-2


def test_tile_dtype_gradient_flows_through_the_rounding():
    # The rounding is the identity to first order (astype's transpose):
    # the gradient of the rounded-tile matvec is close to the full one's.
    x, _ = _data(90, seed=6)
    v = T(np.random.RandomState(7).randn(90, 2))
    grads = []
    for td in (None, torch.bfloat16):
        le = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
        out = tit.kernel_matvec(st.EQ().stretch(torch.exp(le)), T(x), v, block=32, tile_dtype=td)
        (g,) = torch.autograd.grad(torch.sum(out**2), [le])
        grads.append(float(g))
    np.testing.assert_allclose(grads[1], grads[0], rtol=2e-2)


@pytest.mark.parametrize("precision", ["default", "bfloat16", "tensorfloat32"])
def test_low_precision_products(precision):
    """The TPU meaning of the low precisions, on the CPU: bfloat16
    operands (the tile as ``tile_dtype`` rounds it) or TF32 operands (10
    significand bits, to nearest), each product exact and summed in the
    input dtype; within the rounded operands' error of the full product."""
    from stheno_torch.ops.gram_matvec import _tf32

    x, _ = _data(100, seed=8)
    v = np.random.RandomState(9).randn(100, 2)
    out = np_(tit.kernel_matvec(st.EQ(), T(x), T(v), block=BLOCK, precision=precision))
    K = np_(st.dense(st.pairwise(st.EQ(), T(x))))
    if precision == "tensorfloat32":
        def r(a):
            return np_(_tf32(torch.tensor(a, dtype=torch.float32))).astype(np.float64)

        want, bound = r(K) @ r(v), 2e-3
    else:
        want = np_(tit.kernel_matvec(st.EQ(), T(x), T(v), block=BLOCK,
                                     tile_dtype=torch.bfloat16))
        bound = 2e-2
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
    full = K @ v
    assert np.abs(out - full).max() / np.abs(full).max() < bound


def test_symmetric_matvec_parity_and_grad():
    """The upper-triangle sweep equals the row sweep (and the JAX
    package's), through a gradient and with a ragged last block, and the
    operator is exactly symmetric."""
    n = 53
    x = np.linspace(0, 10, n)
    v = np.random.RandomState(0).randn(n, 3)
    out_sym = tit.kernel_matvec(st.EQ(), T(x), T(v), noise=0.1, block=16, symmetric=True)
    out_row = tit.kernel_matvec(st.EQ(), T(x), T(v), noise=0.1, block=16, symmetric=False)
    np.testing.assert_allclose(np_(out_sym), np_(out_row), rtol=1e-12, atol=1e-12)
    out_j = jit_.kernel_matvec(sj.EQ(), J(x), J(v), noise=0.1, block=16, symmetric=True)
    np.testing.assert_allclose(np_(out_sym), np.asarray(out_j), rtol=1e-12, atol=1e-12)

    def f(sym):
        le = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
        out = tit.kernel_matvec(st.EQ().stretch(torch.exp(le)), T(x), T(v), block=16,
                                symmetric=sym)
        (g,) = torch.autograd.grad(torch.sum(out**2), [le])
        return float(g)

    np.testing.assert_allclose(f(True), f(False), rtol=1e-10)
    g_j = jax.grad(lambda p: jnp.sum(jit_.kernel_matvec(
        sj.EQ().stretch(jnp.exp(p)), J(x), J(v), block=16, symmetric=True) ** 2))(0.2)
    np.testing.assert_allclose(f(True), float(g_j), rtol=1e-10)
    x2 = T(np.linspace(0, 10, 32))
    K = np_(tit.kernel_matvec(st.EQ(), x2, torch.eye(32, dtype=torch.float64), block=8,
                              symmetric=True))
    np.testing.assert_array_equal(K, K.T)


def test_iterative_nlml_bf16_surrogate_gradients():
    """bfloat16 tiles in the backward surrogate only: the forward value is
    unchanged, the gradients stay within the stochastic estimator's
    tolerance of the dense gradient (the JAX test's bounds), and the core
    with numpy probes gives the JAX package's bfloat16 surrogate gradient
    (its tiles rounded from the same float64 tiles)."""
    x, y = _data(120)
    kw = dict(num_probes=32, cg_tol=1e-8, slq_steps=30, precond_rank=40, block=64)
    p16, n16 = pt(grad=True), torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    v16 = tit.iterative_nlml(kf_t, p16, T(x), T(y), n16, torch.Generator().manual_seed(0),
                             surrogate_tile_dtype=torch.bfloat16, **kw)
    g16 = torch.autograd.grad(v16, [*p16.values(), n16])
    v32 = tit.iterative_nlml(kf_t, pt(), T(x), T(y), 0.1, torch.Generator().manual_seed(0), **kw)
    np.testing.assert_allclose(float(v16), float(v32), rtol=1e-10)
    pd, nd = pt(grad=True), torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    f = st.GP(kf_t(pd))
    gd = torch.autograd.grad(-f.measure.logpdf(f(T(x), nd), T(y)), [*pd.values(), nd])
    for a, b in zip(g16, gd):
        np.testing.assert_allclose(float(a), float(b), rtol=0.3, atol=0.5)

    r = np.random.RandomState(21)
    u, om = r.randn(120, 8), r.randn(120, 40)
    common = (1e-10, 400, 30, 40)

    def smv_j(k, xx, vv, nz):
        return jit_.kernel_matvec(k, xx, vv, noise=nz, block=64, tile_dtype=jnp.bfloat16)

    def mv_j(k, xx, vv, nz):
        return jit_.kernel_matvec(k, xx, vv, noise=nz, block=64)

    gj = jax.grad(lambda p: jnlml._nlml(
        p, J(y), jnp.asarray(0.1), J(x), J(u), J(om), None, kf_j, mv_j,
        jnlml.make_surrogate_grad(kf_j, smv_j), *common, "eig", 1, None)[0])(pj())

    def smv_t(k, xx, vv, nz):
        return tit.kernel_matvec(k, xx, vv, noise=nz, block=64, tile_dtype=torch.bfloat16)

    p_t = pt(grad=True)
    vt, _ = tnlml._nlml(p_t, T(y), 0.1, T(x), T(u), T(om), None, kf_t, *common, "eig", 1,
                        block=64, surrogate_matvec_fn=smv_t)
    gt = torch.autograd.grad(vt, list(p_t.values()))
    for a, k in zip(gt, p_t):
        np.testing.assert_allclose(float(a), float(gj[k]), rtol=1e-2, err_msg=k)


def test_variance_cache_bf16_basis_build():
    """bfloat16 tiles in the basis build's subspace sweeps: at full rank
    the refined cache is exact to the CG tolerance; at low rank within the
    float32 build's accuracy class (the JAX test's bounds)."""
    x, y = _data(120, seed=9)
    x32, y32 = T(x).float(), T(y).float()
    x_new = torch.linspace(0, 10, 29)
    f = st.GP(st.EQ())
    post = f | (f(T(x), 0.05), T(y))
    _, var_ref = post(x_new.double()).marginals()
    kf = lambda p: st.EQ()  # noqa: E731
    cache = tit.variance_cache(kf, None, x32, 0.05, rank=120,
                               generator=torch.Generator().manual_seed(2), power_iters=2,
                               refine=True, cg_tol=1e-7, max_cg_iters=200, block=64,
                               basis_tile_dtype=torch.bfloat16)
    var = tit.cached_posterior_var(kf, None, x32, cache, x_new)
    np.testing.assert_allclose(np_(var).astype(np.float64), np_(var_ref), rtol=2e-3, atol=1e-5)
    errs = {}
    for td in (torch.bfloat16, None):
        c = tit.variance_cache(kf, None, x32, 0.05, rank=48,
                               generator=torch.Generator().manual_seed(2), power_iters=2,
                               refine=True, block=64, basis_tile_dtype=td)
        v = tit.cached_posterior_var(kf, None, x32, c, x_new)
        errs[td] = np.abs(np_(v).astype(np.float64) - np_(var_ref)).max()
    assert errs[torch.bfloat16] < 5 * max(errs[None], 1e-6)


def test_eig_precond_state_warns_without_a_generator_and_refreshes_like_jax():
    x, _ = _data(50)
    with pytest.warns(UserWarning, match="generator"):
        U, lam = tit.eig_precond_state(kf_t, pt(), T(x), 8, block=16)
    assert U.shape == (50, 8) and bool((lam >= 0).all())
    # A refresh from the same warm-start block is deterministic: it
    # matches the JAX package's.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        U2, lam2 = tit.eig_precond_state(kf_t, pt(), T(x), 8, init=U, block=16)
    Uj, lamj = jit_.eig_precond_state(kf_j, pj(), J(x), 8, init=J(np_(U)), block=16)
    np.testing.assert_allclose(np_(lam2), np_(lamj), rtol=1e-9)
    np.testing.assert_allclose(np_(U2 @ U2.T), np_(Uj @ Uj.T), atol=1e-9)


def test_float32_nlml_gradients_follow_float64():
    # Float32 inputs: the solves run in float32 and the surrogate sweep in
    # float64. Same probes and state, float32 solves at cg_tol 1e-4: the
    # value (a sum of 150 log terms and a quadratic form, each O(1)) to
    # atol 2e-3, the gradients to rtol 1e-3 of the float64 step.
    x, y = _data()
    r = np.random.RandomState(15)
    u = r.randn(N, 6)
    U, lam = tit.eig_precond_state(kf_t, pt(), T(x), 40, torch.Generator().manual_seed(0))
    out = {}
    for dtype in (torch.float32, torch.float64):
        p_t = {k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in PARAMS.items()}
        val, h = tnlml._nlml(p_t, T(y).to(dtype), 0.1, T(x).to(dtype), T(u).to(dtype), None,
                             (U.to(dtype), lam.to(dtype)), kf_t, 1e-4, 200, 40, 40, "eig",
                             block=BLOCK)
        grads = torch.autograd.grad(val, list(p_t.values()))
        assert h["cg_converged"] and all(g.dtype == dtype for g in grads)
        out[dtype] = (float(val.detach()), [float(g) for g in grads])
    np.testing.assert_allclose(out[torch.float32][0], out[torch.float64][0], atol=2e-3)
    np.testing.assert_allclose(out[torch.float32][1], out[torch.float64][1], rtol=1e-3)
