"""Parity of the port's two-float compensated path
(``stheno_torch.iterative.compensated`` and its call sites) with
``stheno_tpu.iterative.compensated``, and the stories of
``tests/test_compensated.py`` against float64 references.

Tolerances: the error-free transformations and the slice split agree with
the JAX package bitwise, in float32 and float64. The Ozaki-split product's
pair is within 1e-9 of float64 truth, the double-float tiles within 5e-7
(``tests/test_compensated.py``'s bounds). The compensated matvec is within
3e-7 of the largest float64 entry, for the fused forms (K3's float64 route
on promoted inputs) and the double-float route alike. Solves at a tight
tolerance agree with the JAX package's to the solve's accuracy.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_tpu.iterative import compensated as jc
from stheno_tpu.iterative import pchol as jpchol
from stheno_torch import iterative as tit
from stheno_torch.iterative import compensated as tc
from stheno_torch.iterative import matvec as tmv
from stheno_torch.iterative import pchol as tpchol
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

DTYPES = [(np.float32, jnp.float32, torch.float32), (np.float64, jnp.float64, torch.float64)]


def _f64(a):
    return np.asarray(np_(a), np.float64)


@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_two_sum_two_prod_bitwise(dt):
    npd, _, _ = dt
    r = np.random.RandomState(0)
    a = (r.randn(1000) * 1e3).astype(npd)
    b = (r.randn(1000) * 1e-3).astype(npd)
    for fn_j, fn_t in ((jc.two_sum, tc.two_sum), (jc.two_prod, tc.two_prod)):
        hj, ej = fn_j(jnp.asarray(a), jnp.asarray(b))
        ht, et = fn_t(torch.tensor(a), torch.tensor(b))
        np.testing.assert_array_equal(np_(ht), np.asarray(hj))
        np.testing.assert_array_equal(np_(et), np.asarray(ej))
    # Exact in float32: the pair sums to the float64 result.
    if npd == np.float32:
        s, e = tc.two_sum(torch.tensor(a), torch.tensor(b))
        np.testing.assert_array_equal(_f64(s) + _f64(e), a.astype(np.float64) + b)
        p, e = tc.two_prod(torch.tensor(a), torch.tensor(b))
        np.testing.assert_array_equal(_f64(p) + _f64(e), a.astype(np.float64) * b)


@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_split_two_slices_bitwise_and_exact(dt):
    npd, _, _ = dt
    r = np.random.RandomState(1)
    A = (r.randn(16, 512) * np.exp(r.randn(16, 1))).astype(npd)
    A[3] = 0.0  # An all-zero row takes the tiny scale.
    A[5, 7] = 2.0 ** 5  # An exact power of two as the row's largest entry.
    for axis in (0, 1):
        J = jc.split_two_slices(jnp.asarray(A), axis=axis)
        T = tc.split_two_slices(torch.tensor(A), axis=axis)
        for j, t in zip(J, T):
            np.testing.assert_array_equal(_f64(t), np.asarray(j, np.float64))
        np.testing.assert_array_equal(np_(T[0] + T[1] + T[2]), A)
    if npd == np.float32:
        # The slices are bfloat16 values stored in float32.
        A1, A2, _ = tc.split_two_slices(torch.tensor(A), axis=1)
        for s in (A1, A2):
            assert s.dtype == torch.float32
            assert torch.equal(s.to(torch.bfloat16).to(torch.float32), s)


def test_compensated_matmul_accuracy():
    r = np.random.RandomState(2)
    A = r.randn(64, 3000).astype(np.float32)
    B = r.randn(3000, 5).astype(np.float32)
    ref = A.astype(np.float64) @ B.astype(np.float64)
    den = np.abs(ref).max()
    plain = _f64(torch.tensor(A) @ torch.tensor(B))
    hi, lo = tc.compensated_matmul(torch.tensor(A), torch.tensor(B), fold=False)
    err_pair = np.abs(_f64(hi) + _f64(lo) - ref).max() / den
    assert err_pair < 1e-9
    assert err_pair < (np.abs(plain - ref).max() / den) / 100
    folded = _f64(tc.compensated_matmul(torch.tensor(A), torch.tensor(B)))
    assert np.abs(folded - ref).max() / den < 1e-6
    # Beside the JAX package's pair.
    hj, lj = jc.compensated_matmul(jnp.asarray(A), jnp.asarray(B), fold=False)
    pair_j = np.asarray(hj, np.float64) + np.asarray(lj, np.float64)
    assert np.abs(_f64(hi) + _f64(lo) - pair_j).max() / den < 1e-9
    # A low word rides the tail; float64 operands slice at 16 bits.
    A_lo = (r.randn(64, 3000) * 1e-9).astype(np.float32)
    out = tc.compensated_matmul(torch.tensor(A), torch.tensor(B), fold=False,
                                A_lo=torch.tensor(A_lo))
    ref_lo = ref + A_lo.astype(np.float64) @ B.astype(np.float64)
    assert np.abs(_f64(out[0]) + _f64(out[1]) - ref_lo).max() / den < 1e-9
    out64 = tc.compensated_matmul(torch.tensor(A, dtype=torch.float64),
                                  torch.tensor(B, dtype=torch.float64))
    assert np.abs(np_(out64) - ref).max() / den < 1e-14  # the float64 reference's own rounding


_X32 = (np.sort(np.random.RandomState(3).rand(200)) * 10).astype(np.float32)
_D2 = (_X32.astype(np.float64)[:, None] - _X32.astype(np.float64)[None, :]) ** 2
_S3, _S5 = np.sqrt(3.0), np.sqrt(5.0)
_R = np.sqrt(_D2)
DF32_CASES = [
    ("eq", lambda m: m.EQ(), np.exp(-0.5 * _D2)),
    ("scaled_stretched_eq", lambda m: 2.5 * m.EQ().stretch(0.7),
     2.5 * np.exp(-0.5 * _D2 / 0.49)),
    ("matern12", lambda m: m.Matern12(), np.exp(-_R)),
    ("matern32", lambda m: m.Matern32(), (1 + _S3 * _R) * np.exp(-_S3 * _R)),
    ("matern52", lambda m: m.Matern52(), (1 + _S5 * _R + 5 * _D2 / 3) * np.exp(-_S5 * _R)),
    ("rq", lambda m: m.RQ(1.5), (1 + _D2 / 3.0) ** -1.5),
    ("sum", lambda m: m.EQ() + m.Matern32() * 0.5,
     np.exp(-0.5 * _D2) + 0.5 * (1 + _S3 * _R) * np.exp(-_S3 * _R)),
    ("product", lambda m: m.EQ() * m.Matern12(), np.exp(-0.5 * _D2) * np.exp(-_R)),
    ("shifted", lambda m: m.EQ().shift(3.0), np.exp(-0.5 * _D2)),
]


@pytest.mark.parametrize("case", DF32_CASES, ids=[c[0] for c in DF32_CASES])
def test_df32_pairwise_tiles(case):
    _, make, ref = case
    x = torch.tensor(_X32)[:, None]
    hi, lo = tc.df32_pairwise(make(st), x, x)
    val = _f64(hi) + _f64(lo)
    # About eps K entry error (the double-float exp holds to about 1e-8).
    assert np.abs(val - ref).max() < 5e-7
    hj, lj = jc.df32_pairwise(make(sj), jnp.asarray(_X32)[:, None], jnp.asarray(_X32)[:, None])
    assert np.abs(val - (np.asarray(hj, np.float64) + np.asarray(lj, np.float64))).max() < 5e-7


def test_df32_pairwise_has_no_rule_for_these():
    from stheno_torch.kernels.kernel import StretchedKernel

    x = torch.tensor(_X32)[:, None]
    assert tc.df32_pairwise(st.EQ().periodic(1.0), x, x) is None
    assert tc.df32_pairwise(StretchedKernel(st.EQ(), 1.0, 2.0), x, x) is None
    assert tc.df32_pairwise(st.Linear(), x, x) is None


@pytest.mark.parametrize("alpha", [5.0, 20.0])
def test_df32_rq_large_alpha(alpha):
    # The port carries RQ's exp argument -alpha log(t) as a pair (the JAX
    # package scales it in plain float32: ADVICE.md, compensated.py:492).
    # The double-float log's own rounding, about eps absolute, times alpha,
    # still bounds the entry error, so both packages land at about alpha
    # 6e-8.
    x = torch.tensor(_X32)[:, None]
    ref = (1 + _D2 / (2 * alpha)) ** -alpha
    hi, lo = tc.df32_pairwise(st.RQ(alpha), x, x)
    err_t = np.abs(_f64(hi) + _f64(lo) - ref).max()
    hj, lj = jc.df32_pairwise(sj.RQ(alpha), jnp.asarray(_X32)[:, None], jnp.asarray(_X32)[:, None])
    err_j = np.abs(np.asarray(hj, np.float64) + np.asarray(lj, np.float64) - ref).max()
    assert err_t < alpha * 1e-7 and err_t < 1.1 * err_j


def _mv_data(n=1500, seed=4):
    r = np.random.RandomState(seed)
    x = (np.sort(r.rand(n)) * 10).astype(np.float32)
    v = r.randn(n, 3).astype(np.float32)
    return x, v


MV_CASES = [
    ("eq_fused", lambda m: m.EQ(), lambda d2: np.exp(-0.5 * d2)),
    ("scaled_stretched_fused", lambda m: 1.7 * m.EQ().stretch(0.8),
     lambda d2: 1.7 * np.exp(-0.5 * d2 / 0.64)),
    ("sum_double_float", lambda m: m.EQ() + 0.5 * m.Matern32(),
     lambda d2: np.exp(-0.5 * d2) + 0.5 * (1 + _S3 * np.sqrt(d2)) * np.exp(-_S3 * np.sqrt(d2))),
]


@pytest.mark.parametrize("case", MV_CASES, ids=[c[0] for c in MV_CASES])
def test_kernel_matvec_compensated_parity(case, monkeypatch):
    """The compensated matvec against float64: about 100 times tighter than
    the plain one, by K3's float64 route for the fused forms and by the
    double-float tiles otherwise, and beside the JAX package's."""
    name, make, gram = case
    x, v = _mv_data()
    x64 = x.astype(np.float64)
    ref = gram((x64[:, None] - x64[None, :]) ** 2) @ v.astype(np.float64) + 0.01 * v
    den = np.abs(ref).max()
    routes = []
    monkeypatch.setattr(tmv, "_compensated_fused",
                        _spy(tmv._compensated_fused, routes, "fused"))
    monkeypatch.setattr(tmv, "_compensated_tiles",
                        _spy(tmv._compensated_tiles, routes, "tiles"))
    xt, vt = torch.tensor(x), torch.tensor(v)
    comp = _f64(tit.kernel_matvec(make(st), xt, vt, noise=0.01, block=512, compensated=True,
                                  comp_col_chunk=700))
    plain = _f64(tit.kernel_matvec(make(st), xt, vt, noise=0.01, block=512))
    assert routes == ["fused" if "fused" in name else "tiles"]
    assert np.abs(comp - ref).max() / den < 3e-7
    assert np.abs(comp - ref).max() < np.abs(plain - ref).max() / 20
    comp_j = np.asarray(sj.iterative.kernel_matvec(
        make(sj), jnp.asarray(x), jnp.asarray(v), noise=0.01, block=512, compensated=True),
        np.float64)
    assert np.abs(comp - comp_j).max() / den < 3e-7


def _spy(fn, log, tag):
    def wrapped(*a, **kw):
        log.append(tag)
        return fn(*a, **kw)

    return wrapped


def test_kernel_matvec_compensated_options():
    x, v = _mv_data(64)
    xt, vt = torch.tensor(x), torch.tensor(v)
    with pytest.raises(ValueError, match="incompatible"):
        tit.kernel_matvec(st.EQ(), xt, vt, compensated=True, tile_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="incompatible"):
        tit.kernel_matvec(st.EQ(), xt, vt, compensated=True, symmetric=True, block=16)
    # A cross product (x_cols) and a vector right-hand side.
    xq = torch.linspace(0.0, 10.0, 9)
    out = tit.kernel_matvec(st.EQ(), xq, vt[:, 0], x_cols=xt, compensated=True)
    x64 = x.astype(np.float64)
    ref = np.exp(-0.5 * (np_(xq).astype(np.float64)[:, None] - x64[None, :]) ** 2) @ v[:, 0]
    assert out.shape == (9,)
    assert np.abs(_f64(out) - ref).max() / np.abs(ref).max() < 3e-7
    # Forward only: a gradient through it raises.
    with pytest.raises(RuntimeError, match="forward-only"):
        tit.kernel_matvec(st.EQ(), xt.requires_grad_(True), vt, compensated=True)


def test_compensated_scaled_apply_routes_agree():
    """The faithful port of the preconditioner's two-float application,
    the float64 route and the JAX package's, against float64 truth."""
    r = np.random.RandomState(7)
    n, k = 600, 24
    U = np.linalg.qr(r.randn(n, k))[0].astype(np.float32)
    coeff = (r.rand(k) * 30 - 31).astype(np.float32)
    v = r.randn(n, 3).astype(np.float32)
    base = np.float32(1 / np.sqrt(1e-4))
    U64 = U.astype(np.float64)
    ref = base * v + U64 @ (coeff.astype(np.float64)[:, None] * (U64.T @ v))
    den = np.abs(ref).max()
    args = (torch.tensor(U), torch.tensor(coeff), torch.tensor(base), torch.tensor(v))
    faithful = _f64(tc.compensated_scaled_apply(*args))
    f64 = _f64(tc.f64_scaled_apply(*args))
    jx = np.asarray(jc.compensated_scaled_apply(
        jnp.asarray(U), jnp.asarray(coeff), jnp.asarray(base), jnp.asarray(v)), np.float64)
    for out in (faithful, f64, jx):
        assert np.abs(out - ref).max() / den < 2e-7
    assert tc.compensated_scaled_apply(*args[:3], args[3][:, 0]).shape == (n,)
    # The preconditioner ops' compensated application is the float64 one.
    lam = torch.tensor(np.abs(coeff))
    ops = tit.eig_preconditioner_ops(args[0], lam, 1e-4, n, compensated=True)
    d = lam + 1e-4
    want = tc.f64_scaled_apply(args[0], 1.0 / torch.sqrt(d) - 1.0 / np.sqrt(1e-4),
                               1.0 / torch.sqrt(torch.tensor(1e-4)), args[3])
    np.testing.assert_array_equal(np_(ops[2](args[3])), np_(want))


def _small_noise_problem(n, seed=0, noise=2.5e-4):
    r = np.random.RandomState(seed)
    x = (np.sort(r.rand(n)) * 10).astype(np.float32)
    y = (np.sin(x) + 0.1 * r.randn(n)).astype(np.float32)
    return x, y, noise


def test_compensated_cg_small_noise_f64_parity():
    """``tests/test_compensated.py``'s gate, at n=1024 (noise 8e-5, below a
    tenth of the plain float32 wall there, as that test's n=4096 and
    2.5e-4): the plain whitened CG fails by orders of magnitude, the
    compensated one matches the float64 direct solve."""
    n = 1024
    x, y, noise = _small_noise_problem(n, noise=8e-5)
    kf = lambda p: st.EQ()  # noqa: E731
    xt, yt = torch.tensor(x), torch.tensor(y)
    state = tit.eig_precond_state(kf, None, xt, 128, torch.Generator().manual_seed(1), block=n)
    assert noise < 0.1 * tit.plain_noise_wall(float(state[1].max()), n, torch.float32)
    x64 = x.astype(np.float64)
    A64 = np.exp(-0.5 * (x64[:, None] - x64[None, :]) ** 2) + noise * np.eye(n)
    ref = np.linalg.solve(A64, y.astype(np.float64))

    alpha, info = tit.posterior_weights(kf, None, xt, yt, noise, cg_tol=1e-10,
                                        max_cg_iters=300, precond_state=state, block=n,
                                        compensated=True)
    sol_err = np.linalg.norm(_f64(alpha) - ref) / np.linalg.norm(ref)
    assert sol_err < 1e-4
    assert np.linalg.norm(y - A64 @ _f64(alpha)) / np.linalg.norm(y) < 1e-3
    alpha_p, _ = tit.posterior_weights(kf, None, xt, yt, noise, cg_tol=1e-10, max_cg_iters=300,
                                       precond_state=state, block=n, compensated=False)
    assert np.linalg.norm(_f64(alpha_p) - ref) / np.linalg.norm(ref) > 100 * sol_err


def test_compensated_whitened_solve_matches_jax():
    """The compensated whitened solve (segmented CG, one refinement pass,
    the true residual through the compensated operator) beside the JAX
    package's on the same float32 state at noise 1e-4: the same iteration
    count, and the weights and true residual no worse than the JAX
    package's against the float64 direct solve. (The JAX package's
    operator is two-float, the port's K3's float64 route: their iterates
    differ at the operators' rounding.)"""
    n, noise = 300, 1e-4
    r = np.random.RandomState(5)
    x = (np.sort(r.rand(n)) * 10).astype(np.float32)
    y = (np.sin(x) + 0.1 * r.randn(n)).astype(np.float32)
    x64 = x.astype(np.float64)
    K = np.exp(-0.5 * (x64[:, None] - x64[None, :]) ** 2)
    Ue = np.linalg.qr(K @ r.randn(n, 40))[0]
    lam, V = np.linalg.eigh(Ue.T @ K @ Ue)
    Ue, lam = (Ue @ V).astype(np.float32), np.clip(lam, 0, None).astype(np.float32)
    ref = np.linalg.solve(K + noise * np.eye(n), y.astype(np.float64))

    def mv_j(comp):
        return lambda v: sj.iterative.kernel_matvec(sj.EQ(), jnp.asarray(x), v, block=128,
                                                    compensated=comp)

    sol_j = jpchol.make_whitened_solver(
        mv_j(False), n, noise, 40, state=(jnp.asarray(Ue), jnp.asarray(lam)),
        mv_raw_comp=mv_j(True), compensated=True, dtype=jnp.float32)
    aj, ij = sol_j(jnp.asarray(y), tol=1e-6, max_iters=300, true_residual=True)
    xt = torch.tensor(x)
    sol_t = tit.make_whitened_solver(
        lambda v: tit.kernel_matvec(st.EQ(), xt, v, block=128), n, noise, 40,
        state=(torch.tensor(Ue), torch.tensor(lam)),
        mv_raw_comp=lambda v: tit.kernel_matvec(st.EQ(), xt, v, block=128, compensated=True),
        compensated=True, dtype=torch.float32)
    assert sol_t.compensated is True
    at, it_ = sol_t(torch.tensor(y), tol=1e-6, max_iters=300, true_residual=True)
    assert it_["iters"] == int(ij["iters"])
    err_t = np.abs(_f64(at) - ref).max() / np.abs(ref).max()
    err_j = np.abs(np.asarray(aj, np.float64) - ref).max() / np.abs(ref).max()
    assert err_t <= max(2 * err_j, 1e-6)
    assert float(it_["rel_residual_true"]) <= 2 * float(ij["rel_residual_true"]) + 1e-6


def test_segmented_cg_passes_cg_kwargs(monkeypatch):
    # The JAX package's segmented path drops **cg_kwargs (ADVICE.md,
    # pchol.py:319); the port passes them to every segment.
    seen = []
    real = tpchol.batched_cg

    def spy(*a, **kw):
        seen.append(kw.get("min_iters"))
        return real(*a, **kw)

    monkeypatch.setattr(tpchol, "batched_cg", spy)
    x, y, _ = _small_noise_problem(200, seed=2)
    xt = torch.tensor(x, dtype=torch.float64)
    solve = tit.make_whitened_solver(
        lambda v: tit.kernel_matvec(st.EQ(), xt, v), 200, 1e-3, 20,
        mv_raw_comp=lambda v: tit.kernel_matvec(st.EQ(), xt, v, compensated=True),
        compensated=True, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    solve(torch.tensor(y, dtype=torch.float64), tol=1e-8, max_iters=50, min_iters=2)
    assert seen and all(m == 2 for m in seen)


def test_resolve_compensated_policy():
    # The JAX package's measured bench problem: lam_max = 63,118 puts the
    # threshold at 0.060; noise 0.1 stays plain, 0.01 flips.
    lam = torch.tensor([100.0, 63118.0])
    n = 262144
    assert 3.0 < tit.plain_noise_wall(63118.0, n, torch.float32) < 5.0
    assert tit.resolve_compensated("auto", 0.01, lam, n, torch.float32, True)
    assert not tit.resolve_compensated("auto", 0.1, lam, n, torch.float32, True)
    assert not tit.resolve_compensated("auto", 0.01, lam, n, torch.float32, False)
    assert not tit.resolve_compensated(False, 0.01, lam, n, torch.float32, True)
    assert tit.resolve_compensated(True, 0.01, lam, n, torch.float32, True)
    with pytest.raises(ValueError, match="compensated"):
        tit.resolve_compensated(True, 0.01, lam, n, torch.float32, False)
    for noise in (0.01, 0.1):
        assert tit.resolve_compensated("auto", noise, lam, n, torch.float32, True) == \
            jc.resolve_compensated("auto", noise, jnp.asarray(np_(lam)), n, jnp.float32, True)


def test_whitened_solver_exposes_compensated_flag():
    n = 256
    r = np.random.RandomState(5)
    x = torch.tensor((np.sort(r.rand(n)) * 10).astype(np.float32))
    mv = lambda v: tit.kernel_matvec(st.EQ(), x, v, block=256)  # noqa: E731
    mv_c = lambda v: tit.kernel_matvec(st.EQ(), x, v, block=256, compensated=True)  # noqa: E731
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    lo = tit.make_whitened_solver(mv, n, 1.0, 32, gen(), mv_raw_comp=mv_c, compensated="auto",
                                  dtype=torch.float32)
    assert lo.compensated is False
    hi = tit.make_whitened_solver(mv, n, 1e-10, 32, gen(), mv_raw_comp=mv_c,
                                  compensated="auto", dtype=torch.float32)
    assert hi.compensated is True


def test_pathwise_compensated_small_noise():
    """Draws conditioned on near-noiseless observations (n=512, noise 1e-5,
    float32, where even the dense float32 Cholesky fails) interpolate them
    within 0.05 through the compensated solve; the plain solve does not,
    and warns advising the compensated one."""
    n = 512
    r = np.random.RandomState(6)
    x = torch.tensor((np.sort(r.rand(n)) * 10).astype(np.float32))
    y = torch.sin(x)
    opts = dict(num_samples=4, num_features=2048, solver="cg", cg_tol=1e-8, max_cg_iters=600,
                precond_rank=128, return_info=True)
    f_cg, _, info = st.pathwise_sampler(st.EQ(), x, y, 1e-5, torch.Generator().manual_seed(0),
                                        compensated=True, **opts)
    # Both packages' float32 segmented solves stop at their CG arithmetic's
    # floor here, short of tol 1e-8 (the JAX test bounds it at 1e-6: 4.5e-7
    # to 6.3e-7 over five keys; the port 4.9e-7 to 1.9e-6 over six seeds, so
    # twice that). The draws' interpolation below is the functional gate.
    assert float(info["rel_residual"]) <= 2e-6
    err = float((f_cg(x) - y[:, None]).abs().max())
    assert err < 0.05
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        f_plain, _, _ = st.pathwise_sampler(st.EQ(), x, y, 1e-5,
                                            torch.Generator().manual_seed(0),
                                            compensated=False, **opts)
    err_p = float((f_plain(x) - y[:, None]).abs().max())
    assert not np.isfinite(err_p) or err_p > 10 * err
    stalls = [str(w.message) for w in rec if "STALLED" in str(w.message)]
    assert stalls and all("compensated=True" in m for m in stalls)


def test_compensated_entry_points_small():
    """``bench_compensated_262k``'s entry points at n=2048: the data as
    ``bench.py`` draws it, the compensated matvec within 3e-7 of float64,
    and the small-noise weights' true residual under ``bench.py``'s 1e-4
    gate."""
    from stheno_torch import entry as E

    n = 2048
    x, y, v = E.compensated_262k_inputs(n)
    r = np.random.RandomState(0)
    xr = np.sort(r.rand(n).astype(np.float32)) * 10
    np.testing.assert_array_equal(np_(x), xr)
    np.testing.assert_allclose(np_(y), np.sin(xr) + 0.1 * r.randn(n).astype(np.float32),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np_(v), r.randn(n, 8).astype(np.float32))
    out = _f64(E.compensated_matvec8_262k(x, v))
    x64 = xr.astype(np.float64)
    ref = np.exp(-0.5 * (x64[:, None] - x64[None, :]) ** 2) @ np_(v).astype(np.float64)
    ref += 0.01 * np_(v)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 3e-7
    alpha, info, res = E.smallnoise_weights_262k(x, y, torch.Generator().manual_seed(1), rank=64)
    assert alpha.shape == (n,) and float(res) <= 1e-4
