"""Parity of the port's fused Gram-gradient x V (the plain version of the
kernel in ``csrc/gram_matvec_vjp.cu``, the ``autograd.Function`` that
differentiates K3 with it, and the one that takes the square Gram's
bilinear form from it) with the JAX package's Gram VJP, ``_gram_bwd`` in
``stheno_tpu/ops/gram.py``, reached by ``jax.grad`` of ``sum(A *
(gram(kind, x, y, alpha) @ V))`` in interpret mode, and with that sum's
value.

Float64, inputs from numpy seeds, rtol 1e-10 (``EXACT``, as
``tests/test_torch_iterative.py``): the two run the same float64 formulas
and differ in summation order only. The Pallas kernel in interpret mode
rounds its tile to float32 (its dot runs with ``preferred_element_type``
float32), so for that comparison the custom VJP's forward residual is the
JAX package's float64 XLA tile; its backward is ``_gram_bwd`` as
``jax.grad`` runs it. A second comparison keeps the Pallas tile and holds
float32 inputs to the float32 tolerance of ``tests/test_torch_gram.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_torch.ops import gram_matvec as tgmv
from stheno_torch.ops import gram_matvec_vjp as tvjp
from stheno_torch.ops.gram import KINDS, gram_plain
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

# The JAX package's ``ops`` re-exports the function ``gram`` under the
# module's name.
jgram = importlib.import_module("stheno_tpu.ops.gram")

EXACT = 1e-10
ALPHA = 1.25  # exact in float32: the JAX wrapper hands the kernel a float32 alpha
BLOCK = 16  # the plain version's row block: 37 rows make two full blocks and a ragged one


@pytest.fixture
def jax_interpret():
    jgram.set_gram_mode("interpret")
    yield
    jgram.set_gram_mode("auto")


@pytest.fixture
def jax_interpret_f64(jax_interpret, monkeypatch):
    def xla_tile(kind, x, y, alpha, interpret):
        return jgram._xla_gram(kind, x, y, alpha)

    monkeypatch.setattr(jgram, "_pallas_gram", xla_tile)


def _lattice(n, offset, seed):
    """``n`` points of a jittered 2-D lattice of spacing 0.6: no two closer
    than 0.4, so each d2 is well conditioned in both packages' formulas."""
    r = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)[:n]
    return grid * 0.6 + offset + 0.1 * r.rand(n, 2)


def _case(case, q=5, dtype=np.float64):
    r = np.random.RandomState(1)
    x = _lattice(37, 0.0, 2)
    y = x if case == "square" else _lattice(29, 0.3, 3)
    A, V = r.randn(37, q), r.randn(len(y), q)
    return (a.astype(dtype) for a in (x, y, A, V))


def _jax_grads(kind, x, y, A, V, square):
    """``(xbar, ybar, alphabar)`` of ``sum(A * (gram @ V))`` by jax.grad.
    Matérn-1/2 at coincident points (x is y) gets a cotangent with a zero
    diagonal: there its g' is -0.5 / 1e-18, and the W-trick's two sums of
    such terms cancel to noise; the port's difference form adds exactly 0."""
    cot = A @ V.T
    if square and kind == "matern12":
        np.fill_diagonal(cot, 0.0)

    def loss(xx, yy, alpha):
        return jnp.sum(jnp.asarray(cot) * jgram.gram(kind, xx, yy, alpha))

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y), jnp.asarray(ALPHA))


def _jax_value(kind, x, y, A, V, square):
    """``sum(A * (gram @ V))`` over the JAX package's Gram. Matérn-1/2 at
    coincident points (x is y) takes its exact diagonal g(0) = 1: the JAX
    Gram's d2 there is the rounding of |x|^2 + |y|^2 - 2 x.y, about 1e-16,
    whose square root puts K_ii some 1e-8 below 1; the port's difference
    form has d2 = 0 exactly."""
    G = jgram.gram(kind, jnp.asarray(x), jnp.asarray(y), ALPHA)
    if square and kind == "matern12":
        G = G.at[jnp.diag_indices(len(x))].set(1.0)
    return jnp.sum(jnp.asarray(A @ V.T) * G)


def _close(a, b, rtol=EXACT, scale=1.0):
    np.testing.assert_allclose(np_(a), np_(b), rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("case", ["square", "cross"])
@pytest.mark.parametrize("kind", KINDS)
def test_vjp_plain_matches_jax_gram_bwd(kind, case, jax_interpret_f64):
    x, y, A, V = _case(case)
    gx, gy, ga = _jax_grads(kind, x, y, A, V, case == "square")
    scale = float(np.abs(np_(gx)).max())
    T = torch.tensor
    # The row role and the column role, each over ragged row blocks.
    xbar, abar = tvjp.gram_matvec_vjp_plain(kind, T(x), T(y), T(A), T(V), ALPHA,
                                            alpha_grad=True, block=BLOCK)
    ybar, _ = tvjp.gram_matvec_vjp_plain(kind, T(y), T(x), T(V), T(A), ALPHA, block=BLOCK)
    if case == "square" and kind == "matern12":
        # The JAX side's zero diagonal: only the sum of the roles (the
        # gradient of the shared input) sees it cancel.
        _close(xbar + ybar, np_(gx) + np_(gy), scale=scale)
    else:
        _close(xbar, gx, scale=scale)
        _close(ybar, gy, scale=scale)
    if kind == "rq":
        _close(abar, ga)
    else:
        assert abar is None

    # Through the autograd Function (x is y: one sweep over both roles).
    xt = T(x).requires_grad_(True)
    yt = xt if case == "square" else T(y).requires_grad_(True)
    at = T(ALPHA, dtype=torch.float64).requires_grad_(True)
    out = tvjp._GramMatvecFn.apply(xt, yt, T(V), at, kind)
    _close(out, gram_plain(kind, T(x), T(y), ALPHA) @ T(V), scale=1.0)
    targets = [xt, at] if case == "square" else [xt, yt, at]
    grads = torch.autograd.grad(torch.sum(T(A) * out), targets, allow_unused=True)
    if case == "square":
        _close(grads[0], np_(gx) + np_(gy), scale=scale)
    else:
        _close(grads[0], gx, scale=scale)
        _close(grads[1], gy, scale=scale)
    if kind == "rq":
        _close(grads[-1], ga)
    else:
        assert grads[-1] is None


@pytest.mark.parametrize("case", ["square", "cross"])
@pytest.mark.parametrize("kind", KINDS)
def test_vjp_plain_value_matches_jax_gram(kind, case, jax_interpret_f64):
    # The value the sweep adds up beside the gradient, sum_ij (A V^T)_ij
    # K_ij, against the same sum over the JAX package's Gram; the gradient
    # it comes with is the plain call's own.
    x, y, A, V = _case(case)
    ref = _jax_value(kind, x, y, A, V, case == "square")
    T = torch.tensor
    xbar, abar, value = tvjp.gram_matvec_vjp_plain(kind, T(x), T(y), T(A), T(V), ALPHA,
                                                   alpha_grad=True, value=True, block=BLOCK)
    _close(value, ref)
    ref_xbar, ref_abar = tvjp.gram_matvec_vjp_plain(kind, T(x), T(y), T(A), T(V), ALPHA,
                                                    alpha_grad=True, block=BLOCK)
    assert torch.equal(xbar, ref_xbar)
    assert (abar is None) == (ref_abar is None) == (kind != "rq")
    # The wrapper hands back the same three on the CPU.
    _close(tvjp.gram_matvec_vjp(kind, T(x), T(y), T(A), T(V), ALPHA, value=True)[2], ref)


@pytest.mark.parametrize("kind", KINDS)
def test_bilinear_fn_matches_matvec_fn_and_jax(kind, jax_interpret_f64):
    # sum(A * (G(x, x) @ V)) through _GramBilinearFn (one sweep for the
    # value and the gradients of x and rq's alpha) against autograd through
    # _GramMatvecFn and against jax.grad of the same sum, float64.
    x, _, A, V = _case("square")
    gx, gy, ga = _jax_grads(kind, x, x, A, V, True)
    ref_value = _jax_value(kind, x, x, A, V, True)
    scale = float(np.abs(np_(gx) + np_(gy)).max())
    T = torch.tensor
    results = []
    for fn in ("bilinear", "matvec"):
        xt = T(x).requires_grad_(True)
        at = T(ALPHA, dtype=torch.float64).requires_grad_(True)
        if fn == "bilinear":
            out = tvjp._GramBilinearFn.apply(xt, T(A), T(V), at, kind)
        else:
            out = torch.sum(T(A) * tvjp._GramMatvecFn.apply(xt, xt, T(V), at, kind))
        grads = torch.autograd.grad(out, [xt, at], allow_unused=True)
        results.append((out.detach(), *grads))
    (value, xbar, abar), (mv_value, mv_xbar, mv_abar) = results
    if kind != "matern12":
        # K3's plain version forms d2 by the norms identity: Matérn-1/2's
        # diagonal is then some 1e-8 below g(0) = 1 (see _jax_value).
        _close(value, mv_value)
    _close(value, ref_value)
    _close(xbar, mv_xbar, scale=scale)
    _close(xbar, np_(gx) + np_(gy), scale=scale)
    if kind == "rq":
        _close(abar, mv_abar)
        _close(abar, ga)
    else:
        assert abar is None and mv_abar is None
    # No gradient for A or V: asking for one raises.
    for i in (1, 2):
        args = [T(x), T(A), T(V), T(ALPHA, dtype=torch.float64), kind]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no gradient for A or V"):
            torch.autograd.grad(tvjp._GramBilinearFn.apply(*args), args[i])


@pytest.mark.parametrize("kind", KINDS)
def test_vjp_plain_matches_pallas_interpret_f32(kind, jax_interpret):
    # The Pallas tile itself as the residual, float32: rtol 1e-3, the
    # tolerance of tests/test_pallas_gram.py for the float32 W-trick.
    x, y, A, V = _case("cross", dtype=np.float32)
    gx, gy, ga = _jax_grads(kind, x, y, A, V, False)
    T = torch.tensor
    xbar, abar = tvjp.gram_matvec_vjp(kind, T(x), T(y), T(A), T(V), ALPHA, alpha_grad=True)
    ybar, _ = tvjp.gram_matvec_vjp(kind, T(y), T(x), T(V), T(A), ALPHA)
    scale = float(np.abs(np_(gx)).max())
    _close(xbar, gx, rtol=1e-3, scale=scale)
    _close(ybar, gy, rtol=1e-3, scale=scale)
    if kind == "rq":
        _close(abar, ga, rtol=1e-3)


@pytest.mark.parametrize("kind", ["eq", "rq", "matern52", "linear"])
def test_function_v_gradient_is_the_transposed_product(kind):
    # V's gradient is K3 over (y, x): against autograd through the plain
    # Gram, float64 (rtol 1e-12).
    x, y, A, V = (torch.tensor(a) for a in _case("cross", q=3))
    Vt = V.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(A * tvjp._GramMatvecFn.apply(
        x, y, Vt, torch.tensor(ALPHA, dtype=torch.float64), kind)), Vt)
    Vr = V.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(torch.sum(A * (gram_plain(kind, x, y, ALPHA) @ Vr)), Vr)
    np.testing.assert_allclose(np_(g), np_(ref), rtol=1e-12, atol=1e-12)


def test_plain_version_is_autograd_of_the_plain_gram_at_depth_three():
    # Depth 3 (the kernel pads it to 4) and q = 40 (two panel splits of 36
    # on the card): against torch autograd through the plain Gram, float64.
    r = np.random.RandomState(4)
    x, y = torch.tensor(r.randn(21, 3)), torch.tensor(r.randn(18, 3) + 0.05)
    A, V = torch.tensor(r.randn(21, 40)), torch.tensor(r.randn(18, 40))
    for kind in ("eq", "matern32", "rq"):
        xr = x.clone().requires_grad_(True)
        (ref,) = torch.autograd.grad(torch.sum(A * (gram_plain(kind, xr, y, 0.7) @ V)), xr)
        out, _ = tvjp.gram_matvec_vjp(kind, x, y, A, V, 0.7)
        np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-10, atol=1e-12)


def test_gram_matvec_still_raises_under_a_gradient():
    x = torch.randn(6, 1, dtype=torch.float64, requires_grad=True)
    v = torch.randn(6, 2, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="_GramMatvecFn"):
        tgmv.gram_matvec("eq", x, x, v)
    # The Function takes the same call.
    assert tvjp._GramMatvecFn.apply(x, x, v, torch.tensor(1.0, dtype=torch.float64),
                                    "eq").requires_grad


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, A = torch.zeros(4, 2), torch.zeros(4, 3)
    y, V = torch.zeros(5, 2), torch.zeros(5, 3)
    with pytest.raises(ValueError):
        tvjp.gram_matvec_vjp("cosine", x, y, A, V)
    with pytest.raises(ValueError):
        tvjp.gram_matvec_vjp("eq", x, y, torch.zeros(4, 2), V)
    with pytest.raises(ValueError):
        tvjp.gram_matvec_vjp("eq", x, torch.zeros(5, 3), A, V)
    with pytest.raises(TypeError):
        tvjp.gram_matvec_vjp("eq", x.double(), y, A, V)
    with pytest.raises(TypeError):
        tvjp.gram_matvec_vjp("eq", *(t.to(torch.bfloat16) for t in (x, y, A, V)))
    with pytest.raises(ValueError, match="d <= 8"):
        tvjp.gram_matvec_vjp("eq", torch.zeros(4, 9), torch.zeros(5, 9), A, V)
    # Linear is a small product at any depth.
    out, dal = tvjp.gram_matvec_vjp("linear", torch.ones(4, 9), torch.ones(5, 9), A, V)
    assert out.shape == (4, 9) and dal is None


def test_cpu_call_launches_no_kernel():
    before = tvjp.launches
    x, y, A, V = (torch.tensor(a) for a in _case("cross"))
    tvjp.gram_matvec_vjp("eq", x, y, A, V)
    assert tvjp.launches == before


@pytest.mark.parametrize(
    "n, m, q, d, itemsize",
    [
        (262_144, 262_144, 34, 1, 8),  # the surrogate's fused roles, q = 17
        (262_144, 262_144, 17, 1, 8),
        (8192, 8192, 8194, 1, 8),  # 4096 probes, both roles
        (3000, 2500, 18, 2, 4),
        (3000, 2500, 36, 2, 8),
        (37, 29, 5, 3, 8),
    ],
)
def test_launch_shape_covers_every_column_once(n, m, q, d, itemsize):
    qc, depth, qsplits, m_pad, span, splits = tvjp.launch_shape(n, m, q, d, itemsize)
    assert qc in (4, 8, 20, 36) and qc * qsplits >= q and qc * (qsplits - 1) < q
    assert depth in (1, 2, 4, 8) and depth >= d
    assert m_pad % 64 == 0 and m <= m_pad < m + 64
    assert span % 64 == 0 and 1 <= splits <= 65535
    # Every padded column lies in exactly one split, and no split is empty.
    assert span * splits >= m_pad and span * (splits - 1) < m_pad
    assert splits <= -(-m // 1024)
