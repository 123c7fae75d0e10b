"""Parity of the port's K1 backward (the plain version of the kernel in
``csrc/gram_bwd.cu``, and ``ops/gram.py:_Gram`` that takes it) with the
JAX package's Gram VJP, ``_gram_bwd`` in ``stheno_tpu/ops/gram.py``,
reached by ``jax.grad`` of ``sum(cot * gram(kind, x, y, alpha))`` in
interpret mode; and the launch shapes of K1 and of its backward.

Float64, inputs from numpy seeds, rtol 1e-10 (``EXACT``, as
``tests/test_torch_gram_matvec_vjp.py``): the two run the same float64
formulas, the W-trick there and the direct form ``sum_j W_ij (x_i - y_j)``
here, and differ in summation order only. The Pallas kernel in interpret
mode rounds its tile to float32, so the custom VJP's forward residual is
the JAX package's float64 XLA tile; its backward is ``_gram_bwd`` as
``jax.grad`` runs it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_torch.ops import gram as tgram
from stheno_torch.ops import gram_bwd as tbwd
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

# The JAX package's ``ops`` re-exports the function ``gram`` under the
# module's name.
jgram = importlib.import_module("stheno_tpu.ops.gram")

EXACT = 1e-10
ALPHA = 1.25  # exact in float32: the JAX wrapper hands the kernel a float32 alpha
KINDS = tgram.KINDS
DTYPES = (torch.float32, torch.float64, torch.bfloat16)


@pytest.fixture
def jax_interpret_f64(monkeypatch):
    jgram.set_gram_mode("interpret")

    def xla_tile(kind, x, y, alpha, interpret):
        return jgram._xla_gram(kind, x, y, alpha)

    monkeypatch.setattr(jgram, "_pallas_gram", xla_tile)
    yield
    jgram.set_gram_mode("auto")


def _lattice(n, offset, seed, d=2):
    """``n`` points of a jittered lattice of spacing 0.6 in ``d``
    dimensions: no two closer than 0.4, so each d2 is well conditioned in
    both packages' formulas."""
    r = np.random.RandomState(seed)
    side = int(np.ceil(n ** (1.0 / d)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * d), -1).reshape(-1, d)[:n]
    return grid * 0.6 + offset + 0.1 * r.rand(n, d)


def _case(case, d=2, kind="eq"):
    x = _lattice(37, 0.0, 2, d)
    y = x if case == "square" else _lattice(29, 0.3, 3, d)
    cot = np.random.RandomState(1).randn(len(x), len(y))
    if case == "square" and kind == "matern12":
        np.fill_diagonal(cot, 0.0)  # Matérn-1/2 at coincident points: see below
    return x, y, cot


def _jax_grads(kind, x, y, cot, case):
    """jax.grad of ``sum(cot * gram)`` with respect to x (and y unless x is
    y, or y takes no gradient) and alpha. For Matérn-1/2 where x is y the
    cotangent's diagonal is 0: there g' is -0.5 / 1e-18, and the W-trick's
    rowsum(W) x - W y cancels two such terms to noise, where the port's
    direct form adds exactly 0. Every other kind keeps its diagonal."""
    C = jnp.asarray(cot)
    if case == "square":
        def loss(xx, alpha):
            return jnp.sum(C * jgram.gram(kind, xx, xx, alpha))

        gx, ga = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(ALPHA))
        return gx, None, ga

    def loss(xx, yy, alpha):
        return jnp.sum(C * jgram.gram(kind, xx, yy, alpha))

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y), jnp.asarray(ALPHA))


def _close(a, b, scale=1.0):
    np.testing.assert_allclose(np_(a), np_(b), rtol=EXACT, atol=EXACT * scale)


@pytest.mark.parametrize("shape", ["launch", "split"])
@pytest.mark.parametrize("case", ["cross", "square", "x_only"])
@pytest.mark.parametrize("kind", KINDS)
def test_gram_bwd_plain_matches_jax_gram_bwd(kind, case, shape, jax_interpret_f64):
    # "split" forces a 3 x 3 grid over ragged row groups and column spans,
    # the kernel's partials and their fixed-order sum.
    x, y, cot = _case(case, kind=kind)
    gx, gy, ga = _jax_grads(kind, x, y, cot, case)
    T = torch.tensor
    n, m = len(x), len(y)
    grid = (3, -(-n // 3), 2 * -(-m // 6)) if shape == "split" else None
    xbar, ybar, abar = tbwd.gram_bwd_plain(
        kind, T(x), T(y), T(cot), ALPHA, want_y=case != "x_only", want_alpha=True,
        same=case == "square", shape=grid,
    )
    scale = float(np.abs(np_(gx)).max())
    _close(xbar, gx, scale)
    if case == "cross":
        _close(ybar, gy, float(np.abs(np_(gy)).max()))
    else:
        assert ybar is None
    if kind == "rq":
        _close(abar, ga)
    else:
        assert abar is None


@pytest.mark.parametrize("case", ["cross", "square", "x_only"])
@pytest.mark.parametrize("kind", KINDS)
def test_gram_autograd_matches_jax_gram_bwd(kind, case, jax_interpret_f64):
    # The same through the autograd Function, as a model differentiates it:
    # x is y hands one tensor twice, and its gradient is both roles'.
    x, y, cot = _case(case, kind=kind)
    gx, gy, ga = _jax_grads(kind, x, y, cot, case)
    xt = torch.tensor(x).requires_grad_(True)
    yt = xt if case == "square" else torch.tensor(y).requires_grad_(case == "cross")
    at = torch.tensor(ALPHA, dtype=torch.float64).requires_grad_(True)
    targets = [xt, at] if case != "cross" else [xt, yt, at]
    grads = torch.autograd.grad(torch.sum(torch.tensor(cot) * tgram.gram(kind, xt, yt, at)),
                                targets, allow_unused=True)
    _close(grads[0], gx, float(np.abs(np_(gx)).max()))
    if case == "cross":
        _close(grads[1], gy, float(np.abs(np_(gy)).max()))
    if kind == "rq":
        _close(grads[-1], ga)
    else:
        assert grads[-1] is None or float(grads[-1]) == 0.0


@pytest.mark.parametrize("case", ["cross", "square"])
@pytest.mark.parametrize("kind", KINDS)
def test_gram_second_derivative_matches_jax(kind, case, jax_interpret_f64):
    # On CPU tensors K1's backward is plain torch and differentiable again:
    # the gradient of <v, d/dx sum(cot * gram)> against jax.grad of the
    # same through ``_gram_bwd``. Matérn-1/2 at x is y has no second
    # derivative at the coincident points, so there the cotangent's
    # diagonal is 0 as above.
    x, y, cot = _case(case, kind=kind)
    v = np.random.RandomState(5).randn(*x.shape)
    C, V = jnp.asarray(cot), jnp.asarray(v)

    def jloss(xx, alpha):
        yy = xx if case == "square" else jnp.asarray(y)
        return jnp.sum(C * jgram.gram(kind, xx, yy, alpha))

    def jinner(xx, alpha):
        return jnp.sum(V * jax.grad(jloss)(xx, alpha))

    hx, ha = jax.grad(jinner, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(ALPHA))
    xt = torch.tensor(x).requires_grad_(True)
    at = torch.tensor(ALPHA, dtype=torch.float64).requires_grad_(True)
    yt = xt if case == "square" else torch.tensor(y)
    (gx,) = torch.autograd.grad(torch.sum(torch.tensor(cot) * tgram.gram(kind, xt, yt, at)), xt,
                                create_graph=True)
    if not gx.requires_grad:  # linear's x gradient, cot @ y, is free of x
        assert kind == "linear" and case == "cross" and not np.any(np_(hx))
        return
    hxt, hat = torch.autograd.grad(torch.sum(torch.tensor(v) * gx), (xt, at), allow_unused=True)
    _close(hxt, hx, float(np.abs(np_(hx)).max()))
    if kind == "rq":
        # The JAX wrapper hands the kernel alpha as float32, so the second
        # pass's cotangent of alpha is rounded to float32 once there.
        assert float(np.float32(ha)) == float(ha)
        np.testing.assert_allclose(np_(hat), float(ha), rtol=2.0**-24)


@pytest.mark.parametrize("d", [1, 3, 9])
def test_gram_bwd_plain_depths_match_jax(d, jax_interpret_f64):
    # The depth templates' widths (1; 3, padded to 4 on the card; 9, the
    # generic loop there) through the plain version, eq and rq.
    x, y, cot = _case("cross", d=d)
    for kind in ("eq", "rq"):
        gx, gy, ga = _jax_grads(kind, x, y, cot, "cross")
        xbar, ybar, abar = tbwd.gram_bwd_plain(kind, torch.tensor(x), torch.tensor(y),
                                               torch.tensor(cot), ALPHA, want_alpha=True)
        _close(xbar, gx, float(np.abs(np_(gx)).max()))
        _close(ybar, gy, float(np.abs(np_(gy)).max()))
        if kind == "rq":
            _close(abar, ga)


def test_gram_bwd_matern12_coincident_points_add_exactly_zero():
    # x is y with a full cotangent: the direct form's diagonal terms are
    # W_ii (x_i - x_i) = 0 exactly, so the gradient equals the one with the
    # diagonal of the cotangent zeroed, bit for bit.
    x, _, cot = _case("square")
    full = np.random.RandomState(4).randn(len(x), len(x))
    zeroed = full.copy()
    np.fill_diagonal(zeroed, 0.0)
    T = torch.tensor
    a = tbwd.gram_bwd_plain("matern12", T(x), T(x), T(full), same=True)[0]
    b = tbwd.gram_bwd_plain("matern12", T(x), T(x), T(zeroed), same=True)[0]
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m", [(1, 1), (7, 300), (300, 7), (1000, 777), (2000, 2000)])
def test_launch_shape_covers_every_entry_once(n, m, dtype):
    # K1's grid: block t builds tile t, row-major; every output entry is
    # one tile's, once.
    tm, tn, tiles = tgram.launch_shape(n, m, dtype)
    assert (tm, tn) == tgram.tile_shape(dtype)
    assert tn * torch.empty((), dtype=dtype).element_size() == 32 * 16  # a warp's 16 bytes a lane
    hits = np.zeros((n, m), np.int32)
    tiles_n = -(-m // tn)
    for t in range(tiles):
        r0, c0 = (t // tiles_n) * tm, (t % tiles_n) * tn
        hits[r0:r0 + tm, c0:c0 + tn] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 2, 3, 8, 9, 17])
@pytest.mark.parametrize("n,m", [(1, 1), (9, 40), (1000, 777), (2000, 2000), (8192, 262_144)])
def test_bwd_launch_shape_covers_every_entry_once(n, m, d, dtype):
    # The backward's S x S grid: every (row, column) in one block, each of
    # the S x slices holds every row once and each y slice every column
    # once; spans are whole 16-byte vectors, and the partials stay within
    # 1/16 of gbar where more than one split is taken.
    splits, rows, span = tbwd.launch_shape(n, m, d, dtype)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    assert span % vec == 0 and 1 <= splits <= 16
    assert (splits - 1) * span < m <= splits * span and n <= splits * rows
    if splits > 1:
        assert splits * (n + m) * d * 16 <= n * m
    row_hits, col_hits = np.zeros(n, np.int64), np.zeros(m, np.int64)
    for a in range(splits):
        row_hits[a * rows:(a + 1) * rows] += 1
    for b in range(splits):
        col_hits[b * span:(b + 1) * span] += 1
    # Block (a, b) owns rows of group a times columns of span b, so each
    # entry is one block's when each row and each column is one group's.
    assert (row_hits == 1).all() and (col_hits == 1).all()


def test_gram_bwd_plain_split_order_agrees():
    # A 4 x 4 grid over 9 rows leaves a group empty; its slices hold zeros.
    r = np.random.RandomState(8)
    x, y, cot = r.randn(9, 2), r.randn(40, 2), r.randn(9, 40)
    T = torch.tensor
    for kind in KINDS:
        ref = tbwd.gram_bwd_plain(kind, T(x), T(y), T(cot), ALPHA, want_alpha=True,
                                  shape=(1, 9, 40))
        got = tbwd.gram_bwd_plain(kind, T(x), T(y), T(cot), ALPHA, want_alpha=True,
                                  shape=(4, 3, 10))
        for a, b in zip(got, ref):
            if b is None:
                assert a is None
            else:
                np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12, atol=1e-12)


def test_gram_bwd_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4, 2)
    with pytest.raises(TypeError):
        tbwd.gram_bwd("eq", x.half(), x.half(), torch.zeros(4, 4).half())
    with pytest.raises(TypeError):
        tbwd.gram_bwd("eq", x, x, torch.zeros(4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        tbwd.gram_bwd("eq", x, x, torch.zeros(4, 5))
    with pytest.raises(ValueError):
        tbwd.gram_bwd("cosine", x, x, torch.zeros(4, 4))


def test_gram_bwd_runs_plain_and_launches_nothing_on_cpu():
    x = torch.randn(5, 2, requires_grad=True)
    before = (tgram.launches, tbwd.launches)
    torch.sum(tgram.gram("matern32", x, x)).backward()
    assert torch.isfinite(x.grad).all()
    assert (tgram.launches, tbwd.launches) == before
