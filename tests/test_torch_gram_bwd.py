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
    grid = tbwd.BwdShape(3, -(-n // 3), 3, 2 * -(-m // 6), 1) if shape == "split" else None
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


def _blocks(shape):
    return shape.groups * shape.spans


def _share_ok(shape, n, m, d, fold):
    # csrc/gram_bwd.cuh: x slices (spans of n d) where several spans add
    # into a row, y slices (groups of m d) where several groups add into a
    # column, both with fold; none in a grid of one block.
    if _blocks(shape) == 1:
        return True
    parts = ((shape.spans * n * d if fold or shape.spans > 1 else 0)
             + (shape.groups * m * d if fold or shape.groups > 1 else 0))
    return parts * 16 <= n * m


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 2, 3, 8, 9, 17])
@pytest.mark.parametrize("n,m", [(1, 1), (9, 40), (1000, 777), (2000, 2000), (8192, 262_144),
                                 (512, 1_000_000), (512, 4096), (16_384, 16_384)])
def test_bwd_launch_shape_covers_every_entry_once(n, m, d, dtype):
    # The backward's grid of spans x groups blocks (and, where x is y, the
    # fold's): every (row, column) in one block, each x slice holds every
    # row once and each y slice every column once; spans are whole tiles of
    # 128 columns a warp (wcols of them a round), the grid is within the
    # card's limits and the staged partials within a block's shared memory,
    # and the partials stay within 1/16 of gbar where there are several
    # blocks.
    itemsize = torch.empty((), dtype=tgram.arith_dtype(dtype)).element_size()
    for fold in (False, True) if n == m else (False,):
        shape = tbwd.launch_shape(n, m, d, dtype, fold)
        groups, rows, spans, span, wcols = shape
        assert wcols in (1, 8) and span % (128 * wcols) == 0
        assert 1 <= groups <= 65535 and (groups - 1) * rows < n <= groups * rows
        assert (spans - 1) * span < m <= spans * span
        assert tbwd._stage_bytes(shape, d, itemsize) <= tbwd._STAGE
        assert _share_ok(shape, n, m, d, fold)
        row_hits, col_hits = np.zeros(n, np.int64), np.zeros(m, np.int64)
        for a in range(groups):
            row_hits[a * rows:(a + 1) * rows] += 1
        for b in range(spans):
            col_hits[b * span:(b + 1) * span] += 1
        # Block (a, b) owns rows of group a times columns of span b, so each
        # entry is one block's when each row and each column is one group's.
        assert (row_hits == 1).all() and (col_hits == 1).all()


#: The shapes where the paths launch K1's backward (PERF.md §6): n, m, d,
#: dtype, x is y, and whether the columns are wide (spans of a block's
#: warps each owning its tiles).
PATH_SHAPES = {
    "n2000": (2000, 2000, 2, torch.float32, True, False),
    "sparse_512x1e6": (512, 1_000_000, 1, torch.float32, False, True),
    "dist_16384": (16_384, 16_384, 1, torch.float32, True, False),
    "tiles_8192": (8192, 8192, 1, torch.float32, False, False),
    "rq_2000x1": (2000, 2000, 1, torch.float32, True, False),
    "kron_1024": (1024, 1024, 1, torch.float32, True, False),
    "svgp_512x4096": (512, 4096, 1, torch.float32, False, False),
    "sweep_8192x262144": (8192, 262_144, 1, torch.float64, False, True),
}


@pytest.mark.parametrize("case", sorted(PATH_SHAPES))
def test_bwd_launch_shape_at_the_paths(case):
    # The paths' grids: partials within 1/16 of gbar; the wide and large
    # ones more than one block an SM of the H100's 132 (at most two an SM
    # resident at once, so one full wave or more), wide columns taken by
    # each warp alone with every row of a group (no y partials across
    # warps), x is y in spans of one tile.
    n, m, d, dtype, same, wide = PATH_SHAPES[case]
    shape = tbwd.launch_shape(n, m, d, dtype, same)
    assert _share_ok(shape, n, m, d, same)
    assert shape.wcols == (8 if wide else 1)
    if wide or n * m >= 4_000_000:
        assert _blocks(shape) > tbwd._SMS
    if same:
        assert shape.span == 128
    if case == "sparse_512x1e6":
        assert shape.groups == 1  # ybar complete in one block: no y partials


@pytest.mark.parametrize("case", sorted(PATH_SHAPES) + ["ragged_fold", "ragged_cross"])
def test_bwd_partials_are_each_written_once(case):
    # The partials' layout in work (csrc/gram_bwd.cu): block (a, b) writes
    # its rows' x partials into x slice b and its columns' y partials into
    # y slice a, and its alpha partial; every entry of the layout is written
    # by exactly one block, and the sum reads, for each entry of out, one
    # slice of each block that adds into it.
    if case == "ragged_fold":
        n, m, d, dtype, same = 1000, 1000, 2, torch.float32, True
    elif case == "ragged_cross":
        n, m, d, dtype, same = 1000, 777, 2, torch.float32, False
    else:
        n, m, d, dtype, same, _ = PATH_SHAPES[case]
    shape = tbwd.launch_shape(n, m, d, dtype, same)
    groups, rows, spans, span, _ = shape
    for want_x, want_y in ((True, True), (True, False), (False, True)):
        if same and not (want_x and want_y):
            continue
        x_sliced, y_sliced, y_work, a_work, total = tbwd._work_layout(
            shape, n, m, 1, want_x, want_y, True, same)
        hits = np.zeros(total, np.int64)
        for a in range(groups):
            r0, r1 = a * rows, min(n, (a + 1) * rows)
            for b in range(spans):
                c0, c1 = b * span, min(m, (b + 1) * span)
                if x_sliced:
                    hits[b * n + r0:b * n + r1] += 1
                if y_sliced:
                    hits[y_work + a * m + c0:y_work + a * m + c1] += 1
                hits[a_work + a * spans + b] += 1
        assert (hits == 1).all()
        assert x_sliced == (want_x and (same or spans > 1))
        assert y_sliced == (want_y and (same or groups > 1))


def _kernel_order(kind, x, y, g, shape, alpha=ALPHA):
    """float64: the kernel's sums of x's and y's slices in its order
    (csrc/gram_bwd.cuh), block by block: a warp's steps of R rows (every
    8th step of the group with wcols = 1; every row with wcols = 8, tiles
    w, w + 8, ... of the span), each step's rows summed over the lanes'
    4 columns (lane l: columns 4 l, + 4 of the tile) and then over the
    lanes; x added over a warp's tiles and then over the warps in order,
    y over a tile's rows and then over the warps in order. Returns the
    slices (spans, n, d) and (groups, m, d)."""
    n, d = x.shape
    m = y.shape[0]
    groups, rows, spans, span, wcols = shape
    R = 4 if d <= 2 else 2 if d <= 4 else 1
    wrows, rounds = 8 // wcols, span // (128 * wcols)
    xs, ys = x.new_zeros((spans, n, d)), y.new_zeros((groups, m, d))
    for a in range(groups):
        r_begin, r_end = a * rows, min(n, (a + 1) * rows)
        for b in range(spans):
            c_begin, c_end = b * span, min(m, (b + 1) * span)
            xw = x.new_zeros((wcols, n, d))
            for warp in range(8):
                wc, wr = warp % wcols, warp // wcols
                for u in range(rounds):
                    tile = c_begin + (u * wcols + wc) * 128
                    if tile >= c_end:
                        continue
                    cols = torch.arange(tile, min(c_end, tile + 128))
                    lanes = (cols - tile) // 4
                    yacc = y.new_zeros((len(cols), d))
                    for r0 in range(r_begin + wr * R, r_end, wrows * R):
                        rr = torch.arange(r0, min(r_end, r0 + R))
                        W, diff = _terms(kind, x[rr], y[cols], g[rr][:, cols], alpha)
                        t = W[..., None] * diff  # (R, cols, d)
                        per_lane = torch.zeros((len(rr), 32, d), dtype=x.dtype).index_add_(
                            1, lanes, t)
                        xw[wc, rr] += 2 * per_lane.sum(1)
                        yacc -= t.sum(0)
                    ys[a, cols] += 2 * yacc
            xs[b, r_begin:r_end] = xw[:, r_begin:r_end].sum(0)
    return xs, ys


def _terms(kind, xb, yb, gb, alpha):
    d2 = torch.clamp_min(tgram._d2(xb, yb, xb @ yb.T), 0.0)
    K = tgram._apply_kind(kind, d2, None, torch.tensor(alpha, dtype=xb.dtype))
    return gb * tgram._g_prime(kind, d2, K, alpha), xb[:, None, :] - yb[None, :, :]


@pytest.mark.parametrize("shape", [(3, 14, 3, 128, 1), (2, 20, 2, 256, 1), (2, 20, 1, 1024, 8),
                                   (1, 40, 1, 2048, 8)])
@pytest.mark.parametrize("kind", ["eq", "matern32"])
def test_kernel_order_matches_plain(kind, shape):
    # The kernel's order of sums within and across blocks (both wcols, one
    # and several tiles a span, ragged edges) against the plain version's
    # blocks at the same grid, float64: the same slices to rounding.
    r = np.random.RandomState(11)
    T = torch.tensor
    x, y, g = T(r.randn(40, 2)), T(r.randn(300, 2)), T(r.randn(40, 300))
    shape = tbwd.BwdShape(*shape)
    xs, ys = _kernel_order(kind, x, y, g, shape)
    want = tbwd.gram_bwd_plain(kind, x, y, g, ALPHA, shape=shape)
    np.testing.assert_allclose(np_(tbwd._ordered_sum(list(xs))), np_(want[0]), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np_(tbwd._ordered_sum(list(ys))), np_(want[1]), rtol=1e-12,
                               atol=1e-12)


def test_gram_bwd_plain_split_order_agrees():
    # A 4 x 4 grid over 9 rows leaves a group empty; its slices hold zeros.
    r = np.random.RandomState(8)
    x, y, cot = r.randn(9, 2), r.randn(40, 2), r.randn(9, 40)
    T = torch.tensor
    for kind in KINDS:
        ref = tbwd.gram_bwd_plain(kind, T(x), T(y), T(cot), ALPHA, want_alpha=True,
                                  shape=tbwd.BwdShape(1, 9, 1, 40, 1))
        got = tbwd.gram_bwd_plain(kind, T(x), T(y), T(cot), ALPHA, want_alpha=True,
                                  shape=tbwd.BwdShape(4, 3, 4, 10, 1))
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


def test_device_alpha_keeps_the_values_used_last():
    # rq's alpha as a number: one device tensor per value, reused while it
    # is among the last _ALPHAS_KEPT used, the oldest dropped beyond them.
    tgram._ALPHAS.clear()
    first = tgram.device_alpha("rq", 0.5, torch.float32, "cpu")
    assert tgram.device_alpha("rq", 0.5, torch.float32, "cpu") is first
    for i in range(3 * tgram._ALPHAS_KEPT):
        a = tgram.device_alpha("rq", 1.0 + i, torch.float64, "cpu")
        assert a.dtype == torch.float64 and float(a) == 1.0 + i
        assert len(tgram._ALPHAS) <= tgram._ALPHAS_KEPT
    recent = tgram.device_alpha("rq", 3.0 * tgram._ALPHAS_KEPT, torch.float64, "cpu")
    assert tgram.device_alpha("rq", 3.0 * tgram._ALPHAS_KEPT, torch.float64, "cpu") is recent
    assert tgram.device_alpha("rq", 0.5, torch.float32, "cpu") is not first
    assert tgram.device_alpha("eq", 0.5, torch.float32, "cpu") is None
