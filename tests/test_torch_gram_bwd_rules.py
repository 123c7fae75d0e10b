"""K1's backward as a Function of its own (``ops/gram_bwd.py:_GramBwd``):
its forward rule (``ops/gram_bwd_jvp.py``, the plain version of
``csrc/gram_bwd_jvp.cu``), its reverse rule and its vmap rule, against the
JAX package on the same numpy float64 inputs.

- ``gram_bwd_jvp_plain`` against ``jax.jvp`` of ``(x, y, alpha, gbar) ->
  stheno_tpu/ops/gram.py:_gram_bwd(kind, False, (x, y, alpha,
  _xla_gram(kind, x, y, alpha)), gbar)`` for every kind, with x apart
  from y and x as y, one and three directions, rq's alpha tangent: rtol
  1e-10 of the largest entry (``EXACT``; both run float64 formulas, the
  W-trick there and the direct form here). Where x is y, Matérn-1/2's
  ``g'`` is ``-0.5 / 1e-18`` on the diagonal and the W-trick's two sums
  cancel to noise there, so that case takes zero diagonals of ``gbar``
  and of its tangent; the port's diagonal adds exactly 0, which a test
  of its own holds bit for bit.
- Reverse over reverse through ``gram`` against ``jax.grad`` of
  ``jax.grad`` through the JAX package's custom VJP (``_gram_bwd``, the
  Pallas kernel in interpret mode with the float64 XLA tile); and through
  the five Cholesky-backed reductions, whose backward a second reverse
  pass now differentiates (``matrix/ops.py:_adjoint_ops``), against
  ``jax.hessian``: the JAX package's own reverse over reverse through
  those reductions' custom VJPs holds the factor fixed and is not their
  second derivative.
- ``torch.func.hessian`` of the flagship NLML with the kernels routed
  through ``gram`` on the CPU (a monkeypatched ``_fused_gram``, since the
  CPU kernels compute their Gram in plain torch): it takes ``_GramBwd``
  and one call of the tangent for all three directions, and matches
  ``jax.hessian`` at ``PARITY`` (1e-8, as ``tests/test_torch_forward_mode.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_tpu.matrix.ops as jops
from stheno_torch import entry as E
from stheno_torch.kernels import kernel as tkernel
from stheno_torch.matrix import ops as tops
from stheno_torch.ops import gram as tgram
from stheno_torch.ops import gram_bwd as tbwd
from stheno_torch.ops import gram_bwd_jvp as tjvb
from tests.test_torch_helpers import np_, spd, torch_cpu  # noqa: F401

jgram = importlib.import_module("stheno_tpu.ops.gram")

EXACT = 1e-10
PARITY = 1e-8
ALPHA = 1.25  # exact in float32: the JAX wrapper hands the kernel a float32 alpha
KINDS = tgram.KINDS


@pytest.fixture
def jax_interpret_f64(monkeypatch):
    jgram.set_gram_mode("interpret")

    def xla_tile(kind, x, y, alpha, interpret):
        return jgram._xla_gram(kind, x, y, alpha)

    monkeypatch.setattr(jgram, "_pallas_gram", xla_tile)
    yield
    jgram.set_gram_mode("auto")


@pytest.fixture
def gram_on_cpu(monkeypatch):
    """The kernels' Gram through ``gram`` (K1's Function) on CPU tensors
    too, as it runs on the card."""
    def fused(kind, x, y, alpha=1.0):
        if x.ndim == 2 and y.ndim == 2:
            return tgram.gram(kind, x, y, alpha)
        return None

    monkeypatch.setattr(tkernel, "_fused_gram", fused)


def _lattice(n, offset, seed, d=2):
    """``n`` points of a jittered lattice of spacing 0.6: no two closer
    than 0.4, so each d2 is well conditioned in both packages."""
    r = np.random.RandomState(seed)
    side = int(np.ceil(n ** (1.0 / d)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * d), -1).reshape(-1, d)[:n]
    return grid * 0.6 + offset + 0.1 * r.rand(n, d)


def _case(kind, same, B, seed=1, n=37, m=29, d=2):
    x = _lattice(n, 0.0, 2, d)
    y = x if same else _lattice(m, 0.3, 3, d)
    r = np.random.RandomState(seed)
    g, gt = r.randn(len(x), len(y)), r.randn(B, len(x), len(y))
    xt = r.randn(B, *x.shape)
    yt = xt if same else r.randn(B, *y.shape)
    at = r.randn(B)
    if same and kind == "matern12":
        np.fill_diagonal(g, 0.0)
        for t in gt:
            np.fill_diagonal(t, 0.0)
    return x, y, g, xt, yt, at, gt


def _jax_bwd_jvp(kind, x, y, g, xt, yt, at, gt, same):
    """``jax.jvp`` of ``_gram_bwd`` (its forward residual the XLA Gram), one
    direction at a time: ``(xbar', ybar' or None, dalpha')``."""
    def bwd(xx, yy, al, gg):
        yy = xx if same else yy
        K = jgram._xla_gram(kind, xx, yy, al)
        xb, yb, ab = jgram._gram_bwd(kind, False, (xx, yy, al, K), gg)
        return (xb + yb if same else xb), yb, ab

    outs = [jax.jvp(bwd, tuple(map(jnp.asarray, (x, y, ALPHA, g))),
                    tuple(map(jnp.asarray, (xt[b], yt[b], at[b], gt[b]))))[1]
            for b in range(xt.shape[0])]
    xd, yd, ad = (np.stack([np.asarray(o[i]) for o in outs]) for i in range(3))
    return xd, None if same else yd, ad


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(np_(a), b, rtol=EXACT, atol=EXACT * float(np.abs(b).max()))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_gram_bwd_jvp_plain_matches_jax(kind, same, B):
    x, y, g, xt, yt, at, gt = _case(kind, same, B)
    T = torch.tensor
    got = tjvb.gram_bwd_jvp_plain(kind, T(x), T(y), T(g), T(ALPHA), T(xt),
                                  None if same else T(yt), T(at), T(gt), want_alpha=True,
                                  same=same)
    want = _jax_bwd_jvp(kind, x, y, g, xt, yt, at, gt, same)
    _close(got[0], want[0])
    if same:
        assert got[1] is None
    else:
        _close(got[1], want[1])
    if kind == "rq":
        _close(got[2], want[2])
    else:
        assert got[2] is None


#: Cases at the kernel's launch shape with several blocks (``bwd_jvp_shape``:
#: spans of 128 columns, row groups of 32 to 144 rows): ``(n, m, d, B,
#: same)``. B = 8 is the largest sweep of
#: directions at depth 1; depths 8 and 9 hold the whole depth in registers
#: and one past it; ragged n != m.
LAUNCH_CASES = {"b8": (150, 130, 1, 8, False), "same_b8": (150, 150, 1, 8, True),
                "d8": (70, 150, 8, 3, False), "d9": (150, 150, 9, 2, True),
                "ragged": (133, 67, 3, 3, False)}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_gram_bwd_jvp_plain_at_launch_shape_matches_jax(kind, case):
    n, m, d, B, same = LAUNCH_CASES[case]
    x, y, g, xt, yt, at, gt = _case(kind, same, B, seed=5, n=n, m=m, d=d)
    splits, rows, span = tjvb.bwd_jvp_shape(n, m, d)
    assert splits * tjvb._cdiv(m, span) > 1
    T = torch.tensor
    got = tjvb.gram_bwd_jvp_plain(kind, T(x), T(y), T(g), T(ALPHA), T(xt),
                                  None if same else T(yt), T(at), T(gt), want_alpha=True,
                                  same=same)
    want = _jax_bwd_jvp(kind, x, y, g, xt, yt, at, gt, same)
    _close(got[0], want[0])
    if same:
        assert got[1] is None
    else:
        _close(got[1], want[1])
    if kind == "rq":
        _close(got[2], want[2])


@pytest.mark.parametrize("n,m,d", [
    (2000, 2000, 1), (2001, 1999, 1), (1000, 1000, 1), (333, 517, 3), (517, 333, 9), (1, 1, 1),
    (517, 1, 2), (3, 100_000, 1), (100_000, 3, 1), (4096, 300, 9)])
def test_bwd_jvp_shape_blocks_cover_every_entry_once(n, m, d):
    # The grid of row groups by column spans of 128 columns (a warp's
    # lanes, 4 columns each: whole 16-byte vectors of float32 and float64)
    # covers each entry of the n x m tile exactly once, with no empty row
    # group and within the grid's limits; a direction's y partials stay
    # within 1/16 of a tile where the tile is large enough to split.
    splits, rows, span = tjvb.bwd_jvp_shape(n, m, d)
    assert span == 32 * 4
    assert 1 <= splits <= 65535 and rows * (splits - 1) < n <= rows * splits
    seen = torch.zeros(n, m, dtype=torch.int32)
    for a in range(splits):
        for b in range(tjvb._cdiv(m, span)):
            seen[a * rows:(a + 1) * rows, b * span:(b + 1) * span] += 1
    assert bool((seen == 1).all())
    if splits > 1:
        assert 16 * splits * m * d <= n * m + 16 * m * d


@pytest.mark.parametrize("kind", ["eq", "rq", "linear"])
def test_gram_bwd_jvp_plain_each_tangent_alone(kind):
    # Each of the four tangents (x, y, alpha, gbar) alone, the others None,
    # against jax.jvp with the others zero; and x only, y only.
    x, y, g, xt, yt, at, gt = _case(kind, False, 2, seed=4)
    T = torch.tensor
    zero = {"x": np.zeros_like(xt), "y": np.zeros_like(yt), "a": np.zeros_like(at),
            "g": np.zeros_like(gt)}
    for name in ("x", "y", "a", "g"):
        tans = {k: v for k, v in zero.items()}
        tans[name] = {"x": xt, "y": yt, "a": at, "g": gt}[name]
        want = _jax_bwd_jvp(kind, x, y, g, tans["x"], tans["y"], tans["a"], tans["g"], False)
        kw = {k: (T(tans[k[0]]) if k[0] == name else None) for k in ("xt", "yt", "at", "gt")}
        got = tjvb.gram_bwd_jvp_plain(kind, T(x), T(y), T(g), T(ALPHA), **kw, want_alpha=True)
        _close(got[0], want[0])
        _close(got[1], want[1])
        got_x = tjvb.gram_bwd_jvp_plain(kind, T(x), T(y), T(g), T(ALPHA), **kw, want_y=False)
        assert got_x[1] is None and got_x[2] is None
        _close(got_x[0], want[0])


def test_gram_bwd_jvp_plain_split_order_agrees():
    # A 4 x 4 grid over 9 rows leaves a row group empty; its slices hold
    # zeros, and the grid changes only the order of the sums.
    r = np.random.RandomState(8)
    T = torch.tensor
    x, y, g = T(r.randn(9, 2)), T(r.randn(40, 2)), T(r.randn(9, 40))
    xt, yt, gt, at = T(r.randn(3, 9, 2)), T(r.randn(3, 40, 2)), T(r.randn(3, 9, 40)), T(r.randn(3))
    for kind in KINDS:
        ref = tjvb.gram_bwd_jvp_plain(kind, x, y, g, ALPHA, xt, yt, at, gt, want_alpha=True,
                                      shape=(1, 9, 40))
        got = tjvb.gram_bwd_jvp_plain(kind, x, y, g, ALPHA, xt, yt, at, gt, want_alpha=True,
                                      shape=(4, 3, 10))
        for a, b in zip(got, ref):
            if b is None:
                assert a is None
            else:
                np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["matern12", "matern32", "eq"])
def test_gram_bwd_jvp_coincident_points_add_exactly_zero(kind, dtype):
    # x is y: the diagonal's r and rt are 0 exactly, so whatever gbar and
    # its tangent hold there (Matérn-1/2's g'' overflows float32 at d2 =
    # 0) the result is that of zeroed diagonals, bit for bit, and finite.
    x, _, g, xt, _, at, gt = _case("eq", True, 3, seed=6)
    g0, gt0 = g.copy(), gt.copy()
    np.fill_diagonal(g0, 0.0)
    for t in gt0:
        np.fill_diagonal(t, 0.0)

    def run(gg, gtt):
        T = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
        return tjvb.gram_bwd_jvp_plain(kind, T(x), T(x), T(gg), 1.3, T(xt), None, None, T(gtt),
                                       same=True)[0]

    a, b = run(g, gt), run(g0, gt0)
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_gram_bwd_jvp_rejects_what_it_does_not_take():
    x = torch.zeros(4, 2, dtype=torch.float64)
    g = torch.zeros(4, 4, dtype=torch.float64)
    with pytest.raises(ValueError):
        tjvb.gram_bwd_jvp("eq", x, x, g)
    with pytest.raises(ValueError):
        tjvb.gram_bwd_jvp("cosine", x, x, g, xt=x[None])
    empty = tjvb.gram_bwd_jvp("eq", x[:0], x, g[:0], xt=x[None, :0])
    assert empty[0].shape == (1, 0, 2) and empty[1].shape == (1, 4, 2)


# --- Reverse over reverse -----------------------------------------------------


@pytest.mark.parametrize("case", ["cross", "square"])
@pytest.mark.parametrize("kind", KINDS)
def test_reverse_over_reverse_through_gram_matches_jax(kind, case, jax_interpret_f64):
    # L = sum(C * G) + 0.5 sum(G^2): the cotangent gbar = C + G moves with
    # the inputs, so the second pass takes both of _GramBwd's reverse
    # paths (K1's tangent for gbar's cotangent, the backward's tangent for
    # x's, y's and alpha's). The gradient of <V, grad L> against jax.grad of
    # the same through the custom VJP's _gram_bwd. Matérn-1/2 where x is y
    # keeps L = sum(C * G) with C's diagonal 0 (see the module docstring):
    # G's diagonal of ones would put the W-trick's noise back.
    same = case == "square"
    quad = 0.0 if same and kind == "matern12" else 1.0
    x, y, C, *_ = _case(kind, same, 1, seed=9)
    r = np.random.RandomState(10)
    vx, vy, va = r.randn(*x.shape), r.randn(*y.shape), 0.7
    Cj = jnp.asarray(C)

    def jloss(xx, yy, al):
        G = jgram.gram(kind, xx, xx if same else yy, al)
        return jnp.sum(Cj * G) + quad * 0.5 * jnp.sum(G * G)

    def jinner(xx, yy, al):
        gx, gy, ga = jax.grad(jloss, argnums=(0, 1, 2))(xx, yy, al)
        return jnp.sum(vx * gx) + (0.0 if same else jnp.sum(vy * gy)) + va * ga

    want = jax.grad(jinner, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y), jnp.asarray(ALPHA))

    xt = torch.tensor(x).requires_grad_(True)
    yt = xt if same else torch.tensor(y).requires_grad_(True)
    at = torch.tensor(ALPHA, dtype=torch.float64).requires_grad_(True)
    G = tgram.gram(kind, xt, yt, at)
    loss = torch.sum(torch.tensor(C) * G) + quad * 0.5 * torch.sum(G * G)
    leaves = [xt, at] if same else [xt, yt, at]
    grads = torch.autograd.grad(loss, leaves, create_graph=True, allow_unused=True)
    inner = torch.sum(torch.tensor(vx) * grads[0])
    if not same:
        inner = inner + torch.sum(torch.tensor(vy) * grads[1])
    if kind == "rq":
        inner = inner + va * grads[-1]
    got = torch.autograd.grad(inner, leaves, allow_unused=True)
    _close(got[0], want[0])
    if not same:
        _close(got[1], want[1])
    if kind == "rq":
        # The JAX wrapper hands the kernel alpha as float32, so its
        # cotangents are rounded to float32 there.
        np.testing.assert_allclose(float(got[-1]), float(want[2]), rtol=2.0**-23)


@pytest.mark.parametrize("name", ["logdet", "iqf", "iqf_diag", "solve", "ratio"])
def test_reduction_reverse_over_reverse_matches_jax(name):
    # The reductions' analytic adjoints run on a detached factor; under a
    # second reverse pass A^{-1} comes from _SolveChol and _KinvChol, which
    # carry mat's own adjoint. d^2/ds^2 of each against jax.hessian (its
    # forward-over-reverse fallback differentiates the factorisation).
    A0 = spd(6, 1) * 6
    B0, C0 = np.random.RandomState(2).randn(6, 2), np.random.RandomState(3).randn(6, 6)

    def make(ops, asarray, total):
        A, b, C = (asarray(a) for a in (A0, B0, C0))

        def M(s):
            return ops.as_matrix(s * A + s * s * C @ C.T)

        return {
            "logdet": lambda s: ops.logdet(M(s)),
            "iqf": lambda s: total(ops.dense(ops.iqf(M(s), s * b))),
            "iqf_diag": lambda s: total(ops.iqf_diag(M(s), s * b)),
            "solve": lambda s: total(ops.solve(M(s), s * b)),
            "ratio": lambda s: ops.ratio(s * C, M(s)),
        }[name]

    f = make(tops, torch.tensor, torch.sum)
    s = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(f(s), s, create_graph=True)
    (h,) = torch.autograd.grad(g, s)
    jf = make(jops, jnp.asarray, jnp.sum)
    want = jax.hessian(jf)(jnp.asarray(1.3))
    np.testing.assert_allclose(float(h), float(want), rtol=PARITY)
    np.testing.assert_allclose(float(h), float(torch.func.hessian(f)(s.detach())), rtol=1e-9)


def test_first_order_adjoints_unchanged():
    # A first-order backward (no create_graph) keeps the plain products of
    # the factor: no _SolveChol or _KinvChol node is made.
    A = torch.tensor(spd(6, 4) * 6, requires_grad=True)
    b = torch.tensor(np.random.RandomState(5).randn(6, 1))
    val = tops.logdet(tops.as_matrix(A)) + tops.dense(tops.iqf(tops.as_matrix(A), b)).sum()
    (g,) = torch.autograd.grad(val, A)
    Ainv = np.linalg.inv(np_(A))
    ab = Ainv @ np_(b)
    np.testing.assert_allclose(np_(g), Ainv - ab @ ab.T, rtol=1e-10)
    assert not g.requires_grad


@pytest.mark.parametrize("name", ["logdet", "iqf", "iqf_diag", "solve", "ratio"])
def test_reductions_save_no_alias_of_the_matrix(name):
    # The reductions save the factor and the matrix's _Anchor (a stride-0
    # zero), never the matrix: nothing their graph keeps shares its storage,
    # so it is freed with the caller's reference, and a second reverse pass
    # still reaches it through the anchor.
    A0 = torch.tensor(spd(6, 1) * 6)
    b = torch.tensor(np.random.RandomState(2).randn(6, 2))
    s = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)

    def M(t):
        return t * A0 + t * t * torch.eye(6, dtype=torch.float64)

    mat = M(s)
    ptr = mat.untyped_storage().data_ptr()
    saved = []

    def pack(t):
        saved.append(t.untyped_storage().data_ptr())
        return t

    fn = {
        "logdet": lambda m, s: tops.logdet(m),
        "iqf": lambda m, s: tops.dense(tops.iqf(m, s * b)).sum(),
        "iqf_diag": lambda m, s: tops.iqf_diag(m, s * b).sum(),
        "solve": lambda m, s: tops.solve(m, s * b).sum(),
        "ratio": lambda m, s: tops.ratio(s * A0, m),
    }[name]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        val = fn(tops.as_matrix(mat), s)
    assert saved and ptr not in saved
    (g,) = torch.autograd.grad(val, s, create_graph=True)
    (h,) = torch.autograd.grad(g, s)
    want = torch.func.hessian(lambda t: fn(tops.as_matrix(M(t)), t))(s.detach())
    np.testing.assert_allclose(float(h), float(want), rtol=1e-9)


# --- The flagship's Hessian through _GramBwd ---------------------------------


P0 = np.array([0.2, -0.1, -2.0])  # log ell, log s2, log noise


def _flagship(n=60):
    x = np.linspace(0.0, 10.0, n)
    return x, np.sin(x) + 0.3 * np.cos(3.2 * x)


def _jax_hessian(x, y):
    def nlml(p):
        f = sj.GP(jnp.exp(p[1]) * sj.EQ().stretch(jnp.exp(p[0])))
        return -f.measure.logpdf(f(jnp.asarray(x), jnp.exp(p[2])), jnp.asarray(y))

    return np.asarray(jax.hessian(nlml)(jnp.asarray(P0)))


def _params():
    return dict(zip(("log_ell", "log_s2", "log_noise"),
                    (torch.tensor(v, dtype=torch.float64) for v in P0)))


def _spy(monkeypatch, module, name, calls, tag):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((tag, args))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_flagship_hessian_takes_gram_bwd_and_matches_jax(gram_on_cpu, monkeypatch):
    calls = []
    _spy(monkeypatch, tbwd, "gram_bwd_plain", calls, "bwd")
    _spy(monkeypatch, tjvb, "gram_bwd_jvp_plain", calls, "bwd_jvp")
    x, y = _flagship()
    H = E.flagship_hessian(torch.tensor(x), torch.tensor(y), _params())
    want = _jax_hessian(x, y)
    err = np.abs(np_(H) - want).max() / np.abs(want).max()
    assert err <= PARITY, err
    assert [c[0] for c in calls] == ["bwd", "bwd_jvp"]
    xt = calls[1][1][5]
    assert xt.shape == (3, 60, 1)  # the three directions in one call


def test_flagship_reverse_over_reverse_matches_hessian(gram_on_cpu):
    x, y = (torch.tensor(a) for a in _flagship())
    p = torch.tensor(P0, requires_grad=True)
    f, noise = E._eq_model(dict(zip(("log_ell", "log_s2", "log_noise"), p)))
    val = -f.measure.logpdf(f(x, noise), y)
    (g,) = torch.autograd.grad(val, p, create_graph=True)
    H = torch.stack([torch.autograd.grad(g[i], p, retain_graph=True)[0] for i in range(3)])
    want = _jax_hessian(np_(x), np_(y))
    err = np.abs(np_(H) - want).max() / np.abs(want).max()
    assert err <= PARITY, err


# --- _GramBwd's and _GramBwdJvp's vmap rules ----------------------------------


def test_gram_bwd_jvp_one_call_for_all_directions(monkeypatch):
    # jacfwd of K1's gradient: _GramBwd's jvp hands the directions to
    # _GramBwdJvp, whose vmap rule takes all 12 in one call.
    calls = []
    _spy(monkeypatch, tjvb, "gram_bwd_jvp_plain", calls, "bwd_jvp")
    x = torch.tensor(np.random.RandomState(13).randn(6, 2))
    C = torch.tensor(np.random.RandomState(14).randn(6, 6))
    grad = torch.func.grad(lambda a: torch.sum(C * tgram.gram("matern52", a, a)))
    H = torch.func.jacfwd(grad)(x)
    assert [c[1][5].shape for c in calls] == [(12, 6, 2)]
    want = torch.func.jacfwd(torch.func.grad(lambda a: torch.sum(
        C * tgram.gram_plain("matern52", a, a))))(x)
    np.testing.assert_allclose(np_(H), np_(want), rtol=1e-9, atol=1e-9 * float(want.abs().max()))


def test_gram_bwd_rules_under_vmap_over_data(monkeypatch):
    # A batch of inputs: _GramBwd's vmap rule (and the tangent's) takes
    # one call per member.
    calls = []
    _spy(monkeypatch, tbwd, "gram_bwd_plain", calls, "bwd")
    _spy(monkeypatch, tjvb, "gram_bwd_jvp_plain", calls, "bwd_jvp")
    r = np.random.RandomState(15)
    xs, vs = torch.tensor(r.randn(3, 5, 2)), torch.tensor(r.randn(3, 5, 2))

    def f(a):
        return torch.sum(tgram.gram("rq", a, a, 1.7) ** 2)

    g = torch.func.vmap(torch.func.grad(f))(xs)
    assert [c[0] for c in calls] == ["bwd"] * 3
    calls.clear()
    hv = torch.func.vmap(lambda a, v: torch.func.jvp(torch.func.grad(f), (a,), (v,))[1])(xs, vs)
    assert sorted(c[0] for c in calls) == ["bwd"] * 3 + ["bwd_jvp"] * 3
    for i in range(3):
        ref = torch.func.grad(lambda a: torch.sum(tgram.gram_plain("rq", a, a, 1.7) ** 2))
        np.testing.assert_allclose(np_(g[i]), np_(ref(xs[i])), rtol=1e-10)
        want = torch.func.jvp(ref, (xs[i],), (vs[i],))[1]
        np.testing.assert_allclose(np_(hv[i]), np_(want), rtol=1e-9,
                                   atol=1e-9 * float(want.abs().max()))
