"""Parity of the port's fused Gram (kernel K1's plain version, and the
kernel classes that reach it) with the JAX package.

The JAX side runs its Pallas kernel in interpret mode, as
``tests/test_pallas_gram.py`` does; the port's CPU path is the plain
version of the CUDA kernel, behind the same ``autograd.Function`` whose
backward the card uses. Inputs come from numpy seeds."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stheno_tpu as sj
import stheno_torch as st
from stheno_torch.ops import gram as tgram
from stheno_torch.kernels import kernel as tkernel
from tests.test_torch_helpers import np_, torch_cpu  # noqa: F401

# The JAX package's ``ops`` re-exports the function ``gram`` under the
# module's name.
jgram = importlib.import_module("stheno_tpu.ops.gram")

KINDS = ["eq", "matern12", "matern32", "matern52", "rq", "linear"]


@pytest.fixture
def jax_interpret():
    jgram.set_gram_mode("interpret")
    yield
    jgram.set_gram_mode("auto")


def _xy(seed, n=30, m=17, d=3, dtype=np.float32):
    r = np.random.RandomState(seed)
    return r.randn(n, d).astype(dtype), r.randn(m, d).astype(dtype)


@pytest.mark.parametrize("kind", KINDS)
def test_gram_f32_matches_pallas_interpret(kind, jax_interpret):
    # rtol 2e-5: the tolerance tests/test_pallas_gram.py holds the Pallas
    # kernel to against XLA in float32.
    x, y = _xy(0)
    ref = jgram.gram(kind, jnp.asarray(x), jnp.asarray(y), alpha=1.3)
    out = tgram.gram(kind, torch.tensor(x), torch.tensor(y), alpha=1.3)
    np.testing.assert_allclose(np_(out), np_(ref), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_gram_grads_match_pallas_custom_vjp(kind, jax_interpret):
    # rtol 1e-3: the tolerance of tests/test_pallas_gram.py for the
    # float32 W-trick backward against autodiff.
    x, y = _xy(1, n=12, m=9, d=2)
    w = np.random.RandomState(2).randn(12, 9).astype(np.float32)

    def loss_j(x, y, alpha):
        return jnp.sum(jnp.asarray(w) * jgram.gram(kind, x, y, alpha))

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(y), jnp.float32(1.3)
    )
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    at = torch.tensor(1.3, requires_grad=True)
    torch.sum(torch.tensor(w) * tgram.gram(kind, xt, yt, at)).backward()
    for a, b in zip((xt.grad, yt.grad), gj[:2]):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-3, atol=1e-5)
    dalpha = 0.0 if at.grad is None else float(at.grad)
    np.testing.assert_allclose(dalpha, float(gj[2]), rtol=1e-3, atol=1e-5)


def _bf16_xy(seed, n=30, m=17, d=3):
    """bfloat16 inputs, the same values for both packages."""
    x, y = _xy(seed, n=n, m=m, d=d)
    xb, yb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, y))
    xt, yt = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16) for a in (xb, yb))
    return xb, yb, xt, yt


@pytest.mark.parametrize("kind", KINDS)
def test_gram_bf16_matches_pallas_interpret(kind, jax_interpret):
    # Both compute in float32 from the same bfloat16 inputs and round the
    # result once to bfloat16 (the TPU kernel's preferred_element_type): the
    # two float32 values differ only by the orders of their sums, so the
    # bfloat16 results are equal or one rounding apart, 2^-7 of the value.
    xb, yb, xt, yt = _bf16_xy(10)
    ref = jgram.gram(kind, xb, yb, alpha=1.3)
    out = tgram.gram(kind, xt, yt, alpha=1.3)
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(np_(out.float()), np_(ref.astype(jnp.float32)), rtol=2.0**-7,
                               atol=1e-6)


def _bf16_grad_tols(kind, x, y, cot, alpha, delta_rel=2.0**-8, rel=2.0**-6):
    """Tolerances of the port's bfloat16 gradients against the JAX
    package's. The port computes them in float32 and rounds each once
    (2^-8 of the value). The JAX package's _gram_bwd runs in bfloat16 at
    every jnp step: d2's three terms, W, rowsum(W) and both products each
    round to 2^-8 of their terms, and the W-trick rowsum(W) x - W y then
    cancels them, so its error is a few (four: ``rel``) such roundings of
    S_i = 2 sum_j |W_ij| (|x_i| + |y_j|), plus what d2's rounding, delta =
    2^-8 (|x_i|^2 + |y_j|^2), does to g': |g'(d2 - delta) - g'(d2 + delta)|
    per term (g' is monotone in d2). rq's alpha likewise, over
    |cot K h|. Returns (x, y, alpha) tolerances, float64."""
    X, Y, C = (torch.tensor(a, dtype=torch.float64) for a in (x, y, cot))
    a = torch.tensor(alpha, dtype=torch.float64)
    xa, ya = X.abs(), Y.abs()
    if kind == "linear":
        return rel * (C.abs() @ ya), rel * (C.abs().T @ xa), 0.0
    diff = X[:, None, :] - Y[None, :, :]
    d2 = (diff * diff).sum(-1)
    delta = delta_rel * ((X * X).sum(1)[:, None] + (Y * Y).sum(1)[None, :])

    def gp(t):
        return tgram._g_prime(kind, t, tgram._apply_kind(kind, t, None, a), a)

    def h(t):
        return tgram._alpha_factor(t, tgram._apply_kind(kind, t, None, a), a)

    W = C.abs() * (rel * gp(d2).abs() + (gp(d2 + delta) - gp((d2 - delta).clamp_min(0))).abs())
    tx = 2 * (W.sum(1, keepdim=True) * xa + W @ ya)
    ty = 2 * (W.sum(0)[:, None] * ya + W.T @ xa)
    h0 = h(d2)
    dh = (h(d2 + delta) - h0).abs() + (h((d2 - delta).clamp_min(0)) - h0).abs()
    return tx, ty, float((C.abs() * (rel * h0.abs() + dh)).sum())


@pytest.mark.parametrize("kind", KINDS)
def test_gram_bf16_grads_match_pallas_custom_vjp(kind, jax_interpret):
    # bfloat16 inputs and cotangent through both packages' custom
    # gradients: the port's comes back in bfloat16, within
    # _bf16_grad_tols of jax.grad through _gram_bwd.
    xb, yb, xt, yt = _bf16_xy(11, n=12, m=9, d=2)
    cb = jnp.asarray(np.random.RandomState(12).randn(12, 9)).astype(jnp.bfloat16)

    def loss_j(x, y, alpha):
        return jnp.sum((cb * jgram.gram(kind, x, y, alpha)).astype(jnp.float32))

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(xb, yb, jnp.float32(1.3))
    xr, yr = xt.clone().requires_grad_(True), yt.clone().requires_grad_(True)
    at = torch.tensor(1.3, requires_grad=True)
    ct = torch.tensor(np.asarray(cb.astype(jnp.float32))).to(torch.bfloat16)
    gt = torch.autograd.grad(tgram.gram(kind, xr, yr, at), (xr, yr, at), ct, allow_unused=True)
    assert gt[0].dtype == gt[1].dtype == torch.bfloat16
    tx, ty, ta = _bf16_grad_tols(kind, np_(xt.float()), np_(yt.float()),
                                 np_(ct.float()), 1.3)
    for got, ref, tol in ((gt[0], gj[0], tx), (gt[1], gj[1], ty)):
        err = np.abs(np_(got.double()) - np.asarray(jnp.asarray(ref).astype(jnp.float64)))
        assert (err <= np_(tol)).all(), float((err / np_(tol)).max())
    if kind == "rq":
        assert abs(float(gt[2]) - float(gj[2])) <= ta
    else:
        assert gt[2] is None


@pytest.mark.parametrize("kind", KINDS)
def test_gram_f64_matches_xla_formula(kind):
    # The plain version is the JAX package's XLA formula: in float64 the
    # two agree to rounding (rtol 1e-12).
    x, y = _xy(3, dtype=np.float64)
    ref = jgram._xla_gram(kind, jnp.asarray(x), jnp.asarray(y), 0.7)
    out = tgram.gram(kind, torch.tensor(x), torch.tensor(y), 0.7)
    np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kind", ["eq", "matern32", "rq"])
def test_gram_backward_matches_autograd_of_plain_f64(kind):
    # The custom backward against torch autograd through the plain
    # formula, in float64 (rtol 1e-9).
    x, y = _xy(4, n=11, m=7, d=2, dtype=np.float64)
    w = torch.tensor(np.random.RandomState(5).randn(11, 7))

    def grads(fn):
        xt = torch.tensor(x, requires_grad=True)
        yt = torch.tensor(y, requires_grad=True)
        at = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
        torch.sum(w * fn(kind, xt, yt, at)).backward()
        return [np_(t.grad) for t in (xt, yt)] + [0.0 if at.grad is None else float(at.grad)]

    for a, b in zip(grads(tgram.gram), grads(tgram.gram_plain)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_gram_same_input_accumulates_both_gradients():
    x = torch.tensor(_xy(6, n=9, d=2, dtype=np.float64)[0], requires_grad=True)
    torch.sum(tgram.gram("eq", x, x)).backward()
    x2 = x.detach().clone().requires_grad_(True)
    torch.sum(tgram.gram_plain("eq", x2, x2)).backward()
    np.testing.assert_allclose(np_(x.grad), np_(x2.grad), rtol=1e-10, atol=1e-12)


def test_gram_rejects_what_the_kernel_does_not_take():
    # bfloat16 is taken, as the TPU kernel takes it; float16 is not.
    x = torch.zeros(4, 2)
    with pytest.raises(TypeError):
        tgram.gram("eq", x.to(torch.float16), x.to(torch.float16))
    with pytest.raises(TypeError):
        tgram.gram("eq", x, x.double())
    with pytest.raises(ValueError):
        tgram.gram("eq", x, torch.zeros(4, 3))
    with pytest.raises(ValueError):
        tgram.gram("cosine", x, x)


def test_fused_path_is_cuda_only_and_launches_nothing_on_cpu():
    x = torch.randn(5, 2)
    before = tgram.launches
    assert tkernel._fused_gram("eq", x, x) is None
    st.dense(st.EQ()(x))
    assert tgram.launches == before


def _kernel_pairs():
    """(port kernel, JAX kernel) pairs over the kernels of the slice."""
    return {
        "eq": (st.EQ(), sj.EQ()),
        "rq": (st.RQ(0.8), sj.RQ(0.8)),
        "matern12": (st.Matern12(), sj.Matern12()),
        "matern32": (st.Matern32(), sj.Matern32()),
        "matern52": (st.Matern52(), sj.Matern52()),
        "linear": (st.Linear(), sj.Linear()),
        "scaled_stretched": (2.5 * st.EQ().stretch(0.7), 2.5 * sj.EQ().stretch(0.7)),
        "periodic": (st.EQ().stretch(2.0).periodic(1.3), sj.EQ().stretch(2.0).periodic(1.3)),
        "sum": (st.Matern32() + st.EQ().stretch(3.0), sj.Matern32() + sj.EQ().stretch(3.0)),
        "product": (st.Matern52() * st.RQ(1.5), sj.Matern52() * sj.RQ(1.5)),
        "shifted_selected": (
            st.EQ().shift(0.3).select(0),
            sj.EQ().shift(0.3).select(0),
        ),
        "plus_constant": (st.EQ() + 1.5, sj.EQ() + 1.5),
    }


@pytest.mark.parametrize("name", sorted(_kernel_pairs()))
def test_kernel_pairwise_and_elwise_match_jax(name):
    # float64 (rtol 1e-12): the same formulas on the same inputs.
    kt, kj = _kernel_pairs()[name]
    r = np.random.RandomState(7)
    x, y = r.randn(13, 2), r.randn(8, 2)
    np.testing.assert_allclose(
        np_(st.dense(kt(torch.tensor(x), torch.tensor(y)))),
        np_(sj.dense(kj(jnp.asarray(x), jnp.asarray(y)))),
        rtol=1e-12,
        atol=1e-13,
    )
    np.testing.assert_allclose(
        np_(kt.elwise(torch.tensor(x), torch.tensor(x[::-1].copy()))),
        np_(kj.elwise(jnp.asarray(x), jnp.asarray(x[::-1].copy()))),
        rtol=1e-12,
        atol=1e-13,
    )


def _bf16_rne(a):
    """float32 values rounded to bfloat16 to nearest, ties to even, in numpy:
    ``.astype(bfloat16)``'s rounding (finite inputs)."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_gram_bf16_tile_of_float32_inputs(kind, jax_interpret):
    """``out_dtype=bfloat16`` on float32 inputs (the tile-dtype option's
    tile): the float32 tile rounded once to nearest, as the JAX package's
    ``K_b.astype(bfloat16)`` of its float32 kernel's tile."""
    x, y = _xy(7, n=40, m=33)
    out = tgram.gram(kind, torch.tensor(x), torch.tensor(y), 0.8, out_dtype=torch.bfloat16)
    f32 = tgram.gram_plain(kind, torch.tensor(x), torch.tensor(y), 0.8)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(np_(out.float()), _bf16_rne(np_(f32)))
    ref = jgram.gram(kind, jnp.asarray(x), jnp.asarray(y), 0.8).astype(jnp.bfloat16)
    np.testing.assert_allclose(np_(out.float()), np.asarray(ref, np.float32), rtol=2**-7,
                               atol=2**-7 * np.abs(np_(f32)).max())
    # The kernel's tile for a bfloat16 output is the bfloat16 route's.
    assert tgram.tile_shape(torch.bfloat16) == (16, 256)


def test_gram_bf16_tile_gradient_is_the_float32_one():
    # The rounding's derivative is the identity (astype's transpose): the
    # cotangent of the rounded tile, cast up, goes through K1's backward.
    x, y = _xy(8, n=20, m=15, d=2)
    xt = torch.tensor(x, requires_grad=True)
    gbar = torch.tensor(np.random.RandomState(9).randn(20, 15).astype(np.float32))
    out = tgram.gram("matern32", xt, torch.tensor(y), out_dtype=torch.bfloat16)
    (g,) = torch.autograd.grad(out, [xt], gbar.to(torch.bfloat16))
    xr = torch.tensor(x, requires_grad=True)
    (g_ref,) = torch.autograd.grad(tgram.gram("matern32", xr, torch.tensor(y)), [xr],
                                   gbar.to(torch.bfloat16).float())
    np.testing.assert_array_equal(np_(g), np_(g_ref))
    # Other pairs round the tile of the input dtype.
    out64 = tgram.gram("eq", torch.tensor(x, dtype=torch.float64),
                       torch.tensor(y, dtype=torch.float64), out_dtype=torch.bfloat16)
    ref64 = tgram.gram_plain("eq", torch.tensor(x, dtype=torch.float64),
                             torch.tensor(y, dtype=torch.float64)).to(torch.bfloat16)
    assert torch.equal(out64, ref64)
    with pytest.raises(TypeError):
        tgram.gram("eq", xr.detach(), xr.detach(), out_dtype=torch.int32)
