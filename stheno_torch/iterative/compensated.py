"""Compensated-precision (two-float) products for kernel solves, and the
small-noise policy that switches them on.

Counterpart of ``stheno_tpu/iterative/compensated.py``. Below a noise of
about ``||K|| eps sqrt(N)`` a float32 Gram matvec's rounding makes the
computed operator effectively indefinite and CG stalls; an operator whose
application error is about 1e-10 relative restores convergence. The JAX
package builds it from two ingredients, both ported here op for op:

1. **Double-float Gram tiles** (:func:`df32_pairwise`): distances by
   direct differencing, the distance and the kernel's exp argument carried
   as ``(hi, lo)`` pairs, so each entry is right to about ``eps K``.
2. **The Ozaki-split product** (:func:`compensated_matmul`): each operand
   split exactly into two 8-bit-significand slices (16 bits in float64)
   with per-row (per-column) power-of-two scales and a full-precision
   tail; the four slice products accumulate exactly and combine by TwoSum
   into a ``(hi, lo)`` pair, and the tails ride ordinary float32 products.

Torch specifics, each a hazard of the JAX design on this stack:

- The slices hold bfloat16-representable values, but are **stored in the
  operand's dtype**: ``torch.matmul`` of two bfloat16 tensors returns
  bfloat16, which would round the exact accumulator to 8 bits, and cuBLAS
  may reduce bfloat16 split-K partials in bfloat16. A float32 product of
  8-bit slices accumulates exactly in any order over sub-blocks of 512
  (every partial sum is an integer multiple of one scale below 2^24), so
  the slice products below are ordinary float32 (float64) products.
- Every product here runs at full float32 (``config.pin_matmul_precision``:
  TF32 off). The tails are meant to be exact to about 1e-10; TF32 would put
  about 2^-11 on each operand.
- Nothing here is fused: eager torch runs each operation as its own
  kernel, so no compiler contracts Dekker's split ``c a - (c a - a)`` into
  an FMA (which would destroy it), and there is no constant folding of
  ``(x + 1) - 1`` to guard against (the JAX package's ``_opaque`` barrier
  answers XLA's simplifier; it has no counterpart here).
- Power-of-two scales are exact: ``torch.frexp`` for the slice scales and
  ``torch.ldexp`` with an integer exponent for the exp's range reduction,
  never ``exp2``.

On the card, the matvec of a kernel expression that K3 fuses does not
take this route: ``matvec.kernel_matvec(compensated=True)`` runs K3's
float64 route on the float32 inputs promoted exactly to float64, which
computes the same function to better than this module's 1e-10 (see
``matvec.py``). This module serves every other expression and the tests;
:func:`compensated_scaled_apply` is the preconditioner's faithful port,
:func:`f64_scaled_apply` the float64 product ``pchol.py`` uses instead.

The policy (``"auto"`` | ``True`` | ``False``): in torch every call is
eager, so ``"auto"`` always decides by value (the JAX package decides by
value only when called eagerly; under ``jax.jit`` it comes out ``False``).
"""

import math

import torch

from .. import config

__all__ = [
    "AUTO_WALL_FACTOR",
    "plain_noise_wall",
    "resolve_compensated",
    "two_sum",
    "two_prod",
    "split_two_slices",
    "compensated_matmul",
    "compensated_scaled_apply",
    "f64_scaled_apply",
    "df32_pairwise",
]

#: ``"auto"`` switches to the compensated matvec below this fraction of
#: the plain noise wall ``||K|| * eps * sqrt(n)`` (the JAX package's
#: constant: the formula's coherent worst case overstates the practical
#: boundary).
AUTO_WALL_FACTOR = 1.0 / 64.0


def plain_noise_wall(lam_max, n, dtype):
    """The plain noise validity floor ``||K|| * eps * sqrt(n)``, with
    ``lam_max`` (e.g. the top Ritz value of an eig-preconditioner state)
    standing in for ``||K||``."""
    return float(lam_max) * math.sqrt(float(n)) * float(torch.finfo(dtype).eps)


def resolve_compensated(compensated, noise, lam, n, dtype, have_comp_mv):
    """Resolve a ``compensated`` policy (``"auto"`` | ``True`` | ``False``)
    to a bool. ``"auto"`` is ``True`` when ``noise < AUTO_WALL_FACTOR *
    plain_noise_wall(max(lam), n, dtype)``. Explicit ``True`` without a
    compensated matvec on the path raises ``ValueError``."""
    if compensated is True:
        if not have_comp_mv:
            raise ValueError(
                "compensated=True but no compensated matvec is available on this path."
            )
        return True
    if compensated in (False, None):
        return False
    if compensated != "auto":
        raise ValueError(f"compensated must be 'auto', True or False, got {compensated!r}")
    if not have_comp_mv:
        return False
    lam = torch.as_tensor(lam).detach()
    lam_max = torch.max(lam) if lam.numel() else 0.0
    noise = float(torch.as_tensor(noise).detach())
    return noise < AUTO_WALL_FACTOR * plain_noise_wall(lam_max, n, dtype)


# ---------------------------------------------------------------------------
# Error-free transformations.


def two_sum(a, b):
    """Knuth's branch-free TwoSum: ``s + err == a + b`` exactly (``s`` the
    rounded sum, ``err`` its rounding error)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split_const(dtype):
    """Dekker's split factor ``2^ceil(p / 2) + 1`` for precision-``p``
    floats."""
    return 134217729.0 if dtype == torch.float64 else 4097.0


def two_prod(a, b):
    """Dekker's TwoProd without FMA: ``p + err == a * b`` exactly."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    c = _split_const(torch.result_type(a, b))
    p = a * b
    a_ = c * a
    a_hi = a_ - (a_ - a)
    a_lo = a - a_hi
    b_ = c * b
    b_hi = b_ - (b_ - b)
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


# ---------------------------------------------------------------------------
# The Ozaki-split product.


def _slice_bits(dtype):
    """Significand bits per slice: 8 for float32 (bfloat16-representable),
    16 for float64."""
    return 16 if dtype == torch.float64 else 8


def _pow2_ceil(a):
    """``2^ceil(log2(a))`` for ``a > 0``, exactly: ``a = m 2^e`` with ``m``
    in [0.5, 1), and ``m == 0.5`` is a power of two itself."""
    m, e = torch.frexp(a)
    return torch.ldexp(torch.ones_like(a), e - (m == 0.5).to(e.dtype))


def split_two_slices(A, axis):
    """Split ``A`` into ``(A1, A2, Ar)`` with ``A == A1 + A2 + Ar``
    exactly: two ``t``-bit-significand slices scaled by powers of two over
    ``axis`` (the contraction axis) and the full-precision tail.

    ``fl((A + M) - M)`` with ``M = 3 * 2^(p - 2) * delta`` rounds ``A`` to
    the nearest multiple of ``delta`` exactly. The slices are returned in
    ``A``'s dtype; for float32 their values are those of the JAX package's
    bfloat16 slices."""
    dtype = A.dtype
    t = _slice_bits(dtype)
    prec = 53 if dtype == torch.float64 else 24
    absmax = torch.amax(torch.abs(A), dim=axis, keepdim=True)
    sigma = _pow2_ceil(torch.clamp_min(absmax, torch.finfo(dtype).tiny))
    d1 = sigma * 2.0 ** (1 - t)
    M1 = (3.0 * 2.0 ** (prec - 2)) * d1
    A1 = (A + M1) - M1
    r1 = A - A1
    M2 = M1 * 2.0 ** (-t)
    A2 = (r1 + M2) - M2
    Ar = r1 - A2
    return A1, A2, Ar


def _exact_slice_matmul(A_sl, B_sl, sub):
    """Slice-pair product with exact accumulation: ``A_sl (m, C)`` and
    ``B_sl (C, p)``, ``C`` a multiple of ``sub``. Each ``sub``-wide block's
    product is exact in the operands' dtype; the blocks' partials combine
    exactly by a TwoSum cascade, in order. Returns ``(hi, lo)``."""
    m, C = A_sl.shape
    p = B_sl.shape[1]
    nsub = C // sub
    parts = torch.bmm(A_sl.reshape(m, nsub, sub).transpose(0, 1), B_sl.reshape(nsub, sub, p))
    hi = torch.zeros((m, p), dtype=A_sl.dtype, device=A_sl.device)
    lo = torch.zeros_like(hi)
    for part in parts:
        hi, err = two_sum(hi, part)
        lo = lo + err
    return hi, lo


def _pad_cols(A, C_pad):
    C = A.shape[1]
    return A if C == C_pad else torch.nn.functional.pad(A, (0, C_pad - C))


@config.pin_matmul_precision
def compensated_matmul(A, B, *, sub=512, fold=True, A_lo=None):
    """``A @ B`` for float32 (float64) operands with about 1e-10 (1e-19)
    relative application error: the Ozaki-split product of the module
    docstring.

    Args:
        A: ``(m, C)`` left operand.
        B: ``(C, p)`` right-hand sides.
        sub: contraction sub-block of the exact slice products; must keep
            ``2^(2t) sub < 2^precision`` (at most 1024 in float32).
        fold: return ``hi + lo`` (default) or the pair ``(hi, lo)``.
        A_lo: optional low word of a double-float left operand ``A +
            A_lo`` (a :func:`df32_pairwise` tile), applied in the tail.
    """
    m, C = A.shape
    C_pad = -(-C // sub) * sub
    A = _pad_cols(A, C_pad)
    if C_pad != C:
        B = torch.nn.functional.pad(B, (0, 0, 0, C_pad - C))
    A1, A2, Ar = split_two_slices(A, axis=1)
    B1, B2, Br = split_two_slices(B, axis=0)
    hi = torch.zeros((m, B.shape[1]), dtype=A.dtype, device=A.device)
    lo = torch.zeros_like(hi)
    for A_sl in (A1, A2):
        for B_sl in (B1, B2):
            h, l_ = _exact_slice_matmul(A_sl, B_sl, sub)
            hi, lo = _df_add(hi, lo, h, l_)
    # The O(2^-2t)-relative tails need only ordinary precision.
    rest = Ar @ B + (A1 + A2) @ Br
    if A_lo is not None:
        rest = rest + _pad_cols(A_lo, C_pad) @ B
    hi, lo = _df_add(hi, lo, rest)
    return hi + lo if fold else (hi, lo)


# ---------------------------------------------------------------------------
# Double-float arithmetic and Gram tiles of the stationary kernels.


def _df_norm(h, l_):
    return two_sum(h, l_)


def _df_add(h1, l1, h2, l2=None):
    """Double-float add ``(h1, l1) + (h2[, l2])``, renormalised."""
    h, e = two_sum(h1, h2)
    lo = e + l1 if l2 is None else e + l1 + l2
    return _df_norm(h, lo)


def _df_mul(h1, l1, h2, l2):
    p, e = two_prod(h1, h2)
    return _df_norm(p, e + h1 * l2 + l1 * h2)


def _df_scale(s, h, l_):
    s = torch.as_tensor(s, dtype=h.dtype, device=h.device)
    p, e = two_prod(s, h)
    return _df_norm(p, e + s * l_)


# exp(u) in double-float (the JAX package's scheme): Cody-Waite reduction
# u = k ln2 + r against a split ln2 (k * LN2_HI exact), exp(r) = 1 + r +
# r^2/2 + r^3/6 + r^4 R(r) with the leading terms in double-float and the
# remainder polynomial R plain (it enters at the r^4 scale), then the exact
# power-of-two scale by ldexp.
_LN2_HI = 0.693359375  # 10 significand bits: k * LN2_HI exact for |k| < 2^14.
_LN2_LO = -2.121944400546905827679e-4
_EXP_R_COEFS = [1.0 / math.factorial(j + 4) for j in range(6)]
_C3_H = float(torch.tensor(1.0 / 6.0, dtype=torch.float32))
_C3_L = 1.0 / 6.0 - _C3_H


def _df_exp(h, l_):
    k = torch.round(h * (1.0 / (_LN2_HI + _LN2_LO)))
    rh = h - k * _LN2_HI  # Exact (Sterbenz).
    ph, pe = two_prod(k, torch.full_like(k, _LN2_LO))
    rh, rl = _df_add(rh, l_, -ph, -pe)
    R = torch.full_like(rh, _EXP_R_COEFS[-1])
    for c in reversed(_EXP_R_COEFS[:-1]):
        R = R * rh + c
    r2h, r2e = two_prod(rh, rh)
    r2e = r2e + 2.0 * rh * rl
    r3h, r3e = two_prod(r2h, rh)
    r3e = r3e + r2e * rh + r2h * rl
    q4 = (r2h * r2h) * R
    t2h, t2e = 0.5 * r2h, 0.5 * r2e
    t3h, t3p = two_prod(r3h, torch.full_like(r3h, _C3_H))
    t3e = t3p + r3h * _C3_L + r3e * _C3_H
    s1h, s1e = two_sum(torch.ones_like(rh), rh)
    s2h, s2e = two_sum(s1h, t2h)
    s3h, s3e = two_sum(s2h, t3h)
    el = s1e + s2e + s3e + rl + t2e + t3e + q4
    eh, er = two_sum(s3h, el)
    ki = k.to(torch.int32)
    return torch.ldexp(eh, ki), torch.ldexp(er, ki)


def _df_sqrt(h, l_):
    s = torch.sqrt(h)
    p, pe = two_prod(s, s)
    pos = s > 0
    denom = torch.where(pos, 2.0 * s, torch.ones_like(s))
    s_lo = torch.where(pos, ((h - p) - pe + l_) / denom, torch.zeros_like(s))
    return s, s_lo


def _df_log(h, l_):
    """``log(h + l)``: the plain log plus one Newton correction."""
    L = torch.log(h)
    return L, (h * torch.exp(-L) - 1.0) + l_ / h


def _df32_dists2(x, y, inv_scale):
    """Double-float squared distances ``(m, n)``, the factor ``inv_scale``
    applied to the differences (scaling the inputs first would bring back
    the near-diagonal cancellation)."""
    hi = lo = None
    for di in range(x.shape[-1]):
        dd, dd_e = two_sum(x[:, None, di], -y[None, :, di])  # The exact difference.
        if inv_scale is not None:
            s = inv_scale[di] if inv_scale.ndim > 0 else inv_scale
            p, pe = two_prod(dd, s.expand_as(dd))
            dd, dd_e = p, pe + dd_e * s
        sq, sq_e = two_prod(dd, dd)
        sq_e = sq_e + 2.0 * dd * dd_e
        if hi is None:
            hi, lo = sq, sq_e
        else:
            hi, lo = _df_add(hi, lo, sq, sq_e)
    return hi, lo


def _one(like):
    return torch.ones((), dtype=like.dtype, device=like.device)


def _df32_pw(k, x, y, inv_scale):
    """The double-float tile ``(hi, lo)`` of ``k``, or ``None`` where the
    expression has no rule. ``inv_scale`` carries shared stretches down to
    the distances."""
    from ..kernels import kernel as K

    if isinstance(k, K.EQ):
        d2h, d2l = _df32_dists2(x, y, inv_scale)
        return _df_exp(-0.5 * d2h, -0.5 * d2l)
    if isinstance(k, K.Matern12):
        rh, rl = _df_sqrt(*_df32_dists2(x, y, inv_scale))
        return _df_exp(-rh, -rl)
    if isinstance(k, K.Matern32):
        rh, rl = _df_sqrt(*_df32_dists2(x, y, inv_scale))
        rh, rl = _df_scale(3.0**0.5, rh, rl)
        eh, el = _df_exp(-rh, -rl)
        th, tl = _df_add(_one(rh), torch.zeros_like(_one(rh)), rh, rl)
        return _df_mul(th, tl, eh, el)
    if isinstance(k, K.Matern52):
        rh, rl = _df_sqrt(*_df32_dists2(x, y, inv_scale))
        rh, rl = _df_scale(5.0**0.5, rh, rl)
        r2h, r2l = _df_mul(rh, rl, rh, rl)
        ph, pl = _df_add(_one(rh), torch.zeros_like(_one(rh)), rh, rl)
        ph, pl = _df_add(ph, pl, r2h / 3.0, r2l / 3.0)
        eh, el = _df_exp(-rh, -rl)
        return _df_mul(ph, pl, eh, el)
    if isinstance(k, K.RQ):
        alpha = torch.as_tensor(k.alpha, dtype=x.dtype, device=x.device)
        d2h, d2l = _df32_dists2(x, y, inv_scale)
        th, tl = _df_add(_one(d2h), torch.zeros_like(_one(d2h)),
                         d2h / (2.0 * alpha), d2l / (2.0 * alpha))
        Lh, Ll = _df_log(th, tl)
        # The exp argument -alpha log(t) carried in double-float (the JAX
        # package scales it in plain float32, which leaves its rounding,
        # |u| eps, on every entry).
        return _df_exp(*_df_scale(-alpha, Lh, Ll))
    if isinstance(k, K.ScaledKernel):
        sub = _df32_pw(k.k, x, y, inv_scale)
        return None if sub is None else _df_scale(k.scale, *sub)
    if isinstance(k, K.SumKernel):
        s1 = _df32_pw(k.k1, x, y, inv_scale)
        s2 = _df32_pw(k.k2, x, y, inv_scale)
        return None if s1 is None or s2 is None else _df_add(*s1, *s2)
    if isinstance(k, K.ProductKernel):
        s1 = _df32_pw(k.k1, x, y, inv_scale)
        s2 = _df32_pw(k.k2, x, y, inv_scale)
        return None if s1 is None or s2 is None else _df_mul(*s1, *s2)
    if isinstance(k, K.StretchedKernel):
        if k.s1 is not k.s2:
            return None
        inv = 1.0 / torch.as_tensor(k.s1, dtype=x.dtype, device=x.device)
        if inv.ndim > 1:
            return None
        return _df32_pw(k.k, x, y, inv if inv_scale is None else inv_scale * inv)
    if isinstance(k, K.ShiftedKernel):
        # A shared shift cancels in the differences of a stationary child.
        if k.s1 is not k.s2 or not k.k.stationary:
            return None
        return _df32_pw(k.k, x, y, inv_scale)
    if isinstance(k, K.ZeroKernel):
        z = torch.zeros((x.shape[0], y.shape[0]), dtype=x.dtype, device=x.device)
        return z, z
    if isinstance(k, K.OneKernel):
        o = torch.ones((x.shape[0], y.shape[0]), dtype=x.dtype, device=x.device)
        return o, torch.zeros_like(o)
    return None


def df32_pairwise(k, x, y):
    """The double-float Gram tile ``(hi, lo)`` of a stationary kernel
    expression (entry error about ``eps K``), or ``None`` when the
    expression has no rule (EQ, RQ, the Matérns under shared stretches and
    shifts, scalings, sums and products have one)."""
    x = x[:, None] if x.ndim == 1 else x
    y = y[:, None] if y.ndim == 1 else y
    return _df32_pw(k, x, y, None)


# ---------------------------------------------------------------------------
# The eig preconditioner's application.


@config.pin_matmul_precision
def compensated_scaled_apply(U, coeff, base, v):
    """Two-float ``base * v + U @ (coeff * (U^T @ v))``, the
    eig-preconditioner application with its cancellation compensated: both
    products through :func:`compensated_matmul`, the sum kept in
    double-float until one final rounding."""
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    Uv_hi, Uv_lo = compensated_matmul(U.T, v2, fold=False)
    p_hi, p_err = two_prod(coeff[:, None].expand_as(Uv_hi), Uv_hi)
    p_lo = coeff[:, None] * Uv_lo + p_err
    c_hi, c_lo = compensated_matmul(U, p_hi, fold=False)
    c_lo = c_lo + U @ p_lo
    b_hi, b_err = two_prod(torch.as_tensor(base, dtype=v2.dtype, device=v2.device)
                           .expand_as(v2), v2)
    out_hi, e = two_sum(c_hi, b_hi)
    out = out_hi + (c_lo + e + b_err)
    return out[:, 0] if squeeze else out


@config.pin_matmul_precision
def f64_scaled_apply(U, coeff, base, v):
    """``base * v + U @ (coeff * (U^T @ v))`` in float64 on the operands
    promoted exactly, rounded once to ``v``'s dtype: the same function as
    :func:`compensated_scaled_apply` to about 1e-16 relative, from two
    float64 products."""
    wide = torch.float64
    squeeze = v.ndim == 1
    v2 = (v[:, None] if squeeze else v).to(wide)
    U64 = U.to(wide)
    coeff = torch.as_tensor(coeff, device=v.device).to(wide)
    base = torch.as_tensor(base, device=v.device).to(wide)
    out = (v2 * base + U64 @ (coeff[:, None] * (U64.T @ v2))).to(v.dtype)
    return out[:, 0] if squeeze else out
