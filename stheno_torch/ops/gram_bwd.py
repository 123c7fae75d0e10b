"""K1's backward: the gradient of the fused Gram, and its plain version.

For ``x (n, d)``, ``y (m, d)`` and the cotangent ``gbar (n, m)`` of
``G = gram(kind, x, y, alpha)``, :func:`gram_bwd` computes

    xbar_i = 2 sum_j W_ij (x_i - y_j),   ybar_j = 2 sum_i W_ij (y_j - x_i),

with ``W = gbar * g'(d2)`` (``linear``: ``gbar y`` and ``gbar^T x``) and,
for ``rq``, ``dalpha = sum_ij gbar_ij K_ij (d2 / (2 alpha base) - log
base)``:

- on CUDA tensors it launches the hand-written kernel of
  ``csrc/gram_bwd.cu``, which replaces the JAX package's ``_gram_bwd``
  (``stheno_tpu/ops/gram.py:198``, XLA, the W-trick): it reads ``gbar``
  once, recomputes ``d2`` and ``g'`` in registers (K is not read), and
  sums the two reductions through per-block partials added in a fixed
  order, so that a result is bitwise the same from run to run; see the
  source's header;
- on CPU tensors it runs :func:`gram_bwd_plain`, the same arithmetic in
  plain torch over the same blocks and in the same order of partials,
  which is also what the tests and ``chip_smoke.py`` compare the kernel
  with.

float32, float64 and bfloat16 (computed in float32; each gradient rounded
once to bfloat16). ``ops/gram.py:_Gram`` takes it as its backward.
"""

import torch

from . import _build
from .gram import (_DTYPE_CODES, KINDS, _alpha_factor, _apply_kind, _d2, _g_prime, arith_dtype,
                   device_alpha)

__all__ = ["gram_bwd", "gram_bwd_plain", "launch_shape", "launches"]

#: Number of launches of the CUDA kernel in this process.
launches = 0

_SPLITS = 16  # at most 16 x 16 = 256 blocks: one wave of two for each SM of an H100
_PARTIAL_SHARE = 16  # the partials, S (n + m) d, at most 1/16 of gbar's n m


def _cdiv(a, b):
    return -(-a // b)


def launch_shape(n, m, d, dtype):
    """``(splits, rows, span)``: the S x S grid of a launch, S =
    ``splits``, block ``(a, b)`` sweeping the rows ``[a rows, + rows)``
    against the columns ``[b span, + span)``. ``span`` is whole 16-byte
    vectors of the dtype, every span holds columns, and S is bounded so
    that the partials (S slices of ``(n + m) d``) stay a small share of
    ``gbar``. Depends on the shapes only, so one shape always sums in the
    same order."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    cap = (n * m) // (_PARTIAL_SHARE * (n + m) * max(d, 1))
    s0 = max(1, min(_SPLITS, cap, _cdiv(m, vec)))
    span = _cdiv(_cdiv(m, s0), vec) * vec
    splits = _cdiv(m, span)
    return splits, _cdiv(n, splits), span


def _check(kind, x, y, gbar):
    if kind not in KINDS:
        raise ValueError(f"Unknown gram kind {kind!r}.")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1] or gbar.shape != (
        x.shape[0], y.shape[0]
    ):
        raise ValueError(
            f"gram_bwd: need x (n, d), y (m, d), gbar (n, m); got {tuple(x.shape)}, "
            f"{tuple(y.shape)}, {tuple(gbar.shape)}"
        )
    if len({x.dtype, y.dtype, gbar.dtype}) != 1 or x.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"gram_bwd takes float32, float64 or bfloat16 inputs of one dtype; got {x.dtype}, "
            f"{y.dtype}, {gbar.dtype}."
        )
    if not (x.device == y.device == gbar.device):
        raise ValueError("gram_bwd: x, y and gbar must lie on one device")


def _ordered_sum(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def gram_bwd_plain(kind, x, y, gbar, alpha=1.0, *, want_x=True, want_y=True, want_alpha=False,
                   same=False, shape=None):
    """Plain torch version of the kernel: per block ``(a, b)`` of
    ``shape`` (default :func:`launch_shape`), ``d2`` by the forward's
    formula, ``W = gbar g'(d2)`` and the direct sums over the block's
    ``(rows, span, d)`` differences into slice ``b`` (x) and ``a`` (y),
    then the slices added in order: x's, then (with ``same``) y's into the
    same sum. Returns ``(xbar, ybar, dalpha)``, each None where not asked
    for; with ``same`` (x is y) ``xbar`` is the sum of both roles and
    ``ybar`` None."""
    n, d = x.shape
    m = y.shape[0]
    want_alpha = want_alpha and kind == "rq"
    ct = arith_dtype(x.dtype)
    xf, yf, gf = x.to(ct), y.to(ct), gbar.to(ct)
    alpha = torch.as_tensor(alpha, dtype=ct, device=x.device)
    splits, rows, span = shape or launch_shape(n, m, d, x.dtype)
    scale = 1.0 if kind == "linear" else 2.0
    xs = xf.new_zeros((splits, n, d))
    ys = xf.new_zeros((splits, m, d))
    al = xf.new_zeros((splits, splits))
    for a in range(splits):
        r = slice(a * rows, min(n, (a + 1) * rows))
        if r.start >= r.stop:
            continue
        for b in range(splits):
            c = slice(b * span, min(m, (b + 1) * span))
            xb, yb, gb = xf[r], yf[c], gf[r, c]
            if kind == "linear":
                xs[b, r], ys[a, c] = gb @ yb, gb.T @ xb
                continue
            d2 = torch.clamp_min(_d2(xb, yb, xb @ yb.T), 0.0)
            K = _apply_kind(kind, d2, None, alpha)
            W = gb * _g_prime(kind, d2, K, alpha)
            diff = xb[:, None, :] - yb[None, :, :]
            xs[b, r] = scale * torch.einsum("ij,ijk->ik", W, diff)
            ys[a, c] = -scale * torch.einsum("ij,ijk->jk", W, diff)
            if want_alpha:
                al[b, a] = torch.sum(gb * _alpha_factor(d2, K, alpha))
    xbar = ybar = dalpha = None
    if same:
        xbar = _ordered_sum(list(xs) + list(ys)).to(x.dtype) if want_x else None
    else:
        xbar = _ordered_sum(list(xs)).to(x.dtype) if want_x else None
        ybar = _ordered_sum(list(ys)).to(y.dtype) if want_y else None
    if want_alpha:
        dalpha = _ordered_sum(list(al)).sum()
    return xbar, ybar, dalpha


def _launch(kind, x, y, gbar, alpha, want_x, want_y, want_alpha, same):
    global launches
    lib = _build.library()
    n, d = x.shape
    m = y.shape[0]
    ct = arith_dtype(x.dtype)
    splits, rows, span = launch_shape(n, m, d, x.dtype)
    fold = same and want_x
    nx = n * d if want_x else 0
    ny = m * d if want_y and not fold else 0
    na = splits if want_alpha else 0
    count = nx + ny + na
    slices = 2 * splits if fold else splits
    out = torch.empty(count, dtype=ct, device=x.device)
    work = torch.empty(slices * count, dtype=ct, device=x.device) if slices > 1 else None
    gbar = gbar.contiguous()
    a = device_alpha(kind, alpha, ct, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_gram_bwd(
            KINDS.index(kind), _DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
            gbar.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(), n, m, d,
            rows, span, splits, _build.ptr(a), int(want_x),
            int(want_y), int(want_alpha), int(fold), stream,
        )
    _build.check(code, "gram_bwd")
    launches += 1
    xbar = out[:nx].view(n, d).to(x.dtype) if want_x else None
    ybar = out[nx:nx + ny].view(m, d).to(y.dtype) if ny else None
    dalpha = out[nx + ny:].sum() if want_alpha else None
    return xbar, ybar, dalpha


def gram_bwd(kind, x, y, gbar, alpha=1.0, *, want_x=True, want_y=True, want_alpha=False,
             same=False):
    """``(xbar, ybar, dalpha)``: the gradients of ``sum(gbar * gram(kind,
    x, y, alpha))`` with respect to ``x``, ``y`` and (rq with
    ``want_alpha``) ``alpha``, each None where not asked for: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. With
    ``same`` (``x`` is ``y``) ``xbar`` is the gradient of the one input,
    both roles, and ``ybar`` None. ``dalpha`` takes ``alpha``'s dtype where
    ``alpha`` is a tensor."""
    _check(kind, x, y, gbar)
    want_alpha = want_alpha and kind == "rq"
    if same:
        want_y = want_x
    if not (want_x or want_y or want_alpha) or x.shape[0] == 0 or y.shape[0] == 0:
        zero = lambda t, want: torch.zeros_like(t) if want else None  # noqa: E731
        dalpha = x.new_zeros((), dtype=arith_dtype(x.dtype)) if want_alpha else None
        return zero(x, want_x), None if same else zero(y, want_y), dalpha
    x, y = x.contiguous(), (x.contiguous() if same else y.contiguous())
    if x.is_cuda:
        out = _launch(kind, x, y, gbar, alpha, want_x, want_y, want_alpha, same)
    else:
        out = gram_bwd_plain(kind, x, y, gbar, alpha, want_x=want_x, want_y=want_y,
                             want_alpha=want_alpha, same=same)
    xbar, ybar, dalpha = out
    if dalpha is not None and isinstance(alpha, torch.Tensor):
        dalpha = dalpha.to(alpha.dtype)
    return xbar, ybar, dalpha


class _GramBwd(torch.autograd.Function):
    """``gram_bwd(kind, x, y, gbar, alpha)``, differentiable again: what
    ``ops/gram.py:_Gram.backward`` returns, on every device. Forward: the
    backward kernel for CUDA tensors, the plain version for CPU tensors.
    ``jvp``: the forward rule (``ops/gram_bwd_jvp.py:_GramBwdJvp``), which
    ``torch.func.hessian`` (forward over reverse) takes, in one launch for
    all its directions. ``backward`` (reverse over reverse) from the two
    tangent kernels: ``gbar``'s cotangent is K1's tangent (``gram_jvp``)
    along the output cotangents ``(xbar', ybar', dalpha')``, and ``x``'s,
    ``y``'s and ``alpha``'s are the backward's own tangent along the same
    direction with ``gbar`` held, since the Hessian of ``sum(gbar * G)`` is
    symmetric. ``vmap``: one call per member of a batch. Inputs: ``x, y,
    alpha, gbar, kind, want_x, want_y, want_alpha, same``, with ``y`` None
    when ``same`` (``x`` is ``y``: ``xbar`` is both roles'); outputs
    ``(xbar, ybar, dalpha)``, None where not asked for."""

    @staticmethod
    def forward(x, y, alpha, gbar, kind, want_x, want_y, want_alpha, same):
        return gram_bwd(kind, x, x if same else y, gbar, alpha, want_x=want_x, want_y=want_y,
                        want_alpha=want_alpha, same=same)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y, alpha, gbar, kind, want_x, want_y, want_alpha, same = inputs
        ctx.flags = (kind, want_x, want_y, want_alpha, same)
        ctx.save_for_backward(x, y, alpha, gbar)
        ctx.save_for_forward(x, y, alpha, gbar)

    @staticmethod
    def jvp(ctx, xt, yt, at, gt, *_):
        from .gram_bwd_jvp import _GramBwdJvp

        kind, want_x, want_y, want_alpha, same = ctx.flags
        x, y, alpha, gbar = ctx.saved_tensors
        at = at if kind == "rq" else None
        if xt is None and yt is None and at is None and gt is None:
            return _zero_outputs(x, y, kind, *ctx.flags[1:])
        return _GramBwdJvp.apply(x, y, alpha, gbar, xt, yt, at, gt, *ctx.flags)

    @staticmethod
    def backward(ctx, xbb, ybb, abb):
        from .gram_bwd_jvp import _GramBwdJvp
        from .gram_jvp import _GramJvp

        kind, _, _, _, same = ctx.flags
        x, y, alpha, gbar = ctx.saved_tensors
        need_x, need_y, need_alpha, need_g = ctx.needs_input_grad[:4]
        abb = abb if kind == "rq" else None
        if xbb is None and ybb is None and abb is None:
            return (None,) * 9
        gx = gy = ga = gg = None
        if need_g:
            gg = _GramJvp.apply(x, x if same else y, alpha, xbb, xbb if same else ybb, abb,
                                kind).to(gbar.dtype)
        if need_x or need_y or (need_alpha and kind == "rq"):
            gx, gy, ga = _GramBwdJvp.apply(x, y, alpha, gbar, xbb, None if same else ybb, abb,
                                           None, kind, need_x, need_y and not same,
                                           need_alpha, same)
        if ga is not None:
            ga = ga.to(alpha.dtype)
        return gx, gy, ga, gg, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, y, alpha, gbar, kind, want_x, want_y, want_alpha, same):
        from .gram import _member
        from .gram_bwd_jvp import _stack

        outs = [_GramBwd.apply(*(_member(t, d, i) for t, d in zip((x, y, alpha, gbar), in_dims)),
                               kind, want_x, want_y, want_alpha, same)
                for i in range(info.batch_size)]
        return _stack(outs)


def _zero_outputs(x, y, kind, want_x, want_y, want_alpha, same):
    """Zero tangents of ``_GramBwd``'s outputs."""
    xo = torch.zeros_like(x) if want_x else None
    yo = torch.zeros_like(y) if want_y and not same else None
    ao = x.new_zeros((), dtype=arith_dtype(x.dtype)) if want_alpha and kind == "rq" else None
    return xo, yo, ao
