"""The forward rule of K1's backward: the tangent of the Gram's gradient
along a batch of directions, and its plain version.

For ``x (n, d)``, ``y (m, d)``, the cotangent ``gbar (n, m)`` of ``G =
gram(kind, x, y, alpha)`` and ``B`` tangent directions ``xt (B, n, d)``,
``yt (B, m, d)``, ``gt (B, n, m)`` (of ``gbar``) and, for rq, ``at (B,)``,
each of which may be None (a zero tangent), :func:`gram_bwd_jvp` returns the
tangents of :func:`~stheno_torch.ops.gram_bwd.gram_bwd`'s ``(xbar, ybar,
dalpha)``: with ``W = gbar g'(d2)``, ``r_ij = x_i - y_j`` and ``rt_ij =
xt_i - yt_j``,

    xbar'_i = 2 sum_j [W'_ij r_ij + W_ij rt_ij],   ybar'_j = -2 sum_i [same],
    W' = gt g' + gbar g'' d2' + gbar (d g'/d alpha) at,   d2' = 2 <r, rt>,

for rq also ``dalpha' = sum [gt h + gbar ((d g'/d alpha) d2' + (d h/d alpha)
at)]`` (``h = dK/d alpha``), and for linear ``gt y + gbar yt`` and ``gt^T x
+ gbar^T xt``. ``d2`` is clamped at 0 as the backward clamps it; where the
clamp bites the entry is flat in ``d2``. A ``d2'`` of 0 drops its terms:
where ``x`` is ``y`` the diagonal's ``r`` and ``rt`` are 0 exactly, so it
adds exactly 0 whatever ``gbar`` and ``gt`` hold there (Matérn-1/2's ``g''``
is infinite in float32 there).

- On CUDA tensors (float32 or float64) it launches
  ``csrc/gram_bwd_jvp.cu``: one sweep for all of a call's directions at
  depth 1 (up to 8; more take further sweeps of 8), then the fixed-order
  sum of its partials. It replaces no Pallas kernel: on the TPU the JAX
  package's forward mode differentiates the XLA backward ``_gram_bwd``
  (``stheno_tpu/ops/gram.py:198``) op by op; a ctypes launch of K1's
  backward carries no tangents, so the port needs one. It is bound by
  reading ``gbar`` and the ``B`` tiles ``gt`` (64.1 MB at 2000 x 2000, B =
  3, float32: 19.1 us at 3.35 TB/s). Blocks of one 128-column span
  (:func:`bwd_jvp_shape`) read them in 16-byte vectors, the next step's
  loads in flight (float32 in registers, float64 through a ring of shared
  memory), keep the y partials in registers across the row sweep and write
  each partial once, with no barrier inside the sweep; see the source's
  header. On an H100 (700 W) a call at 2000 x 2000, eq, x is y, takes
  about 0.035 device ms at B = 3 in float32, 0.019 at B = 1 and 0.058 at B
  = 3 in float64 (``PERF.md`` §6, ``scripts/torch_k1.py jvb``).
- On CPU tensors it runs :func:`gram_bwd_jvp_plain`, the same arithmetic in
  plain torch over the same blocks, which the tests hold to ``jax.jvp`` of
  ``_gram_bwd`` and ``chip_smoke.py`` holds the kernel to.

``_GramBwdJvp`` is the Function that ``ops/gram_bwd.py:_GramBwd``'s ``jvp``
and ``backward`` call: its ``vmap`` rule is the batched launch, so
``torch.func.hessian`` (a ``vmap`` of forward over reverse) takes one
launch for all its directions.
"""

import torch

from . import _build
from .gram import (_DTYPE_CODES, KINDS, _alpha_factor, _alpha_second, _apply_kind, _d2,
                   _g_prime, _g_second, _member, arith_dtype, device_alpha)
from .gram_bwd import _cdiv, _ordered_sum

__all__ = ["gram_bwd_jvp", "gram_bwd_jvp_plain", "launches"]

#: Number of launches of the CUDA kernel in this process.
launches = 0

_DTYPES = (torch.float32, torch.float64)
_SPAN = 128  # columns of a block: csrc/gram_bwd_jvp.cuh:kJvbSpan
_ROWS = 128  # rows of a block's group: 16,000 of the flagship's entries a block
_BLOCKS = 256  # halve the groups below this many blocks: two a streaming multiprocessor
_MIN_ROWS = 32
_MAX_GROUPS = 65535  # the grid's y extent


def _batch(*tangents):
    return next(t.shape[0] for t in tangents if t is not None)


def bwd_jvp_shape(n, m, d):
    """The launch's ``(splits, rows, span)``: ``splits`` row groups of
    ``rows`` rows against ``ceil(m / span)`` column spans of ``span`` =
    ``_SPAN`` columns (a warp's 32 lanes of 4: one 16-byte load of float32
    or two of float64), one block each. The row groups are about
    ``max(_ROWS, 16 d)`` rows, halved while the grid has fewer than
    ``_BLOCKS`` blocks and a group keeps ``max(_MIN_ROWS, 16 d)`` rows (the
    y partials, ``splits m d`` a direction, stay at most 1/16 of a tangent
    tile). Depends on the shapes only, so one shape always sums in the same
    order, whatever the dtype and the number of directions."""
    span = _SPAN
    spans = _cdiv(m, span)
    groups = _cdiv(n, max(_ROWS, 16 * d))
    while groups * spans < _BLOCKS and _cdiv(n, 2 * groups) >= max(_MIN_ROWS, 16 * d):
        groups *= 2
    rows = _cdiv(n, min(groups, _MAX_GROUPS))
    return _cdiv(n, rows), rows, span


def gram_bwd_jvp_plain(kind, x, y, gbar, alpha=1.0, xt=None, yt=None, at=None, gt=None, *,
                       want_x=True, want_y=True, want_alpha=False, same=False, shape=None):
    """Plain torch version of the kernel: per block ``(a, b)`` of ``shape``
    (default :func:`bwd_jvp_shape`: row group ``a``, column span ``b``),
    the terms of the module docstring summed over the block into x slice
    ``b`` and y slice ``a``, then the slices added in order: x's, then
    (with ``same``) y's into the same sum. Returns ``(xbar' (B, n, d),
    ybar' (B, m, d), dalpha' (B,))``, each None where not asked for; with
    ``same`` (``y`` is ``x`` and ``yt`` is ``xt``) ``xbar'`` is the sum of
    both roles and ``ybar'`` None."""
    want_alpha = want_alpha and kind == "rq"
    if same:
        y, yt, want_y = x, xt, want_x
    ct = arith_dtype(x.dtype)
    batch = _batch(xt, yt, at, gt)
    n, d = x.shape
    m = y.shape[0]
    cast = lambda t: None if t is None else t.to(ct)  # noqa: E731
    xf, yf, gf, xtf, ytf, gtf = (cast(t) for t in (x, y, gbar, xt, yt, gt))
    atf = None if at is None or kind != "rq" else at.to(ct)
    alpha = torch.as_tensor(alpha, dtype=ct, device=x.device)
    splits, rows, span = shape or bwd_jvp_shape(n, m, d)
    spans = _cdiv(m, span)
    scale = 1.0 if kind == "linear" else 2.0
    xs = xf.new_zeros((spans, batch, n, d))
    ys = xf.new_zeros((splits, batch, m, d))
    al = xf.new_zeros((batch, splits, spans))
    zero = xf.new_zeros(())
    for a in range(splits):
        r = slice(a * rows, min(n, (a + 1) * rows))
        if r.start >= r.stop:
            continue
        for b in range(spans):
            c = slice(b * span, min(m, (b + 1) * span))
            xb, yb, gb = xf[r], yf[c], gf[r, c]
            xtb = zero if xtf is None else xtf[:, r]  # (B, rows, d)
            ytb = zero if ytf is None else ytf[:, c]  # (B, span, d)
            gtb = zero if gtf is None else gtf[:, r, c]  # (B, rows, span)
            if kind == "linear":
                if gtf is not None:
                    xs[b, :, r] += gtb @ yb
                    ys[a, :, c] += gtb.mT @ xb
                if ytf is not None:
                    xs[b, :, r] += gb @ ytb
                if xtf is not None:
                    ys[a, :, c] += gb.T @ xtb
                continue
            d2 = _d2(xb, yb, xb @ yb.T)
            flat = d2 < 0
            d2 = torch.clamp_min(d2, 0.0)
            K = _apply_kind(kind, d2, None, alpha)
            gp = _g_prime(kind, d2, K, alpha)
            diff = xb[:, None, :] - yb[None, :, :]  # (rows, span, d)
            tdiff = (xtb[:, :, None, :] if xtf is not None else zero) - (
                ytb[:, None, :, :] if ytf is not None else zero)
            tdiff = torch.broadcast_to(tdiff, (batch,) + diff.shape)
            dd2 = torch.where(flat, 0.0, 2.0 * torch.einsum("ijk,bijk->bij", diff, tdiff))
            drop = dd2 == 0
            wd = gtb * gp + torch.where(drop, 0.0, gb * _g_second(kind, d2, K, alpha) * dd2)
            if kind == "rq":
                gpa, haa = _alpha_second(d2, K, alpha)
                atb = zero if atf is None else atf[:, None, None]
                wd = wd + gb * gpa * atb
                if want_alpha:
                    e = gtb * _alpha_factor(d2, K, alpha) + gb * haa * atb + torch.where(
                        drop, 0.0, gb * gpa * dd2)
                    al[:, a, b] = torch.broadcast_to(e, (batch,) + d2.shape).sum((1, 2))
            t = wd[..., None] * diff + (gb * gp)[..., None] * tdiff  # (B, rows, span, d)
            xs[b, :, r] = scale * t.sum(2)
            ys[a, :, c] = -scale * t.sum(1)
    xdot = ydot = adot = None
    if same:
        xdot = _ordered_sum(list(xs) + list(ys)).to(x.dtype) if want_x else None
    else:
        xdot = _ordered_sum(list(xs)).to(x.dtype) if want_x else None
        ydot = _ordered_sum(list(ys)).to(y.dtype) if want_y else None
    if want_alpha:
        adot = al.flatten(1).sum(-1)
    return xdot, ydot, adot


def _launch(kind, x, y, gbar, alpha, xt, yt, at, gt, want_x, want_y, want_alpha, same):
    global launches
    lib = _build.library()
    n, d = x.shape
    m = y.shape[0]
    batch = _batch(xt, yt, at, gt)
    splits, rows, span = bwd_jvp_shape(n, m, d)
    spans = _cdiv(m, span)
    fold = same and want_x
    nx = batch * n * d if want_x else 0
    ny = batch * m * d if want_y and not fold else 0
    na = batch * splits * spans if want_alpha else 0
    # The x slices (one a column span), then the y slices (one a row group).
    slices = spans * nx + splits * (nx if fold else ny)
    out = torch.empty(nx + ny + na, dtype=x.dtype, device=x.device)
    work = torch.empty(slices, dtype=x.dtype, device=x.device) if slices else None
    prep = lambda t: None if t is None else t.to(x.dtype).contiguous()  # noqa: E731
    gbar, xt, yt, gt = (prep(t) for t in (gbar, xt, yt, gt))
    at = None if at is None or kind != "rq" else prep(at)
    a = device_alpha(kind, alpha, x.dtype, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_gram_bwd_jvp(
            KINDS.index(kind), _DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
            gbar.data_ptr(), _build.ptr(gt), _build.ptr(xt), _build.ptr(yt), _build.ptr(a),
            _build.ptr(at), out.data_ptr(), _build.ptr(work), batch, n, m, d, rows, span,
            splits, int(want_x), int(want_y), int(want_alpha), int(fold), stream,
        )
    _build.check(code, "gram_bwd_jvp")
    launches += 1
    xdot = out[:nx].view(batch, n, d) if want_x else None
    ydot = out[nx:nx + ny].view(batch, m, d) if ny else None
    adot = out[nx + ny:].view(batch, -1).sum(-1) if want_alpha else None
    return xdot, ydot, adot


def gram_bwd_jvp(kind, x, y, gbar, alpha=1.0, xt=None, yt=None, at=None, gt=None, *,
                 want_x=True, want_y=True, want_alpha=False, same=False):
    """The tangents ``(xbar' (B, n, d), ybar' (B, m, d), dalpha' (B,))`` of
    ``gram_bwd(kind, x, y, gbar, alpha)`` along the directions ``xt (B, n,
    d)``, ``yt (B, m, d)``, ``at (B,)`` and ``gt (B, n, m)``, each of which
    may be None (a zero tangent), not all; each output None where not asked
    for. With ``same`` (``x`` is ``y``, and ``yt`` is ``xt``) ``xbar'`` is
    the tangent of the one input's gradient, both roles, and ``ybar'``
    None. The kernel for CUDA tensors (float32 or float64; one launch), the
    plain version for CPU tensors."""
    if kind not in KINDS:
        raise ValueError(f"Unknown gram kind {kind!r}.")
    if xt is None and yt is None and at is None and gt is None:
        raise ValueError("gram_bwd_jvp: give at least one of xt, yt, at and gt.")
    want_alpha = want_alpha and kind == "rq"
    if same:
        y, yt, want_y = x, xt, want_x
    batch = _batch(xt, yt, at, gt)
    n, m = x.shape[0], y.shape[0]
    if not (want_x or want_y or want_alpha) or n == 0 or m == 0 or x.shape[1] == 0:
        zero = lambda t, want: t.new_zeros((batch,) + t.shape) if want else None  # noqa: E731
        adot = x.new_zeros((batch,), dtype=arith_dtype(x.dtype)) if want_alpha else None
        return zero(x, want_x), None if same else zero(y, want_y), adot
    if not x.is_cuda:
        return gram_bwd_jvp_plain(kind, x, y, gbar, alpha, xt, yt, at, gt, want_x=want_x,
                                  want_y=want_y, want_alpha=want_alpha, same=same)
    if x.dtype not in _DTYPES or y.dtype != x.dtype or gbar.dtype != x.dtype:
        raise TypeError(
            f"gram_bwd_jvp: the kernel takes float32 or float64 inputs of one dtype; got "
            f"{x.dtype}, {y.dtype}, {gbar.dtype}."
        )
    return _launch(kind, x.contiguous(), y.contiguous(), gbar, alpha, xt, yt, at, gt,
                   want_x, want_y, want_alpha, same)


class _GramBwdJvp(torch.autograd.Function):
    """The tangent of ``gram_bwd(kind, x, y, gbar, alpha)`` along ``(xt,
    yt, at, gt)``, one direction (``xt (n, d)``, ``yt (m, d)``, ``at``
    0-dim, ``gt (n, m)``, each may be None): what ``_GramBwd.jvp`` returns,
    and with ``gt`` None the Hessian-vector product that
    ``_GramBwd.backward`` takes. Its ``vmap`` rule launches the kernel once
    for a batch of directions. Not itself differentiable. Inputs: ``x, y,
    alpha, gbar, xt, yt, at, gt, kind, want_x, want_y, want_alpha, same``
    (``y`` and ``yt`` None with ``same``)."""

    @staticmethod
    def forward(x, y, alpha, gbar, xt, yt, at, gt, kind, want_x, want_y, want_alpha, same):
        lift = lambda t: None if t is None else t[None]  # noqa: E731
        outs = gram_bwd_jvp(kind, x, x if same else y, gbar, alpha, lift(xt), lift(yt),
                            lift(at), lift(gt), want_x=want_x, want_y=want_y,
                            want_alpha=want_alpha, same=same)
        return tuple(None if o is None else o[0] for o in outs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, y, alpha, gbar, xt, yt, at, gt, kind, want_x, want_y,
             want_alpha, same):
        batch = info.batch_size
        args = (x, y, alpha, gbar, xt, yt, at, gt)
        flags = (kind, want_x, want_y, want_alpha, same)
        if any(d is not None for d in in_dims[:4]):
            # A batch of primals (a vmap over data or over chains): one call
            # per member.
            outs = [_GramBwdJvp.apply(*(_member(t, dim, i) for t, dim in zip(args, in_dims)),
                                      *flags) for i in range(batch)]
            return _stack(outs)

        def lead(t, dim):
            if t is None:
                return None
            if dim is None:
                return t.expand((batch,) + t.shape)
            return t.movedim(dim, 0)

        xt, yt, at, gt = (lead(t, dim) for t, dim in zip(args[4:], in_dims[4:8]))
        outs = gram_bwd_jvp(kind, x, x if same else y, gbar, alpha, xt, yt, at, gt,
                            want_x=want_x, want_y=want_y, want_alpha=want_alpha, same=same)
        return outs, tuple(None if o is None else 0 for o in outs)


def _stack(outs):
    """A vmap rule's per-member outputs, stacked at dim 0 (None stays)."""
    stacked = tuple(None if parts[0] is None else torch.stack(parts) for parts in zip(*outs))
    return stacked, tuple(None if o is None else 0 for o in stacked)
