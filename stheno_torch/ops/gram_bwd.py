"""K1's backward: the gradient of the fused Gram, and its plain version.

For ``x (n, d)``, ``y (m, d)`` and the cotangent ``gbar (n, m)`` of
``G = gram(kind, x, y, alpha)``, :func:`gram_bwd` computes

    xbar_i = 2 sum_j W_ij (x_i - y_j),   ybar_j = 2 sum_i W_ij (y_j - x_i),

with ``W = gbar * g'(d2)`` (``linear``: ``gbar y`` and ``gbar^T x``) and,
for ``rq``, ``dalpha = sum_ij gbar_ij K_ij (d2 / (2 alpha base) - log
base)``:

- on CUDA tensors it launches the hand-written kernel of
  ``csrc/gram_bwd.cu``, which replaces the JAX package's ``_gram_bwd``
  (``stheno_tpu/ops/gram.py:198``, XLA, the W-trick): a sweep reads
  ``gbar`` once, recomputes ``d2`` and ``g'`` in registers (K is not read)
  and writes per-block partials of the two reductions once each; a second
  launch, a programmatic dependent of the sweep, adds them in a fixed
  order, so that a result is bitwise the same from run to run; see the
  source's header. The grid (:func:`launch_shape`) follows both extents
  and the card's streaming multiprocessors: 128-column spans for square
  and moderate shapes, long spans whose warps each own their columns for
  wide ones;
- on CPU tensors it runs :func:`gram_bwd_plain`, the same arithmetic in
  plain torch over the same blocks and in the same order of partials,
  which is also what the tests and ``chip_smoke.py`` compare the kernel
  with.

float32, float64 and bfloat16 (computed in float32; each gradient rounded
once to bfloat16). ``ops/gram.py:_Gram`` takes it as its backward.
"""

import functools
from collections import namedtuple

import torch

from . import _build
from .gram import (_DTYPE_CODES, KINDS, _alpha_factor, _apply_kind, _d2, _g_prime, arith_dtype,
                   device_alpha)

__all__ = ["BwdShape", "gram_bwd", "gram_bwd_plain", "launch_shape", "launches"]

#: Number of launches of the CUDA kernel in this process.
launches = 0

#: A launch's grid: ``spans`` column spans of ``span`` columns by ``groups``
#: row groups of ``rows`` rows, one block each; ``wcols`` is 1 (the block's
#: warps share each 128-column tile and split its rows) or 8 (each warp
#: takes its own tiles of the span and every row of the group).
BwdShape = namedtuple("BwdShape", "groups rows spans span wcols")

_SMS = 132  # streaming multiprocessors of an H100 SXM
_WAVE = 2 * _SMS  # blocks resident at once: two an SM
_TILE = 128  # a warp's columns: csrc/gram_bwd.cuh:kBwdTile
_WARPS = 8
_PARTIAL_SHARE = 16  # where a grid has several blocks, its partials at most 1/16 of gbar's n m
_WIDE = 512  # tiles above which the warps take tiles each (wcols = 8)
_STAGE = 96 * 1024  # bytes of shared memory a block stages partials in
_RAMP = 32  # a block's fixed cost, in rows of its sweep
_MAX_GROUPS = 65535  # the grid's y extent
_PLAIN_CHUNK = 1 << 20  # entries of (rows, columns, depth) the plain version takes at once
_PLAIN_CHUNK_CUDA = 1 << 26  # the same on the card, where it is a reference only


def _cdiv(a, b):
    return -(-a // b)


def _depth_width(d):
    """The kernel's depth per pass: its template (1, 2, 4, 8), 8 deeper."""
    return d if d <= 2 else 4 if d <= 4 else 8


def _shares_ok(shape, n, m, d, fold):
    """Whether a grid of more than one block keeps its partials (both
    gradients') within 1/``_PARTIAL_SHARE`` of gbar's ``n m`` entries."""
    if shape.groups * shape.spans == 1:
        return True
    return _work_layout(shape, n, m, d, True, True, False, fold)[-1] * _PARTIAL_SHARE <= n * m


def _stage_bytes(shape, d, itemsize):
    """Shared memory a block stages its warps' partials in
    (``csrc/gram_bwd.cuh:bwd_stage_bytes``, want_x and want_y)."""
    _, rows, _, span, wcols = shape
    dc = _depth_width(d)
    rounds = span // (_TILE * wcols)
    x = wcols * rows * dc if wcols > 1 or rounds > 1 else 0
    y = (_WARPS // wcols) * _TILE * dc if wcols == 1 else 0
    return (x + y) * itemsize


@functools.lru_cache(maxsize=512)
def launch_shape(n, m, d, dtype, fold=False):
    """The launch's :class:`BwdShape` for ``x (n, d)``, ``y (m, d)`` in
    ``dtype`` (``fold``: x is y, both roles into one sum). Block ``(a, b)``
    sweeps the rows ``[a rows, + rows)`` against the columns ``[b span, +
    span)``. Chosen from both extents and the card's 132 SMs: of the grids
    that fit (the block's staged partials in shared memory) and keep the
    partials within 1/16 of ``gbar`` where there are several blocks, the one
    whose waves of two blocks an SM sweep the fewest entries, each block's
    counted with ``_RAMP`` rows more for its start; ties go to fewer
    blocks.

    - Up to ``_WIDE`` tiles of 128 columns: ``wcols = 1``, spans of one tile
      (of a power of two of tiles where the share needs longer spans: deep
      inputs), against row groups.
    - Wider (unless no such grid keeps the share): ``wcols = 8``, spans of
      ``1024 t`` columns, against row groups of at most what a block's
      shared memory stages.
    - Where no grid keeps the share, spans of one tile.

    Depends on the shapes only, so one shape always sums in the same
    order."""
    itemsize = torch.empty((), dtype=arith_dtype(dtype)).element_size()
    tiles = _cdiv(m, _TILE)
    row_options = sorted({_cdiv(n, g) for g in _group_counts(n)})

    def fits(shape):
        return shape.groups <= _MAX_GROUPS and _stage_bytes(shape, d, itemsize) <= _STAGE

    def good(shape):
        return fits(shape) and _shares_ok(shape, n, m, d, fold)

    def tiles_of(t):
        return [BwdShape(_cdiv(n, rows), rows, _cdiv(m, _TILE * t), _TILE * t, 1)
                for rows in row_options]

    cands = []
    if tiles > _WIDE:
        for t in range(1, _cdiv(tiles, _WARPS) + 1):
            span = _TILE * _WARPS * t
            if t > 1 and _cdiv(m, span - _TILE * _WARPS) == _cdiv(m, span):
                continue  # the same spans as t - 1
            cands += [BwdShape(_cdiv(n, rows), rows, _cdiv(m, span), span, _WARPS)
                      for rows in row_options if _WARPS * rows * _depth_width(d) * itemsize
                      <= _STAGE]
    if not any(map(good, cands)):
        cands, t = tiles_of(1), 1
        while not any(map(good, cands)) and _TILE * t < m:
            t *= 2
            cands = tiles_of(t)

    def cost(shape):
        blocks = shape.groups * shape.spans
        return _cdiv(blocks, _WAVE) * (shape.rows + _RAMP) * shape.span, blocks

    pool = [c for c in cands if good(c)] or [c for c in tiles_of(1) if fits(c)]
    return min(pool, key=cost)


def _group_counts(n):
    """Candidate numbers of row groups: every count up to 128, then those
    of power-of-two rows down to 8."""
    counts = set(range(1, min(n, 128) + 1))
    rows = 8
    while rows < n:
        counts.add(_cdiv(n, rows))
        rows *= 2
    return sorted(counts)


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


def _row_chunks(n, rows, per_row, limit):
    """The plain version's row chunks ``(r0, r1)``: whole groups of
    ``rows`` rows (the last may be ragged), as many as hold ``limit``
    entries of ``per_row`` (columns times depth) a row, or parts of one
    group where a group holds more."""
    whole = rows * per_row <= limit
    step = rows * (limit // (rows * per_row)) if whole else max(1, limit // per_row)
    r0 = 0
    while r0 < n:
        r1 = min(n, r0 + step) if whole else min(n, r0 + step, (r0 // rows + 1) * rows)
        yield r0, r1
        r0 = r1


def _span_sums(t, spans, span):
    """``t (c, m, ...)`` summed over each column span: ``(c, spans, ...)``."""
    if spans == 1:
        return t.sum(1, keepdim=True)
    extra = spans * span - t.shape[1]
    if extra:
        t = torch.cat([t, t.new_zeros((t.shape[0], extra, *t.shape[2:]))], 1)
    return t.view(t.shape[0], spans, span, *t.shape[2:]).sum(2)


def gram_bwd_plain(kind, x, y, gbar, alpha=1.0, *, want_x=True, want_y=True, want_alpha=False,
                   same=False, shape=None):
    """Plain torch version of the kernel over the blocks of ``shape``
    (default :func:`launch_shape`), in batched tensor operations: per block
    ``(a, b)``, ``d2`` by the forward's formula, ``W = gbar g'(d2)`` and the
    direct sums over the block's ``(rows, span, d)`` terms ``W_ij (x_ik -
    y_jk)`` into x slice ``b`` and y slice ``a``, then the
    slices added in order: x's, then (with ``same``) y's into the same sum;
    rq's alpha partials, one a block, summed. Returns ``(xbar, ybar,
    dalpha)``, each None where not asked for; with ``same`` (x is y) ``xbar``
    is the sum of both roles and ``ybar`` None."""
    n, d = x.shape
    m = y.shape[0]
    want_alpha = want_alpha and kind == "rq"
    ct = arith_dtype(x.dtype)
    xf, yf, gf = x.to(ct), y.to(ct), gbar.to(ct)
    alpha = torch.as_tensor(alpha, dtype=ct, device=x.device)
    groups, rows, spans, span, _ = shape or launch_shape(n, m, d, x.dtype, same and want_x)
    xs = xf.new_zeros((spans, n, d))
    ys = xf.new_zeros((groups, m, d))
    al = xf.new_zeros((groups, spans))
    limit = _PLAIN_CHUNK_CUDA if x.is_cuda else _PLAIN_CHUNK
    for r0, r1 in _row_chunks(n, rows, m * max(d, 1), limit):
        a0, ng = r0 // rows, (r1 - 1) // rows - r0 // rows + 1  # the chunk's groups
        whole = min(r1 - r0, (ng - 1) * rows)  # rows of its groups but the last

        def group_sums(t):  # (r1 - r0, ...) summed over each group's rows
            if ng * rows == r1 - r0:  # whole groups only
                return t.view(ng, rows, *t.shape[1:]).sum(1)
            last = t[whole:].sum(0, keepdim=True)
            if not whole:
                return last
            return torch.cat([t[:whole].view(ng - 1, rows, *t.shape[1:]).sum(1), last])

        xb, gb = xf[r0:r1], gf[r0:r1]
        if kind == "linear":
            xs[:, r0:r1] = _span_sums(gb[..., None] * yf, spans, span).transpose(0, 1)
            ys[a0:a0 + ng] += group_sums(gb[..., None] * xb[:, None, :])
            continue
        d2 = torch.clamp_min(_d2(xb, yf, xb @ yf.T), 0.0)
        K = _apply_kind(kind, d2, None, alpha)
        terms = (gb * _g_prime(kind, d2, K, alpha))[..., None] * (xb[:, None, :] - yf)  # (c, m, d)
        xs[:, r0:r1] = 2.0 * _span_sums(terms, spans, span).transpose(0, 1)
        ys[a0:a0 + ng] -= 2.0 * group_sums(terms)
        if want_alpha:
            al[a0:a0 + ng] += group_sums(_span_sums(gb * _alpha_factor(d2, K, alpha), spans, span))
    xbar = ybar = dalpha = None
    if same:
        xbar = _ordered_sum(list(xs) + list(ys)).to(x.dtype) if want_x else None
    else:
        xbar = _ordered_sum(list(xs)).to(x.dtype) if want_x else None
        ybar = _ordered_sum(list(ys)).to(y.dtype) if want_y else None
    if want_alpha:
        dalpha = al.flatten().sum()
    return xbar, ybar, dalpha


def _work_layout(shape, n, m, d, want_x, want_y, want_alpha, fold):
    """The partials' layout in ``work`` (``csrc/gram_bwd.cu``): ``(x
    sliced, y sliced, y slices' offset, alpha partials' offset, entries)``.
    x is sliced where several column spans add into a row, y where several
    row groups add into a column (both with ``fold``): ``spans`` x slices of
    ``n d``, then ``groups`` y slices of ``m d``, then one alpha partial a
    block."""
    groups, _, spans, _, _ = shape
    x_sliced, y_sliced = want_x and (fold or spans > 1), want_y and (fold or groups > 1)
    y_work = spans * n * d if x_sliced else 0
    a_work = y_work + (groups * m * d if y_sliced else 0)
    return x_sliced, y_sliced, y_work, a_work, a_work + (groups * spans if want_alpha else 0)


def _launch(kind, x, y, gbar, alpha, want_x, want_y, want_alpha, same, shape=None):
    global launches
    lib = _build.library()
    n, d = x.shape
    m = y.shape[0]
    ct = arith_dtype(x.dtype)
    fold = same and want_x
    groups, rows, spans, span, wcols = shape or launch_shape(n, m, d, x.dtype, fold)
    nx = n * d if want_x else 0
    ny = m * d if want_y and not fold else 0
    work_n = _work_layout(BwdShape(groups, rows, spans, span, wcols), n, m, d, want_x, want_y,
                          want_alpha, fold)[-1]
    out = torch.empty(nx + ny + int(want_alpha), dtype=ct, device=x.device)
    work = torch.empty(work_n, dtype=ct, device=x.device) if work_n else None
    gbar = gbar.contiguous()
    a = device_alpha(kind, alpha, ct, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_gram_bwd(
            KINDS.index(kind), _DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
            gbar.data_ptr(), out.data_ptr(), _build.ptr(work), n, m, d, groups, rows, spans,
            span, wcols, _build.ptr(a), int(want_x), int(want_y), int(want_alpha), int(fold),
            stream,
        )
    _build.check(code, "gram_bwd")
    launches += 1
    xbar = out[:nx].view(n, d).to(x.dtype) if want_x else None
    ybar = out[nx:nx + ny].view(m, d).to(y.dtype) if ny else None
    dalpha = out[nx + ny] if want_alpha else None
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
