"""Fused Gram x V (kernel K3) and its plain version.

Counterpart of ``stheno_tpu/ops/gram_matvec.py``. :func:`gram_matvec`
computes ``g(d2(x, y)) @ v`` (or ``(x y^T) @ v`` for ``linear``) for
``x (n, d)``, ``y (m, d)`` and ``v (m, p)`` without storing the ``(n, m)``
Gram:

- on CUDA tensors it launches a hand-written kernel, which replaces the
  TPU kernel ``stheno_tpu/ops/gram_matvec.py:_gmv_kernel``. :func:`route`
  picks it from the shapes and the dtype:

  - ``"mma"``, float32 with ``p >= 17``: the tensor-core kernel of
    ``csrc/gram_matvec_mma.cu`` (a split-precision 3xTF32 product, p
    padded to 24, 32, 64 or 128 columns per block);
  - ``"ffma"``, float32 with ``p <= 16``, where the exp per entry and not
    the product sets the floor: the FFMA kernel of ``csrc/gram_matvec.cu``,
    whose exp kinds run in base 2 on the special-function unit, their
    constant folded into x and y;
  - ``"dmma"``, float64 at every p: ``csrc/gram_matvec_f64.cu``, each entry
    built in float64 as its own FP64 tensor-core fragment (p padded to a
    multiple of 8, or one column of p = 8 k + 1 on DFMA), with an exp
    written for the epilogue's arguments.

  See the sources' headers for what bounds each;
- on CPU tensors it runs :func:`gram_matvec_plain`, blocked
  ``gram_plain(kind, x_b, y) @ v`` in plain torch, which is also what the
  tests and ``chip_smoke.py`` compare the kernels with.
  :func:`gram_matvec_split_plain` and :func:`gram_matvec_ex2_plain` emulate
  the float32 kernels' arithmetic for the tests; nothing on the path calls
  them.

float32 and float64, all six kinds of :data:`~stheno_torch.ops.gram.KINDS`.
Forward only, as in the JAX package: a call through which a gradient would
flow raises; nothing is detached silently. The differentiable product is
``ops/gram_matvec_vjp.py:_GramMatvecFn``, whose forward is this function
and whose backward is the fused Gram-gradient kernel.

The route and launch shape are chosen here, in Python, so that the CPU
tests reach them: :func:`route` picks the kernel and :func:`launch_shape`,
:func:`mma_launch_shape` and :func:`dmma_launch_shape` how many output
columns a thread or block holds and how the column sweep is split across
blocks.
"""

import math

import torch

from . import _build
from .gram import KINDS, device_alpha, gram_plain

__all__ = [
    "dmma_launch_shape",
    "gram_matvec",
    "gram_matvec_ex2_plain",
    "gram_matvec_plain",
    "gram_matvec_split_plain",
    "launch_shape",
    "launches",
    "mma_launch_shape",
    "route",
    "route_launches",
]

#: Number of launches of K3's kernels in this process.
launches = 0
#: The same by route (:func:`route`): their sum is :data:`launches`.
route_launches = {"mma": 0, "ffma": 0, "dmma": 0}

_THREADS = 128  # threads per block of the FFMA kernel, as kThreads in csrc/gram_matvec.cu
_TN = 64  # columns staged per pass, as kTN
_TARGET_BLOCKS = 8 * 132  # eight blocks for each SM of an H100
_MIN_SPAN = 1024  # the fewest columns a column split sweeps
_MMA_MIN_P = 17  # float32 from this width on takes the tensor cores
_MMA_ROWS = 128  # rows per block of the tensor-core kernel (kWgRows)
_MMA_TARGET_BLOCKS = 4 * 132  # four blocks of either tensor-core kernel for each SM of an H100
_DMMA_WIDTHS = (8, 16, 24, 32, 64)  # output columns per block of the float64 kernel
_DMMA_ROWS = 64  # its rows per block (kDmmaRows)


def _width(p):
    """Output columns a thread of the FFMA kernel accumulates (its
    ``PC``), for ``p <= 16``."""
    return next(pc for pc in (1, 4, 8, 16) if p <= pc)


def _rows_per_thread(pc):
    """Rows a thread of the FFMA kernel owns (its ``rows_per_thread``)."""
    return max(1, min(4, 64 // pc))


def _split_columns(m, blocks, target):
    """``(span, splits)``: the column sweep split into ``splits`` ranges of
    ``span`` columns (a multiple of 64) where ``blocks`` alone would leave
    the card short of ``target`` blocks; a range sweeps at least about
    1024 columns. Depends on the shapes only, so one shape always sums in
    the same order."""
    want = math.ceil(target / blocks)
    splits = max(1, min(want, math.ceil(m / _MIN_SPAN), 65535))
    span = math.ceil(math.ceil(m / splits) / _TN) * _TN
    return span, math.ceil(m / span)


def launch_shape(n, m, p):
    """``(pc, span, splits)`` of a float32 FFMA launch (``p <= 16``):
    ``pc`` output columns per thread and the column split."""
    pc = _width(p)
    rows = _THREADS * _rows_per_thread(pc)
    return (pc, *_split_columns(m, math.ceil(n / rows), _TARGET_BLOCKS))


def mma_launch_shape(n, m, p):
    """``(nb, span, splits)`` of a tensor-core launch: ``nb`` output
    columns per block (p padded to 24, 32, 64 or 128; wider p splits over
    blocks of 128), and the column split."""
    nb = next(w for w in (24, 32, 64, 128) if p <= w or w == 128)
    blocks = math.ceil(n / _MMA_ROWS) * math.ceil(p / nb)
    return (nb, *_split_columns(m, blocks, _MMA_TARGET_BLOCKS))


def dmma_launch_shape(n, m, p):
    """``(nb, span, splits)`` of a float64 launch: ``nb`` output columns
    per block (p padded to 8, 16, 24, 32 or 64, wider p split over blocks
    of 64; but p = 1, 9, 17, 25 or 33 exactly, its last column on DFMA),
    and the column split."""
    if p % 8 == 1 and p <= 33:
        nb = p
    else:
        nb = next(w for w in _DMMA_WIDTHS if p <= w or w == _DMMA_WIDTHS[-1])
    blocks = math.ceil(n / _DMMA_ROWS) * math.ceil(p / nb)
    return (nb, *_split_columns(m, blocks, _MMA_TARGET_BLOCKS))


def _mma_split_floats(m, p, nb):
    """Floats of one part (high or low) of v as the tensor-core kernel
    stages it: a 64 x nb tile per pass of 64 columns and per p-split."""
    return math.ceil(m / _TN) * math.ceil(p / nb) * _TN * nb


def route(n, m, p, dtype):
    """``(kernel, width, span, splits)`` of a launch: ``"dmma"`` (the
    float64 kernel, ``width`` columns per block) for float64, ``"mma"``
    (the tensor-core kernel, ``width`` columns per block) for float32 with
    ``p >= 17``, else ``"ffma"`` (``width`` columns per thread)."""
    if dtype == torch.float64:
        return ("dmma", *dmma_launch_shape(n, m, p))
    if p >= _MMA_MIN_P:
        return ("mma", *mma_launch_shape(n, m, p))
    return ("ffma", *launch_shape(n, m, p))


def _tf32(z):
    """Round float32 ``z`` to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits'
    range to the magnitude, then clear them."""
    bits = z.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(z):
    """``(hi, lo)`` as the tensor-core kernel reads them: ``hi`` rounded to
    TF32, ``lo = z - hi`` truncated to TF32 (the MMA reads only its top
    bits)."""
    hi = _tf32(z)
    lo = (z - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def gram_matvec_split_plain(kind, x, y, v, alpha=1.0, block=4096):
    """Plain emulation of the tensor-core kernel's arithmetic, float32:
    each Gram entry and each v entry split into TF32 high and low parts
    (:func:`_split`), ``G_lo v_hi + G_hi v_lo + G_hi v_hi`` formed per pass
    of 64 columns from zero and added to the running total. For the
    tests; nothing on the path calls it."""
    vh, vl = _split(v)
    out = []
    for xb in torch.split(x, block):
        gh, gl = _split(gram_plain(kind, xb, y, alpha))
        total = torch.zeros((xb.shape[0], v.shape[1]), dtype=v.dtype, device=v.device)
        for j0 in range(0, y.shape[0], _TN):
            s = slice(j0, j0 + _TN)
            total = total + (gl[:, s] @ vh[s] + gh[:, s] @ vl[s] + gh[:, s] @ vh[s])
        out.append(total)
    return torch.cat(out, dim=0) if out else v.new_zeros((0, v.shape[1]))


#: The factor the float32 FFMA kernel folds into x and y
#: (``csrc/gram_matvec.cu:prescale``): the scaled d2 (eq) or distance
#: (the Matérns) is the exponent of 2. rq and linear keep their arithmetic.
_PRESCALE = {
    "eq": math.sqrt(0.5 / math.log(2)),
    "matern12": 1 / math.log(2),
    "matern32": math.sqrt(3) / math.log(2),
    "matern52": math.sqrt(5) / math.log(2),
}


def gram_matvec_ex2_plain(kind, x, y, v, alpha=1.0):
    """Plain emulation of the float32 FFMA kernel's arithmetic: x and y
    scaled by :data:`_PRESCALE` in float32, the norms and the inner product
    by one multiply-add chain over the depth (so d2 is exactly 0 where x is
    y), and the exp kinds in base 2, ``torch.exp2`` standing in for
    ``ex2.approx``; rq and linear as :func:`gram_plain`. For the tests;
    nothing on the path calls it."""
    if kind not in _PRESCALE:
        return gram_plain(kind, x, y, alpha) @ v
    c = torch.tensor(_PRESCALE[kind], dtype=x.dtype)
    xs, ys = x * c, y * c
    xn = torch.zeros(x.shape[0], dtype=x.dtype)
    yn = torch.zeros(y.shape[0], dtype=x.dtype)
    inner = torch.zeros((x.shape[0], y.shape[0]), dtype=x.dtype)
    for k in range(x.shape[1]):
        xn = xn + xs[:, k] * xs[:, k]
        yn = yn + ys[:, k] * ys[:, k]
        inner = inner + xs[:, k, None] * ys[None, :, k]
    d2 = torch.clamp_min((xn[:, None] + yn[None, :]) - 2 * inner, 0.0)
    if kind == "eq":
        return torch.exp2(-d2) @ v
    d = torch.sqrt(d2 + 1e-36)
    e = torch.exp2(-d)
    r = d * math.log(2)
    poly = {"matern12": 1.0, "matern32": 1 + r, "matern52": 1 + r + r * r / 3}[kind]
    return (poly * e) @ v


def gram_matvec_plain(kind, x, y, v, alpha=1.0, block=4096):
    """Plain torch version: ``gram_plain(kind, x_b, y) @ v`` over row
    blocks of ``block`` rows, so at most a ``(block, m)`` tile is held."""
    if x.shape[0] == 0:
        return v.new_zeros((0, v.shape[1]))
    return torch.cat(
        [gram_plain(kind, xb, y, alpha) @ v for xb in torch.split(x, block)], dim=0
    )


def _launch(kind, x, y, v, alpha):
    global launches
    lib = _build.library()
    n, d = x.shape
    m, p = v.shape
    out = torch.empty((n, p), dtype=x.dtype, device=x.device)
    if n == 0 or p == 0:
        return out
    if m == 0:
        return out.zero_()
    kernel, width, span, splits = route(n, m, p, x.dtype)
    work = torch.empty((splits, n, p), dtype=x.dtype, device=x.device) if splits > 1 else None
    ptrs = (x.data_ptr(), y.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr())
    a = device_alpha(kind, alpha, x.dtype, x.device)
    dims = (n, m, d, p, width, span, splits, _build.ptr(a))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "mma":
            # v's TF32 high and low parts, in the kernel's tile order.
            vsplit = torch.empty(2 * _mma_split_floats(m, p, width), dtype=x.dtype,
                                 device=x.device)
            code = lib.stheno_gram_matvec_mma(KINDS.index(kind), *ptrs, vsplit.data_ptr(),
                                              *dims, stream)
        elif kernel == "dmma":
            code = lib.stheno_gram_matvec_dmma(KINDS.index(kind), *ptrs, *dims, stream)
        else:
            code = lib.stheno_gram_matvec(KINDS.index(kind), *ptrs, *dims, stream)
    _build.check(code, f"gram_matvec ({kernel})")
    launches += 1
    route_launches[kernel] += 1
    return out


def gram_matvec(kind, x, y, v, alpha=1.0):
    """``g(d2(x, y)) @ v`` for ``x (n, d)``, ``y (m, d)``, ``v (m, p)``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Forward only: raises if a gradient would flow through the call."""
    if kind not in KINDS:
        raise ValueError(f"Unknown gram kind {kind!r}.")
    if x.ndim != 2 or y.ndim != 2 or v.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(
            f"gram_matvec: need x (n, d), y (m, d), v (m, p); got {tuple(x.shape)}, "
            f"{tuple(y.shape)}, {tuple(v.shape)}"
        )
    if v.shape[0] != y.shape[0]:
        raise ValueError(f"gram_matvec: v has {v.shape[0]} rows for {y.shape[0]} columns of y")
    if (
        x.dtype != y.dtype
        or x.dtype != v.dtype
        or x.dtype not in (torch.float32, torch.float64)
    ):
        raise TypeError(
            f"gram_matvec takes float32 or float64 inputs of one dtype; got {x.dtype}, "
            f"{y.dtype}, {v.dtype}."
        )
    if not (x.device == y.device == v.device):
        raise ValueError(f"gram_matvec: x on {x.device}, y on {y.device}, v on {v.device}")
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in (x, y, v, alpha)
    ):
        raise RuntimeError(
            "gram_matvec is forward-only: a gradient would flow through this call. "
            "Differentiate ops.gram_matvec_vjp._GramMatvecFn (iterative.kernel_matvec "
            "takes it when a gradient is needed) or call it under torch.no_grad()."
        )
    if not x.is_cuda:
        return gram_matvec_plain(kind, x, y, v, alpha)
    return _launch(kind, x.contiguous(), y.contiguous(), v.contiguous(), alpha)
