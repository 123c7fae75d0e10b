"""Fused Gram x V (kernel K3) and its plain version.

Counterpart of ``stheno_tpu/ops/gram_matvec.py``. :func:`gram_matvec`
computes ``g(d2(x, y)) @ v`` (or ``(x y^T) @ v`` for ``linear``) for
``x (n, d)``, ``y (m, d)`` and ``v (m, p)`` without storing the ``(n, m)``
Gram:

- on CUDA tensors it launches a hand-written kernel, which replaces the
  TPU kernel ``stheno_tpu/ops/gram_matvec.py:_gmv_kernel``. :func:`route`
  picks it: float32 with ``p >= 17`` takes the tensor-core kernel of
  ``csrc/gram_matvec_mma.cu`` (a split-precision 3xTF32 product, p padded
  to 24, 32, 64 or 128 columns per block), everything else (float32 with
  ``p <= 16``, where the exp per entry and not the product sets the floor,
  and float64) the FFMA kernel of ``csrc/gram_matvec.cu``. See the
  sources' headers for what bounds each;
- on CPU tensors it runs :func:`gram_matvec_plain`, blocked
  ``gram_plain(kind, x_b, y) @ v`` in plain torch, which is also what the
  tests and ``chip_smoke.py`` compare the kernel with.
  :func:`gram_matvec_split_plain` emulates the tensor-core kernel's
  arithmetic for the tests; nothing on the path calls it.

float32 and float64, all six kinds of :data:`~stheno_torch.ops.gram.KINDS`.
Forward only, as in the JAX package: a call through which a gradient would
flow raises; nothing is detached silently. The differentiable product is
``ops/gram_matvec_vjp.py:_GramMatvecFn``, whose forward is this function
and whose backward is the fused Gram-gradient kernel.

The route and launch shape are chosen here, in Python, so that the CPU
tests reach them: :func:`route` picks the kernel and :func:`launch_shape`
/ :func:`mma_launch_shape` how many output columns a thread or block
holds and how the column sweep is split across blocks.
"""

import math

import torch

from . import _build
from .gram import KINDS, gram_plain

__all__ = [
    "gram_matvec",
    "gram_matvec_plain",
    "gram_matvec_split_plain",
    "launch_shape",
    "launches",
    "mma_launch_shape",
    "route",
]

#: Number of launches of either CUDA kernel in this process.
launches = 0

_THREADS = 128  # threads per block, as kThreads in csrc/gram_matvec.cu
_TN = 64  # columns staged per pass, as kTN
_TARGET_BLOCKS = 8 * 132  # eight blocks for each SM of an H100
_MIN_SPAN = 1024  # the fewest columns a column split sweeps
_MMA_MIN_P = 17  # float32 from this width on takes the tensor cores
_MMA_ROWS = 128  # rows per block of the tensor-core kernel (kWgRows)
_MMA_TARGET_BLOCKS = 4 * 132  # four of its blocks for each SM of an H100


def _width(p):
    """Output columns a thread accumulates (the kernel's ``PC``)."""
    for pc in (1, 4, 8, 16):
        if p <= pc:
            return pc
    return 32


def _rows_per_thread(pc, itemsize):
    """Rows a thread owns (the kernel's ``rows_per_thread``)."""
    return max(1, min(4, 256 // (pc * itemsize)))


def launch_shape(n, m, p, itemsize):
    """``(pc, span, splits)`` of a launch: ``pc`` output columns per
    thread, and the column sweep split into ``splits`` ranges of ``span``
    columns where the row blocks times the p-splits alone would leave the
    card short of blocks. Depends on the shapes only, so one shape always
    sums in the same order."""
    pc = _width(p)
    rows = _THREADS * _rows_per_thread(pc, itemsize)
    blocks = math.ceil(n / rows) * math.ceil(p / pc)
    want = math.ceil(_TARGET_BLOCKS / blocks)
    splits = max(1, min(want, math.ceil(m / _MIN_SPAN), 65535))
    span = math.ceil(math.ceil(m / splits) / _TN) * _TN
    return pc, span, math.ceil(m / span)


def mma_launch_shape(n, m, p):
    """``(nb, span, splits)`` of a tensor-core launch: ``nb`` output
    columns per block (p padded to 24, 32, 64 or 128; wider p splits over
    blocks of 128), and the column sweep split as in :func:`launch_shape`.
    Depends on the shapes only."""
    nb = next(w for w in (24, 32, 64, 128) if p <= w or w == 128)
    blocks = math.ceil(n / _MMA_ROWS) * math.ceil(p / nb)
    want = math.ceil(_MMA_TARGET_BLOCKS / blocks)
    splits = max(1, min(want, math.ceil(m / _MIN_SPAN), 65535))
    span = math.ceil(math.ceil(m / splits) / _TN) * _TN
    return nb, span, math.ceil(m / span)


def _mma_split_floats(m, p, nb):
    """Floats of one part (high or low) of v as the tensor-core kernel
    stages it: a 64 x nb tile per pass of 64 columns and per p-split."""
    return math.ceil(m / _TN) * math.ceil(p / nb) * _TN * nb


def route(n, m, p, dtype):
    """``(kernel, width, span, splits)`` of a launch: ``"mma"`` (the
    tensor-core kernel, ``width`` columns per block) for float32 with
    ``p >= 17``, else ``"ffma"`` (``width`` columns per thread)."""
    if dtype == torch.float32 and p >= _MMA_MIN_P:
        return ("mma", *mma_launch_shape(n, m, p))
    return ("ffma", *launch_shape(n, m, p, torch.finfo(dtype).bits // 8))


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
    dims = (n, m, d, p, width, span, splits, float(alpha) if kind == "rq" else 1.0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "mma":
            # v's TF32 high and low parts, in the kernel's tile order.
            vsplit = torch.empty(2 * _mma_split_floats(m, p, width), dtype=x.dtype,
                                 device=x.device)
            code = lib.stheno_gram_matvec_mma(KINDS.index(kind), *ptrs, vsplit.data_ptr(),
                                              *dims, stream)
        else:
            code = lib.stheno_gram_matvec(KINDS.index(kind), int(x.dtype == torch.float64),
                                          *ptrs, *dims, stream)
    _build.check(code, f"gram_matvec ({kernel})")
    launches += 1
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
