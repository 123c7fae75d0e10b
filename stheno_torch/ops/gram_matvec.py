"""Fused Gram x V (kernel K3) and its plain version.

Counterpart of ``stheno_tpu/ops/gram_matvec.py``. :func:`gram_matvec`
computes ``g(d2(x, y)) @ v`` (or ``(x y^T) @ v`` for ``linear``) for
``x (n, d)``, ``y (m, d)`` and ``v (m, p)`` without storing the ``(n, m)``
Gram:

- on CUDA tensors it launches the hand-written kernel in
  ``csrc/gram_matvec.cu``, which replaces the TPU kernel
  ``stheno_tpu/ops/gram_matvec.py:_gmv_kernel``. It is bound by
  operations (``2 n m p`` FMA flops against ``O((n + m)(d + p))`` bytes;
  for ``p = 1`` by the one exp per entry); see the source's header;
- on CPU tensors it runs :func:`gram_matvec_plain`, blocked
  ``gram_plain(kind, x_b, y) @ v`` in plain torch, which is also what the
  tests and ``chip_smoke.py`` compare the kernel with.

float32 and float64, all six kinds of :data:`~stheno_torch.ops.gram.KINDS`.
Forward only, as in the JAX package: the iterative NLML differentiates a
surrogate sweep built from K1 tiles, never this product. A call through
which a gradient would flow raises; nothing is detached silently.

The launch shape is chosen here, in Python, so that the CPU tests reach
it: :func:`launch_shape` picks how many output columns a thread holds and
how the column sweep is split across blocks.
"""

import math

import torch

from . import _build
from .gram import KINDS, gram_plain

__all__ = ["gram_matvec", "gram_matvec_plain", "launch_shape", "launches"]

#: Number of launches of the CUDA kernel in this process.
launches = 0

_THREADS = 128  # threads per block, as kThreads in csrc/gram_matvec.cu
_TN = 64  # columns staged per pass, as kTN
_TARGET_BLOCKS = 8 * 132  # eight blocks for each SM of an H100
_MIN_SPAN = 1024  # the fewest columns a column split sweeps


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
    pc, span, splits = launch_shape(n, m, p, x.element_size())
    work = torch.empty((splits, n, p), dtype=x.dtype, device=x.device) if splits > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_gram_matvec(
            KINDS.index(kind),
            int(x.dtype == torch.float64),
            x.data_ptr(),
            y.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            None if work is None else work.data_ptr(),
            n,
            m,
            d,
            p,
            pc,
            span,
            splits,
            float(alpha) if kind == "rq" else 1.0,
            stream,
        )
    _build.check(code, "gram_matvec")
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
            "Differentiate the blocked Gram sweep (iterative.kernel_matvec takes it "
            "when a gradient is needed) or call it under torch.no_grad()."
        )
    if not x.is_cuda:
        return gram_matvec_plain(kind, x, y, v, alpha)
    return _launch(kind, x.contiguous(), y.contiguous(), v.contiguous(), alpha)
