"""Fused pairwise-distance + Gram matrix (kernel K1) and its plain version.

Counterpart of ``stheno_tpu/ops/gram.py``. :func:`gram` computes
``g(||x_i - y_j||^2)`` (or ``x_i . y_j`` for ``linear``) for ``x (n, d)``
and ``y (m, d)``:

- on CUDA tensors it launches the hand-written kernel in
  ``csrc/gram.cu``, which replaces the TPU kernel
  ``stheno_tpu/ops/gram.py:_gram_kernel``. It is bound by the ``(n, m)``
  output write (the contraction depth ``d`` is a few), so it holds the
  depth in registers (a template per depth 1, 2, 4 and 8) and stores 16
  bytes a thread, one block per tile (:func:`launch_shape`); see the
  source's header;
- on CPU tensors it runs :func:`gram_plain`, the same arithmetic in plain
  torch, which is also what the tests and ``chip_smoke.py`` compare the
  kernel with.

float32, float64 and bfloat16, as the TPU kernel takes: bfloat16 inputs
are computed in float32 (norms, inner product, clamp, epilogue) and the
result is rounded once to bfloat16. ``out_dtype=torch.bfloat16`` on
float32 inputs is the matrix-free matvec's tile-dtype option
(``stheno_tpu/iterative/matvec.py``: ``K_b.astype(tile_dtype)``): the
float32 tile rounded once to nearest, in one launch of the kernel's
float32-in, bfloat16-out instance; any other ``out_dtype`` rounds the
tile of the input dtype with ``.to``.

The gradient is an ``autograd.Function`` whose backward is K1's backward
kernel (``ops/gram_bwd.py``, ``csrc/gram_bwd.cu``) on the card and its
plain version on the CPU: ``xbar_i = 2 sum_j W_ij (x_i - y_j)`` with ``W =
gbar * g'(d2)``, the gradient of the JAX package's ``_gram_bwd`` in its
direct form, itself differentiable (``ops/gram_bwd.py:_GramBwd``, whose
forward rule is ``ops/gram_bwd_jvp.py``). Its forward rule is the tangent
kernel (``ops/gram_jvp.py``, ``csrc/gram_jvp.cu``). rq's alpha reaches
every kernel as a device pointer (:func:`device_alpha`).
"""

import collections
import math

import torch

from .. import config
from . import _build

__all__ = ["gram", "gram_plain", "launch_shape", "tile_shape", "device_alpha", "KINDS", "DTYPES",
           "launches"]

#: Kernel functions, in the order of the ``Kind`` enum of ``csrc/gram_kind.cuh``.
KINDS = ("eq", "rq", "matern12", "matern32", "matern52", "linear")

#: Storage dtypes the kernels take, with the codes of ``csrc/gram_elem.cuh``.
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
DTYPES = tuple(_DTYPE_CODES)
#: The code of float32 inputs with a bfloat16 output.
_F32_BF16 = 3
_MIXED = (torch.float32, torch.bfloat16)

#: Number of launches of the CUDA kernel in this process.
launches = 0

_WARPS = 8  # warps per block, as kGramWarps in csrc/gram_elem.cuh


def arith_dtype(dtype):
    """The dtype the kernels compute in: float32 for bfloat16 storage."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _apply_kind(kind, d2, inner, alpha):
    """Elementwise kernel function of the squared distance."""
    if kind == "linear":
        return inner
    d2 = torch.clamp_min(d2, 0.0)
    if kind == "eq":
        return torch.exp(-0.5 * d2)
    if kind == "rq":
        return (1.0 + d2 / (2.0 * alpha)) ** (-alpha)
    d = torch.sqrt(d2 + 1e-36)
    if kind == "matern12":
        return torch.exp(-d)
    if kind == "matern32":
        r = math.sqrt(3.0) * d
        return (1.0 + r) * torch.exp(-r)
    if kind == "matern52":
        r = math.sqrt(5.0) * d
        return (1.0 + r + r * r / 3.0) * torch.exp(-r)
    raise ValueError(f"Unknown gram kind {kind!r}.")


def _d2(x, y, inner):
    xn = torch.sum(x * x, dim=-1, keepdim=True)
    yn = torch.sum(y * y, dim=-1, keepdim=True)
    return xn + yn.T - 2.0 * inner


def _g_prime(kind, d2, K, alpha):
    """dK/d(d2) as a function of d2 (and the entry K)."""
    if kind == "eq":
        return -0.5 * K
    if kind == "rq":
        return -0.5 * (1.0 + d2 / (2.0 * alpha)) ** (-alpha - 1.0)
    d = torch.sqrt(torch.clamp_min(d2, 0.0) + 1e-36)
    if kind == "matern12":
        return -0.5 * K / d
    if kind == "matern32":
        return -1.5 * torch.exp(-math.sqrt(3.0) * d)
    if kind == "matern52":
        r5 = math.sqrt(5.0)
        return -(5.0 / 6.0) * (1.0 + r5 * d) * torch.exp(-r5 * d)
    raise ValueError(kind)


def _g_second(kind, d2, K, alpha):
    """d^2 K / d(d2)^2 as a function of d2 (and the entry K), the
    arithmetic of ``csrc/gram_kind.cuh:g_second``. Matérn-1/2's and
    Matérn-3/2's grow as ``1 / d^3`` and ``1 / d`` at coincident points."""
    if kind == "eq":
        return 0.25 * K
    if kind == "rq":
        return 0.25 * (1.0 + 1.0 / alpha) * K / (1.0 + d2 / (2.0 * alpha)) ** 2
    d = torch.sqrt(torch.clamp_min(d2, 0.0) + 1e-36)
    if kind == "matern12":
        return 0.25 * K * (1.0 + d) / (d * d * d)
    if kind == "matern32":
        r = math.sqrt(3.0) * d
        return 2.25 * torch.exp(-r) / r
    if kind == "matern52":
        return (25.0 / 12.0) * torch.exp(-math.sqrt(5.0) * d)
    raise ValueError(kind)


def _alpha_second(d2, K, alpha):
    """rq's ``(d g' / d alpha, d^2 K / d alpha^2)``: with ``u = d2 / (2
    alpha base)`` and ``q = u - log base`` (so that dK/d(alpha) = K q),
    ``g' (q + u / alpha)`` and ``K (q^2 + u^2 / alpha)``."""
    base = 1.0 + d2 / (2.0 * alpha)
    u = d2 / (2.0 * alpha * base)
    q = u - torch.log(base)
    return -0.5 * K / base * (q + u / alpha), K * (q * q + u * u / alpha)


def _alpha_factor(d2, K, alpha):
    """``K (d2 / (2 alpha base) - log base)``: dK/d(alpha) of rq."""
    base = 1.0 + d2 / (2.0 * alpha)
    return K * (d2 / (2.0 * alpha * base) - torch.log(base))


def gram_plain(kind, x, y, alpha=1.0):
    """Plain torch version of the kernel: the matmul identity and the
    epilogue, materialising ``d2``; bfloat16 inputs computed in float32
    and the result rounded to bfloat16."""
    ct = arith_dtype(x.dtype)
    xf, yf = x.to(ct), y.to(ct)
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.to(ct)
    inner = xf @ yf.T
    out = inner if kind == "linear" else _apply_kind(kind, _d2(xf, yf, inner), inner, alpha)
    return out.to(x.dtype)


def tile_shape(dtype):
    """``(tm, tn)`` of the kernel's output tile: a warp covers 16 bytes a
    lane of a row (``tn = 32 * 16 / itemsize`` columns) and its R rows (R
    = 2 for bfloat16, else 4), the block's 8 warps ``tm = 8 R`` rows."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = 2 if itemsize == 2 else 4
    return _WARPS * rows, 32 * (16 // itemsize)


def launch_shape(n, m, dtype):
    """``(tm, tn, tiles)`` of a launch: the tile shape and the number of
    tiles of the ``(n, m)`` output, one block each, as ``stheno_gram``
    (``csrc/gram.cu``) launches them. Block ``t`` builds the
    rows ``[(t // cdiv(m, tn)) tm, + tm)`` and the columns ``[(t % cdiv(m,
    tn)) tn, + tn)``."""
    tm, tn = tile_shape(dtype)
    return tm, tn, -(-n // tm) * -(-m // tn)


#: rq's alpha on the device, per (value, dtype, device), for alphas given
#: as numbers: each is filled in once (no copy from host memory) and kept
#: while it is among the ``_ALPHAS_KEPT`` used last.
_ALPHAS = collections.OrderedDict()
_ALPHAS_KEPT = 64


def device_alpha(kind, alpha, dtype, device):
    """rq's ``alpha`` as the 0-dim ``dtype`` tensor on ``device`` that the
    kernels read (once per thread, through a pointer), or None for the
    other kinds, which read none. A tensor is cast there on the device; a
    number is filled in by a kernel, once per value outside a CUDA graph
    capture (and kept while among the ``_ALPHAS_KEPT`` values used last),
    and inside one at each replay (a tensor kept from a capture would hold
    what the fill had not yet written)."""
    if kind != "rq":
        return None
    if isinstance(alpha, torch.Tensor):
        return alpha.detach().to(device=device, dtype=dtype).contiguous()
    key = (alpha, dtype, torch.device(device))
    if config.capturing():
        return torch.full((), alpha, dtype=dtype, device=device)
    held = _ALPHAS.pop(key, None)
    if held is None:
        # Made outside any torch.func transform: a tensor made inside one
        # is that level's, and the cache would hand it to later levels.
        with torch._C._DisableFuncTorch():
            held = torch.full((), alpha, dtype=dtype, device=device)
    _ALPHAS[key] = held  # the most recently used last
    while len(_ALPHAS) > _ALPHAS_KEPT:
        # Dropped tensors are freed in stream order, after the launches
        # that read them.
        _ALPHAS.popitem(last=False)
    return held


def _launch(kind, x, y, alpha, out_dtype):
    global launches
    lib = _build.library()
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=out_dtype, device=x.device)
    if n == 0 or m == 0:
        return out
    tm, tn = tile_shape(out_dtype)
    code = _DTYPE_CODES[x.dtype] if out_dtype == x.dtype else _F32_BF16
    a = device_alpha(kind, alpha, arith_dtype(x.dtype), x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_gram(
            KINDS.index(kind), code, x.data_ptr(), y.data_ptr(),
            out.data_ptr(), n, m, d, _build.ptr(a), tm, tn, stream,
        )
    _build.check(code, "gram")
    launches += 1
    return out


class _Gram(torch.autograd.Function):
    """``gram(kind, x, y, alpha)``, differentiable in ``x``, ``y`` and rq's
    ``alpha`` (a tensor): forward K1, backward K1's backward kernel
    (``ops/gram_bwd.py``), which recomputes ``d2`` and ``g'`` and does not
    keep K. Where ``x`` is ``y`` one launch sums both roles. Forward mode
    (``jvp``) is the tangent kernel (``ops/gram_jvp.py``), launched once for
    a batch of directions by its own Function's vmap rule, so
    ``torch.func.jacfwd`` takes K1. The backward is itself a Function,
    ``ops/gram_bwd.py:_GramBwd``, on every device (the kernel on the card,
    the plain version on the CPU), with forward, reverse and vmap rules of
    its own, so second derivatives (``torch.func.hessian``'s forward over
    reverse, and reverse over reverse) take K1's backward, its tangent
    kernel (``ops/gram_bwd_jvp.py``) and K1's. Inputs: ``x, y, alpha, kind,
    out_dtype``."""

    @staticmethod
    def forward(x, y, alpha, kind, out_dtype):
        if x.is_cuda and (out_dtype == x.dtype or (x.dtype, out_dtype) == _MIXED):
            return _launch(kind, x, y, alpha, out_dtype)
        if x.is_cuda:
            return _launch(kind, x, y, alpha, x.dtype).to(out_dtype)
        return gram_plain(kind, x, y, alpha).to(out_dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y, alpha, kind, out_dtype = inputs
        ctx.kind = kind
        ctx.out_dtype = out_dtype
        ctx.same = x is y
        ctx.save_for_backward(x, y, alpha)
        ctx.save_for_forward(x, y, alpha)

    @staticmethod
    def backward(ctx, gbar):
        from .gram_bwd import _GramBwd

        x, y, alpha = ctx.saved_tensors
        # A rounded tile's cotangent is the unrounded one's (the rounding is
        # the identity to first order, as astype's transpose is a cast).
        gbar = gbar.to(x.dtype)
        need_x, need_y, need_alpha = ctx.needs_input_grad[:3]
        want_alpha = ctx.kind == "rq" and need_alpha
        if ctx.same:
            # autograd hands the one tensor twice: the first slot takes the
            # sum of both roles.
            xbar, _, dalpha = _GramBwd.apply(x, None, alpha, gbar, ctx.kind, need_x, need_x,
                                             want_alpha, True)
            return xbar, None, dalpha, None, None
        xbar, ybar, dalpha = _GramBwd.apply(x, y, alpha, gbar, ctx.kind, need_x, need_y,
                                            want_alpha, False)
        return xbar, ybar, dalpha, None, None

    @staticmethod
    def jvp(ctx, xt, yt, at, *_):
        from .gram_jvp import _GramJvp

        x, y, alpha = ctx.saved_tensors
        if ctx.same and xt is None:
            xt = yt
        if ctx.same and yt is None:
            yt = xt
        at = at if ctx.kind == "rq" else None
        if xt is None and yt is None and at is None:
            return x.new_zeros((x.shape[0], y.shape[0]), dtype=ctx.out_dtype)
        return _GramJvp.apply(x, y, alpha, xt, yt, at, ctx.kind).to(ctx.out_dtype)

    @staticmethod
    def vmap(info, in_dims, x, y, alpha, kind, out_dtype):
        # A batch of inputs (not of tangents): one Gram per member.
        outs = [
            _Gram.apply(*(_member(t, d, i) for t, d in zip((x, y, alpha), in_dims)), kind,
                        out_dtype)
            for i in range(info.batch_size)
        ]
        return torch.stack(outs), 0


def _member(t, d, i):
    """Member ``i`` of a vmap rule's input batched at dim ``d`` (None: not
    batched, or no tensor)."""
    return t if t is None or d is None else t.select(d, i)


def gram(kind, x, y, alpha=1.0, out_dtype=None):
    """Gram matrix ``g(||x_i - y_j||^2)`` (or ``x_i . y_j`` for linear) of
    ``x (n, d)`` and ``y (m, d)``, float32, float64 or bfloat16: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    Differentiable in ``x``, ``y`` and, for ``rq``, ``alpha``, in reverse
    and in forward mode. ``out_dtype`` (default: the inputs') rounds the
    tile once to another floating dtype (see the module docstring). rq's
    ``alpha`` reaches the kernels as a device operand (:func:`device_alpha`),
    so a tensor alpha costs no host read and a CUDA graph replays its
    current value."""
    if kind not in KINDS:
        raise ValueError(f"Unknown gram kind {kind!r}.")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"gram: need x (n, d), y (m, d); got {x.shape}, {y.shape}")
    if x.dtype != y.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"gram takes float32, float64 or bfloat16 inputs of one dtype; got {x.dtype}, "
            f"{y.dtype}."
        )
    if x.device != y.device:
        raise ValueError(f"gram: x on {x.device}, y on {y.device}")
    if not isinstance(alpha, torch.Tensor):
        alpha = (device_alpha("rq", alpha, arith_dtype(x.dtype), x.device) if x.is_cuda
                 else torch.as_tensor(alpha, dtype=arith_dtype(x.dtype)))
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if not out_dtype.is_floating_point:
        raise TypeError(f"gram: out_dtype must be a floating dtype, got {out_dtype}.")
    return _Gram.apply(x.contiguous(), y.contiguous(), alpha, kind, out_dtype)
