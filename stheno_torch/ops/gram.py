"""Fused pairwise-distance + Gram matrix (kernel K1) and its plain version.

Counterpart of ``stheno_tpu/ops/gram.py``. :func:`gram` computes
``g(||x_i - y_j||^2)`` (or ``x_i . y_j`` for ``linear``) for ``x (n, d)``
and ``y (m, d)``:

- on CUDA tensors it launches the hand-written kernel in
  ``csrc/gram.cu``, which replaces the TPU kernel
  ``stheno_tpu/ops/gram.py:_gram_kernel``. It is bound by the ``(n, m)``
  output write (the contraction depth ``d`` is a few), so it keeps the
  inputs in shared memory, never writes ``d2``, and stores each row
  segment as one coalesced warp transaction; see the source's header;
- on CPU tensors it runs :func:`gram_plain`, the same arithmetic in plain
  torch, which is also what the tests and ``chip_smoke.py`` compare the
  kernel with.

float32 and float64 only: a bfloat16 kernel is still to be ported.

The gradient is an ``autograd.Function`` whose backward is plain torch,
the W-trick of ``_gram_bwd`` in the JAX package (which is XLA there too):
``xbar = 2 (rowsum(W) x - W y)`` with ``W = gbar * g'(d2)``.
"""

import math

import torch

from . import _build

__all__ = ["gram", "gram_plain", "KINDS", "launches"]

#: Kernel functions, in the order of the ``Kind`` enum of ``csrc/gram.cu``.
KINDS = ("eq", "rq", "matern12", "matern32", "matern52", "linear")

#: Number of launches of the CUDA kernel in this process.
launches = 0


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


def gram_plain(kind, x, y, alpha=1.0):
    """Plain torch version of the kernel: the matmul identity and the
    epilogue, materialising ``d2``."""
    inner = x @ y.T
    if kind == "linear":
        return inner
    return _apply_kind(kind, _d2(x, y, inner), inner, alpha)


def _launch(kind, x, y, alpha):
    global launches
    lib = _build.library()
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0 or m == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_gram(
            KINDS.index(kind),
            int(x.dtype == torch.float64),
            x.data_ptr(),
            y.data_ptr(),
            out.data_ptr(),
            n,
            m,
            d,
            float(alpha) if kind == "rq" else 1.0,
            stream,
        )
    _build.check(code, "gram")
    launches += 1
    return out


def _g_prime(kind, d2, K, alpha):
    """dK/d(d2) as a function of d2 (and the saved forward K)."""
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


class _Gram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, alpha, kind):
        K = _launch(kind, x, y, alpha) if x.is_cuda else gram_plain(kind, x, y, alpha)
        ctx.kind = kind
        ctx.save_for_backward(x, y, alpha, K)
        return K

    @staticmethod
    def backward(ctx, gbar):
        x, y, alpha, K = ctx.saved_tensors
        kind = ctx.kind
        if kind == "linear":
            return gbar @ y, gbar.T @ x, None, None
        d2 = None
        if kind == "eq":
            # g' = -0.5 K needs no d2: skip the x y^T product and the norms.
            W = gbar * (-0.5 * K)
        else:
            d2 = _d2(x, y, x @ y.T)
            W = gbar * _g_prime(kind, d2, K, alpha)
        row = torch.sum(W, dim=1, keepdim=True)
        col = torch.sum(W, dim=0, keepdim=True).T
        xbar = 2.0 * (row * x - W @ y)
        ybar = 2.0 * (col * y - W.T @ x)
        dalpha = None
        if kind == "rq" and ctx.needs_input_grad[2]:
            base = 1.0 + d2 / (2.0 * alpha)
            dalpha = torch.sum(
                gbar * K * (-torch.log(base) + d2 / (2.0 * alpha * base))
            )
        return xbar, ybar, dalpha, None


def gram(kind, x, y, alpha=1.0):
    """Gram matrix ``g(||x_i - y_j||^2)`` (or ``x_i . y_j`` for linear) of
    ``x (n, d)`` and ``y (m, d)``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Differentiable in ``x``, ``y`` and, for
    ``rq``, ``alpha``."""
    if kind not in KINDS:
        raise ValueError(f"Unknown gram kind {kind!r}.")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"gram: need x (n, d), y (m, d); got {x.shape}, {y.shape}")
    if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"gram takes float32 or float64 inputs of one dtype; got {x.dtype}, "
            f"{y.dtype}. A bfloat16 kernel is not ported yet."
        )
    if x.device != y.device:
        raise ValueError(f"gram: x on {x.device}, y on {y.device}")
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    return _Gram.apply(x.contiguous(), y.contiguous(), alpha, kind)
