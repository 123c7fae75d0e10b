"""Fused Gram-gradient x V (the backward of the fused Gram x V product K3)
and its plain version, and the differentiable Gram x V product and Gram
bilinear form built on them.

:func:`gram_matvec_vjp` computes, for ``x (n, d)``, ``y (m, d)``,
``A (n, q)``, ``V (m, q)`` and a kind of :data:`~stheno_torch.ops.gram.KINDS`,
the gradient with respect to ``x`` of ``sum(A * (G(x, y) @ V))``:

    xbar_i = 2 sum_j (A V^T)_ij g'(d2_ij) (x_i - y_j),

and, for ``rq`` with ``alpha_grad``, its gradient with respect to
``alpha``, ``sum_ij (A V^T)_ij K_ij (d2_ij / (2 alpha base_ij) - log
base_ij)``, and with ``value`` the value itself, ``sum_ij (A V^T)_ij
K_ij``, without forming any ``(n, m)`` array:

- on CUDA tensors it launches the hand-written kernel of
  ``csrc/gram_matvec_vjp.cu``. On the matrix-free path's surrogate
  gradient it replaces what the JAX package differentiates there: the K1
  tiles (``stheno_tpu/ops/gram.py:_gram_kernel``) times V, under
  ``_gram_bwd``'s W-trick, and, through :class:`_GramBilinearFn`, the
  surrogate's forward sweep (K3's float64 route until then). It is bound
  by operations (a q-wide dot, the distance and one exp per entry); see
  the source's header;
- on CPU tensors it runs :func:`gram_matvec_vjp_plain`, the same
  arithmetic in plain torch over row blocks of ``(block, m)`` tiles, which
  is also what the tests and ``chip_smoke.py`` compare the kernel with;
- ``linear`` needs no sweep: ``xbar = A (V^T y)`` is a small product in
  plain torch, on either device.

The gradient with respect to ``y`` is the same function called with
``(y, x, V, A)``. float32 and float64, depth ``d <= 8`` (:data:`MAX_DEPTH`).

:class:`_GramMatvecFn` is ``G(x, y) @ V`` as an ``autograd.Function``:
its forward is :func:`~stheno_torch.ops.gram_matvec.gram_matvec` (K3 on
the card), its backward :func:`gram_matvec_vjp` for ``x``, ``y`` and
``alpha`` (one launch over both roles where ``x is y``) and K3 again for
``V``. :func:`~stheno_torch.iterative.kernel_matvec` takes it whenever a
gradient flows through a fused-form kernel.

:class:`_GramBilinearFn` is the square case's scalar ``sum(A * (G(x, x) @
V))``, differentiable in ``x`` and rq's ``alpha``: one launch of the
kernel gives its value and both gradients, so no forward sweep runs. The
training step's surrogate takes it (``iterative.matvec._kernel_bilinear``).
"""

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .gram import KINDS, _apply_kind, _g_prime
from .gram_matvec import gram_matvec

__all__ = ["gram_matvec_vjp", "gram_matvec_vjp_plain", "launch_shape", "launches", "MAX_DEPTH"]

#: Number of launches of the CUDA kernel in this process.
launches = 0

_THREADS = 128  # threads per block, as kVjpThreads in csrc/gram_matvec_vjp.cuh
_TN = 64  # columns staged per pass, as kVjpTN
_WIDTHS = (4, 8, 20, 36)  # panel widths QC the kernel is built for
_DEPTHS = (1, 2, 4, 8)  # depths D the kernel is built for
_TARGET_BLOCKS = 8 * 132  # eight blocks for each SM of an H100
_MIN_SPAN = 1024  # the fewest columns a column split sweeps

#: The widest input the kernel takes.
MAX_DEPTH = _DEPTHS[-1]


def _cdiv(a, b):
    return -(-a // b)


def _rows_per_block(qc, depth, itemsize):
    """Rows a block owns: 4 warps of 8-row groups, ``dmma_groups`` each,
    for the float64 (tensor-core) kernel; 128 threads of ``vjp_rows`` rows
    each for the float32 kernel. Each launch passes it to the kernel, which
    refuses one that is not its own."""
    if itemsize == 8:
        return 32 * (4 if depth <= 2 else 2 if depth == 4 else 1)
    return _THREADS * max(1, min(4, 96 // (qc + 3 * depth)))


def launch_shape(n, m, q, d, itemsize):
    """``(qc, depth, qsplits, m_pad, span, splits)`` of a launch: the panel
    width ``qc`` (q split over ``qsplits`` of them where it is wider), the
    depth ``depth`` that ``d`` is padded to, the columns padded to
    ``m_pad``, and the column sweep split into ``splits`` ranges of
    ``span`` columns where the row blocks times the q-splits alone would
    leave the card short of blocks. Depends on the shapes only, so one
    shape always sums in the same order."""
    qc = next((w for w in _WIDTHS if q <= w), _WIDTHS[-1])
    depth = next(w for w in _DEPTHS if d <= w)
    qsplits = _cdiv(q, qc)
    want = _cdiv(_TARGET_BLOCKS, _cdiv(n, _rows_per_block(qc, depth, itemsize)) * qsplits)
    m_pad = _cdiv(m, _TN) * _TN
    splits = max(1, min(want, _cdiv(m, _MIN_SPAN), 65535))
    span = _cdiv(_cdiv(m_pad, splits), _TN) * _TN
    return qc, depth, qsplits, m_pad, span, _cdiv(m_pad, span)


def _alpha_factor(d2, K, alpha):
    """``K (d2 / (2 alpha base) - log base)``: dK/d(alpha) of rq."""
    base = 1.0 + d2 / (2.0 * alpha)
    return K * (d2 / (2.0 * alpha * base) - torch.log(base))


def _linear_value(x, y, A, V):
    """``sum(A * ((x y^T) @ V))`` as the small product ``sum((A^T x) *
    (V^T y))``."""
    return torch.sum((A.T @ x) * (V.T @ y))


def gram_matvec_vjp_plain(kind, x, y, A, V, alpha=1.0, *, alpha_grad=False, value=False,
                          block=1024):
    """Plain torch version: per row block, the ``(block, m)`` tiles of the
    differences, ``g'`` (``ops/gram.py:_g_prime``) and ``A V^T``, and
    ``xbar = 2 sum_j W_ij (x_i - y_j)``. Returns ``(xbar, dalpha)``,
    ``dalpha`` None unless ``kind == "rq"`` and ``alpha_grad``; with
    ``value``, ``(xbar, dalpha, sum_ij (A V^T)_ij K_ij)``."""
    if kind == "linear":
        out = (A @ (V.T @ y), None)
        return (*out, _linear_value(x, y, A, V)) if value else out
    want_alpha = kind == "rq" and alpha_grad
    xbars, dalpha, total = [], x.new_zeros(()), x.new_zeros(())
    for xb, Ab in zip(torch.split(x, block), torch.split(A, block)):
        diff = xb[:, None, :] - y[None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
        K = _apply_kind(kind, d2, None, alpha)
        S = Ab @ V.T
        xbars.append(2.0 * torch.einsum("ij,ijk->ik", S * _g_prime(kind, d2, K, alpha), diff))
        if want_alpha:
            dalpha = dalpha + torch.sum(S * _alpha_factor(d2, K, alpha))
        if value:
            total = total + torch.sum(S * K)
    xbar = torch.cat(xbars) if xbars else x.new_zeros((0, x.shape[1]))
    out = (xbar, dalpha if want_alpha else None)
    return (*out, total) if value else out


def _launch(kind, x, y, A, V, alpha, want_alpha, want_value):
    global launches
    lib = _build.library()
    n, d = x.shape
    m, q = V.shape
    if n == 0 or m == 0 or q == 0:
        zero = x.new_zeros(())
        return x.new_zeros((n, d)), (zero if want_alpha else None), zero
    qc, depth, qsplits, m_pad, span, splits = launch_shape(n, m, q, d, x.element_size())
    # Zero padding: extra columns of x and y add nothing to d2 or to the
    # gradient, extra rows of y and V nothing to the sums (their W is 0).
    if depth == d:
        xp = x.contiguous()
    else:
        xp = x.new_zeros((n, depth))
        xp[:, :d] = x
    yp = x.new_zeros((m_pad, depth))
    yp[:m, :d] = y
    vp = x.new_zeros((m_pad, qsplits * qc))
    vp[:m, :q] = V
    vp = vp.view(m_pad, qsplits, qc).transpose(0, 1).contiguous()
    A = A.contiguous()
    count = n * depth + (n if want_alpha else 0) + (n if want_value else 0)
    out = torch.empty(count, dtype=x.dtype, device=x.device)
    parts = splits * qsplits
    work = torch.empty(parts * count, dtype=x.dtype, device=x.device) if parts > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_gram_matvec_vjp(
            KINDS.index(kind), int(x.dtype == torch.float64), xp.data_ptr(), yp.data_ptr(),
            A.data_ptr(), vp.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), n, m_pad, depth, q, qc, span, splits,
            qsplits, float(alpha) if kind == "rq" else 1.0, int(want_alpha), int(want_value),
            _rows_per_block(qc, depth, x.element_size()), stream,
        )
    _build.check(code, "gram_matvec_vjp")
    launches += 1
    xbar = out[: n * depth].view(n, depth)[:, :d]
    rest = out[n * depth :].view(-1, n)  # the rows' alpha, then value, partials
    dalpha = rest[0].sum() if want_alpha else None
    return xbar, dalpha, (rest[-1].sum() if want_value else None)


def gram_matvec_vjp(kind, x, y, A, V, alpha=1.0, *, alpha_grad=False, value=False):
    """``(xbar, dalpha)``: the gradients with respect to ``x`` and (for
    ``rq`` with ``alpha_grad``, else None) ``alpha`` of
    ``sum(A * (G(x, y) @ V))``, for ``x (n, d)``, ``y (m, d)``,
    ``A (n, q)`` and ``V (m, q)``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. With ``value``, ``(xbar, dalpha,
    sum(A * (G(x, y) @ V)))`` from the same sweep."""
    if kind not in KINDS:
        raise ValueError(f"Unknown gram kind {kind!r}.")
    if (
        x.ndim != 2 or y.ndim != 2 or A.ndim != 2 or V.ndim != 2
        or x.shape[1] != y.shape[1] or A.shape != (x.shape[0], V.shape[1])
        or V.shape[0] != y.shape[0]
    ):
        raise ValueError(
            f"gram_matvec_vjp: need x (n, d), y (m, d), A (n, q), V (m, q); got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(A.shape)}, {tuple(V.shape)}"
        )
    if len({x.dtype, y.dtype, A.dtype, V.dtype}) != 1 or x.dtype not in (
        torch.float32, torch.float64
    ):
        raise TypeError(
            f"gram_matvec_vjp takes float32 or float64 inputs of one dtype; got {x.dtype}, "
            f"{y.dtype}, {A.dtype}, {V.dtype}."
        )
    if not (x.device == y.device == A.device == V.device):
        raise ValueError("gram_matvec_vjp: x, y, A and V must lie on one device")
    if kind != "linear" and x.shape[1] > MAX_DEPTH:
        raise ValueError(f"gram_matvec_vjp takes d <= {MAX_DEPTH}; got d = {x.shape[1]}")
    if kind == "linear" or not x.is_cuda:
        return gram_matvec_vjp_plain(kind, x, y, A, V, alpha, alpha_grad=alpha_grad, value=value)
    out = _launch(kind, x, y, A, V, alpha, kind == "rq" and alpha_grad, value)
    return out if value else out[:2]


class _GramMatvecFn(torch.autograd.Function):
    """``G(x, y) @ V``, differentiable in ``x``, ``y``, ``V`` and rq's
    ``alpha`` (a tensor): forward K3, backward :func:`gram_matvec_vjp` and
    K3 (for ``V``). Inputs: ``x, y, V, alpha, kind``."""

    @staticmethod
    def forward(ctx, x, y, V, alpha, kind):
        ctx.kind = kind
        ctx.same = x is y
        ctx.save_for_backward(x, y, V, alpha)
        return gram_matvec(kind, x, y, V, alpha)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        x, y, V, alpha = ctx.saved_tensors
        kind = ctx.kind
        need_x, need_y, need_v, need_alpha = ctx.needs_input_grad[:4]
        want_alpha = kind == "rq" and need_alpha
        gbar = gbar.contiguous()
        xbar = ybar = vbar = abar = None
        if ctx.same:
            if need_x or want_alpha:
                # Both roles in one sweep: [gbar, V]_i . [V, gbar]_j is
                # (gbar V^T)_ij + (gbar V^T)_ji, so the sweep gives xbar +
                # ybar and counts each entry's alpha term twice.
                xbar, abar = gram_matvec_vjp(
                    kind, x, x, torch.cat([gbar, V], dim=1), torch.cat([V, gbar], dim=1),
                    alpha, alpha_grad=want_alpha,
                )
                abar = None if abar is None else 0.5 * abar
        else:
            if need_x or want_alpha:
                xbar, abar = gram_matvec_vjp(kind, x, y, gbar, V, alpha, alpha_grad=want_alpha)
            if need_y:
                ybar, _ = gram_matvec_vjp(kind, y, x, V, gbar, alpha)
        if need_v:
            vbar = gram_matvec(kind, y, x, gbar, alpha)
        return (xbar if need_x else None), ybar, vbar, abar, None


class _GramBilinearFn(torch.autograd.Function):
    """``sum(A * (G(x, x) @ V))``, the square Gram's bilinear form, a
    scalar differentiable in ``x`` and rq's ``alpha`` (a tensor). Its
    forward is one :func:`gram_matvec_vjp` over both roles (``[A, V]``
    against ``[V, A]``), which gives the value and the gradients together;
    its backward scales the saved gradients by the cotangent. ``A`` and
    ``V`` take no gradient: the backward raises if one is needed. Inputs:
    ``x, A, V, alpha, kind``."""

    @staticmethod
    def forward(ctx, x, A, V, alpha, kind):
        want_alpha = kind == "rq" and ctx.needs_input_grad[3]
        # Both roles in one sweep: [A, V]_i . [V, A]_j is (A V^T)_ij +
        # (A V^T)_ji, so the sweep gives the gradient of the shared x and
        # counts the value and each entry's alpha term twice.
        xbar, abar, total = gram_matvec_vjp(
            kind, x, x, torch.cat([A, V], dim=1), torch.cat([V, A], dim=1), alpha,
            alpha_grad=want_alpha, value=True,
        )
        ctx.save_for_backward(xbar, None if abar is None else 0.5 * abar)
        return 0.5 * total

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise RuntimeError(
                "_GramBilinearFn gives no gradient for A or V; take "
                "sum(A * _GramMatvecFn.apply(x, x, V, alpha, kind)) for those."
            )
        xbar, abar = ctx.saved_tensors
        need_x, need_alpha = ctx.needs_input_grad[0], ctx.needs_input_grad[3]
        return (
            gbar * xbar if need_x else None, None, None,
            gbar * abar if need_alpha and abar is not None else None, None,
        )
