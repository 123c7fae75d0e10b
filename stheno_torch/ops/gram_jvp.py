"""K1's forward rule: the tangent of the fused Gram along a batch of
directions (the tangent kernel) and its plain version.

Given ``K = gram(kind, x, y, alpha)`` and ``B`` tangent directions ``xt (B,
n, d)``, ``yt (B, m, d)`` and (rq) ``at (B,)``, :func:`gram_jvp` returns the
``(B, n, m)`` tangents

    Kt[b]_ij = 2 g'(d2_ij) <x_i - y_j, xt[b]_i - yt[b]_j> + dK/dalpha_ij at[b]

(``<xt[b]_i, y_j> + <x_i, yt[b]_j>`` for linear), with ``d2`` by K1's
matmul identity clamped at 0; where the clamp bites the entry is flat.
A missing ``xt``, ``yt`` or ``at`` is a zero tangent.

- On CUDA tensors (float32 or float64) it launches ``csrc/gram_jvp.cu``
  once for the whole batch. It replaces no Pallas kernel: on the TPU the
  JAX package's forward mode differentiates the XLA Gram
  (``stheno_tpu/ops/gram.py:_xla_gram``), since the custom VJP around K1
  (``_gram_kernel``) has none; a ctypes launch of K1 carries no tangents,
  so the port needs one. It is bound by the ``B`` output tiles' write;
  see the source's header.
- On CPU tensors it runs :func:`gram_jvp_plain`, the same arithmetic in
  plain torch, which the tests hold to ``jax.jvp`` of ``_xla_gram`` and
  ``chip_smoke.py`` holds the kernel to.

``_GramJvp`` is the Function that ``ops/gram.py:_Gram``'s ``jvp`` calls:
its ``vmap`` rule is the batched launch, since a launch cannot run on a
``BatchedTensor``; so ``torch.func.jacfwd`` (a ``vmap`` of ``jvp``) takes
one launch for all its directions.
"""

import torch

from . import _build
from .gram import (_DTYPE_CODES, KINDS, _alpha_factor, _apply_kind, _g_prime, _member,
                   arith_dtype, device_alpha, tile_shape)

__all__ = ["gram_jvp", "gram_jvp_plain", "launches"]

#: Number of launches of the CUDA kernel in this process.
launches = 0

_DTYPES = (torch.float32, torch.float64)


def gram_jvp_plain(kind, x, y, xt=None, yt=None, alpha=1.0, at=None):
    """Plain torch version of the tangent kernel: ``(B, n, m)``; bfloat16
    inputs are computed in float32 and the result rounded back."""
    ct = arith_dtype(x.dtype)
    x, y = x.to(ct), y.to(ct)
    xt = None if xt is None else xt.to(ct)
    yt = None if yt is None else yt.to(ct)
    batch = next(t.shape[0] for t in (xt, yt, at) if t is not None)
    n, m = x.shape[0], y.shape[0]
    if kind == "linear":
        out = x.new_zeros((batch, n, m))
        if xt is not None:
            out = out + xt @ y.T
        if yt is not None:
            out = out + x @ yt.mT
        return out
    xn = torch.sum(x * x, dim=-1, keepdim=True)
    yn = torch.sum(y * y, dim=-1, keepdim=True)
    d2 = xn + yn.T - 2.0 * (x @ y.T)
    flat = d2 < 0
    d2 = torch.clamp_min(d2, 0.0)
    alpha = torch.as_tensor(alpha, dtype=ct, device=x.device)
    K = _apply_kind(kind, d2, None, alpha)
    w = torch.where(flat, 0.0, 2.0 * _g_prime(kind, d2, K, alpha))
    diff = x[:, None, :] - y[None, :, :]  # (n, m, d)
    tdiff = 0.0
    if xt is not None:
        tdiff = tdiff + xt[:, :, None, :]
    if yt is not None:
        tdiff = tdiff - yt[:, None, :, :]
    out = w * torch.sum(diff * tdiff, dim=-1)
    if kind == "rq" and at is not None:
        out = out + _alpha_factor(d2, K, alpha) * at.to(ct)[:, None, None]
    return out.to(x.dtype)


def _launch(kind, x, y, xt, yt, alpha, at):
    global launches
    lib = _build.library()
    n, d = x.shape
    m = y.shape[0]
    batch = next(t.shape[0] for t in (xt, yt, at) if t is not None)
    out = torch.empty((batch, n, m), dtype=x.dtype, device=x.device)
    if n == 0 or m == 0 or batch == 0:
        return out
    if d == 0:
        return out.zero_()
    tm, tn = tile_shape(x.dtype)
    a = device_alpha(kind, alpha, x.dtype, x.device)
    xt, yt = (None if t is None else t.to(x.dtype).contiguous() for t in (xt, yt))
    at = None if at is None or kind != "rq" else at.to(x.dtype).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.stheno_gram_jvp(
            KINDS.index(kind), _DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
            _build.ptr(xt), _build.ptr(yt), _build.ptr(a), _build.ptr(at), out.data_ptr(),
            batch, n, m, d, tm, tn, stream,
        )
    _build.check(code, "gram_jvp")
    launches += 1
    return out


def gram_jvp(kind, x, y, xt=None, yt=None, alpha=1.0, at=None):
    """The ``(B, n, m)`` tangents of ``gram(kind, x, y, alpha)`` along the
    directions ``xt (B, n, d)``, ``yt (B, m, d)`` and (rq) ``at (B,)``,
    each of which may be None (a zero tangent), not all: the tangent kernel
    for CUDA tensors (float32 or float64; one launch), the plain version
    for CPU tensors."""
    if kind not in KINDS:
        raise ValueError(f"Unknown gram kind {kind!r}.")
    if xt is None and yt is None and at is None:
        raise ValueError("gram_jvp: give at least one of xt, yt and at.")
    if not x.is_cuda:
        return gram_jvp_plain(kind, x, y, xt, yt, alpha, at)
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(
            f"gram_jvp: the tangent kernel takes float32 or float64 inputs of one dtype; got "
            f"{x.dtype}, {y.dtype}."
        )
    return _launch(kind, x.contiguous(), y.contiguous(), xt, yt, alpha, at)


class _GramJvp(torch.autograd.Function):
    """The tangent of ``gram(kind, x, y, alpha)`` along ``(xt, yt, at)``,
    one direction (``xt (n, d)``, ``yt (m, d)``, ``at`` 0-dim, each may be
    None): what ``_Gram.jvp`` returns. Its ``vmap`` rule launches the
    kernel once for a batch of directions. Not itself differentiable.
    Inputs: ``x, y, alpha, xt, yt, at, kind``."""

    @staticmethod
    def forward(x, y, alpha, xt, yt, at, kind):
        lift = lambda t: None if t is None else t[None]  # noqa: E731
        return gram_jvp(kind, x, y, lift(xt), lift(yt), alpha, lift(at))[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, y, alpha, xt, yt, at, kind):
        batch = info.batch_size
        if any(d is not None for d in in_dims[:3]):
            # A batch of primals (a vmap over data): one call per member.
            outs = [
                _GramJvp.apply(*(_member(t, dim, i) for t, dim in zip((x, y, alpha, xt, yt, at),
                                                                       in_dims)), kind)
                for i in range(batch)
            ]
            return torch.stack(outs), 0

        def lead(t, dim):
            if t is None:
                return None
            if dim is None:
                return t.expand((batch,) + t.shape)
            return t.movedim(dim, 0)

        xt, yt, at = (lead(t, dim) for t, dim in zip((xt, yt, at), in_dims[3:6]))
        return gram_jvp(kind, x, y, xt, yt, alpha, at), 0
