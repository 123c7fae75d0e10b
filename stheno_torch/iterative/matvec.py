"""Matrix-free kernel matvecs.

Counterpart of ``stheno_tpu/iterative/matvec.py``: ``(k(x, x_cols) [+
noise I]) @ v`` without ever storing the N x N Gram. Two routes, chosen
by the expression and by whether a gradient is needed, never by catching
an error:

- **Fused (kernel K3).** ``k`` is a chain of ``ScaledKernel``s over input
  wrappers (stretch, shift, select, transform, periodic) over a stationary
  leaf (EQ, RQ, Matérn) or ``Linear``: the inputs are warped once (O(N d))
  and :func:`~stheno_torch.ops.gram_matvec.gram_matvec` computes ``g(d2) @
  v`` (the CUDA kernel on the card, its plain version on the CPU); the
  scales multiply the product and the noise term is added. When a gradient
  flows, the product is ``ops/gram_matvec_vjp.py:_GramMatvecFn``: the same
  K3 forward, and a backward by the fused Gram-gradient kernel for the
  warped inputs and rq's alpha (K3 again for ``v``), so no Gram tile is
  built. The scales and the warps stay in autograd: they are O(N d).
  :func:`_kernel_bilinear`, the scalar ``sum(A * (K + noise I) V)`` that
  the training step's surrogate differentiates, takes
  ``ops/gram_matvec_vjp.py:_GramBilinearFn`` for the square Gram instead:
  one launch of the fused Gram-gradient kernel gives its value and its
  gradients, and no forward sweep runs.
- **Blocked sweep.** Everything else (other expressions,
  ``config.accurate_dists()``, which the kernels' distances do not honour,
  inputs of mixed dtypes, and under a gradient warped inputs wider than
  the gradient kernel's ``MAX_DEPTH``): the JAX package's structure, one
  ``(block, m)`` Gram tile per row block (K1 on the card) times ``v``.
  When a gradient is needed each block runs under
  ``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``: the
  backward pass rebuilds each tile instead of saving all of them, so peak
  memory stays O(block * m).

Not ported yet (each raises ``NotImplementedError``; ``ROADMAP.md`` lists
them): ``tile_dtype``, ``symmetric=True`` and ``compensated=True``. Any
``precision`` below full float32 raises too: the JAX package measured
that single-pass tile products put the NLML 18% off with gradients about
9x wrong. Every tile product in the port is a full float32 (or float64)
FMA product, which is at least as accurate as the JAX default ``"high"``.
"""

import torch
from torch.utils.checkpoint import checkpoint

from .. import config
from ..kernels.eval import pairwise
from ..kernels.kernel import Linear, ScaledKernel, _InputWrappedKernel, _Stationary
from ..kernels.util import uprank
from ..matrix import dense
from ..ops.gram_matvec import gram_matvec
from ..ops.gram_matvec_vjp import MAX_DEPTH, _GramBilinearFn, _GramMatvecFn

__all__ = ["kernel_matvec"]

_FULL_PRECISION = (None, "high", "float32", "highest")
_LOW_PRECISION = ("default", "bfloat16", "tensorfloat32")


def not_ported(what, item=9):
    """The error of an option this port does not have yet, naming the
    ``ROADMAP.md`` item that ports it."""
    return NotImplementedError(
        f"{what} is not ported to stheno_torch yet (see ROADMAP.md, queue 1 item {item})."
    )


def fused_form(k):
    """``(scales, wrappers, leaf)`` when ``k`` is a chain of scalings and
    input wrappers over a stationary or linear leaf, else ``None``."""
    scales, wrappers = [], []
    while True:
        if isinstance(k, ScaledKernel):
            scales.append(k.scale)
            k = k.k
        elif isinstance(k, _InputWrappedKernel):
            wrappers.append(k)
            k = k.k
        elif isinstance(k, (_Stationary, Linear)):
            return scales, wrappers, k
        else:
            return None


def _requires_grad(t):
    return isinstance(t, torch.Tensor) and t.requires_grad


def _warped(form, x, xc):
    """``(xw, yw, kind, alpha)``: the fused form's leaf kind and alpha and
    the inputs through its wrappers, the square case's one tensor kept
    one (the backward then sweeps both roles at once)."""
    _, wrappers, leaf = form
    xw, yw = x, xc
    for w in wrappers:
        xw, yw = w._warp_pair(xw, yw)
        same = xw is yw
        xw = uprank(xw)
        yw = xw if same else uprank(yw)
    kind = "linear" if isinstance(leaf, Linear) else leaf.kind
    return xw, yw, kind, (leaf._alpha() if kind != "linear" else 1.0)


def _alpha_tensor(alpha, like):
    if isinstance(alpha, torch.Tensor):
        return alpha
    return torch.as_tensor(alpha, dtype=like.dtype, device=like.device)


def _fused_matvec(form, x, xc, v2):
    """K3's product for the fused form, through :class:`_GramMatvecFn`
    when a gradient flows; ``None`` where the blocked sweep must run."""
    scales = form[0]
    xw, yw, kind, alpha = _warped(form, x, xc)
    if xw.dtype != v2.dtype or xw.dtype != yw.dtype:
        return None
    if torch.is_grad_enabled() and any(
        _requires_grad(t) for t in (xw, yw, v2, alpha, *scales)
    ):
        if kind != "linear" and xw.shape[1] > MAX_DEPTH:
            return None
        out = _GramMatvecFn.apply(xw, yw, v2, _alpha_tensor(alpha, xw), kind)
    else:
        out = gram_matvec(kind, xw, yw, v2, alpha)
    for s in scales:
        out = out * s
    return out


def _fused_bilinear(form, x, A, V):
    """``sum(A * (G(xw, xw) @ V))`` times the scales, through
    :class:`_GramBilinearFn`; ``None`` where the definition must run: a
    wrapper that warps the two sides apart, mixed dtypes, inputs wider
    than the kernel takes, or a gradient for ``A`` or ``V``."""
    scales = form[0]
    xw, yw, kind, alpha = _warped(form, x, x)
    if (
        xw is not yw or len({xw.dtype, A.dtype, V.dtype}) != 1
        or (kind != "linear" and xw.shape[1] > MAX_DEPTH)
        or (torch.is_grad_enabled() and (_requires_grad(A) or _requires_grad(V)))
    ):
        return None
    out = _GramBilinearFn.apply(xw, A, V, _alpha_tensor(alpha, xw), kind)
    for s in scales:
        out = out * s
    return out


def _kernel_bilinear(k, x, A, V, noise=None, block=4096):
    """``sum(A * kernel_matvec(k, x, V, noise=noise, block=block))`` for
    ``A`` and ``V`` of shape ``(n, q)``, its definition. A fused form under
    full-precision distances takes :func:`_fused_bilinear`: one launch of
    the fused Gram-gradient kernel for the value and the gradients of the
    warped inputs and rq's alpha, the warps, scales and noise term
    (``noise sum(A V)``, per row for vector noise) in autograd. Every other
    case computes the definition."""
    x = uprank(x)
    form = fused_form(k)
    out = None
    if form is not None and not config.accurate_dists_enabled():
        out = _fused_bilinear(form, x, A, V)
    if out is None:
        return torch.sum(A * kernel_matvec(k, x, V, noise=noise, block=block))
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=V.dtype, device=V.device)
        out = out + torch.sum((noise[:, None] if noise.ndim == 1 else noise) * (A * V))
    return out


def _tile_product(k, xb, xc, v2):
    return dense(pairwise(k, xb, xc)) @ v2


@config.pin_matmul_precision
def kernel_matvec(
    k,
    x,
    v,
    noise=None,
    block=4096,
    tile_dtype=None,
    x_cols=None,
    symmetric=None,
    precision="high",
    compensated=False,
):
    """Compute ``(k(x, x_cols) [+ noise I]) @ v`` matrix-free.

    Args:
        k: kernel expression.
        x: row inputs ``(n, d)`` (or ``(n,)``).
        v: right-hand sides ``(m, p)`` (or ``(m,)``) with ``m = len(x_cols)``.
        noise: optional scalar (or ``(n,)``) diagonal noise (square case only).
        block: row-block size of the blocked sweep.
        tile_dtype: not ported (must be ``None``).
        x_cols: optional column inputs (default: ``x``, the square Gram).
        symmetric: not ported (``None`` or ``False``).
        precision: ``"high"``, ``"float32"``, ``"highest"`` or ``None``: all
            run full float32 (or float64) products. ``"default"``,
            ``"bfloat16"`` and ``"tensorfloat32"`` raise.
        compensated: not ported (must be false).

    Returns:
        ``(n, p)`` (or ``(n,)`` matching ``v``).
    """
    if compensated:
        raise not_ported("kernel_matvec(compensated=True), the two-float matvec,")
    if tile_dtype is not None:
        raise not_ported("kernel_matvec(tile_dtype=...)")
    if symmetric:
        raise not_ported("kernel_matvec(symmetric=True)")
    if precision in _LOW_PRECISION:
        raise not_ported(
            f"kernel_matvec(precision={precision!r}) (tile products below full float32)"
        )
    if precision not in _FULL_PRECISION:
        raise ValueError(f"Unknown precision {precision!r}.")
    x = uprank(x)
    square = x_cols is None
    xc = x if square else uprank(x_cols)
    v_in = config.as_tensor(v)
    v2 = v_in[:, None] if v_in.ndim == 1 else v_in

    out = None
    form = fused_form(k)
    if form is not None and not config.accurate_dists_enabled():
        out = _fused_matvec(form, x, xc, v2)
    if out is None:
        need_grad = torch.is_grad_enabled()
        tiles = []
        for xb in torch.split(x, min(block, max(x.shape[0], 1))):
            if need_grad:
                tiles.append(checkpoint(_tile_product, k, xb, xc, v2, use_reentrant=False))
            else:
                tiles.append(_tile_product(k, xb, xc, v2))
        out = torch.cat(tiles, dim=0)

    if noise is not None:
        if not square:
            raise ValueError("noise only applies to the square (x_cols=None) case.")
        noise = torch.as_tensor(noise, dtype=v2.dtype, device=v2.device)
        noise_col = noise[:, None] if noise.ndim == 1 else noise
        out = out + noise_col * v2
    return out[:, 0] if v_in.ndim == 1 else out
