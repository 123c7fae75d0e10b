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

The options, each as the JAX package defines it:

- ``compensated=True``, the small-noise operator (``compensated.py``).
  A fused form runs **K3's float64 route** on the inputs, the right-hand
  sides, the scales and the parameters promoted exactly to float64 (no
  rounding: every float32 is a float64), adds the noise term in float64
  and rounds once to the input dtype. Its application error is about
  1e-16 relative, below the two-float target of about 1e-10, and it is
  two orders of magnitude faster on the card than the double-float tiles
  (``scripts/torch_item9.py`` times both; ``PERF.md``). Every other
  expression takes the JAX package's double-float route: per row block and
  column chunk (``comp_col_chunk``), the double-float tile
  (``compensated.df32_pairwise``, or a cancellation-free tile under
  ``config.accurate_dists()`` where the expression has no rule) through
  ``compensated_matmul``, the chunks' pairs summed by TwoSum. The choice is
  by expression, the same on the CPU as on the card. Forward only.
- ``tile_dtype``: the Gram tile rounded once to ``tile_dtype``
  (``K_b.astype(tile_dtype)``) and ``v`` cast to it, the product
  accumulated in ``v``'s dtype. A fused form without scales takes the tile
  from **K1's float32-in, bfloat16-out instance** (one launch); any other
  expression rounds its tile of the input dtype. Rounded operands multiply
  exactly in the wider dtype (a bfloat16 product has 16 significand bits),
  so the product is a full-precision product of the rounded operands: a
  ``torch.matmul`` of two bfloat16 tensors would round its result to
  bfloat16 instead.
- ``precision``: the JAX package's CPU backend ignores it, and on the TPU
  it rounds the tile product's operands; the port gives it the TPU meaning
  on every device. ``"default"`` and ``"bfloat16"`` round both operands to
  bfloat16 (the tile as ``tile_dtype=torch.bfloat16`` rounds it);
  ``"tensorfloat32"`` is a TF32 product on the card and, on the CPU, the
  product of the operands rounded to TF32 (a 10-bit significand, to
  nearest). These three take the blocked sweep; ``"high"``, ``"float32"``,
  ``"highest"`` and ``None`` are full-precision products.
- ``symmetric=True`` (square case, more than one row block): the
  upper-triangle sweep of ``_matvec_sym``, each off-diagonal tile built
  once (K1) and applied both ways, so the operator is exactly symmetric;
  each tile checkpointed under a gradient.
"""

import torch
from torch.utils.checkpoint import checkpoint

from .. import config
from ..kernels.eval import pairwise
from ..kernels.kernel import Linear, ScaledKernel, _InputWrappedKernel, _Stationary
from ..kernels.util import uprank
from ..matrix import dense
from ..ops.gram import gram
from ..ops.gram_matvec import _tf32, gram_matvec
from ..ops.gram_matvec_vjp import MAX_DEPTH, _GramBilinearFn, _GramMatvecFn

__all__ = ["kernel_matvec"]

_FULL_PRECISION = (None, "high", "float32", "highest")
_LOW_PRECISION = ("default", "bfloat16", "tensorfloat32")


def not_ported(what, item=12):
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


def _tile(k, xb, xc, tile_dtype):
    """The ``(block, m)`` Gram tile, rounded once to ``tile_dtype`` if
    given: a fused form without scales takes K1's rounded output directly
    (its float32-in, bfloat16-out instance on the card), any other
    expression rounds its tile of the input dtype."""
    if tile_dtype is None:
        return dense(pairwise(k, xb, xc))
    form = fused_form(k)
    if form is not None and not form[0] and not config.accurate_dists_enabled():
        xw, yw, kind, alpha = _warped(form, xb, xc)
        if xw.dtype == yw.dtype:
            return gram(kind, xw, yw, alpha, out_dtype=tile_dtype)
    return dense(pairwise(k, xb, xc)).to(tile_dtype)


def _tf32_round(z):
    """``z`` rounded to TF32 (a 10-bit significand, to nearest, ties away
    from zero) with an identity derivative, computed through float32."""
    r = _tf32(z.detach().to(torch.float32)).to(z.dtype)
    return z + (r - z).detach()


class _Product:
    """The tile product of a blocked sweep: full precision, or of operands
    rounded to ``rounding`` (a dtype) or to TF32 (``"tf32"``), accumulated
    in ``acc``. ``v`` is rounded once per sweep (:meth:`rhs`)."""

    def __init__(self, rounding, acc):
        self.rounding = rounding
        self.acc = acc

    def tile(self, k, xb, xc):
        if isinstance(self.rounding, torch.dtype):
            return _tile(k, xb, xc, self.rounding)
        return dense(pairwise(k, xb, xc))

    def rhs(self, v):
        if isinstance(self.rounding, torch.dtype):
            return v.to(self.rounding)
        return v

    def __call__(self, K, v):
        if self.rounding == "tf32":
            if K.is_cuda and K.dtype == torch.float32:
                with config.tf32_products():
                    return K @ v
            return _tf32_round(K) @ _tf32_round(v)
        # Exact products of the rounded operands, summed in the wider dtype.
        return K.to(self.acc) @ v.to(self.acc)


def _sweep_block(prod, k, xb, xc, v):
    return prod(prod.tile(k, xb, xc), v)


def _sym_pair(prod, k, xi, xj, vi, vj):
    K = prod.tile(k, xi, xj)
    return prod(K, vj), prod(K.T, vi)


def _matvec_sym(k, x, v, block, prod, need_grad):
    """Upper-triangle tile sweep: for each pair of row blocks ``i <= j``
    build ``K_ij`` once, add ``K_ij v_j`` into block ``i`` and ``K_ij^T
    v_i`` into block ``j`` (``i < j``). Each pair is checkpointed under a
    gradient, as the JAX package's scan body is."""
    xs = torch.split(x, block)
    vs = torch.split(prod.rhs(v), block)
    out = [None] * len(xs)

    def add(i, t):
        out[i] = t if out[i] is None else out[i] + t

    for i in range(len(xs)):
        add(i, _run(need_grad, _sweep_block, prod, k, xs[i], xs[i], vs[i]))
        for j in range(i + 1, len(xs)):
            a, b = _run(need_grad, _sym_pair, prod, k, xs[i], xs[j], vs[i], vs[j])
            add(i, a)
            add(j, b)
    return torch.cat(out, dim=0)


def _run(need_grad, fn, *args):
    if need_grad:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _compensated_fused(form, x, xc, v2, noise):
    """K3's float64 route on the promoted inputs: the fused form's product
    in float64, the noise term added in float64, one rounding."""
    wide = torch.float64
    scales = form[0]
    xw, yw, kind, alpha = _warped(form, x.to(wide), xc.to(wide))
    v64 = v2.to(wide)
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.to(wide)
    out = gram_matvec(kind, xw.to(wide), yw.to(wide), v64, alpha)
    for s in scales:
        out = out * torch.as_tensor(s, dtype=v2.dtype, device=out.device).to(wide)
    if noise is not None:
        nz = torch.as_tensor(noise, dtype=v2.dtype, device=v64.device).to(wide)
        out = out + (nz[:, None] if nz.ndim == 1 else nz) * v64
    return out.to(v2.dtype)


def _compensated_tiles(k, x, xc, v2, noise, block, comp_col_chunk):
    """The JAX package's double-float route: per row block, the column
    chunks' double-float tiles through ``compensated_matmul``, their
    ``(hi, lo)`` pairs summed by TwoSum; the noise term by TwoProd."""
    from .compensated import compensated_matmul, df32_pairwise, two_prod, two_sum

    cc = min(comp_col_chunk, xc.shape[0])
    his, los = [], []
    for xb in torch.split(x, block):
        hi = torch.zeros((xb.shape[0], v2.shape[1]), dtype=v2.dtype, device=v2.device)
        lo = torch.zeros_like(hi)
        for xc_c, v_c in zip(torch.split(xc, cc), torch.split(v2, cc)):
            tile = df32_pairwise(k, xb, xc_c)
            if tile is None:
                with config.accurate_dists():
                    K_b, K_lo = dense(pairwise(k, xb, xc_c)), None
            else:
                K_b, K_lo = tile
            h, l_ = compensated_matmul(K_b, v_c, fold=False, A_lo=K_lo)
            del tile, K_b, K_lo
            hi, e = two_sum(hi, h)
            lo = lo + e + l_
        his.append(hi)
        los.append(lo)
    hi, lo = torch.cat(his), torch.cat(los)
    if noise is not None:
        nz = torch.as_tensor(noise, dtype=v2.dtype, device=v2.device)
        nv_hi, nv_lo = two_prod((nz[:, None] if nz.ndim == 1 else nz).expand_as(v2), v2)
        hi, err = two_sum(hi, nv_hi)
        lo = lo + err + nv_lo
    return hi + lo


def _compensated(k, x, xc, v2, noise, block, comp_col_chunk):
    if torch.is_grad_enabled() and any(
        _requires_grad(t) for t in (x, xc, v2, noise)
    ):
        raise RuntimeError(
            "kernel_matvec(compensated=True) is forward-only: a gradient would flow through "
            "this call. Call it under torch.no_grad()."
        )
    form = fused_form(k)
    if form is not None:
        return _compensated_fused(form, x, xc, v2, noise)
    return _compensated_tiles(k, x, xc, v2, noise, block, comp_col_chunk)


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
    comp_col_chunk=32768,
):
    """Compute ``(k(x, x_cols) [+ noise I]) @ v`` matrix-free.

    Args:
        k: kernel expression.
        x: row inputs ``(n, d)`` (or ``(n,)``).
        v: right-hand sides ``(m, p)`` (or ``(m,)``) with ``m = len(x_cols)``.
        noise: optional scalar (or ``(n,)``) diagonal noise (square case only).
        block: row-block size of the blocked sweep (and of the
            compensated double-float route).
        tile_dtype: optional dtype the Gram tiles are rounded to (e.g.
            ``torch.bfloat16``): rounding breaks the operator's symmetry,
            so not for CG.
        x_cols: optional column inputs (default: ``x``, the square Gram).
        symmetric: in the square case with more than one row block, the
            upper-triangle sweep (an exactly symmetric operator).
        precision: ``"high"``, ``"float32"``, ``"highest"`` or ``None``
            (full-precision products), ``"default"`` or ``"bfloat16"``
            (bfloat16 operands), ``"tensorfloat32"`` (TF32 operands).
        compensated: the small-noise operator (see the module docstring);
            incompatible with ``tile_dtype`` and ``symmetric``.
        comp_col_chunk: column chunk of the compensated double-float
            route (its working set is a few ``(block, comp_col_chunk)``
            tiles).

    Returns:
        ``(n, p)`` (or ``(n,)`` matching ``v``).
    """
    if precision not in _FULL_PRECISION + _LOW_PRECISION:
        raise ValueError(f"Unknown precision {precision!r}.")
    x = uprank(x)
    square = x_cols is None
    xc = x if square else uprank(x_cols)
    v_in = config.as_tensor(v)
    v2 = v_in[:, None] if v_in.ndim == 1 else v_in
    sym = bool(symmetric) and square and x.shape[0] > block
    if noise is not None and not square:
        raise ValueError("noise only applies to the square (x_cols=None) case.")

    if compensated:
        if tile_dtype is not None or sym:
            raise ValueError("compensated matvec is incompatible with tile_dtype / symmetric.")
        out = _compensated(k, x, xc, v2, noise, block, comp_col_chunk)
        return out[:, 0] if v_in.ndim == 1 else out

    rounding = tile_dtype
    if precision in ("default", "bfloat16") and rounding is None:
        rounding = torch.bfloat16
    elif precision == "tensorfloat32":
        rounding = "tf32" if tile_dtype is None else tile_dtype
    blocked = rounding is not None or sym

    out = None
    form = fused_form(k)
    if not blocked and form is not None and not config.accurate_dists_enabled():
        out = _fused_matvec(form, x, xc, v2)
    if out is None:
        need_grad = torch.is_grad_enabled()
        prod = _Product(rounding, v2.dtype)
        if sym:
            out = _matvec_sym(k, x, v2, block, prod, need_grad)
        else:
            v_mm = prod.rhs(v2)
            out = torch.cat([
                _run(need_grad, _sweep_block, prod, k, xb, xc, v_mm)
                for xb in torch.split(x, min(block, max(x.shape[0], 1)))
            ], dim=0)

    if noise is not None:
        noise = torch.as_tensor(noise, dtype=v2.dtype, device=v2.device)
        noise_col = noise[:, None] if noise.ndim == 1 else noise
        out = out + noise_col * v2
    return out[:, 0] if v_in.ndim == 1 else out
