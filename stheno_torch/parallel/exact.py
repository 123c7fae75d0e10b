"""Distributed exact-GP inference: the row-sharded Gram, the NLML with its
analytic gradient, and the posterior.

Counterpart of ``stheno_tpu/parallel/exact.py``. ``x`` (N x d), ``y`` and
the hyperparameters are replicated; the N x N Gram is row-sharded. Each
rank builds its ``(N/D, N)`` rows of the Gram with the fused Gram kernel
K1 (``ops/gram.py``, through ``kernels.pairwise``; its backward kernel
under a gradient) and adds the noise on its own diagonal slice. The
factorisation is ``parallel/cholesky.py``'s. The NLML's gradient is
analytic, ``dK = 0.5 (m K^{-1} - a a^T)`` with ``a = K^{-1} y``, so no
loop is differentiated by autograd; ``_NLMLParts`` works on a layout's
operations (``cholesky._Rows`` here, ``cholesky2d.Grid`` for the 2-D
path's tile sets), so one forward and backward serve both.

Gradients of replicated inputs (decision 4 of ``parallel/__init__.py``):
the kernel's tensors, ``x``, ``y`` and the noise enter each rank's rows
through ``copy_to_mesh``, and the NLML's log-determinant and quadratic
parts are summed over the ranks through ``reduce_from_mesh``, so every
rank ends with the same, whole gradient.
"""

import copy
import math

import torch

from .. import config
from ..kernels import Kernel, elwise, pairwise
from ..kernels.mean import Mean
from ..kernels.util import uprank
from ..matrix import dense
from ..mo.core import MultiOutputKernel
from ._comm import MeshAxis, copy_to_mesh, reduce_from_mesh, routed
from .cholesky import (
    _Rows,
    factor_rows,
    local_rows,
    sharded,
    solve_rows,
)

__all__ = ["sharded_gram", "dist_nlml", "dist_posterior_predict"]

_LOG_2_PI = math.log(2 * math.pi)


def _route(obj, ax, memo=None, to=copy_to_mesh):
    """``obj`` with every tensor it holds through ``to`` (``copy_to_mesh``
    by default): a tensor, a list, tuple or dict of them, or a kernel or
    mean (copied, with its attributes routed). Anything else is returned as
    it is."""
    memo = {} if memo is None else memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = to(obj, ax)
    elif type(obj) in (list, tuple):
        out = type(obj)(_route(o, ax, memo, to) for o in obj)
    elif type(obj) is dict:
        out = {k: _route(v, ax, memo, to) for k, v in obj.items()}
    elif isinstance(obj, (Kernel, Mean)):
        out = copy.copy(obj)
        out.__dict__.update({k: _route(v, ax, memo, to) for k, v in vars(obj).items()})
    else:
        out = obj
    memo[id(obj)] = out
    return out


def check_routed(t, what):
    """Raise if a gradient from ``t`` (a rank-local result of replicated
    inputs) reaches a leaf other than through ``copy_to_mesh``: that leaf's
    gradient would be this rank's share alone, not the sum over the ranks."""
    stack, seen = [t.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen or routed(node):
            continue
        seen.add(node)
        if not node.next_functions and hasattr(node, "variable"):
            raise ValueError(
                f"{what}: a tensor that needs a gradient reached the rank-local computation "
                "without copy_to_mesh (held by an object other than a kernel?), so its "
                "gradient would not be summed over the ranks."
            )
        stack.extend(f for f, _ in node.next_functions)


def _row_inputs(kernel, x, start, stop):
    """The inputs of rows ``[start, stop)`` of ``kernel``'s Gram at ``x``: a
    slice of ``x``, or for a multi-output kernel of plain inputs (whose
    rows run over the outputs, then the points), the outputs' slices."""
    if not isinstance(kernel, MultiOutputKernel):
        return x[start:stop]
    n = x.shape[0]
    parts = []
    for i, p in enumerate(kernel.ps):
        a, b = max(start, i * n), min(stop, (i + 1) * n)
        if a < b:
            parts.append(p(x[a - i * n:b - i * n]))
    return tuple(parts)


def _gram_rows(kernel, x, ax):
    """``(local, N)``: this rank's rows of ``kernel``'s N x N Gram at ``x``
    (``kernel`` and ``x`` already routed)."""
    n_x = x.shape[0]
    N = n_x * len(kernel.ps) if isinstance(kernel, MultiOutputKernel) else n_x
    if N % ax.size:
        raise ValueError(f"the Gram's {N} rows do not divide evenly over {ax.size} ranks.")
    n = N // ax.size
    row0 = ax.rank * n
    return dense(pairwise(kernel, _row_inputs(kernel, x, row0, row0 + n), x)), N


@config.pin_matmul_precision
def sharded_gram(kernel, x, mesh, axis="data", noise=None):
    """The Gram ``k(x, x) (+ noise I)``, a row-sharded DTensor. ``x``: (N,
    d) or (N,) replicated; ``noise`` a scalar. Each rank computes its rows
    against all of ``x``; N must divide evenly over the ranks."""
    ax = MeshAxis(mesh, axis)
    x = uprank(config.as_tensor(x))
    K, N = _gram_rows(_route(kernel, ax), copy_to_mesh(x, ax), ax)
    if noise is not None:
        noise = copy_to_mesh(config.as_scalar(noise, K.dtype, K.device), ax)
        diag = K.diagonal(ax.rank * K.shape[0])
        K = torch.diagonal_scatter(K, diag + noise, ax.rank * K.shape[0])
    if K.requires_grad:
        check_routed(K, "sharded_gram")
    return sharded(K, ax, N)


class _NLMLParts(torch.autograd.Function):
    """This rank's share of ``(log det K, sum_j y_j^T K^{-1} y_j)`` from its
    local block ``K`` of ``ops``'s layout (``cholesky._Rows``, or
    ``cholesky2d.Grid``'s tile sets) and its block of ``y``: the
    log-determinant over its entries of ``L``'s diagonal, the quadratic
    over its block of ``L^{-1} y``. Its backward returns this rank's block
    of the whole gradient of ``g_ld log det K + g_q y^T K^{-1} y``, ``Kbar =
    g_ld K^{-1} - g_q alpha alpha^T`` with ``K^{-1} = L^{-T} L^{-1}`` and
    ``alpha = K^{-1} y``, and ``ybar = 2 g_q alpha``, so that after
    ``reduce_from_mesh`` each entry comes from one rank only."""

    @staticmethod
    def forward(ctx, K, y, ops, need_inverse):
        L, Linv = ops.factor(K, need_inverse)
        half = ops.solve(L, y)  # L^{-1} y
        ctx.ops = ops
        # One N x N residual (L^{-1}); L itself is not needed backward.
        ctx.save_for_backward(Linv, half)
        return torch.stack([2.0 * torch.log(L[ops.diagonal]).sum(), (half * half).sum()])

    @staticmethod
    @config.pin_matmul_precision
    def backward(ctx, g):
        Linv, half = ctx.saved_tensors
        ops = ctx.ops
        alpha = ops.tmm(Linv, half)  # K^{-1} y = L^{-T} (L^{-1} y)
        Kbar = ybar = None
        if ctx.needs_input_grad[0]:
            Kbar = ops.tmm(Linv, Linv).mul_(g[0]).sub_(ops.outer(g[1] * alpha, alpha))
        if ctx.needs_input_grad[1]:
            ybar = 2.0 * g[1] * alpha
        return Kbar, ybar, None, None


@config.pin_matmul_precision
def dist_nlml(K, y, mesh, axis="data", block=256):
    """Negative log marginal likelihood for ``K``, a row-sharded DTensor
    (or a replicated tensor); differentiable with respect to ``K`` and
    ``y`` through the analytic gradient.

    ``y`` (replicated) may be ``(N,)`` or ``(N, m)``: with ``m`` columns
    this is the sum of the ``m`` per-column NLMLs of independent outputs
    sharing ``K``, ``0.5 (m logdet K + sum_j y_j^T K^{-1} y_j + m N log
    2pi)``. A call through which no gradient flows computes no ``L^{-1}``:
    the counterpart of XLA pruning the inverse of a value-only call."""
    ax = MeshAxis(mesh, axis)
    K_local = local_rows(K, ax)
    N = K.shape[-1]
    y = config.as_tensor(y)
    y2 = y[:, None] if y.ndim == 1 else y
    y_local = local_rows(y2, ax)
    need = torch.is_grad_enabled() and (K_local.requires_grad or y_local.requires_grad)
    ops = _Rows(ax, block, K_local.shape[0], N, K_local.device)
    parts = reduce_from_mesh(_NLMLParts.apply(K_local, y_local, ops, need), ax)
    m = y2.shape[-1]
    return 0.5 * (m * parts[0] + parts[1] + m * N * _LOG_2_PI)


@config.pin_matmul_precision
def dist_posterior_predict(kernel, x, y, x_new, noise, mesh, axis="data", block=256):
    """Posterior mean and variance-diagonal at ``x_new`` of an exact GP with
    row-sharded O(N^3/D) math; both replicated, differentiable in the
    kernel's tensors, ``x``, ``y``, ``x_new`` and ``noise`` through the
    factor's and the solves' backwards (``cholesky.factor_rows``,
    ``solve_rows``). The rank-local work (this rank's rows of the Gram and
    of the cross Gram) reads the inputs through ``copy_to_mesh``, the sums
    over the ranks go through ``reduce_from_mesh``, and the prior variance
    after them reads the inputs as they are (decision 4)."""
    ax = MeshAxis(mesh, axis)
    x = uprank(config.as_tensor(x))
    x_new = uprank(config.as_tensor(x_new))
    k_r, x_r, xn_r = _route(kernel, ax), copy_to_mesh(x, ax), copy_to_mesh(x_new, ax)
    K, N = _gram_rows(k_r, x_r, ax)
    n = K.shape[0]
    row0 = ax.rank * n
    noise = copy_to_mesh(config.as_scalar(noise, K.dtype, K.device), ax)
    K = torch.diagonal_scatter(K, K.diagonal(row0) + noise, row0)
    L = factor_rows(K, ax, block)
    del K
    y = config.as_tensor(y)
    y2 = local_rows(y[:, None] if y.ndim == 1 else y, ax)
    alpha = solve_rows(L, solve_rows(L, y2, ax, block), ax, block, trans=True)
    K_xs = dense(pairwise(k_r, _row_inputs(k_r, x_r, row0, row0 + n), xn_r))  # (N/D, M)
    mean = reduce_from_mesh(K_xs.mT @ alpha, ax)
    V = solve_rows(L, K_xs, ax, block)  # L^{-1} K_xs
    var = elwise(kernel, x_new)[:, 0] - reduce_from_mesh((V * V).sum(0), ax)
    if mean.requires_grad:
        check_routed(mean, "dist_posterior_predict")
    return mean[:, 0], torch.clamp_min(var, 0.0)
